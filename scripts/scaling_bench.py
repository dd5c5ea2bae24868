"""Scaling harness: sharded-insert throughput vs device count.

Runs the SPMD insert step (parallel/sharded.py) on meshes of 1/2/4/8
devices — weak scaling: each shard integrates its own `max_points`-point
Morton-contiguous slice, so the global scan grows with N.  Prints scans/s
and points/s per mesh size plus the weak-scaling efficiency
``eff(N) = throughput(N) / (N * throughput(1))`` against BASELINE.md's
>= 0.8 target.

Runs on JAX's default backend.  On GPUs the all_to_all runs over NVLink
and the numbers are meaningful; on a virtual CPU mesh
(``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8``)
all "devices" share the host's cores, so CPU results validate the harness
and the collective overhead *structure* only.

Usage:  python scripts/scaling_bench.py [--points-per-shard 65536]
        [--devices 1,2,4,8] [--rounds 5] [--json out.json]
"""

import argparse
import json
import os
import sys
import time

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
import numpy as np                                            # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chad_tsdf_tpu.config import MapConfig                    # noqa: E402
from chad_tsdf_tpu.core.state import origin_blocks_for_position  # noqa: E402
from chad_tsdf_tpu.parallel import (create_sharded_state, make_mesh,  # noqa: E402
                                    make_sharded_insert, morton_split)
from chad_tsdf_tpu.parallel.sharded import adaptive_bounds  # noqa: E402
from chad_tsdf_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def sphere_points(n, r=5.0, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def bench_mesh(n_dev: int, cfg: MapConfig, rounds: int, inner: int = 4):
    mesh = make_mesh(n_dev)
    pos = np.zeros(3, np.float32)
    origin = origin_blocks_for_position(pos, cfg)
    pts = sphere_points(n_dev * cfg.max_points, seed=1)
    chunks = morton_split(pts, n_dev, cfg.sdf_res)
    padded = np.zeros((n_dev * cfg.max_points, 3), np.float32)
    n_per = np.zeros((n_dev,), np.int32)
    for i, c in enumerate(chunks):
        c = c[:cfg.max_points]
        padded[i * cfg.max_points:i * cfg.max_points + len(c)] = c
        n_per[i] = len(c)

    step, _ = make_sharded_insert(cfg, mesh)
    state = create_sharded_state(cfg, mesh, origin)
    padded_j = jax.device_put(jnp.asarray(padded))
    n_per_j = jnp.asarray(n_per)
    pos_j = jnp.asarray(pos)
    bounds_j = jnp.asarray(adaptive_bounds(pts, origin, n_dev, cfg))

    sync = jax.block_until_ready
    state, m = step(state, padded_j, n_per_j, pos_j, bounds_j)     # compile + warmup
    sync(state)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(inner):
            state, m = step(state, padded_j, n_per_j, pos_j, bounds_j)
        sync(state)
        best = min(best, (time.perf_counter() - t0) / inner)
    n_points = int(n_per.sum())
    return {
        "n_devices": n_dev,
        "points_per_scan": n_points,
        "ms_per_scan": best * 1e3,
        "scans_per_s": 1.0 / best,
        "points_per_s": n_points / best,
        "route_overflow": int(m["route_overflow"]),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points-per-shard", type=int, default=65536)
    ap.add_argument("--devices", type=str, default="1,2,4,8")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args()
    enable_compile_cache()

    cfg = MapConfig(max_points=args.points_per_shard,
                    block_capacity=1 << 15, touched_capacity=1 << 13)
    avail = len(jax.devices())
    sizes = [int(s) for s in args.devices.split(",") if int(s) <= avail]
    rows = []
    for n in sizes:
        r = bench_mesh(n, cfg, args.rounds)
        rows.append(r)
        print(f"N={n}: {r['ms_per_scan']:.1f} ms/scan, "
              f"{r['points_per_s'] / 1e6:.2f} M pts/s, "
              f"route_overflow={r['route_overflow']}")
    base = rows[0]["points_per_s"] / rows[0]["n_devices"]
    for r in rows:
        r["weak_scaling_efficiency"] = (
            r["points_per_s"] / (r["n_devices"] * base))
        print(f"N={r['n_devices']}: efficiency "
              f"{r['weak_scaling_efficiency']:.3f}")
    dev = jax.devices()[0]
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}, "rows": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
