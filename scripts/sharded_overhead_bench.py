"""Price the sharded step's fixed overhead on one device, and measure the
halo traffic of the KITTI-shaped workload — the constants of the sharded
path's efficiency model.

Three measurements:

1. ``direct``: the N=1 fast-path step (= the single-device pipeline under
   shard_map) — the baseline t_pipe.
2. ``generic``: the same workload through the N>1 code path forced at
   N=1 (scratch pool -> row extract -> route -> merge).  generic - direct
   = F, the per-step fixed cost every pod shard pays on top of the
   pipeline (the all_to_all itself is degenerate at N=1, so F prices the
   extract+merge machinery; the collective is modeled from bytes/BW).
3. ``halo rows``: host-side numpy count of touched blocks per scan that
   land outside their integrating shard's Morton range, for N = 2..32 —
   the actual per-step all_to_all traffic (rows x 2 KiB x 2 planes).

Runs on JAX's default backend (the GPU where there is one; set
JAX_PLATFORMS=cpu for a CPU run).

Usage: python scripts/sharded_overhead_bench.py [--json out.json]
"""

import argparse
import json
import os
import sys
import time

import jax                                                    # noqa: E402
import numpy as np                                            # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chad_tsdf_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from chad_tsdf_tpu.config import MapConfig                    # noqa: E402
from chad_tsdf_tpu.core import integrate                      # noqa: E402
from chad_tsdf_tpu.core.state import origin_blocks_for_position  # noqa: E402
from chad_tsdf_tpu.io.kitti import synthetic_lidar_scan       # noqa: E402
from chad_tsdf_tpu.ops import morton                          # noqa: E402
from chad_tsdf_tpu.parallel import (create_sharded_state, key_bounds,  # noqa: E402
                                    make_mesh, make_sharded_insert,
                                    morton_split)
from chad_tsdf_tpu.parallel.sharded import (adaptive_bounds,  # noqa: E402
                                            owner_split, point_block_keys)


def time_step(step, state, scans, pos, bounds, sync, rounds=3):
    """Median over rounds of (mean ms/step) for a stream of scans."""
    best = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        st = state
        for q, n in scans:
            st, _m = step(st, q, n, pos, bounds)
        sync(st)
        best.append((time.perf_counter() - t0) * 1e3 / len(scans))
        state = st
    return float(np.median(best)), state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    enable_compile_cache()

    cap = 1 << 17
    cfg = MapConfig(block_capacity=1 << 17, touched_capacity=1 << 15,
                    max_points=cap, packed_ingest=True,
                    accumulate_impl="seg", point_buckets=())
    pos0 = np.float32([0.0, 0.0, 1.7])
    origin = origin_blocks_for_position(pos0, cfg)

    # stationary-position stream (no rotation; steady-state map) — the
    # same scan shape as bench.py's kitti line
    raw = [synthetic_lidar_scan([0.15 * i, 0.0, 0.0], seed=i)
           for i in range(args.scans)]
    scans = []
    for pts in raw:
        n = len(pts)
        padded = np.zeros((cap, 3), np.float32)
        padded[:n] = pts
        q = integrate.pack_points(padded, pos0, cfg.sdf_res)
        scans.append((q, np.asarray([n], np.int32)))

    mesh = make_mesh(1)
    dev = jax.devices()[0]
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "n_points_per_scan": len(raw[0])}
    sync = jax.block_until_ready

    bounds1 = key_bounds(1, cfg)
    for name, force in (("direct_ms", False), ("generic_ms", True)):
        step, _ = make_sharded_insert(cfg, mesh, force_generic=force)
        state = create_sharded_state(cfg, mesh, origin)
        # warm: compile + allocate all blocks
        st = state
        for q, n in scans:
            st, _m = step(st, q, n, pos0, bounds1)
        sync(st)
        ms, _ = time_step(step, st, scans, pos0, bounds1, sync)
        out[name] = round(ms, 2)
        print(f"{name}: {ms:.2f} ms/step")

    out["fixed_overhead_ms"] = round(out["generic_ms"] - out["direct_ms"], 2)

    # ---- halo traffic vs N (host-side, exact same mapping as the step):
    # under BOTH partitions — the static uniform key_bounds and the
    # occupancy-adaptive bounds + owner_split the map actually uses
    halo = {}
    for n_sh in (2, 4, 8, 16, 32):
        row_sets = {}
        for scheme in ("static", "adaptive"):
            if scheme == "static":
                bounds = key_bounds(n_sh, cfg)
                split = lambda pts: morton_split(pts, n_sh, cfg.sdf_res)
            else:
                bounds = adaptive_bounds(raw[0], origin, n_sh, cfg)
                split = lambda pts: owner_split(pts, bounds, origin, cfg)
            rows = []
            for pts in raw:
                remote = 0
                touched = 0
                for me, c in enumerate(split(pts)):
                    if not len(c):
                        continue
                    uk = np.unique(point_block_keys(c, origin, cfg))
                    touched += len(uk)
                    owner = np.searchsorted(bounds, uk,
                                            side="right") - 1
                    remote += int((owner != me).sum())
                rows.append((remote, touched))
            r = np.asarray(rows)
            row_sets[scheme] = {
                "remote_rows_per_scan": round(float(r[:, 0].mean()), 1),
                "touched_rows_per_scan": round(float(r[:, 1].mean()), 1),
                "remote_fraction": round(
                    float(r[:, 0].sum() / max(r[:, 1].sum(), 1)), 4),
            }
        halo[n_sh] = row_sets
        print(f"N={n_sh}: {row_sets}")
    out["halo"] = halo
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
