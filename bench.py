"""Benchmark: TSDF integrate throughput on the canonical workload.

Measures points/s for the reference's sphere demo (1M points on a 5 m
sphere, res 0.05 m, trunc 0.1 m — reference src/chad/main.cpp:8-38) on the
GPU, plus a KITTI-shaped LiDAR stream through ``TSDFMap.insert``.

Timing: every timed region ends in ``jax.block_until_ready``.
* amortized: median over rounds of ``reps`` inserts chained in one
  dispatch (``core/integrate.insert_steps_scan``).
* per-insert-synced: median latency of a single insert.

Prints the device (platform, kind, count) on stderr and exactly one JSON
line on stdout:
  {"metric": "tsdf_integrate_points_per_sec", "value": N, "unit": "points/s",
   "vs_baseline": N / 50e6, ...}
vs_baseline is against BASELINE.md's throughput target of 50M points/s
(the reference itself publishes no numbers).  Exits non-zero without a GPU.
"""

import json
import statistics
import sys
import time


def main():
    import jax

    from chad_tsdf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}", file=sys.stderr)
    if dev.platform != "gpu":
        print("bench.py measures the GPU; JAX found none", file=sys.stderr)
        return 1

    import jax.numpy as jnp
    import numpy as np

    from chad_tsdf_tpu.config import MapConfig
    from chad_tsdf_tpu.core import integrate
    from chad_tsdf_tpu.core.state import (create_state,
                                          origin_blocks_for_position)

    n_points = 1 << 20
    config = MapConfig(max_points=n_points)

    rng = np.random.default_rng(420)
    d = rng.uniform(-1.0, 1.0, (n_points, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    points = jnp.asarray((d * 5.0).astype(np.float32))
    position = jnp.zeros(3, jnp.float32)
    n = jnp.int32(n_points)

    pos_np = np.zeros(3, np.float32)
    state = create_state(config, origin_blocks_for_position(pos_np, config))

    # compile + warm up
    state, metrics = integrate.insert_step(state, points, n, position,
                                           config)
    print("warmup:", {k: int(v) for k, v in metrics.items()},
          file=sys.stderr)

    reps, rounds = 25, 3
    state = integrate.insert_steps_scan(state, points, n, position, config,
                                        reps)     # compile + warm
    jax.block_until_ready(state)
    per_round = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        state = integrate.insert_steps_scan(state, points, n, position,
                                            config, reps)
        jax.block_until_ready(state)
        per_round.append((time.perf_counter() - t0) / reps)
    amortized = statistics.median(per_round)
    pts_per_sec = n_points / amortized

    singles = []
    for _ in range(5):
        t0 = time.perf_counter()
        state, metrics = integrate.insert_step(state, points, n, position,
                                               config)
        jax.block_until_ready(state)
        singles.append(time.perf_counter() - t0)
    single = statistics.median(singles)

    print(f"amortized: {amortized*1e3:.3f} ms/insert over {rounds}x{reps} "
          f"-> {pts_per_sec/1e6:.2f} M points/s "
          f"(rounds: {[f'{r*1e3:.3f}' for r in per_round]})",
          file=sys.stderr)
    print(f"per-insert-synced: {single*1e3:.3f} ms", file=sys.stderr)

    # ---- secondary metric: KITTI-shaped streaming scans/s (sparse ~120k-pt
    # scans through the bucketed TSDFMap path, incl. submap rotations) —
    # BASELINE.json config 2 without the dataset ----
    extra = _kitti_shaped_stream()

    print(json.dumps({
        "metric": "tsdf_integrate_points_per_sec",
        "value": round(pts_per_sec),
        "unit": "points/s",
        "vs_baseline": round(pts_per_sec / 50e6, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **extra,
    }))
    return 0


def _kitti_shaped_stream(n_scans: int = 12):
    import jax
    import numpy as np

    from chad_tsdf_tpu.core.map import TSDFMap
    from chad_tsdf_tpu.config import MapConfig
    from chad_tsdf_tpu.io.kitti import synthetic_lidar_scan

    # right-sized for sparse outdoor scans: ~120k points spread over tens of
    # thousands of blocks (vs the dense sphere's ~4k): a block pool sized to
    # the submap-rotation policy (a 5 m KITTI-shaped submap touches
    # <= ~25k blocks) and a touched capacity sized to one scan's block set
    config = MapConfig(block_capacity=1 << 16, touched_capacity=1 << 15,
                       packed_ingest=True)
    scans = [(synthetic_lidar_scan([1.5 * i, 0.0, 0.0], seed=i),
              np.float32([1.5 * i, 0.0, 1.7])) for i in range(n_scans)]

    # warm pass over the whole stream: compiles the insert buckets AND the
    # rotation path (deferred finalize shapes), whose first-run compiles
    # would otherwise land inside the timed region
    m = TSDFMap(config=config)
    for pts, pos in scans:
        m.insert(pts, pos)
    m.stats()                       # drain pending finalizes + sync

    m = TSDFMap(config=config)
    m.insert(scans[0][0], scans[0][1])
    jax.block_until_ready(m.state)
    t0 = time.perf_counter()
    total_pts = 0
    for pts, pos in scans[1:]:
        m.insert(pts, pos)
        total_pts += len(pts)
    jax.block_until_ready(m.state)
    dt = time.perf_counter() - t0
    scans_per_s = (len(scans) - 1) / dt
    tile_ovf = int(m.state.tile_overflow)
    print(f"kitti-shaped: {scans_per_s:.2f} scans/s, "
          f"{total_pts / dt / 1e6:.3f} M pts/s, "
          f"tile_overflow={tile_ovf}, submaps={m.n_submaps}",
          file=sys.stderr)
    return {"kitti_scans_per_sec": round(scans_per_s, 2),
            "kitti_points_per_sec": round(total_pts / dt),
            "kitti_tile_overflow": tile_ovf}


if __name__ == "__main__":
    sys.exit(main())
