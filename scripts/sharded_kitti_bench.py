"""Sharded KITTI-shaped streaming bench: ShardedTSDFMap scans/s.

The sharded analog of bench.py's kitti line.  Runs on JAX's default
backend over ``--devices`` of its devices (all by default).  On one GPU it
measures the sharded path's overhead at N=1.  A CPU run
(``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8``)
uses a virtual mesh and validates the stream's structure only.

Usage: python scripts/sharded_kitti_bench.py [--devices N] [--scans 12]
       [--json out.json]
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
from chad_tsdf_tpu.io.kitti import synthetic_lidar_scan       # noqa: E402
from chad_tsdf_tpu.parallel import ShardedTSDFMap, make_mesh  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    enable_compile_cache()

    n_dev = args.devices or len(jax.devices())
    # block_capacity right-sized to the submap-rotation policy: a 5 m
    # KITTI-shaped submap touches <= ~25k blocks, 65536 is 2.6x
    # headroom (overflow is counted + warned)
    config = MapConfig(block_capacity=1 << 16, touched_capacity=1 << 15,
                       max_points=1 << 17, packed_ingest=True)
    scans = [(synthetic_lidar_scan([1.5 * i, 0.0, 0.0], seed=i),
              np.float32([1.5 * i, 0.0, 1.7]))
             for i in range(args.scans)]

    def run_stream():
        m = ShardedTSDFMap(config=config, mesh=make_mesh(n_dev))
        for pts, pos in scans:
            m.insert(pts, pos)
        return m

    # warm pass compiles insert buckets + rotation path
    m = run_stream()
    m.stats()

    m = ShardedTSDFMap(config=config, mesh=make_mesh(n_dev))
    m.insert(scans[0][0], scans[0][1])
    jax.block_until_ready(m.state_stack)
    t0 = time.perf_counter()
    total = 0
    for pts, pos in scans[1:]:
        m.insert(pts, pos)
        total += len(pts)
    jax.block_until_ready(m.state_stack)
    dt = time.perf_counter() - t0
    out = {
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "n_devices": n_dev,
        "scans_per_sec": round((len(scans) - 1) / dt, 3),
        "points_per_sec": round(total / dt),
        "route_overflow": int(m.last_metrics.get("route_overflow", 0)),
        "n_submaps": m.n_submaps,
    }
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
