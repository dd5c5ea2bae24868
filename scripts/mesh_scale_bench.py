"""Map-scale meshing cost: save() on a ~10-submap stream, with the host
sections itemized.

Streams KITTI-shaped scans with a short rotation distance so ~10 submaps
accumulate, then times save(): ``sub_fin_ms`` (drain pending rotations +
active snapshot), ``mesh_ms`` (voxel_samples DAG walk + merge + marching
cubes + weld), plus a manual breakdown of voxel_samples vs MC.

Runs on JAX's default backend (the GPU where there is one; set
JAX_PLATFORMS=cpu for a CPU run).

Usage: python scripts/mesh_scale_bench.py [--scans 40] [--json out.json]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import jax                                                    # noqa: E402
import numpy as np                                            # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chad_tsdf_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from chad_tsdf_tpu.config import MapConfig                    # noqa: E402
from chad_tsdf_tpu.core.map import TSDFMap                    # noqa: E402
from chad_tsdf_tpu.io.kitti import synthetic_lidar_scan       # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=40)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    enable_compile_cache()

    cfg = MapConfig(block_capacity=1 << 17, touched_capacity=1 << 15,
                    max_points=1 << 17, packed_ingest=True,
                    submap_distance=6.0)
    m = TSDFMap(config=cfg)
    t0 = time.perf_counter()
    total = 0
    for i in range(args.scans):
        pts = synthetic_lidar_scan([1.5 * i, 0.0, 0.0], seed=i)
        m.insert(pts, np.float32([1.5 * i, 0.0, 1.7]))
        total += len(pts)
    t_stream = time.perf_counter() - t0

    t0 = time.perf_counter()
    subs = m._all_submaps()                 # drain + active snapshot
    t_fin = time.perf_counter() - t0

    t0 = time.perf_counter()
    codes, sd = m.voxel_samples(subs)
    t_vox = time.perf_counter() - t0

    t0 = time.perf_counter()
    mesh = m.extract_mesh()
    t_mesh_total = time.perf_counter() - t0

    out_ply = os.path.join(tempfile.mkdtemp(), "mesh_scale.ply")
    t0 = time.perf_counter()
    m.save(out_ply)
    t_save = time.perf_counter() - t0

    out = {
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "n_scans": args.scans,
        "n_points": total,
        "n_submaps": len(subs),
        "n_voxels": int(len(codes)),
        "n_vertices": int(mesh.n_vertices),
        "stream_s": round(t_stream, 2),
        "sub_fin_ms": round(t_fin * 1e3, 1),
        "voxel_samples_ms": round(t_vox * 1e3, 1),
        "mesh_total_ms": round(t_mesh_total * 1e3, 1),
        "mc_ms": round((t_mesh_total - t_vox) * 1e3, 1),
        "save_ms": round(t_save * 1e3, 1),
    }
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
