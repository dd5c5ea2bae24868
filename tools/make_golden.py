"""Regenerate the committed golden voxel set + mesh (tests/golden/).

Fixed-seed sphere workload; run on CPU so the artifacts are
environment-independent (XLA CPU f32 + the deterministic pipeline).
Rerun ONLY when an intentional numerics change invalidates the goldens —
the diff then documents exactly what moved.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from chad_tsdf_tpu import MapConfig, TSDFMap

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "golden", "sphere_r2_seed420.npz")


def main():
    rng = np.random.default_rng(420)
    d = rng.uniform(-1.0, 1.0, (65536, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * 2.0).astype(np.float32)

    m = TSDFMap(config=MapConfig(max_points=65536, block_capacity=16384,
                                 touched_capacity=8192,
                                 accumulate_impl="xla", mesh_impl="host"))
    m.insert(pts, np.zeros(3, np.float32))
    codes, sd = m.voxel_samples()
    mesh = m.extract_mesh()
    np.savez_compressed(
        OUT, codes=codes, sd=sd.astype(np.float32),
        vertices=mesh.vertices, faces=mesh.faces)
    print(f"golden: {codes.shape[0]} voxels, {mesh.n_vertices} verts, "
          f"{mesh.n_faces} faces -> {OUT}")


if __name__ == "__main__":
    main()
