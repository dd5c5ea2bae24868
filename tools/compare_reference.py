"""Compare this build's mesh against the C++ reference's mesh — the
out-of-band half of BASELINE.md target 2 ("vertex RMSE vs reference mesh").

The reference cannot be built in an offline environment (its CMake deps are
all FetchContent and there is no network), so the protocol is:

1. On any networked Linux host with a C++20 toolchain:

       git clone https://github.com/M2-TE/chad_tsdf && cd chad_tsdf
       cmake -B build -DCMAKE_BUILD_TYPE=Release && cmake --build build -j
       ./build/chad_tsdf_executable          # runs the seed-420 sphere demo
       # -> writes mesh.ply (reference: src/chad/main.cpp:7-42)

2. Commit that artifact here as ``tests/golden/reference_sphere.ply``.

3. Run this tool (CPU is fine):

       PYTHONPATH= JAX_PLATFORMS=cpu python tools/compare_reference.py

   It reproduces the exact demo workload (1M points, r=5 m sphere, voxel
   0.05 m, trunc 0.1 m, seed 420 — the reference seeds std::mt19937 with
   420, so the POINT SETS differ between the two RNGs; the surface they
   sample is identical, which is what vertex RMSE measures), meshes it,
   and prints symmetric nearest-vertex RMSE + Hausdorff vs the reference
   mesh.  Pass criterion: RMSE below one codec quantum (trunc/127 ≈
   0.787 mm) plus half a voxel of marching-cubes placement freedom.

PROVENANCE of the committed artifact: ``tests/golden/reference_sphere.ply``
was generated in-repo by ``tools/reference_oracle.py`` — an exact numpy
re-derivation of the reference's insert semantics (descending Morton sort,
greedy prefix-run normals incl. the normals.hpp:100 bound, f32
Amanatides-Woo DDA with the reference's tie-breaks, truncating 8-bit
codec; every rule cited to reference file:line), meshed with this build's
marching cubes.  This is the sanctioned fallback while the true C++ build
is unreachable (no network); a mesh.ply produced by steps 1-2 above is a
drop-in replacement and should supersede the oracle artifact when
available.  The oracle itself is differentially tested against the
analytic sphere and this build's pipeline (tests/test_reference_oracle.py).
``tests/test_mesh.py::test_reference_mesh_rmse`` enforces the RMSE
criterion against whatever artifact is present.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_PLY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "golden", "reference_sphere.ply")


def build_our_mesh():
    import numpy as np

    from chad_tsdf_tpu import MapConfig, TSDFMap

    n = 1 << 20
    rng = np.random.default_rng(420)
    d = rng.uniform(-1.0, 1.0, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * 5.0).astype(np.float32)
    m = TSDFMap(config=MapConfig(max_points=n))
    m.insert(pts, np.zeros(3, np.float32))
    return m.extract_mesh()


def main():
    if not os.path.exists(REF_PLY):
        print(f"reference mesh artifact absent: {REF_PLY}")
        print(__doc__.split("1. On any networked")[0])
        print("Follow steps 1-2 in tools/compare_reference.py's docstring "
              "to produce and commit it.")
        return 0

    from chad_tsdf_tpu.mesh import read_ply
    from chad_tsdf_tpu.mesh.rmse import analytic_sphere_rmse, vertex_rmse

    ref = read_ply(REF_PLY)
    ours = build_our_mesh()
    stats = vertex_rmse(ours.vertices, ref.vertices)
    quantum = 0.1 / 127
    tol = quantum + 0.5 * 0.05
    print(f"ours: {ours.n_vertices} verts  ref: {ref.n_vertices} verts")
    print(f"analytic |v|-5 RMSE  ours: "
          f"{analytic_sphere_rmse(ours.vertices, 5.0):.6f}  ref: "
          f"{analytic_sphere_rmse(ref.vertices, 5.0):.6f}")
    for k, v in stats.items():
        print(f"{k}: {v:.6f} m")
    ok = stats["rmse"] < tol
    print(f"{'PASS' if ok else 'FAIL'} (rmse {stats['rmse']:.6f} "
          f"{'<' if ok else '>='} tol {tol:.6f})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
