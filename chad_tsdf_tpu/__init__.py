"""chad_tsdf_tpu — a dense-mapping (TSDF) engine in JAX/XLA for NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capabilities of
``M2-TE/chad_tsdf`` (a C++20 TSDF SLAM mapping backend): streaming point-cloud
insertion with Morton sorting and neighbourhood normal estimation, truncated
signed-distance integration along sensor rays, a submapped hash-consed DAG map
representation, and marching-cubes mesh extraction to PLY — built as
sort/segment-scan/scatter array programs, scaling over
device meshes via Morton-range sharding (see chad_tsdf_tpu.parallel).

Public API mirrors the reference's single entry class
(reference: include/chad/tsdf.hpp:21-171)::

    from chad_tsdf_tpu import TSDFMap
    m = TSDFMap(sdf_res=0.05, sdf_trunc=0.1)
    m.insert(points, position)       # numpy (N,3), (3,)
    m.save("mesh.ply")
"""

from .config import MapConfig

__all__ = ["TSDFMap", "MapConfig"]
__version__ = "0.1.0"


def __getattr__(name):
    # lazy import so light-weight users (and the ops test suite) don't pay
    # for the full map stack at import time
    if name == "TSDFMap":
        from .core.map import TSDFMap
        return TSDFMap
    raise AttributeError(name)
