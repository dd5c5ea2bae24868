"""Backend choice — the one place that decides which implementation a job
runs on.

Two jobs have more than one implementation:

* insert accumulation (``MapConfig.accumulate_impl``): ``xla`` — one sort
  of the flat ray samples by block key, then a scatter-add into the pool
  (core/integrate.update_pool) — or ``seg`` — a voxel-sorted segment
  reduction, then a scatter of one entry per unique voxel
  (core/integrate.insert_step_sparse_seg);
* marching cubes on ``save()`` (``MapConfig.mesh_impl``): ``device``
  (mesh/device_mc.py) or ``host`` (numpy, mesh/mc.py).

``auto`` follows measurement on an NVIDIA H100 80GB HBM3 at a 700 W power
limit: ``xla`` beat ``seg`` on both the dense 1M-point sphere and the
KITTI-shaped LiDAR stream, so ``auto`` inserts with ``xla`` whatever the
cloud's density; warm device marching cubes beat the numpy one on the
GPU, so ``auto`` meshes on the device there and with numpy on the CPU.
The numbers are in CHANGES.md.

Only the ``gpu`` and ``cpu`` platforms are supported: any other platform
raises instead of being guessed at.
"""

from __future__ import annotations

from typing import NamedTuple

import jax

from .config import MapConfig

PLATFORMS = ("gpu", "cpu")


class Choice(NamedTuple):
    insert: str     # 'xla' | 'seg'
    mesh: str       # 'device' | 'host'


def choose(config: MapConfig, platform: str | None = None) -> Choice:
    """Resolve the ``auto`` options of ``config`` for ``platform``
    (default: JAX's default backend)."""
    if platform is None:
        platform = jax.default_backend()
    if platform not in PLATFORMS:
        raise RuntimeError(f"unsupported JAX platform {platform!r}: this "
                           f"package runs on {' or '.join(PLATFORMS)}")
    insert = config.accumulate_impl
    if insert == "auto":
        insert = "xla"
    mesh = config.mesh_impl
    if mesh == "auto":
        mesh = "device" if platform == "gpu" else "host"
    return Choice(insert, mesh)
