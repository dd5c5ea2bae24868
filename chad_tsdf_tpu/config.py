"""Map configuration.

The reference (chad_tsdf) exposes exactly two runtime knobs — ``sdf_res`` and
``sdf_trunc`` (reference: include/chad/tsdf.hpp:29) — and hardcodes everything
else: submap rotation distance 5.0 m (src/chad/tsdf.cpp:52), normal
neighbourhood ``min_points = 8`` with up to 3 Morton coarsening levels
(include/chad/detail/normals.hpp:88,94), 8-bit TSDF quantization
(include/chad/cluster.hpp:15), and 21 octree levels
(include/chad/detail/levels.hpp:195).  Here every constant is a named,
documented field of one frozen dataclass.

Capacity fields exist because XLA compiles static shapes: points per insert,
DDA sample budget, block-pool capacity etc. are fixed at trace time, with
overflow surfaced through counters (never silent truncation).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MapConfig:
    # --- core TSDF parameters (reference tsdf.hpp:29) ---
    sdf_res: float = 0.05       # voxel edge length [m]
    sdf_trunc: float = 0.1      # truncation distance [m]

    # --- submapping (reference tsdf.cpp:52) ---
    submap_distance: float = 5.0   # travel distance before submap rotation [m]

    # --- normal estimation (reference normals.hpp:88,94) ---
    normal_min_points: int = 8     # min neighbourhood size for a plane fit
    normal_max_depth: int = 3      # Morton coarsening rounds (0,3,6 bits)

    # --- static capacities (XLA shapes are compile-time constants) ---
    # max points per insert() call; longer clouds are processed in chunks
    max_points: int = 1 << 20
    # compile-shape buckets for streaming inserts: a scan is padded to the
    # smallest bucket that fits instead of always paying the full
    # max_points pipeline (a 120k-point KITTI scan would waste ~88% of a
    # 1M-point compile shape).  None = auto {max_points / 8,4,2,1} clipped
    # to multiples of 1024; () = single shape (old behaviour).  Each bucket
    # is a separate XLA compilation, traced on first use.
    point_buckets: tuple | None = None
    # DDA ray-sample slots per point; None = auto from trunc/res (see dda_steps)
    max_steps: int | None = None
    # capacity of the active block pool (blocks of 8x8x8 voxels).  The
    # directory rebuild sorts O(block_capacity) keys per insert, so these
    # defaults
    # are sized for a submap's working set (the active map rotates every
    # submap_distance of travel), not the whole mission: 64k blocks =
    # 33.5M voxels = 256 MiB of pool.  Overflow is counted, never silent.
    block_capacity: int = 1 << 16
    # max distinct blocks touched by one insert
    touched_capacity: int = 1 << 14
    # local block-coordinate extent: blocks per axis = 2**block_bits,
    # centred on the submap origin.  10 bits -> 1024 blocks -> 409.6 m at
    # res=0.05.  Must satisfy 3*block_bits <= 31 (single int32 Morton key).
    block_bits: int = 10

    # --- meshing ---
    # the reference meshes only the first submap (tsdf.cpp:85, a documented
    # limitation); False = mesh the union of all submaps.
    mesh_first_submap_only: bool = False
    # write the LVR2-compatible binary .grid dump on save() (lvr2.cpp:290
    # writes it unconditionally; here it is opt-in)
    save_grid: bool = False
    # marching cubes backend: 'auto' (see backend.choose), or force
    # 'device' (JAX classify + tri-table gather + compaction,
    # mesh/device_mc.py) / 'host' (numpy, mesh/mc.py)
    mesh_impl: str = "auto"

    # --- execution ---
    # insert accumulation backend: 'auto' (see backend.choose), or force
    # 'xla' (sample sort + scatter-add, core/integrate.update_pool) / 'seg'
    # (voxel-sorted segment reduction + compacted scatter,
    # core/integrate.insert_step_sparse_seg)
    accumulate_impl: str = "auto"
    # packed ingestion: upload scans as int16 scanner-relative fixed-point
    # (step = sdf_res/8, i.e. 6.25 mm at the default resolution; range
    # +-204.8 m — exactly the local extent) instead of f32 — halves the
    # host->device bytes per insert.
    # The 3.1 mm max rounding error is ~an order below LiDAR range noise
    # and 1/16 of the default voxel; inputs already on the packing grid
    # round-trip exactly.  Off by default (bit-reproducible f32 path).
    packed_ingest: bool = False
    # max rotated-out submaps that may stay deferred before the oldest is
    # forced to materialize.  A deferred rotation pins the FULL rotated-out
    # pool on device (2 x block_capacity x 512 f32 = 256 MiB at the
    # defaults; zero-sync rotation, core/submap.PendingSubmap), so this
    # bounds device memory at ~max_pending_finalize x pool size — lower it
    # for very large block_capacity
    max_pending_finalize: int = 4

    # --- space carving (reference roadmap README.md:60 — unbuilt there;
    # see core/carve.py for semantics) ---
    # free-space samples per carve ray; 0 = carving off (default).  The
    # carved range from the scanner is carve_steps * carve_stride * sdf_res
    # metres (48 * 2 * 0.05 = 4.8 m at the defaults).
    carve_steps: int = 0
    # spacing between consecutive free-space samples along a ray [voxels]
    carve_stride: float = 2.0
    # carve every Nth point's ray (free-space evidence is spatially
    # redundant across neighbouring LiDAR returns)
    carve_subsample: int = 2
    # observation weight of one free-space sample relative to a band
    # sample's 1.0 — lower it to soften erosion near valid surfaces
    carve_weight: float = 1.0
    # print per-stage wall times like the reference's fmt timers
    # (morton.hpp:78,100, normals.hpp:146, octree.hpp:169, tsdf.cpp:74)
    profile: bool = False

    # ------------------------------------------------------------------
    @property
    def dda_steps(self) -> int:
        """Ray-sample slots per point.

        The Amanatides–Woo traversal (reference octree.hpp:92-152) visits
        ``sum_axis |v_final - v_start| + 1`` voxels.  Per axis
        ``|v_final - v_start| <= span_axis/res + 1`` (a floor difference),
        and ``sum_axis span_axis = 2*trunc*L1(dir) <= 2*trunc*sqrt(3)``, so
        ``ceil(2*trunc/res * sqrt(3)) + 3`` slots (+1 start voxel, +3 for
        the per-axis floor boundaries) provably cover every ray.
        """
        if self.max_steps is not None:
            return self.max_steps
        ratio = 2.0 * self.sdf_trunc / self.sdf_res
        return int(math.ceil(ratio * math.sqrt(3.0))) + 3

    @property
    def buckets(self) -> tuple:
        """Resolved ascending compile-shape buckets (always ends with
        max_points; every other entry a multiple of 4096)."""
        if self.point_buckets is not None:
            bs = {min(int(b), self.max_points) for b in self.point_buckets}
        elif self.max_points % 4096 == 0 and self.max_points >= 1 << 15:
            bs = {self.max_points >> s for s in (3, 2, 1)}
        else:
            bs = set()
        out = {self.max_points}
        for b in bs:
            if b >= 4096 and b % 4096 == 0:
                out.add(b)
        return tuple(sorted(out))

    @property
    def blocks_per_axis(self) -> int:
        return 1 << self.block_bits

    @property
    def local_extent_m(self) -> float:
        """Half-extent of the active map around the submap origin [m]."""
        return self.blocks_per_axis / 2 * 8 * self.sdf_res

    @property
    def sample_capacity(self) -> int:
        return self.max_points * self.dda_steps

    def __post_init__(self):
        if self.sdf_res <= 0 or self.sdf_trunc <= 0:
            raise ValueError("sdf_res and sdf_trunc must be positive")
        if 3 * self.block_bits > 31:
            raise ValueError("block_bits too large for int32 Morton keys")
        if self.accumulate_impl not in ("auto", "xla", "seg"):
            raise ValueError(f"bad accumulate_impl {self.accumulate_impl!r}")
        if self.mesh_impl not in ("auto", "device", "host"):
            raise ValueError(f"bad mesh_impl {self.mesh_impl!r}")
        if self.carve_steps < 0:
            raise ValueError("carve_steps must be >= 0")
        if self.carve_steps > 0 and (self.carve_stride <= 0
                                     or self.carve_subsample < 1
                                     or self.carve_weight <= 0):
            raise ValueError("carving needs carve_stride > 0, "
                             "carve_subsample >= 1, carve_weight > 0")
