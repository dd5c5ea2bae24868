"""Active map state — the array-program replacement for the mutable octree.

The reference's active map is a pointer-linked 21-level octree over two
``VirtualArray`` pools plus a depth-18 hashmap accelerator (reference:
include/chad/detail/octree.hpp:12-188, include/chad/detail/virtual_array.hpp).
Pointer chasing and growable pools don't map to XLA's static-shape model;
the active map here is a **dense block pool**:

* ``pool``: f32[block_capacity, 512, 2] — 8x8x8 voxels per block, channel 0 =
  accumulated signed-distance sum, channel 1 = accumulated weight (sample
  count).  Storing (sum, count) instead of the reference's incremental
  weighted mean (octree.hpp:161-163) is algebraically identical, associative
  and deterministic (SURVEY §7).
* ``dir_keys``/``dir_slots``: a sorted directory mapping local block Morton
  keys (int32) to pool rows.  Rows never move; the directory is rebuilt by a
  small merge-sort each insert.  This replaces both the octree's node walk
  and its gtl hashmap (octree.hpp:31-78,187).
* voxel coordinates are local to the submap origin, so every hot key fits in
  one int32 (see ops/morton.py).  ``origin_blocks`` anchors the local frame
  in world block coordinates.

Overflow of any static capacity increments a counter — never silent.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MapConfig

INT32_MAX = np.int32(2**31 - 1)
# pool rows at the end of every pool that no block is ever allocated to:
# the last one is the dump row for dropped/overflowed entries.  Part of the
# pool layout (checkpoints, overflow counts), so it stays 8 rows.
RESERVED_ROWS = 8


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ActiveMapState:
    dir_keys: jnp.ndarray      # i32[Cb] sorted local block keys, pad=INT32_MAX
    dir_slots: jnp.ndarray     # i32[Cb] pool row per directory entry
    n_blocks: jnp.ndarray      # i32[] allocated blocks
    # the pool is two parallel (Cb, 512) planes, one per accumulator, so
    # each plane is a contiguous row-major array the scatter indexes flat
    pool_sd: jnp.ndarray       # f32[Cb, 512] accumulated signed distance
    pool_w: jnp.ndarray        # f32[Cb, 512] accumulated weight (count)
    origin_blocks: jnp.ndarray  # i32[3] world block coord of local (0,0,0)
    point_overflow: jnp.ndarray    # i32[] points outside the local extent
    sample_overflow: jnp.ndarray   # i32[] ray samples outside the local extent
    block_overflow: jnp.ndarray    # i32[] blocks dropped (pool full)
    touched_overflow: jnp.ndarray  # i32[] touched blocks beyond capacity
    # i32[] always 0: kept so checkpoints and bench output keep their layout
    tile_overflow: jnp.ndarray


def create_state(config: MapConfig, origin_blocks=None) -> ActiveMapState:
    cb = config.block_capacity
    if origin_blocks is None:
        origin_blocks = np.zeros((3,), np.int32)
    # centre the local frame: local block coords are biased by half the extent
    return ActiveMapState(
        dir_keys=jnp.full((cb,), INT32_MAX, jnp.int32),
        dir_slots=jnp.zeros((cb,), jnp.int32),
        n_blocks=jnp.zeros((), jnp.int32),
        pool_sd=jnp.zeros((cb, 512), jnp.float32),
        pool_w=jnp.zeros((cb, 512), jnp.float32),
        origin_blocks=jnp.asarray(origin_blocks, jnp.int32),
        point_overflow=jnp.zeros((), jnp.int32),
        sample_overflow=jnp.zeros((), jnp.int32),
        block_overflow=jnp.zeros((), jnp.int32),
        touched_overflow=jnp.zeros((), jnp.int32),
        tile_overflow=jnp.zeros((), jnp.int32),
    )


def warn_on_overflow(state: ActiveMapState) -> dict:
    """Surface non-zero overflow counters as a Python warning.

    Every static capacity overflows by *counting*, never silently — but a
    user who ignores the counters would silently lose map quality (ADVICE
    r2: block_capacity/touched_capacity defaults are finite where the
    reference's hashmap octree is unbounded).  Called at host sync points
    (finalize); cheap because the state is already on host there.
    """
    import warnings
    counts = {
        "point_overflow": int(state.point_overflow),
        "sample_overflow": int(state.sample_overflow),
        "block_overflow": int(state.block_overflow),
        "touched_overflow": int(state.touched_overflow),
    }
    hit = {k: v for k, v in counts.items() if v > 0}
    if hit:
        warnings.warn(
            f"map capacity overflow — dropped data: {hit}; raise the "
            "corresponding MapConfig capacities (block_capacity/"
            "touched_capacity/max_points) or shrink the scan extent",
            RuntimeWarning, stacklevel=3)
    return counts


def origin_blocks_for_position(position, config: MapConfig) -> np.ndarray:
    """World block coordinate of the local frame corner for a submap starting
    at ``position`` — chosen so the scanner sits at the centre of the local
    extent."""
    half = config.blocks_per_axis // 2
    block_size = 8.0 * config.sdf_res
    centre_block = np.floor(np.asarray(position, np.float64) / block_size)
    return (centre_block - half).astype(np.int32)
