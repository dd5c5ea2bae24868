"""Sample accumulation into the block pool.

Replaces the reference's hottest loop — per-voxel hashmap lookup + weighted
mean update (reference: include/chad/detail/octree.hpp:153-163) — with one
scatter-add of (signed distance, weight 1) per sample into the dense block
pool.  The pool stores (sum, count), so the update is associative and the
weighted mean is recovered at finalize.

The pool is two (Cb, 512) planes (sd-sum and weight) — see
core/state.ActiveMapState.
"""

from __future__ import annotations

import jax.numpy as jnp


def accumulate_xla(pool_sd, pool_w, slots_per_sample, offsets, sd, valid):
    """Scatter-add samples into the pool.

    pool_sd/pool_w: f32[Cb, 512]; slots_per_sample/offsets: i32[S];
    sd: f32[S]; valid: bool[S].
    """
    cb = pool_sd.shape[0]
    idx = slots_per_sample * 512 + offsets
    idx = jnp.where(valid, idx, cb * 512)  # out-of-range -> dropped
    new_sd = pool_sd.reshape(-1).at[idx].add(
        jnp.where(valid, sd, 0.0), mode="drop").reshape(pool_sd.shape)
    new_w = pool_w.reshape(-1).at[idx].add(
        valid.astype(jnp.float32), mode="drop").reshape(pool_w.shape)
    return new_sd, new_w
