"""Segment operations over sorted keys — the array replacement for hashmaps.

The reference resolves "group by voxel / neighbourhood" queries with gtl hash
tables (reference: include/chad/detail/octree.hpp:187,
include/chad/detail/levels.hpp:93,143).  Hash tables are pointer-chasing and
hostile to array programs; the idiomatic equivalent is *sorted keys +
segment ops*:

* segment starts via boundary flags + running maxima (dense scans),
* exact per-segment sums via a segmented associative scan (numerically safe —
  no catastrophic cancellation from global-cumsum differences),
* stream compaction of few-from-many via a sort or a rank binary search
  (no scatter over the long stream).

All functions are shape-polymorphic pure jnp and run on CPU/GPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def boundary_flags(keys) -> jnp.ndarray:
    """True where a run of equal keys starts. keys: sorted (N,) or tuple of
    parallel key arrays compared lexicographically-equal."""
    if not isinstance(keys, (tuple, list)):
        keys = (keys,)
    neq = None
    for k in keys:
        d = jnp.concatenate([jnp.ones((1,), jnp.bool_), k[1:] != k[:-1]])
        neq = d if neq is None else (neq | d)
    return neq


def segment_start_positions(flags: jnp.ndarray) -> jnp.ndarray:
    """For each element, the index where its segment starts (inclusive scan
    of max over flag positions)."""
    n = flags.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    return jax.lax.cummax(jnp.where(flags, idx, 0))


def segment_end_positions(flags: jnp.ndarray) -> jnp.ndarray:
    """For each element, the exclusive end index of its segment."""
    n = flags.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    nxt = jnp.where(flags, idx, n)
    # next segment start strictly after i = suffix-min of nxt shifted left
    shifted = jnp.concatenate([nxt[1:], jnp.full((1,), n, jnp.int32)])
    return jax.lax.cummin(shifted, reverse=True)


def _shift_right(x: jnp.ndarray, d: int, fill):
    """Shift along the last axis by d, filling with ``fill``."""
    pad = jnp.full(x.shape[:-1] + (d,), fill, x.dtype)
    return jnp.concatenate([pad, x[..., :-d]], axis=-1)


def segmented_sum_scan(flags: jnp.ndarray, values: jnp.ndarray) -> jnp.ndarray:
    """Inclusive running sum that resets at each segment start.

    ``values`` may be (N,) or feature-major (F, N).  ``flags`` is (N,)
    boolean.  The value at a segment's last
    element is the exact per-segment sum, accumulated only within the
    segment (numerically superior to cumsum-difference).

    Implemented as explicit Hillis-Steele shift/combine rounds (log2 N
    elementwise passes).
    """
    n = flags.shape[0]
    f = flags
    v = values
    d = 1
    while d < n:
        fprev = jnp.concatenate([jnp.ones((d,), jnp.bool_), f[:-d]])
        vprev = _shift_right(v, d, 0)
        mask = f if v.ndim == 1 else f[None, :]
        v = jnp.where(mask, v, v + vprev)
        f = f | fprev
        d *= 2
    return v


def _last_valid_scan(has: jnp.ndarray, values: jnp.ndarray):
    """Forward scan along the last axis carrying the most recent value at a
    set ``has`` position (Hillis-Steele form; has is 1-D (N,))."""
    n = has.shape[0]
    h = has
    v = values
    d = 1
    while d < n:
        hprev = jnp.concatenate([jnp.zeros((d,), jnp.bool_), h[:-d]])
        vprev = _shift_right(v, d, 0)
        mask = h if v.ndim == 1 else h[None, :]
        v = jnp.where(mask, v, vprev)
        h = h | hprev
        d *= 2
    return v


def segment_broadcast_first(flags: jnp.ndarray, values: jnp.ndarray):
    """Each element receives ``values`` at its segment's FIRST element.

    values: (N,) or feature-major (F, N); flags: (N,) segment-start flags.
    Gather-free (one associative scan).
    """
    return _last_valid_scan(flags, values)


def _shift_left(x: jnp.ndarray, d: int, fill):
    pad = jnp.full(x.shape[:-1] + (d,), fill, x.dtype)
    return jnp.concatenate([x[..., d:], pad], axis=-1)


def segment_broadcast_last(flags: jnp.ndarray, values: jnp.ndarray):
    """Each element receives ``values`` at its segment's LAST element.

    Backward next-valid scan in shift-left form — no array reversal.
    """
    n = flags.shape[0]
    h = jnp.concatenate([flags[1:], jnp.ones((1,), jnp.bool_)])  # is_end
    v = values
    d = 1
    while d < n:
        hnext = _shift_left(h, d, False)
        vnext = _shift_left(v, d, 0)
        mask = h if v.ndim == 1 else h[None, :]
        v = jnp.where(mask, v, vnext)
        h = h | hnext
        d *= 2
    return v


def compact_flag_positions(flags: jnp.ndarray, capacity: int):
    """Positions of set flags, padded to ``capacity``.

    Returns ``(positions, count)`` where ``positions`` is int32 (capacity,)
    holding the indices of the first ``count`` set flags in ascending order;
    slots beyond ``count`` are filled with ``n`` (one past the end).

    Two regimes, never a scatter over *n* elements:

    * small n: one single-operand sort of ``where(flags, idx, n)`` — flag
      positions float to the front in order.
    * large n (the multi-million sample streams): cumulative rank +
      ``searchsorted`` with *capacity* queries.
    """
    n = flags.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    if n <= (1 << 17):
        marked = jnp.where(flags, idx, jnp.int32(n))
        pos_all = jax.lax.sort((marked,), num_keys=1)[0]
        count = jnp.sum(flags.astype(jnp.int32))
        if capacity <= n:
            pos = pos_all[:capacity]
        else:
            pos = jnp.concatenate(
                [pos_all, jnp.full((capacity - n,), n, jnp.int32)])
        return pos, jnp.minimum(count, capacity), count
    rank = jnp.cumsum(flags.astype(jnp.int32))
    count = rank[-1] if n > 0 else jnp.int32(0)
    j = jnp.arange(1, capacity + 1, dtype=jnp.int32)
    pos = jnp.searchsorted(rank, j, side="left").astype(jnp.int32)
    pos = jnp.where(j <= count, pos, n)
    return pos, jnp.minimum(count, capacity), count
