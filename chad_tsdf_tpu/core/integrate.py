"""The insert pipeline — one fused jit per scan.

Mirrors the reference hot path ``TSDFMap::insert`` (reference:
src/chad/tsdf.cpp:39-75):

  reference (scalar, hashmap-based)          array program (this module)
  -----------------------------------       --------------------------------
  calc_morton_vector  morton.hpp:59-80  ->  local (block, offset) int32 keys
  sort_morton_vector  morton.hpp:81-102 ->  lax.sort, 2 keys (ascending*)
  estimate_normals    normals.hpp:81-148->  segmented-scan plane fits
  Octree::insert DDA  octree.hpp:92-152 ->  lax.scan fixed-K traversal
  per-voxel hashmap upsert + weighted    ->  sample sort by block + touched-
  mean                octree.hpp:153-163    block segments + scatter-add
                                            into the block pool

(*) the reference sorts descending (morton.hpp:85-89); ascending is
equivalent for every consumer here (segments and sums are order-free) and is
what jax.lax.sort provides natively.  Documented deviation per SURVEY §7.

The pipeline is split into composable stages so the Morton-sharded SPMD path
(chad_tsdf_tpu.parallel) can interleave its block-row routing between them:

  compute_samples  : points -> (block key, offset, sd) sample triples
  sort_samples     : single-int32-key sample sort
  update_pool      : touched-block segments + directory merge + accumulate

Everything runs under ``jax.jit`` with static shapes; validity masks and
overflow counters absorb the dynamic sizes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from ..config import MapConfig
from ..ops import accumulate, dda, morton, normals, segops
from .state import INT32_MAX, RESERVED_ROWS, ActiveMapState


class SampleBatch(NamedTuple):
    """Flat ray samples.

    ``payload`` packs the 9-bit intra-block offset and the signed distance
    quantized to 16 bits into one int32 (halves the sort payload and the
    routing traffic; 16-bit sd granularity is trunc/32767, far below the
    8-bit output codec's trunc/127):  payload = offset << 16 | sd_q16.
    """
    bkey: jnp.ndarray    # i32[S] block Morton key, INT32_MAX = invalid
    payload: jnp.ndarray  # i32[S] offset<<16 | 16-bit quantized sd
    pt_overflow: jnp.ndarray     # i32[] points outside the local extent
    samp_overflow: jnp.ndarray   # i32[] samples outside the local extent


SD_QUANT = 32767.0
# row-count granularity of update_pool_rows' live-row buckets
_ROW_CHUNK = 128

def pack_payload(okey, sd, sdf_trunc: float):
    q = jnp.round(sd * (SD_QUANT / sdf_trunc)).astype(jnp.int32)
    q = jnp.clip(q, -32767, 32767)
    return (okey << 16) | (q & 0xFFFF)


def unpack_payload(payload, sdf_trunc: float):
    okey = (payload >> 16) & 0x1FF
    q = (payload << 16) >> 16          # arithmetic shift sign-extends
    sd = q.astype(jnp.float32) * (sdf_trunc / SD_QUANT)
    return okey, sd


def point_keys(points, n_points, origin_blocks, config: MapConfig):
    """Local Morton keys per point; invalid/padded points get sentinel keys.

    Returns (bkey, okey, pt_overflow)."""
    return point_keys_soa(points[:, 0], points[:, 1], points[:, 2],
                          n_points, origin_blocks, config)


def point_keys_soa(px, py, pz, n_points, origin_blocks, config: MapConfig):
    """SoA form of :func:`point_keys` — all ops on (N,) arrays."""
    n = px.shape[0]
    extent = config.blocks_per_axis * 8
    idx = jnp.arange(n, dtype=jnp.int32)
    in_cloud = idx < n_points
    origin_voxel = origin_blocks * 8
    inv = jnp.float32(1.0 / config.sdf_res)
    # floor(p / res) exactly as the reference (morton.hpp:71)
    lx = jnp.floor(px * inv).astype(jnp.int32) - origin_voxel[0]
    ly = jnp.floor(py * inv).astype(jnp.int32) - origin_voxel[1]
    lz = jnp.floor(pz * inv).astype(jnp.int32) - origin_voxel[2]
    in_range = ((lx >= 0) & (lx < extent) & (ly >= 0) & (ly < extent) &
                (lz >= 0) & (lz < extent))
    valid_pt = in_cloud & in_range
    pt_overflow = jnp.sum(in_cloud & ~in_range).astype(jnp.int32)
    lx = jnp.clip(lx, 0, extent - 1)
    ly = jnp.clip(ly, 0, extent - 1)
    lz = jnp.clip(lz, 0, extent - 1)
    bkey = morton.encode_block(lx >> 3, ly >> 3, lz >> 3)
    okey = morton.encode_offset(lx & 7, ly & 7, lz & 7)
    bkey = jnp.where(valid_pt, bkey, INT32_MAX)
    okey = jnp.where(valid_pt, okey, INT32_MAX)
    return bkey, okey, pt_overflow


def sort_points_soa(px, py, pz, bkey, okey):
    """Sort points by (block, offset) Morton key (tsdf.cpp:64-65).

    The coordinates ride through the sort as payload operands instead of
    sorting an index and gathering.  Returns (sb, so, px, py, pz) all
    sorted.
    """
    return jax.lax.sort((bkey, okey, px, py, pz), num_keys=2)


def sort_points(points, bkey, okey):
    """AoS wrapper over :func:`sort_points_soa`."""
    sb, so, px, py, pz = sort_points_soa(points[:, 0], points[:, 1],
                                         points[:, 2], bkey, okey)
    return jnp.stack([px, py, pz], axis=-1), sb, so


def compute_sample_grids(pts, sb, so, position, origin_blocks,
                         config: MapConfig):
    """Normals + DDA over Morton-sorted points -> (K, N) sample grids.

    Internally structure-of-arrays: per-axis (N,) and (K, N) arrays.

    Returns (s_bkey, s_okey, sd, n_valid, samp_overflow) with s_bkey/s_okey
    i32[K, N] (INT32_MAX key = invalid slot), sd f32[K, N].
    """
    px, py, pz = pts[:, 0], pts[:, 1], pts[:, 2]
    return compute_sample_grids_soa(px, py, pz, sb, so, position,
                                    origin_blocks, config)


def compute_sample_grids_soa(px, py, pz, sb, so, position, origin_blocks,
                             config: MapConfig):
    k = config.dda_steps
    res, trunc = config.sdf_res, config.sdf_trunc
    extent = config.blocks_per_axis * 8
    origin_voxel = origin_blocks * 8
    valid_sorted = sb != INT32_MAX

    # ---- normals (tsdf.cpp:67) ----
    nx, ny, nz = normals.estimate_normals_soa(
        px, py, pz, sb, so, valid_sorted, position,
        config.normal_min_points, config.normal_max_depth)

    # ---- DDA traversal + signed distances (octree.hpp:92-163) ----
    vx, vy, vz, vvalid = dda.traverse(px, py, pz, position, res, trunc, k)
    sd = dda.signed_distances(vx, vy, vz, px, py, pz, nx, ny, nz, res, trunc)
    vvalid = vvalid & valid_sorted[None, :]

    lx = vx - origin_voxel[0]
    ly = vy - origin_voxel[1]
    lz = vz - origin_voxel[2]
    s_in_range = ((lx >= 0) & (lx < extent) & (ly >= 0) & (ly < extent) &
                  (lz >= 0) & (lz < extent))
    samp_overflow = jnp.sum(vvalid & ~s_in_range).astype(jnp.int32)
    vvalid = vvalid & s_in_range
    lx = jnp.clip(lx, 0, extent - 1)
    ly = jnp.clip(ly, 0, extent - 1)
    lz = jnp.clip(lz, 0, extent - 1)

    s_bkey = morton.encode_block(lx >> 3, ly >> 3, lz >> 3)
    s_okey = morton.encode_offset(lx & 7, ly & 7, lz & 7)
    s_bkey = jnp.where(vvalid, s_bkey, INT32_MAX)
    s_okey = jnp.where(vvalid, s_okey, 0)
    n_valid = jnp.sum(vvalid).astype(jnp.int32)
    return s_bkey, s_okey, sd, n_valid, samp_overflow


def samples_from_sorted_points(pts, sb, so, position, origin_blocks,
                               config: MapConfig,
                               pt_overflow=None) -> SampleBatch:
    """Flat packed sample triples of Morton-sorted points."""
    if pt_overflow is None:
        pt_overflow = jnp.zeros((), jnp.int32)
    s_bkey, s_okey, sd, _, samp_overflow = compute_sample_grids(
        pts, sb, so, position, origin_blocks, config)
    payload = pack_payload(s_okey, sd, config.sdf_trunc)
    payload = jnp.where(s_bkey != INT32_MAX, payload, 0)
    return SampleBatch(s_bkey.reshape(-1), payload.reshape(-1),
                       pt_overflow, samp_overflow)


def compute_samples(points, n_points, position, origin_blocks,
                    config: MapConfig) -> SampleBatch:
    """Morton sort + normals + DDA: points -> flat sample triples."""
    bkey, okey, pt_overflow = point_keys(points, n_points, origin_blocks,
                                         config)
    pts, sb, so = sort_points(points, bkey, okey)
    return samples_from_sorted_points(pts, sb, so, position, origin_blocks,
                                      config, pt_overflow)


def sort_samples(batch: SampleBatch) -> SampleBatch:
    b, p = jax.lax.sort((batch.bkey, batch.payload), num_keys=1)
    return SampleBatch(b, p, batch.pt_overflow, batch.samp_overflow)


def _directory_update(state: ActiveMapState, tb_keys, tvalid,
                      config: MapConfig):
    """Look up touched-block keys in the sorted directory, allocate pool
    slots for new blocks, and rebuild the directory (tsdf/octree alloc,
    reference octree.hpp:31-78, without the hashmap).

    Returns (dir_keys, dir_slots, n_blocks, tb_slots, n_new,
    block_overflow); overflowed/invalid entries get the reserved slot
    ``cb - 1``.
    """
    cb = config.block_capacity
    reserved_row = cb - 1          # dump row for dropped entries
    usable_blocks = cb - RESERVED_ROWS

    pos = jnp.searchsorted(state.dir_keys, tb_keys).astype(jnp.int32)
    pos_c = jnp.minimum(pos, cb - 1)
    found = (state.dir_keys[pos_c] == tb_keys) & tvalid
    is_new = tvalid & ~found
    new_rank = jnp.cumsum(is_new.astype(jnp.int32))
    n_new = new_rank[-1]
    slot_if_new = state.n_blocks + new_rank - 1
    fits = slot_if_new < usable_blocks
    block_overflow = jnp.sum(is_new & ~fits).astype(jnp.int32)
    tb_slots = jnp.where(found, state.dir_slots[pos_c],
                         jnp.where(fits, slot_if_new, reserved_row))
    tb_slots = jnp.where(tvalid, tb_slots, reserved_row)

    # rebuild the sorted directory by merging the new keys; steady-state
    # inserts (no new blocks) skip the O(cb log cb) sort entirely
    def rebuild(_):
        append_keys = jnp.where(is_new & fits, tb_keys, INT32_MAX)
        append_slots = jnp.where(is_new & fits, slot_if_new, 0)
        mk = jnp.concatenate([state.dir_keys, append_keys])
        ms = jnp.concatenate([state.dir_slots, append_slots])
        mk, ms = jax.lax.sort((mk, ms), num_keys=1)
        return mk[:cb], ms[:cb]

    def keep(_):
        return state.dir_keys, state.dir_slots

    dir_keys, dir_slots = jax.lax.cond(n_new > 0, rebuild, keep, None)
    n_blocks = jnp.minimum(state.n_blocks + n_new, usable_blocks)
    return (dir_keys, dir_slots, n_blocks, tb_slots, n_new, block_overflow)


def update_pool(state: ActiveMapState, batch: SampleBatch,
                config: MapConfig):
    """Touched-block segmentation, directory merge, pool accumulation.

    ``batch`` must be sorted by block key (sort_samples).  Returns
    (new_state, metrics).
    """
    cb = config.block_capacity
    t_cap = config.touched_capacity
    reserved_row = cb - 1
    s_bkey, s_payload = batch.bkey, batch.payload
    total = s_bkey.shape[0]
    n_valid_samples = jnp.sum(s_bkey != INT32_MAX).astype(jnp.int32)

    # ---- touched-block segments (compaction via rank search, no scatter) ----
    flags = segops.boundary_flags(s_bkey) & (s_bkey != INT32_MAX)
    starts, _, t_total = segops.compact_flag_positions(flags, t_cap)
    t_count = jnp.minimum(t_total, t_cap)
    touched_overflow = jnp.maximum(t_total - t_cap, 0).astype(jnp.int32)
    tvalid = jnp.arange(t_cap, dtype=jnp.int32) < t_count
    starts_c = jnp.minimum(starts, total - 1)
    tb_keys = jnp.where(tvalid, s_bkey[starts_c], INT32_MAX)

    (dir_keys, dir_slots, n_blocks, tb_slots, n_new,
     block_overflow) = _directory_update(state, tb_keys, tvalid, config)

    # ---- accumulate into the pool ----
    # per-sample slot via dense segment fill (no big searchsorted); samples
    # of overflowed blocks carry the reserved row and are dropped
    s_okey, s_sd = unpack_payload(s_payload, config.sdf_trunc)
    t_idx = jnp.cumsum(flags.astype(jnp.int32)) - 1
    slot_per_sample = tb_slots[jnp.clip(t_idx, 0, t_cap - 1)]
    sample_ok = (s_bkey != INT32_MAX) & (t_idx < t_cap) & \
        (slot_per_sample != reserved_row)
    pool_sd, pool_w = accumulate.accumulate_xla(
        state.pool_sd, state.pool_w, slot_per_sample, s_okey, s_sd,
        sample_ok)

    new_state = ActiveMapState(
        dir_keys=dir_keys, dir_slots=dir_slots, n_blocks=n_blocks,
        pool_sd=pool_sd, pool_w=pool_w, origin_blocks=state.origin_blocks,
        point_overflow=state.point_overflow + batch.pt_overflow,
        sample_overflow=state.sample_overflow + batch.samp_overflow,
        block_overflow=state.block_overflow + block_overflow,
        touched_overflow=state.touched_overflow + touched_overflow,
        tile_overflow=state.tile_overflow,
    )
    metrics = {
        "n_valid_samples": n_valid_samples,
        "n_touched_blocks": t_count,
        "n_new_blocks": n_new,
        "n_blocks": n_blocks,
    }
    return new_state, metrics


def update_pool_rows(state: ActiveMapState, pkeys, psd, pw,
                     n_valid_samples, samp_overflow, pt_overflow,
                     config: MapConfig):
    """Merge consolidated block rows into the pool (the sharded path's
    merge of local and received halo rows, parallel/sharded.py).

    pkeys: i32[P] block keys (INT32_MAX = empty; duplicates allowed);
    psd/pw: f32[P, 512] accumulator rows, summed into the pool by key.
    """
    cb = config.block_capacity
    t_cap = config.touched_capacity
    reserved_row = cb - 1
    p = pkeys.shape[0]

    iota = jnp.arange(p, dtype=jnp.int32)
    sk, order = jax.lax.sort((pkeys, iota), num_keys=1)
    flags = segops.boundary_flags(sk) & (sk != INT32_MAX)
    starts, _, t_total = segops.compact_flag_positions(flags, t_cap)
    t_count = jnp.minimum(t_total, t_cap)
    touched_overflow = jnp.maximum(t_total - t_cap, 0).astype(jnp.int32)
    tvalid = jnp.arange(t_cap, dtype=jnp.int32) < t_count
    tb_keys = jnp.where(tvalid, sk[jnp.minimum(starts, p - 1)], INT32_MAX)

    (dir_keys, dir_slots, n_blocks, tb_slots, n_new,
     block_overflow) = _directory_update(state, tb_keys, tvalid, config)

    # per-row pool slot (dense segment fill over the key-sorted stream)
    t_idx = jnp.cumsum(flags.astype(jnp.int32)) - 1
    t_ok = (sk != INT32_MAX) & (t_idx < t_cap)
    slot_per_row = jnp.where(
        t_ok, tb_slots[jnp.clip(t_idx, 0, t_cap - 1)], reserved_row)

    # sort by slot: dead rows carry the reserved slot (the maximum), so the
    # live rows are a prefix and the (rows, 512) gathers and the scatter
    # run on the smallest row bucket that holds the live count
    slot_s, src = jax.lax.sort((slot_per_row, order), num_keys=1)
    n_live = jnp.sum(slot_s != reserved_row).astype(jnp.int32)
    rc = _ROW_CHUNK
    row_buckets = sorted({max(4 * rc, -(-(p // 2) // rc) * rc),
                          -(-max(p, rc) // rc) * rc})
    rbranch = len(row_buckets) - 1 - sum(
        n_live <= b for b in row_buckets[:-1])

    def scatter_with(r_cap: int):
        def run(args):
            pool_sd, pool_w = args
            r = min(r_cap, p)
            sl = slot_s[:r]
            src_c = jnp.clip(src[:r], 0, p - 1)
            ok = (sl != reserved_row)[:, None]
            pool_sd = pool_sd.at[sl].add(jnp.where(ok, psd[src_c], 0.0))
            pool_w = pool_w.at[sl].add(jnp.where(ok, pw[src_c], 0.0))
            # the reserved row collects masked zeros only; keep it clean
            pool_sd = pool_sd.at[reserved_row].set(0.0)
            pool_w = pool_w.at[reserved_row].set(0.0)
            return pool_sd, pool_w
        return run

    pool_sd, pool_w = jax.lax.switch(
        rbranch, [scatter_with(b) for b in row_buckets],
        (state.pool_sd, state.pool_w))

    new_state = ActiveMapState(
        dir_keys=dir_keys, dir_slots=dir_slots, n_blocks=n_blocks,
        pool_sd=pool_sd, pool_w=pool_w, origin_blocks=state.origin_blocks,
        point_overflow=state.point_overflow + pt_overflow,
        sample_overflow=state.sample_overflow + samp_overflow,
        block_overflow=state.block_overflow + block_overflow,
        touched_overflow=state.touched_overflow + touched_overflow,
        tile_overflow=state.tile_overflow,
    )
    metrics = {
        "n_valid_samples": n_valid_samples,
        "n_touched_blocks": t_count,
        "n_new_blocks": n_new,
        "n_blocks": n_blocks,
    }
    return new_state, metrics


@functools.partial(jax.jit, static_argnames=("config", "reps"),
                   donate_argnums=(0,))
def insert_steps_scan(state: ActiveMapState, points: jnp.ndarray,
                      n_points: jnp.ndarray, position: jnp.ndarray,
                      config: MapConfig, reps: int):
    """Integrate the same (padded) cloud ``reps`` times in ONE dispatch —
    a ``lax.scan`` over the insert body, so the device time is measured
    without per-dispatch host overhead (bench.py).  Also the building
    block for burst ingestion (N queued scans, one launch).
    """
    def body(st, _):
        st, _m = insert_step_impl(st, points, n_points, position, config)
        return st, None

    state, _ = jax.lax.scan(body, state, None, length=reps)
    return state


@functools.partial(jax.jit, static_argnames=("config",), donate_argnums=(0,))
def insert_step_packed(state: ActiveMapState, qpoints: jnp.ndarray,
                       n_points: jnp.ndarray, position: jnp.ndarray,
                       config: MapConfig):
    """Packed-ingest insert (MapConfig.packed_ingest): ``qpoints`` is
    i16[N, 3] scanner-relative fixed-point with step ``sdf_res/8`` —
    world points = q * step + position, dequantized on device.  Halves the
    host->device transfer per scan."""
    step = jnp.float32(config.sdf_res / 8.0)
    pts = qpoints.astype(jnp.float32) * step + position[None, :]
    return insert_step_impl(state, pts, n_points, position, config)


def pack_points(points: np.ndarray, position: np.ndarray,
                sdf_res: float) -> np.ndarray:
    """Host-side packing for :func:`insert_step_packed` (numpy, exact
    round-half-even; points beyond +-204.8 m of the scanner clamp — they
    are outside the local map extent anyway)."""
    step = sdf_res / 8.0
    q = np.rint((points.astype(np.float64) -
                 np.asarray(position, np.float64)) / step)
    return np.clip(q, -32767, 32767).astype(np.int16)


@functools.partial(jax.jit, static_argnames=("config",), donate_argnums=(0,))
def insert_step(state: ActiveMapState, points: jnp.ndarray,
                n_points: jnp.ndarray, position: jnp.ndarray,
                config: MapConfig):
    """Integrate one (padded) point cloud into the active map.

    Args:
      state: ActiveMapState (donated — the pool is updated in place).
      points: f32[N, 3] world points, padded to config.max_points.
      n_points: i32[] number of valid rows in ``points``.
      position: f32[3] scanner position.
    Returns:
      (new_state, metrics dict).
    """
    return insert_step_impl(state, points, n_points, position, config)


def insert_step_impl(state: ActiveMapState, points, n_points, position,
                     config: MapConfig):
    """Un-jitted :func:`insert_step` body — callable inside ``shard_map``
    (the sharded path integrates into a scratch pool with this exact
    pipeline, parallel/sharded.py)."""
    if backend.choose(config).insert == "seg":
        return insert_step_sparse_seg(state, points, n_points, position,
                                      config)
    batch = compute_samples(points, n_points, position, state.origin_blocks,
                            config)
    batch = sort_samples(batch)
    return update_pool(state, batch, config)


def sparse_seg_entry_stream(points, n_points, position, origin_blocks,
                            config: MapConfig):
    """Sparse-insert front half: per-UNIQUE-VOXEL entries for one cloud.

    Sort -> segmented reduce -> compact (steps 1-3 of the
    ``insert_step_sparse_seg`` pipeline, see its docstring).  Returns
    ``(e_b, e_okey, e_sd_q, e_w, e_total, n_valid_samples, batch)`` where
    the entry arrays are (S,) with the live entries an ascending-block
    prefix ``[:e_total]`` and INT32_MAX keys beyond; ``e_sd_q`` is the
    per-voxel SUM of 16-bit-quantized signed distances carried exactly in
    f32 (scaled to metres by :func:`seg_entries_update`).

    Factored out so the sharded path can route the *entry stream* between
    shards (per-voxel entries are the natural halo unit of the sparse
    shape: ~16 B each, already consolidated) instead of integrating into a
    scratch pool and routing (512-lane) block rows.
    """
    batch = compute_samples(points, n_points, position, origin_blocks,
                            config)
    sb, sp = jax.lax.sort((batch.bkey, batch.payload), num_keys=2)
    s = sb.shape[0]
    valid = sb != INT32_MAX
    n_valid_samples = jnp.sum(valid).astype(jnp.int32)
    okey = (sp >> 16) & 0x1FF
    q = (sp << 16) >> 16                       # sign-extended sd16

    raw_flags = segops.boundary_flags((sb, okey))
    vflags = raw_flags & valid
    vals = jnp.stack([q.astype(jnp.float32), jnp.ones((s,), jnp.float32)])
    vals = vals * valid.astype(jnp.float32)[None, :]
    sums = segops.segmented_sum_scan(vflags, vals)          # (2, S)
    # a voxel ends where the NEXT sample starts a new key — including the
    # valid->invalid transition (raw flags, NOT the valid-masked ones, or
    # the last valid voxel of the stream would never emit an entry)
    is_end = jnp.concatenate([raw_flags[1:], jnp.ones((1,), jnp.bool_)])
    live_end = is_end & valid

    # entry compaction: ONE sort keyed on flagged position with the entry
    # fields riding as payload operands (same no-gather form as
    # sort_points_soa)
    iota = jnp.arange(s, dtype=jnp.int32)
    marked = jnp.where(live_end, iota, jnp.int32(s))
    ek = jnp.where(live_end, sb, INT32_MAX)
    eo = jnp.where(live_end, okey, 0)
    (_, e_b_full, e_okey_full, e_sd_full, e_w_full) = jax.lax.sort(
        (marked, ek, eo, sums[0], sums[1]), num_keys=1)
    e_total = jnp.sum(live_end).astype(jnp.int32)
    return (e_b_full, e_okey_full, e_sd_full, e_w_full, e_total,
            n_valid_samples, batch)


def seg_entries_update(state: ActiveMapState, pool_sd, pool_w, e_b, e_okey,
                       e_sd_q, e_w, config: MapConfig):
    """Sparse-insert back half: directory update + compacted pool scatter
    over a block-sorted entry stream (steps 4-5 of
    ``insert_step_sparse_seg``).

    ``e_b`` must be ascending with INT32_MAX marking invalid entries
    (validity is derived from the key, so a merged local+halo stream works
    unchanged); duplicate (block, offset) entries are legal — the
    scatter-add accumulates them (associative sums).  ``e_sd_q`` is in
    16-bit-quant units; the metre scaling happens here.
    """
    cb = config.block_capacity
    e_cap = e_b.shape[0]
    # each entry opens at most one block, so touched capacity beyond the
    # stream length is dead shape (and the stage slices below need
    # t_cap <= e_cap)
    t_cap = min(config.touched_capacity, e_cap)
    reserved_row = cb - 1
    evalid = e_b != INT32_MAX
    e_sd = e_sd_q * (config.sdf_trunc / SD_QUANT)

    # touched blocks over the entry stream (entries are sorted by
    # block key: the producing sorts are stable on equal keys)
    bflags = segops.boundary_flags(e_b) & evalid
    emarked = jnp.where(bflags, jnp.arange(e_cap, dtype=jnp.int32),
                        jnp.int32(e_cap))
    bpos = jax.lax.sort((emarked,), num_keys=1)[0]
    t_total = jnp.sum(bflags).astype(jnp.int32)
    t_count = jnp.minimum(t_total, t_cap)
    touched_overflow = jnp.maximum(t_total - t_cap, 0)
    starts = bpos[:t_cap]
    tvalid = jnp.arange(t_cap, dtype=jnp.int32) < t_count
    starts_c = jnp.minimum(starts, e_cap - 1)
    tb_keys = jnp.where(tvalid, e_b[starts_c], INT32_MAX)

    (dir_keys, dir_slots, n_blocks, tb_slots, n_new,
     block_overflow) = _directory_update(state, tb_keys, tvalid, config)

    # per-entry pool slot: scatter each touched block's slot to its
    # first entry, then a segmented forward carry — no big gather
    slot_at = jnp.full((e_cap,), reserved_row, jnp.int32)
    starts_put = jnp.where(tvalid, starts, jnp.int32(e_cap))
    slot_at = slot_at.at[starts_put].set(tb_slots, mode="drop")
    e_slot = segops.segment_broadcast_first(bflags, slot_at)

    ok = evalid & (e_slot != reserved_row) & (e_b != INT32_MAX)
    idx = jnp.where(ok, e_slot * 512 + e_okey, cb * 512)
    new_sd = pool_sd.reshape(-1).at[idx].add(
        jnp.where(ok, e_sd, 0.0), mode="drop").reshape(pool_sd.shape)
    new_w = pool_w.reshape(-1).at[idx].add(
        jnp.where(ok, e_w, 0.0), mode="drop").reshape(pool_w.shape)
    return (new_sd, new_w, dir_keys, dir_slots, n_blocks, t_count,
            n_new, block_overflow, touched_overflow)


def insert_step_sparse_seg(state: ActiveMapState, points, n_points,
                           position, config: MapConfig):
    """Insert by voxel-sorted segment reduction + compacted scatter.

    The pipeline reduces the ray samples to one entry per unique voxel
    first and scatters that compacted prefix last, so the scatter's index
    array scales with unique voxels instead of samples:

    1. one 2-key sort brings equal (block, offset) voxels contiguous
       (the payload's top 9 bits ARE the offset — measured the same cost
       as the 1-key sort);
    2. a segmented scan produces exact per-voxel (sd-sum, weight) at each
       segment end (quantized-int sums carried in f32 — exact, and no
       cumsum-difference cancellation);
    3. segment-end entries are compacted to a prefix with ONE sort keyed on
       flagged position, the entry fields riding as sort payloads;
    4. a ``lax.switch`` picks the smallest {S/4, 3S/8, S/2, S} entry bucket
       that fits the live count, so the per-entry stages (touched-block
       discovery, directory update, pool scatter) run at unique-voxel
       scale, not sample scale — and the S bucket keeps the path lossless
       (entries are positions in S, so e_total <= S always).

    Replaces the reference's per-sample hashmap upsert (octree.hpp:153-163).
    Selected by ``MapConfig.accumulate_impl='seg'`` (backend.choose).
    """
    (e_b_full, e_okey_full, e_sd_full, e_w_full, e_total,
     n_valid_samples, batch) = sparse_seg_entry_stream(
        points, n_points, position, state.origin_blocks, config)
    s = e_b_full.shape[0]

    def with_entry_cap(e_cap: int):
        def run(args):
            pool_sd, pool_w = args
            return seg_entries_update(
                state, pool_sd, pool_w, e_b_full[:e_cap],
                e_okey_full[:e_cap], e_sd_full[:e_cap], e_w_full[:e_cap],
                config)
        return run

    buckets = sorted({max(1024, s // 4), max(1024, 3 * s // 8),
                      max(1024, s // 2), s})
    branch = len(buckets) - 1 - sum(e_total <= b for b in buckets[:-1])
    (pool_sd, pool_w, dir_keys, dir_slots, n_blocks, t_count, n_new,
     block_overflow, touched_overflow) = jax.lax.switch(
        branch, [with_entry_cap(b) for b in buckets],
        (state.pool_sd, state.pool_w))

    new_state = ActiveMapState(
        dir_keys=dir_keys, dir_slots=dir_slots, n_blocks=n_blocks,
        pool_sd=pool_sd, pool_w=pool_w, origin_blocks=state.origin_blocks,
        point_overflow=state.point_overflow + batch.pt_overflow,
        sample_overflow=state.sample_overflow + batch.samp_overflow,
        block_overflow=state.block_overflow + block_overflow,
        touched_overflow=state.touched_overflow + touched_overflow,
        tile_overflow=state.tile_overflow,
    )
    metrics = {
        "n_valid_samples": n_valid_samples,
        "n_touched_blocks": t_count,
        "n_new_blocks": n_new,
        "n_blocks": n_blocks,
    }
    return new_state, metrics
