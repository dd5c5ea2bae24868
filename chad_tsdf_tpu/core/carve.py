"""Space carving — free-space evidence integrated along the observation rays.

The reference's roadmap lists "Space carving" as its last unbuilt item
(reference: README.md:60); nothing in the C++ implements it.  This module
builds it as a device array program, and deliberately as a *strict
extension of the reference's own update rule*: the batch integrator clamps
the projective signed distance to +-trunc (reference:
include/chad/detail/octree.hpp:156-159) but only ever traverses the
truncation band around each return (octree.hpp:92-96).  By that same rule,
a voxel between the scanner and the band start is an observation of
``sd = +trunc`` — extending the DDA span toward the scanner and
accumulating the clamped value is exactly what the reference integrator
would do if its traversal covered the full ray.  Carving is that
extension, made affordable:

* **strided**, not exhaustive: ``carve_stride`` voxels between consecutive
  free-space samples and ``carve_subsample`` between carved rays, so a 50 m
  LiDAR ray costs tens of samples instead of a thousand (consecutive scans
  jitter the sampling phase, so coverage fills in over a stream);
* **erosion-only**: free-space samples update voxels of ALREADY-ALLOCATED
  blocks and are dropped (counted) elsewhere — observed emptiness never
  grows the map, only the band does.  This keeps block-pool pressure
  identical with carving on or off;
* stops ``sdf_trunc`` short of the return, so a ray never dilutes its own
  truncation band.

Use case (reference README.md:12 "real-time ... large-scale maps"): dynamic
objects leave TSDF residue when they move away; free-space evidence from
later scans pulls those voxels' running mean (``pool_sd / pool_w``) back
toward ``+trunc`` until the zero crossing — and with it the mesh — is gone.
Known tradeoffs (documented, inherent):
* a glancing ray passing within ``trunc`` of a *valid* surface
  contributes +trunc evidence there too; lower ``carve_weight`` to soften
  carving relative to band observations;
* carving updates the ACTIVE map only — rotated-out submaps are immutable
  hash-consed DAGs (the submap model, reference submap.hpp:9-111), so a
  dynamic object must be observed-through within its submap's lifetime
  (``submap_distance`` of travel) to be erased; stale geometry in an
  already-finalized submap is out of carving's reach, as it is for every
  other mutation.

Pipeline (pure XLA — identical on CPU and GPU; mirrors
``insert_step_sparse_seg``'s sort -> segment-reduce -> compact shape):

1. per carve ray, ``carve_steps`` strided sample positions from the scanner
   outward (valid while ``t < range - trunc``), voxelized with the exact
   ``floor(p / res)`` rule of the insert path (morton.hpp:71);
2. one 2-key sort brings equal (block, offset) voxels together; the payload
   is constant (+trunc), so the segment reduction is a pure run-length
   count;
3. compacted entries look their block up in the sorted directory with a
   ``searchsorted`` (the carve analog of the reference's octree descent,
   octree.hpp:44-59 — but a lookup, never an allocation) and scatter-add
   ``(count * trunc * w_c, count * w_c)`` into the pool planes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import MapConfig
from ..ops import morton, segops
from .state import INT32_MAX, ActiveMapState


def carve_sample_keys(px, py, pz, n_points, position, origin_blocks,
                      config: MapConfig):
    """Voxel keys of the free-space samples for one (padded) cloud.

    Returns flat ``(bkey, okey)`` i32[carve_steps * ceil(N / sub)] with
    INT32_MAX marking invalid slots (padded points, samples beyond
    ``range - trunc``, samples outside the local extent).
    """
    sub = config.carve_subsample
    k = config.carve_steps
    pxs, pys, pzs = px[::sub], py[::sub], pz[::sub]
    ns = pxs.shape[0]
    idx = jnp.arange(ns, dtype=jnp.int32) * sub
    valid_pt = idx < n_points

    dx = pxs - position[0]
    dy = pys - position[1]
    dz = pzs - position[2]
    r = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    safe = jnp.maximum(r, jnp.float32(1e-12))
    ux, uy, uz = dx / safe, dy / safe, dz / safe

    step_m = jnp.float32(config.carve_stride * config.sdf_res)
    # sample centres at (i + 0.5) strides: never exactly on the scanner
    # voxel corner, and the first sample clears the scanner's own voxel
    t = (jnp.arange(k, dtype=jnp.float32)[:, None] + 0.5) * step_m  # (K, 1)
    limit = (r - jnp.float32(config.sdf_trunc))[None, :]            # (1, Ns)
    valid_s = (t < limit) & valid_pt[None, :]                       # (K, Ns)

    qx = position[0] + ux[None, :] * t
    qy = position[1] + uy[None, :] * t
    qz = position[2] + uz[None, :] * t

    # exact insert-path voxelization (morton.hpp:71 / point_keys_soa)
    extent = config.blocks_per_axis * 8
    origin_voxel = origin_blocks * 8
    inv = jnp.float32(1.0 / config.sdf_res)
    lx = jnp.floor(qx * inv).astype(jnp.int32) - origin_voxel[0]
    ly = jnp.floor(qy * inv).astype(jnp.int32) - origin_voxel[1]
    lz = jnp.floor(qz * inv).astype(jnp.int32) - origin_voxel[2]
    in_range = ((lx >= 0) & (lx < extent) & (ly >= 0) & (ly < extent) &
                (lz >= 0) & (lz < extent))
    valid = valid_s & in_range
    lx = jnp.clip(lx, 0, extent - 1)
    ly = jnp.clip(ly, 0, extent - 1)
    lz = jnp.clip(lz, 0, extent - 1)
    bkey = morton.encode_block(lx >> 3, ly >> 3, lz >> 3)
    okey = morton.encode_offset(lx & 7, ly & 7, lz & 7)
    bkey = jnp.where(valid, bkey, INT32_MAX)
    okey = jnp.where(valid, okey, INT32_MAX)
    return bkey.reshape(-1), okey.reshape(-1)


def carve_step_impl(state: ActiveMapState, points, n_points, position,
                    config: MapConfig):
    """Un-jitted carve body: accumulate free-space evidence into the pool.

    ``points`` is the same (padded) f32[N, 3] cloud the insert step took;
    only every ``carve_subsample``-th row spawns a carve ray.  Returns
    ``(new_state, metrics)`` with ``n_carve_samples`` (free-space samples
    that hit allocated blocks), ``n_carved_voxels`` (distinct voxels
    updated) and ``n_carve_dropped`` (samples in unallocated space —
    dropped by design, not data loss).
    """
    cb = config.block_capacity
    t_cap = config.touched_capacity
    reserved_row = cb - 1

    bkey, okey = carve_sample_keys(
        points[:, 0], points[:, 1], points[:, 2], n_points, position,
        state.origin_blocks, config)
    sb, so = jax.lax.sort((bkey, okey), num_keys=2)
    s = sb.shape[0]
    valid = sb != INT32_MAX

    flags = segops.boundary_flags((sb, so))
    vflags = flags & valid
    ones = valid.astype(jnp.float32)[None, :]
    counts = segops.segmented_sum_scan(vflags, ones)          # (1, S)
    is_end = jnp.concatenate([flags[1:], jnp.ones((1,), jnp.bool_)])
    live_end = is_end & valid

    # entry compaction: one sort keyed on flagged position, fields riding
    # as payloads (the same no-gather trick as insert_step_sparse_seg)
    iota = jnp.arange(s, dtype=jnp.int32)
    marked = jnp.where(live_end, iota, jnp.int32(s))
    ek = jnp.where(live_end, sb, INT32_MAX)
    eo = jnp.where(live_end, so, 0)
    _, e_b_full, e_o_full, e_c_full = jax.lax.sort(
        (marked, ek, eo, counts[0]), num_keys=1)
    e_total = jnp.sum(live_end).astype(jnp.int32)

    sd_per = jnp.float32(config.sdf_trunc * config.carve_weight)
    w_per = jnp.float32(config.carve_weight)

    def with_entry_cap(e_cap: int):
        def run(args):
            pool_sd, pool_w = args
            evalid = jnp.arange(e_cap, dtype=jnp.int32) < e_total
            e_b = e_b_full[:e_cap]
            e_o = e_o_full[:e_cap]
            e_c = e_c_full[:e_cap]

            # block segments over the (block-sorted) entry stream
            bflags = segops.boundary_flags(e_b) & evalid
            emarked = jnp.where(bflags,
                                jnp.arange(e_cap, dtype=jnp.int32),
                                jnp.int32(e_cap))
            bpos = jax.lax.sort((emarked,), num_keys=1)[0]
            t_total = jnp.sum(bflags).astype(jnp.int32)
            t_count = jnp.minimum(t_total, t_cap)
            starts = bpos[:t_cap]
            tvalid = jnp.arange(t_cap, dtype=jnp.int32) < t_count
            starts_c = jnp.minimum(starts, e_cap - 1)
            tb_keys = jnp.where(tvalid, e_b[starts_c], INT32_MAX)

            # LOOKUP ONLY — carving never allocates (erosion-only rule):
            # binary-search the sorted directory prefix; absent blocks get
            # the reserved row and their entries are dropped below
            pos = jnp.searchsorted(state.dir_keys, tb_keys).astype(jnp.int32)
            pos_c = jnp.minimum(pos, cb - 1)
            found = ((state.dir_keys[pos_c] == tb_keys) & tvalid &
                     (tb_keys != INT32_MAX))
            tb_slots = jnp.where(found, state.dir_slots[pos_c],
                                 reserved_row)

            slot_at = jnp.full((e_cap,), reserved_row, jnp.int32)
            starts_put = jnp.where(tvalid, starts, jnp.int32(e_cap))
            slot_at = slot_at.at[starts_put].set(tb_slots, mode="drop")
            e_slot = segops.segment_broadcast_first(bflags, slot_at)

            ok = evalid & (e_slot != reserved_row) & (e_b != INT32_MAX)
            idx = jnp.where(ok, e_slot * 512 + e_o, cb * 512)
            okf = ok.astype(jnp.float32)
            new_sd = pool_sd.reshape(-1).at[idx].add(
                e_c * sd_per * okf, mode="drop").reshape(pool_sd.shape)
            new_w = pool_w.reshape(-1).at[idx].add(
                e_c * w_per * okf, mode="drop").reshape(pool_w.shape)
            n_hit = jnp.sum(e_c * okf).astype(jnp.int32)
            n_vox = jnp.sum(ok).astype(jnp.int32)
            return new_sd, new_w, n_hit, n_vox
        return run

    buckets = sorted({min(s, max(1024, s // 8)), min(s, max(1024, s // 4)),
                      min(s, max(1024, s // 2)), s})
    branch = len(buckets) - 1 - sum(e_total <= b for b in buckets[:-1])
    pool_sd, pool_w, n_hit, n_vox = jax.lax.switch(
        branch, [with_entry_cap(b) for b in buckets],
        (state.pool_sd, state.pool_w))

    n_valid = jnp.sum(valid).astype(jnp.int32)
    new_state = ActiveMapState(
        dir_keys=state.dir_keys, dir_slots=state.dir_slots,
        n_blocks=state.n_blocks, pool_sd=pool_sd, pool_w=pool_w,
        origin_blocks=state.origin_blocks,
        point_overflow=state.point_overflow,
        sample_overflow=state.sample_overflow,
        block_overflow=state.block_overflow,
        touched_overflow=state.touched_overflow,
        tile_overflow=state.tile_overflow,
    )
    metrics = {
        "n_carve_samples": n_hit,
        "n_carved_voxels": n_vox,
        "n_carve_dropped": n_valid - n_hit,
    }
    return new_state, metrics


@functools.partial(jax.jit, static_argnames=("config",), donate_argnums=(0,))
def carve_step(state: ActiveMapState, points: jnp.ndarray,
               n_points: jnp.ndarray, position: jnp.ndarray,
               config: MapConfig):
    """Jitted :func:`carve_step_impl` (state donated, pool updated in
    place)."""
    return carve_step_impl(state, points, n_points, position, config)


@functools.partial(jax.jit, static_argnames=("config",), donate_argnums=(0,))
def carve_step_packed(state: ActiveMapState, qpoints: jnp.ndarray,
                      n_points: jnp.ndarray, position: jnp.ndarray,
                      config: MapConfig):
    """Packed-ingest carve: same i16 fixed-point cloud as
    ``insert_step_packed`` (no second upload of the scan)."""
    step = jnp.float32(config.sdf_res / 8.0)
    pts = qpoints.astype(jnp.float32) * step + position[None, :]
    return carve_step_impl(state, pts, n_points, position, config)
