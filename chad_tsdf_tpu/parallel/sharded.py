"""Morton-range sharding over a device mesh — the scale-out axis.

The reference is strictly single-threaded and single-process (SURVEY §2.3);
this module is the capability this build adds: the map's block-key space
is partitioned into contiguous Morton ranges, one per device, so each shard
owns a compact spatial region (Morton order preserves locality).  This is
the mapping analog of sequence/context parallelism (SURVEY §5.7).

Design (v2 — block-row halo exchange):

* Points are data-parallel over devices.  The host feeds each device a
  Morton-contiguous slice of the scan (``morton_split``), so per-device
  normal neighbourhoods are as complete as the single-device pipeline's.
* Each shard integrates its local points with the FULL single-device
  pipeline — the same insert body as ``core.integrate.insert_step`` — into
  a small per-step *scratch pool*.  The scratch pool's occupied block rows
  are the per-shard partial sums for this batch, consolidated per distinct
  block.
* **Halo exchange**: scratch rows whose block key lies outside the shard's
  own Morton range are routed to their owner with one ``all_to_all``.
  Because the traffic unit is the consolidated (key, sd_row, w_row) block
  row — not the raw ray sample — a point-density hotspot costs traffic
  proportional to the few blocks it touches, not its millions of samples.
  The pool accumulators are associative sums, so routed rows merge into the
  owner's persistent pool exactly.
* **No data is ever dropped by routing.**  Rows beyond the per-(src,dst)
  ``halo_capacity`` simply stay in the local pool under their own key
  (counted in ``route_overflow``); ``core.submap.finalize_sharded`` merges
  duplicate blocks across shards exactly, so a deferred row only delays
  deduplication, never loses map content.

The same SPMD code runs on a mesh of GPUs (NCCL collectives) and on a
virtual CPU mesh (``--xla_force_host_platform_device_count``), which is how
the tests validate it without N cards.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MapConfig
from ..core import integrate
from ..core.state import INT32_MAX, RESERVED_ROWS, ActiveMapState, \
    create_state
from ..ops import morton


def key_bounds(n_shards: int, config: MapConfig) -> np.ndarray:
    """Static equal partition of the block-key space into owner ranges.

    bounds[d] .. bounds[d+1] is shard d's key range; bounds has n+1 entries.
    """
    space = 1 << (3 * config.block_bits)
    b = np.linspace(0, space, n_shards + 1).astype(np.int64)
    return b.astype(np.int32)


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def scratch_config(config: MapConfig) -> MapConfig:
    """Per-step scratch-pool config: same pipeline, small pool.

    ``touched_capacity`` already bounds the distinct blocks one insert can
    touch, so the scratch pool needs exactly that many usable rows plus the
    reserved tail."""
    scb = config.touched_capacity + RESERVED_ROWS
    return dataclasses.replace(config, block_capacity=scb)


def default_halo_capacity(n_shards: int, config: MapConfig) -> int:
    """Per-(src,dst) row capacity for the halo all_to_all.

    Remote rows are the halo band — blocks within one truncation band of
    an ownership boundary.  Measured on the KITTI-shaped stream with the
    occupancy-adaptive bounds ShardedTSDFMap uses: ~250 of ~5,500 touched
    rows/scan at N=8, i.e. ~36 rows per (src,dst) pair — the default
    reserves a thirty-second of the uniform ``touched_capacity`` share
    (128/pair at the KITTI config's N=8), ~4x that.  The send buffers
    are materialized at full capacity even when almost nothing is sent,
    so the default is sized to measured need, not worst case.  Rows
    beyond it defer locally
    (counted in ``route_overflow``, merged exactly at finalize — never
    dropped), so a too-small capacity costs deduplication latency, not
    data."""
    cap = config.touched_capacity // (32 * max(n_shards, 1))
    return max(64, -(-cap // 8) * 8)


def create_sharded_state(config: MapConfig, mesh: Mesh, origin_blocks=None,
                         axis: str = "shard"):
    """Per-shard ActiveMapState stacked on a leading device axis.

    Works in multi-controller runs too: when the mesh spans processes the
    leaves are built as global jax.Arrays from each process's (identical)
    host value."""
    n = mesh.devices.size
    base = create_state(config, origin_blocks)
    sharding = NamedSharding(mesh, P(axis))

    if jax.process_count() > 1:
        def mk(x):
            xn = np.asarray(x)
            shp = (n,) + xn.shape
            return jax.make_array_from_callback(
                shp, sharding,
                lambda idx, xn=xn, shp=shp:
                    np.broadcast_to(xn[None], shp)[idx])
        return jax.tree.map(mk, base)

    def stack(x):
        return jnp.broadcast_to(x[None], (n,) + x.shape)

    stacked = jax.tree.map(stack, base)
    return jax.device_put(stacked, sharding)


def _route_block_rows(keys, sd_rows, w_rows, bounds, me, capacity: int,
                      axis: str):
    """Exchange consolidated block rows so owners receive their halo.

    ``keys`` must be ascending (INT32_MAX = invalid) with ``sd_rows`` /
    ``w_rows`` the matching (R, 512) accumulator rows.  Rows owned by this
    shard — and rows beyond ``capacity`` in a remote segment — are KEPT
    locally (returned in ``local_keys``); only remote rows within capacity
    travel.  Returns (local_keys, recv_keys, recv_sd, recv_w, deferred)
    where ``deferred`` counts rows kept local only because the per-pair
    capacity was hit (they stay correct under their own key and are merged
    exactly at finalize)."""
    r = keys.shape[0]
    n = bounds.shape[0] - 1
    c = capacity

    seg = jnp.searchsorted(keys, bounds).astype(jnp.int32)   # (n+1,)
    starts, ends = seg[:-1], seg[1:]
    lens = ends - starts

    dst = jnp.arange(n, dtype=jnp.int32)
    valid = keys != INT32_MAX
    j = jnp.arange(c, dtype=jnp.int32)[None, :]
    idx = jnp.minimum(starts[:, None] + j, r - 1)
    send_ok = (j < lens[:, None]) & (dst[:, None] != me) & valid[idx]

    send_k = jnp.where(send_ok, keys[idx], INT32_MAX)
    send_sd = jnp.where(send_ok[:, :, None], sd_rows[idx], 0.0)
    send_w = jnp.where(send_ok[:, :, None], w_rows[idx], 0.0)

    recv_k = jax.lax.all_to_all(send_k, axis, 0, 0, tiled=False).reshape(-1)
    recv_sd = jax.lax.all_to_all(send_sd, axis, 0, 0,
                                 tiled=False).reshape(-1, sd_rows.shape[1])
    recv_w = jax.lax.all_to_all(send_w, axis, 0, 0,
                                tiled=False).reshape(-1, w_rows.shape[1])

    # rows that stay local: own-range rows + deferred (capacity-hit) rows
    row_dst = jnp.clip(
        jnp.searchsorted(bounds, keys, side="right").astype(jnp.int32) - 1,
        0, n - 1)
    pos_in_seg = jnp.arange(r, dtype=jnp.int32) - starts[row_dst]
    sent = valid & (row_dst != me) & (pos_in_seg < c)
    deferred = jnp.sum(valid & (row_dst != me) & (pos_in_seg >= c))
    local_keys = jnp.where(valid & ~sent, keys, INT32_MAX)
    return (local_keys, recv_k, recv_sd, recv_w,
            deferred.astype(jnp.int32), jnp.sum(sent).astype(jnp.int32))


def make_sharded_insert(config: MapConfig, mesh: Mesh,
                        halo_capacity: int | None = None,
                        axis: str = "shard",
                        force_generic: bool = False):
    """Build the jitted SPMD insert step.

    Returns ``(step, halo_capacity)`` where ``step(state_stack, points,
    n_points, position, bounds) -> (state_stack, metrics)``;
    ``state_stack`` leaves carry a leading device axis, ``points`` is
    (n_shards * max_points, 3) data-parallel (ideally aligned to the
    ownership ranges, see :func:`owner_split`), and ``bounds`` is the
    (n_shards + 1,) i32 Morton ownership partition — a TRACED argument,
    so per-submap occupancy-adaptive bounds (ShardedTSDFMap) reuse one
    compiled step.

    ``metrics['route_overflow']`` counts halo rows *deferred* to the local
    pool this step because the per-pair capacity was hit — deferred rows
    keep their key locally and are merged exactly by
    ``finalize_sharded``; no sample is ever lost to routing.
    """
    n_shards = mesh.devices.size
    if halo_capacity is None:
        halo_capacity = default_halo_capacity(n_shards, config)

    if n_shards == 1 and not force_generic:
        # One shard owns the whole key space: no halo can exist, so the
        # scratch pool, the routing all_to_all and the second merge pass
        # are pure overhead.  Integrate straight into the persistent pool
        # with the exact single-device pipeline — the sharded map at N=1
        # then IS the single-device map.
        def shard_fn_single(state, points, n_points, position, bounds):
            del bounds                     # one shard owns everything
            state = jax.tree.map(lambda x: x[0], state)
            points = points.reshape(-1, 3)
            if config.packed_ingest:
                step_q = jnp.float32(config.sdf_res / 8.0)
                points = points.astype(jnp.float32) * step_q + \
                    position[None, :]
            state, metrics = integrate.insert_step_impl(
                state, points, n_points[0], position, config)
            metrics["route_overflow"] = jnp.int32(0)
            metrics["route_sent"] = jnp.int32(0)
            metrics = {k: jax.lax.psum(v, axis) for k, v in metrics.items()}
            state = jax.tree.map(lambda x: x[None], state)
            return state, metrics

        pspec1 = jax.tree.map(lambda _: P(axis),
                              jax.eval_shape(lambda: create_state(config)))
        step1 = jax.jit(
            jax.shard_map(
                shard_fn_single, mesh=mesh,
                in_specs=(pspec1, P(axis), P(axis), P(), P()),
                out_specs=(pspec1, P()),
                # the insert body's lax.cond/switch branches return
                # mesh-invariant values (fresh pools, constants) beside
                # per-shard ones, which the varying-axes check rejects
                check_vma=False,
            ),
            donate_argnums=(0,))
        return step1, halo_capacity
    scfg = scratch_config(config)
    scb = scfg.block_capacity
    # the combined row stream (local + received) can touch at most this many
    # distinct blocks — give the merge plan exact headroom so it never drops
    merge_cap = config.touched_capacity + n_shards * halo_capacity
    merge_cfg = dataclasses.replace(config, touched_capacity=merge_cap)

    def shard_fn(state, points, n_points, position, bounds):
        state = jax.tree.map(lambda x: x[0], state)     # drop device axis
        points = points.reshape(-1, 3)
        if config.packed_ingest:
            # int16 scanner-relative fixed-point upload (see
            # core/integrate.insert_step_packed): halves host->device
            # bytes
            step_q = jnp.float32(config.sdf_res / 8.0)
            points = points.astype(jnp.float32) * step_q + position[None, :]
        me = jax.lax.axis_index(axis)

        # ---- 1. full single-device pipeline into a fresh scratch pool ----
        scratch = create_state(scfg, state.origin_blocks)
        scratch, sm = integrate.insert_step_impl(
            scratch, points, n_points[0], position, scfg)

        # ---- 2-4. extract + route + merge, bucketed on the LIVE row count
        # The scratch directory is sorted with an INT32_MAX tail, so its
        # live entries are a prefix: the (rows, 512) gathers, the routing
        # send buffers and the merge stream all shrink to the smallest
        # bucket holding every shard's live count (a typical KITTI-shaped
        # step touches ~4k of the 32k-row worst case).  The bucket index is
        # pmax-agreed across shards so each branch's all_to_all is executed
        # uniformly by the whole mesh.
        n_live_max = jax.lax.pmax(scratch.n_blocks, axis)
        row_buckets = sorted({min(scb, max(1024, scb // 8)),
                              min(scb, max(1024, scb // 4)),
                              min(scb, max(1024, scb // 2)), scb})

        def step_with_rows(b):
            def run(state):
                keys = scratch.dir_keys[:b]              # ascending prefix
                slots = scratch.dir_slots[:b]
                sd_rows = scratch.pool_sd[slots]
                w_rows = scratch.pool_w[slots]

                local_k, recv_k, recv_sd, recv_w, deferred, sent = \
                    _route_block_rows(keys, sd_rows, w_rows, bounds, me,
                                      halo_capacity, axis)

                pkeys = jnp.concatenate([local_k, recv_k])
                psd = jnp.concatenate([sd_rows, recv_sd])
                pw = jnp.concatenate([w_rows, recv_w])
                state, metrics = integrate.update_pool_rows(
                    state, pkeys, psd, pw, sm["n_valid_samples"],
                    scratch.sample_overflow, scratch.point_overflow,
                    merge_cfg)
                metrics["route_overflow"] = deferred
                # halo rows actually exchanged — x 2 KiB x 2 planes is the
                # per-step all_to_all payload
                metrics["route_sent"] = sent
                return state, metrics
            return run

        branch = len(row_buckets) - 1 - sum(
            n_live_max <= b for b in row_buckets[:-1])
        state, metrics = jax.lax.switch(
            branch, [step_with_rows(b) for b in row_buckets], state)
        # scratch-level overflows are real capacity events — carry them over
        state = dataclasses.replace(
            state,
            block_overflow=state.block_overflow + scratch.block_overflow,
            touched_overflow=(state.touched_overflow +
                              scratch.touched_overflow))

        metrics = {k: jax.lax.psum(v, axis) for k, v in metrics.items()}
        state = jax.tree.map(lambda x: x[None], state)  # re-add device axis
        return state, metrics

    pspec = jax.tree.map(lambda _: P(axis),
                         jax.eval_shape(lambda: create_state(config)))
    step = jax.jit(
        jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(pspec, P(axis), P(axis), P(), P()),
            out_specs=(pspec, P()),
            # see the N=1 step: cond/switch branches mix mesh-invariant
            # and per-shard values
            check_vma=False,
        ),
        donate_argnums=(0,))
    return step, halo_capacity


def make_sharded_carve(config: MapConfig, mesh: Mesh, axis: str = "shard"):
    """Jitted SPMD space-carving step (see core/carve.py for semantics).

    The FULL scan is replicated to every shard (``P()`` input spec); each
    shard runs the single-device carve body against its own directory.
    The erosion-only rule (lookup, never allocate) makes replication
    correct by construction: a shard applies exactly the free-space
    evidence that lands in blocks it holds and drops the rest, so across
    the mesh every sample is applied at most once per holder — no routing
    pass needed.  Edge case, documented: a block held twice (its owner AND
    a shard that deferred it under ``route_overflow``) receives the carve
    evidence twice until the finalize-time exact merge; route_overflow is
    zero in all measured runs and carving is approximate evidence, so this
    is accepted rather than routed around.

    Returns ``step(state_stack, points, n_points, position) ->
    (state_stack, metrics)`` where ``points`` is the full (padded) scan —
    f32[(Np, 3)] or, under ``config.packed_ingest``, the same i16
    fixed-point array the insert step ships.
    """
    from ..core import carve as carve_mod

    def shard_fn(state, points, n_points, position):
        state = jax.tree.map(lambda x: x[0], state)
        if config.packed_ingest:
            step_q = jnp.float32(config.sdf_res / 8.0)
            points = points.astype(jnp.float32) * step_q + position[None, :]
        state, metrics = carve_mod.carve_step_impl(
            state, points, n_points, position, config)
        # every shard sees the identical replicated sample stream, so the
        # per-shard (hits + dropped) total is replicated too; the global
        # dropped count is that total minus ALL shards' hits (a sample is
        # only truly dropped when no shard holds its block)
        n_valid = metrics["n_carve_samples"] + metrics["n_carve_dropped"]
        metrics = {k: jax.lax.psum(v, axis) for k, v in metrics.items()}
        n_shards = mesh.devices.size
        metrics["n_carve_dropped"] = (
            jax.lax.psum(n_valid, axis) // n_shards
            - metrics["n_carve_samples"])
        state = jax.tree.map(lambda x: x[None], state)
        return state, metrics

    pspec = jax.tree.map(lambda _: P(axis),
                         jax.eval_shape(lambda: create_state(config)))
    return jax.jit(
        jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(pspec, P(), P(), P()),
            out_specs=(pspec, P()),
            check_vma=False,
        ),
        donate_argnums=(0,))


def point_block_keys(points: np.ndarray, origin_blocks: np.ndarray,
                     config: MapConfig) -> np.ndarray:
    """Host-side local block key per point — the exact mapping of
    core.integrate.point_keys_soa (out-of-extent points clamp; they are
    counted as point_overflow by the step itself)."""
    vox = np.floor(points.astype(np.float64) /
                   config.sdf_res).astype(np.int64)
    extent = config.blocks_per_axis * 8
    loc = np.clip(vox - np.asarray(origin_blocks, np.int64) * 8, 0,
                  extent - 1)
    blk = (loc >> 3).astype(np.int32)
    return np.asarray(morton.encode_block(blk[:, 0], blk[:, 1], blk[:, 2]))


def adaptive_bounds(points: np.ndarray, origin_blocks, n_shards: int,
                    config: MapConfig) -> np.ndarray:
    """Occupancy-adaptive Morton ownership partition: cut the OBSERVED
    block-key distribution into equal-count ranges.

    The static uniform partition (:func:`key_bounds`) slices the whole
    2^30 key space evenly, but a real scan occupies a tiny fraction of
    it, so nearly all content lands in one or two static ranges — the
    measured remote fraction of the KITTI workload under static bounds
    was 43-98% (scripts/sharded_overhead_bench.py).  Quantile bounds from
    the first scan of a submap make ownership match the data: the halo
    shrinks to the truncation band around the n-1 cut keys."""
    keys = np.sort(point_block_keys(points, origin_blocks, config))
    if keys.size == 0:
        return key_bounds(n_shards, config)
    cuts = keys[np.minimum((np.arange(1, n_shards) * keys.size) //
                           n_shards, keys.size - 1)]
    space = 1 << (3 * config.block_bits)
    b = np.concatenate([[0], cuts.astype(np.int64), [space]])
    return np.maximum.accumulate(b).astype(np.int32)


def owner_split(points: np.ndarray, bounds: np.ndarray,
                origin_blocks, config: MapConfig):
    """Split a scan by OWNERSHIP under ``bounds`` (and Morton-sort each
    chunk for compact normal neighbourhoods).  Unlike
    :func:`morton_split`'s equal-count cut, every point integrates on the
    shard that owns its block, so only the DDA truncation band crosses
    ownership boundaries — the halo the design intends.  Returns a list
    of (count_i, 3) arrays."""
    pts = np.asarray(points, np.float32)
    n_shards = bounds.shape[0] - 1
    if len(pts) == 0:
        return [pts[:0] for _ in range(n_shards)]
    keys = point_block_keys(pts, origin_blocks, config)
    owner = np.clip(np.searchsorted(bounds, keys, side="right") - 1,
                    0, n_shards - 1)
    vox = np.floor(pts.astype(np.float64) / config.sdf_res).astype(np.int64)
    codes = morton.np_encode63(vox)
    order = np.lexsort((codes, owner))
    pts_s, owner_s = pts[order], owner[order]
    starts = np.searchsorted(owner_s, np.arange(n_shards + 1))
    return [pts_s[starts[i]:starts[i + 1]] for i in range(n_shards)]


def rebalance_chunks(chunks: list, cap: int) -> list:
    """Cap each chunk at ``cap`` points, spilling the excess into chunks
    with spare room.  Spilled points integrate on a non-owner shard and
    their block rows travel back through the halo all_to_all (or defer
    locally) — correct by construction, so ownership skew can cost
    traffic but never data."""
    if all(len(c) <= cap for c in chunks):
        return chunks
    excess = [c[cap:] for c in chunks if len(c) > cap]
    chunks = [c[:cap] for c in chunks]
    pool = np.concatenate(excess)
    out = []
    k = 0
    for c in chunks:
        spare = cap - len(c)
        if spare > 0 and k < len(pool):
            take = pool[k:k + spare]
            c = np.concatenate([c, take])
            k += len(take)
        out.append(c)
    assert k == len(pool), "total points exceed n_shards * cap"
    return out


def morton_split(points: np.ndarray, n_shards: int, sdf_res: float):
    """Host-side Morton-contiguous split of a scan for the sharded insert.

    Sorts points by 63-bit world voxel Morton code and cuts the sorted
    order into ``n_shards`` equal-count contiguous chunks, so each shard's
    subset is spatially compact (complete normal neighbourhoods, minimal
    halo).  Returns a list of (count_i, 3) arrays, sum(count_i) == N.
    """
    pts = np.asarray(points, np.float32)
    if len(pts) == 0:
        return [pts[:0] for _ in range(n_shards)]
    vox = np.floor(pts.astype(np.float64) / sdf_res).astype(np.int64)
    codes = morton.np_encode63(vox)
    order = np.argsort(codes, kind="stable")
    return np.array_split(pts[order], n_shards)


def merge_states_host(states: list, config: MapConfig) -> ActiveMapState:
    """Merge per-shard active states into one single-device-equivalent
    state (host-side, exact: duplicate block keys sum their accumulator
    rows).  The bridge for topology-elastic checkpointing — a sharded map
    checkpoints as the merged state and can resume on any device count."""
    keys_l, sd_l, w_l = [], [], []
    for st in states:
        nb = int(st.n_blocks)
        slots = np.asarray(st.dir_slots)[:nb]
        keys_l.append(np.asarray(st.dir_keys)[:nb])
        sd_l.append(np.asarray(st.pool_sd)[slots])
        w_l.append(np.asarray(st.pool_w)[slots])
    keys = np.concatenate(keys_l) if keys_l else np.zeros(0, np.int32)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    sd = np.concatenate(sd_l)[order] if keys.size else \
        np.zeros((0, 512), np.float32)
    w = np.concatenate(w_l)[order] if keys.size else \
        np.zeros((0, 512), np.float32)
    if keys.size:
        starts = np.flatnonzero(
            np.concatenate([[True], keys[1:] != keys[:-1]]))
        ukeys = keys[starts]
        sd = np.add.reduceat(sd, starts, axis=0)
        w = np.add.reduceat(w, starts, axis=0)
    else:
        ukeys = keys

    cb = config.block_capacity
    usable = cb - RESERVED_ROWS
    u = ukeys.shape[0]
    if u > usable:
        raise ValueError(f"merged map has {u} blocks > usable {usable}; "
                         "raise block_capacity to merge this sharded state")
    out = create_state(config, np.asarray(states[0].origin_blocks))
    dir_keys = np.full(cb, INT32_MAX, np.int32)
    dir_keys[:u] = ukeys
    dir_slots = np.zeros(cb, np.int32)
    dir_slots[:u] = np.arange(u, dtype=np.int32)
    pool_sd = np.zeros((cb, 512), np.float32)
    pool_w = np.zeros((cb, 512), np.float32)
    pool_sd[:u] = sd
    pool_w[:u] = w

    def tot(name):
        return jnp.int32(sum(int(getattr(st, name)) for st in states))

    return dataclasses.replace(
        out, dir_keys=jnp.asarray(dir_keys), dir_slots=jnp.asarray(dir_slots),
        n_blocks=jnp.int32(u), pool_sd=jnp.asarray(pool_sd),
        pool_w=jnp.asarray(pool_w),
        point_overflow=tot("point_overflow"),
        sample_overflow=tot("sample_overflow"),
        block_overflow=tot("block_overflow"),
        touched_overflow=tot("touched_overflow"),
        tile_overflow=tot("tile_overflow"))


def shard_state_host(state: ActiveMapState, mesh: Mesh, config: MapConfig,
                     axis: str = "shard"):
    """Partition a single-device state onto a mesh by Morton key range —
    the inverse of :func:`merge_states_host` (resume-on-different-topology).
    """
    n = mesh.devices.size
    bounds = key_bounds(n, config)
    cb = config.block_capacity
    nb = int(state.n_blocks)
    keys = np.asarray(state.dir_keys)[:nb]
    slots = np.asarray(state.dir_slots)[:nb]
    sd = np.asarray(state.pool_sd)[slots]
    w = np.asarray(state.pool_w)[slots]

    leaves = {f: [] for f in ("dir_keys", "dir_slots", "n_blocks",
                              "pool_sd", "pool_w")}
    for d in range(n):
        sel = (keys >= bounds[d]) & (keys < bounds[d + 1])
        u = int(sel.sum())
        dk = np.full(cb, INT32_MAX, np.int32)
        dk[:u] = keys[sel]
        ds = np.zeros(cb, np.int32)
        ds[:u] = np.arange(u, dtype=np.int32)
        psd = np.zeros((cb, 512), np.float32)
        pw = np.zeros((cb, 512), np.float32)
        psd[:u] = sd[sel]
        pw[:u] = w[sel]
        leaves["dir_keys"].append(dk)
        leaves["dir_slots"].append(ds)
        leaves["n_blocks"].append(np.int32(u))
        leaves["pool_sd"].append(psd)
        leaves["pool_w"].append(pw)

    base = create_sharded_state(config, mesh, np.asarray(state.origin_blocks),
                                axis=axis)
    sharding = NamedSharding(mesh, P(axis))

    def put(name, stacked_np):
        return jax.device_put(jnp.asarray(stacked_np), sharding)

    counters = {}
    for name in ("point_overflow", "sample_overflow", "block_overflow",
                 "touched_overflow", "tile_overflow"):
        v = np.zeros(n, np.int32)
        v[0] = int(getattr(state, name))       # totals live on shard 0
        counters[name] = put(name, v)
    return dataclasses.replace(
        base,
        dir_keys=put("dir_keys", np.stack(leaves["dir_keys"])),
        dir_slots=put("dir_slots", np.stack(leaves["dir_slots"])),
        n_blocks=put("n_blocks", np.asarray(leaves["n_blocks"])),
        pool_sd=put("pool_sd", np.stack(leaves["pool_sd"])),
        pool_w=put("pool_w", np.stack(leaves["pool_w"])),
        **counters)


def gather_states(state_stack) -> list[ActiveMapState]:
    """Split a stacked sharded state into per-shard host-side states.

    Materializes EVERY leaf — including the full pool planes (2 x 256 MiB
    per shard at defaults).  Use only where the whole pool is genuinely
    needed (checkpointing); the finalize path takes
    :func:`gather_states_device` and fetches just the live clusters."""
    n = state_stack.dir_keys.shape[0]
    out = []
    for i in range(n):
        out.append(jax.tree.map(lambda x: np.asarray(x[i]), state_stack))
    return out


def gather_states_device(state_stack) -> list[ActiveMapState]:
    """Per-shard state VIEWS with device-array leaves — no host transfer;
    consumers (core.submap.finalize_sharded) fetch only what they need.

    Single-controller only: ``x[i]`` touches shards that are non-addressable
    on remote processes.  Multi-controller paths use the in-graph
    all_gather extraction below (start_finalize_sharded_global /
    gather_states_global)."""
    n = state_stack.dir_keys.shape[0]
    return [jax.tree.map(lambda x, i=i: x[i], state_stack)
            for i in range(n)]


# ---------------------------------------------------------------------------
# Multi-controller-safe extraction (SURVEY §5.8; VERDICT r4 task 2)
#
# In multi-controller JAX a process may only read (a) fully-replicated
# arrays and (b) its own addressable shards.  Rotation/save/checkpoint of a
# ShardedTSDFMap therefore runs the per-shard extraction IN-GRAPH over the
# mesh and all_gathers the (small) results to every device: each process
# reads identical replicated outputs and runs the identical deterministic
# host DAG build, so all processes hold the same submaps without any
# host-side communication.  The same code runs single-controller unchanged.
# ---------------------------------------------------------------------------

_GLOBAL_STEP_CACHE: dict = {}


def _mesh_key(mesh, axis: str):
    return (tuple(d.id for d in mesh.devices.flat), axis)


def _state_pspec(config: MapConfig, axis: str):
    return jax.tree.map(lambda _: P(axis),
                        jax.eval_shape(lambda: create_state(config)))


def _fin_counters_step(config: MapConfig, mesh, axis: str):
    """jit: state_stack -> (n, 10) i32 replicated.

    Per shard: [n_blocks, live clusters, point/sample/block/touched/tile
    overflow, origin_blocks x3] — ONE output so rotation costs ONE host
    readback.

    LAYOUT CONTRACT: columns 0-1 and 2-5 mirror core/submap.
    _rotation_counters (the single-device rotation readback) with tile
    overflow and origin appended; start_finalize_sharded_global and
    gather_states_global slice cnt[:, 2:6] / cnt[:, 7:10] by these
    indices — change all three together."""
    key = ("cnt", config, _mesh_key(mesh, axis))
    step = _GLOBAL_STEP_CACHE.get(key)
    if step is not None:
        return step
    cb = config.block_capacity

    def fn(stack):
        st = jax.tree.map(lambda x: x[0], stack)
        idx = jnp.arange(cb, dtype=jnp.int32)
        valid = idx < st.n_blocks
        idx_c = jnp.minimum(idx, jnp.maximum(st.n_blocks - 1, 0))
        w = st.pool_w[st.dir_slots[idx_c]].reshape(cb, 64, 8)
        ne = jnp.any((w > 0) & valid[:, None, None], -1)
        vals = jnp.concatenate([
            jnp.stack([st.n_blocks, jnp.sum(ne).astype(jnp.int32),
                       st.point_overflow, st.sample_overflow,
                       st.block_overflow, st.touched_overflow,
                       st.tile_overflow]),
            st.origin_blocks.astype(jnp.int32)])
        return jax.lax.all_gather(vals, axis)

    step = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(_state_pspec(config, axis),),
        out_specs=P(), check_vma=False))
    _GLOBAL_STEP_CACHE[key] = step
    return step


def _fin_extract_step(config: MapConfig, mesh, axis: str, n_pad: int,
                      cap: int):
    """jit: state_stack -> ((n, L) u32 bufs replicated,
    (n, n_pad) i32 dir keys replicated) with the uniform static
    (n_pad, cap) bucket."""
    from ..core import submap as submap_mod
    key = ("ext", config, _mesh_key(mesh, axis), n_pad, cap)
    step = _GLOBAL_STEP_CACHE.get(key)
    if step is not None:
        return step

    def fn(stack):
        st = jax.tree.map(lambda x: x[0], stack)
        buf = submap_mod._extract_clusters_compact(st, n_pad, cap,
                                                   config.sdf_trunc)
        keys = st.dir_keys[:n_pad]
        return (jax.lax.all_gather(buf, axis),
                jax.lax.all_gather(keys, axis))

    step = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(_state_pspec(config, axis),),
        out_specs=(P(), P()), check_vma=False))
    _GLOBAL_STEP_CACHE[key] = step
    return step


def _fin_dup_rows_step(config: MapConfig, mesh, axis: str, d_cap: int):
    """jit: (state_stack, dup_keys (d_cap,) i32) -> replicated
    ((n, d_cap, 512) sd, (n, d_cap, 512) w, (n, d_cap) found) — the raw
    accumulator rows of blocks duplicated across shards, for the exact
    pre-quantization merge."""
    key = ("dup", config, _mesh_key(mesh, axis), d_cap)
    step = _GLOBAL_STEP_CACHE.get(key)
    if step is not None:
        return step
    cb = config.block_capacity

    def fn(stack, dupk):
        st = jax.tree.map(lambda x: x[0], stack)
        pos = jnp.searchsorted(st.dir_keys, dupk).astype(jnp.int32)
        pos_c = jnp.minimum(pos, cb - 1)
        found = (st.dir_keys[pos_c] == dupk) & (dupk != INT32_MAX)
        slots = st.dir_slots[pos_c]
        sd = jnp.where(found[:, None], st.pool_sd[slots], 0.0)
        w = jnp.where(found[:, None], st.pool_w[slots], 0.0)
        return (jax.lax.all_gather(sd, axis),
                jax.lax.all_gather(w, axis),
                jax.lax.all_gather(found, axis))

    step = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(_state_pspec(config, axis), P()),
        out_specs=(P(), P(), P()), check_vma=False))
    _GLOBAL_STEP_CACHE[key] = step
    return step


class _ReplicatedRows:
    """Deferred host fetch of a replicated (n, ...) array, shared across
    row references so the transfer happens once."""

    def __init__(self, arr):
        self.arr = arr
        self._np = None

    def row(self, i):
        if self._np is None:
            self._np = np.asarray(self.arr)
        return self._np[i]


class _RowRef:
    """np.asarray-able reference to one row of a _ReplicatedRows."""

    def __init__(self, rows: _ReplicatedRows, i: int):
        self._rows = rows
        self._i = i

    def __array__(self, dtype=None, copy=None):
        out = self._rows.row(self._i)
        return out.astype(dtype) if dtype is not None else out

    def copy_to_host_async(self):
        try:
            self._rows.arr.copy_to_host_async()
        except Exception:   # pragma: no cover - no async backend
            pass


def _pow2(n: int) -> int:
    return max(1, 1 << (max(n, 1) - 1).bit_length())


@dataclasses.dataclass
class PendingShardedStub:
    """Zero-sync sharded rotation (mirrors core.submap.PendingSubmap's
    round-5 form): stashes the rotated-out ``state_stack`` and defers the
    ENTIRE ``start_finalize_sharded_global`` call — whose counter readback
    waits on every queued insert — to the next drain point.  Pins
    the per-shard pools in device memory until then, bounded by
    ``MapConfig.max_pending_finalize``."""
    state_stack: object
    mesh: object
    config: object
    positions: list
    anchor: object
    axis: str
    inner: object = None

    def _materialize(self):
        if self.inner is None:
            self.inner = start_finalize_sharded_global(
                self.state_stack, self.mesh, self.config, self.positions,
                anchor=self.anchor, axis=self.axis)
            self.state_stack = None        # release the pinned pools

    def start_copies(self) -> None:
        self._materialize()
        self.inner.start_copies()

    def finish(self, levels, config):
        self._materialize()
        return self.inner.finish(levels, config)


def start_finalize_sharded_global(state_stack, mesh, config: MapConfig,
                                  positions: list, anchor=None,
                                  axis: str = "shard"):
    """Multi-controller-safe (and single-controller-identical) deferred
    sharded finalize: in-graph per-shard compaction + all_gather, so every
    process reads the same replicated buffers and builds the same submap.
    Returns a core.submap.PendingShardedSubmap."""
    import warnings

    from ..core import submap as submap_mod
    from ..ops import morton as morton_ops

    cnt = np.asarray(_fin_counters_step(config, mesh, axis)(state_stack))
    origin = cnt[0, 7:10]
    nbs, counts = cnt[:, 0], cnt[:, 1]
    ovf_tot = {}
    for name, col in zip(("point_overflow", "sample_overflow",
                          "block_overflow", "touched_overflow"),
                         cnt[:, 2:6].T):
        if int(col.sum()) > 0:
            ovf_tot[name] = int(col.sum())
    if ovf_tot:
        warnings.warn(
            f"sharded map capacity overflow — dropped data: {ovf_tot}; "
            "raise the corresponding MapConfig capacities "
            "(block_capacity/touched_capacity/max_points) or shrink the "
            "scan extent", RuntimeWarning, stacklevel=3)

    live = [i for i in range(len(nbs)) if nbs[i] > 0 and counts[i] > 0]
    if not live:
        return submap_mod.PendingShardedSubmap(
            [], np.zeros(0, np.uint64), None, origin, list(positions),
            anchor)

    n_pad = _pow2(int(nbs.max()))
    cap = submap_mod.cap_bucket(int(counts.max()))
    bufs_g, keys_g = _fin_extract_step(config, mesh, axis, n_pad,
                                       cap)(state_stack)

    wb_dup = np.zeros(0, np.uint64)
    dup_clusters = None
    if len(live) > 1:
        # the directory snapshot is only needed for duplicate detection
        # across >= 2 live shards; fetching it at N=1 would be a wasted
        # device->host round trip per rotation
        keys_np = np.asarray(keys_g)
        all_keys = np.concatenate([keys_np[i, :nbs[i]] for i in live])
        uk, kcounts = np.unique(all_keys, return_counts=True)
        dup = uk[kcounts > 1]
        if dup.size:
            wb_dup = morton_ops.np_block_key_to_world63(
                dup, origin, config.block_bits)
            d_cap = _pow2(int(dup.size))
            dupk = np.full(d_cap, INT32_MAX, np.int32)
            dupk[:dup.size] = dup
            sd_g, w_g, found_g = _fin_dup_rows_step(
                config, mesh, axis, d_cap)(state_stack, dupk)
            sd_sum = np.asarray(sd_g).sum(axis=0)[:dup.size]
            w_sum = np.asarray(w_g).sum(axis=0)[:dup.size]
            dup_clusters = submap_mod._quantize_pack_rows(
                wb_dup, sd_sum, w_sum, config)

    rows = _ReplicatedRows(bufs_g)
    shards = [(_RowRef(rows, i), n_pad, cap, int(counts[i])) for i in live]
    return submap_mod.PendingShardedSubmap(
        shards, wb_dup, dup_clusters, origin, list(positions), anchor)


def _ckpt_rows_step(config: MapConfig, mesh, axis: str, knb: int):
    """jit: state_stack -> replicated ((n, knb) keys, (n, knb, 512) sd,
    (n, knb, 512) w) — each shard's occupied pool rows in directory
    order, for topology-elastic checkpointing without full-pool gathers."""
    key = ("ckpt", config, _mesh_key(mesh, axis), knb)
    step = _GLOBAL_STEP_CACHE.get(key)
    if step is not None:
        return step

    def fn(stack):
        st = jax.tree.map(lambda x: x[0], stack)
        keys = st.dir_keys[:knb]
        slots = st.dir_slots[:knb]
        return (jax.lax.all_gather(keys, axis),
                jax.lax.all_gather(st.pool_sd[slots], axis),
                jax.lax.all_gather(st.pool_w[slots], axis))

    step = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(_state_pspec(config, axis),),
        out_specs=(P(), P(), P()), check_vma=False))
    _GLOBAL_STEP_CACHE[key] = step
    return step


def gather_states_global(state_stack, mesh, config: MapConfig,
                         axis: str = "shard") -> list:
    """Host-side per-shard states (occupied rows only), built from
    replicated in-graph gathers — the multi-controller-safe (and
    transfer-frugal) replacement for ``gather_states`` in
    checkpointing.  Results feed :func:`merge_states_host` unchanged."""
    import types

    cnt = np.asarray(_fin_counters_step(config, mesh, axis)(state_stack))
    origin = cnt[0, 7:10]
    nbs = cnt[:, 0]
    knb = _pow2(int(max(nbs.max(), 1)))
    keys_g, sd_g, w_g = _ckpt_rows_step(config, mesh, axis,
                                        knb)(state_stack)
    keys_np, sd_np, w_np = (np.asarray(keys_g), np.asarray(sd_g),
                            np.asarray(w_g))
    out = []
    for i in range(len(nbs)):
        nb = int(nbs[i])
        out.append(types.SimpleNamespace(
            n_blocks=nb,
            dir_keys=keys_np[i],
            dir_slots=np.arange(knb, dtype=np.int32),
            pool_sd=sd_np[i],
            pool_w=w_np[i],
            origin_blocks=origin,
            point_overflow=int(cnt[i, 2]), sample_overflow=int(cnt[i, 3]),
            block_overflow=int(cnt[i, 4]), touched_overflow=int(cnt[i, 5]),
            tile_overflow=int(cnt[i, 6])))
    return out
