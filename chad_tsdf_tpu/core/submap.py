"""Submap finalization: active block pool -> compressed dual DAG.

Replaces the reference's iterative post-order DFS over the active octree
(reference: include/chad/detail/submap.hpp:10-106) with a bottom-up
sort-group pipeline (SURVEY §7):

* device: per-voxel mean = sd_sum / weight (the reference's incremental
  weighted mean, octree.hpp:161-163, evaluated once), 8-bit quantization
  (cluster.hpp codec), dense (block, 64 clusters, 8 leaves) packing — all a
  reshape because the pool's intra-block offsets ARE the Morton order.
* host: world Morton codes per non-empty cluster, then 20 rounds of
  group-by-parent-prefix + hash-consed NodeLevel adds, producing the two
  parallel DAGs (TSDF + weight) exactly like submap.hpp:31-60.

Reference defect NOT replicated: the weight clamp uses min (intended), not
the always-255 ``std::max`` at submap.hpp:92-93.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MapConfig
from ..ops import codec, morton
from .dag import MAX_DEPTH, NodeLevels
from .state import ActiveMapState


@dataclasses.dataclass
class Submap:
    """Finalized submap: two DAG roots + trajectory (submap.hpp:108-110).

    ``levels``: the NodeLevels the roots index into when it is NOT the
    owning map's global DAG (e.g. a throwaway active-map snapshot consed
    into scratch levels so repeated save()/extract_mesh() on a live map
    never pollutes the persistent pools).  None = the map's levels.

    ``anchor``: (4, 4) world pose of the submap frame recorded at creation
    (first scanner pose).  Voxel codes are stored in world frame; loop
    closure corrects a submap by re-anchoring: applying
    ``T_corrected @ inv(anchor)`` to its voxel positions at mesh/query time
    (see TSDFMap.optimize_loop_closures).  None = identity (uncorrected).
    """
    root_addr_tsdf: int
    root_addr_weight: int
    positions: list
    n_clusters: int = 0
    n_voxels: int = 0
    levels: object = None
    anchor: object = None
    corrected: object = None   # (4,4) np pose set by loop-closure optimize


@functools.partial(jax.jit, static_argnames=("n_pad", "sdf_trunc"))
def _extract_blocks(state: ActiveMapState, n_pad: int, sdf_trunc: float):
    """Device-side finalize prep: gather allocated blocks in key order and
    quantize.  Returns (keys i32[n_pad], tsdf u8[n_pad,64,8],
    weight u8[n_pad,64,8], nonempty bool[n_pad,64])."""
    idx = jnp.arange(n_pad, dtype=jnp.int32)
    valid = idx < state.n_blocks
    idx_c = jnp.minimum(idx, jnp.maximum(state.n_blocks - 1, 0))
    keys = jnp.where(valid, state.dir_keys[idx_c], jnp.int32(2**31 - 1))
    slots = state.dir_slots[idx_c]
    sd_sum = state.pool_sd[slots]                        # (n_pad, 512)
    w = state.pool_w[slots]
    occupied = w > 0
    mean = sd_sum / jnp.maximum(w, 1.0)
    q_sd = jnp.where(occupied, codec.encode_sd(jnp, mean, sdf_trunc),
                     jnp.uint8(codec.EMPTY))
    q_w = jnp.where(occupied, codec.encode_weight(jnp, w),
                    jnp.uint8(codec.EMPTY))
    q_sd = jnp.where(valid[:, None], q_sd, jnp.uint8(codec.EMPTY))
    q_w = jnp.where(valid[:, None], q_w, jnp.uint8(codec.EMPTY))
    q_sd = q_sd.reshape(n_pad, 64, 8)
    q_w = q_w.reshape(n_pad, 64, 8)
    nonempty = jnp.any((occupied & valid[:, None]).reshape(n_pad, 64, 8), -1)
    return keys, q_sd, q_w, nonempty


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _count_nonempty_clusters(state: ActiveMapState, n_pad: int):
    """Number of (block, cluster) cells with any weight — sizes the
    compacted transfer buffer of :func:`_extract_clusters_compact`."""
    idx = jnp.arange(n_pad, dtype=jnp.int32)
    valid = idx < state.n_blocks
    idx_c = jnp.minimum(idx, jnp.maximum(state.n_blocks - 1, 0))
    slots = state.dir_slots[idx_c]
    w = state.pool_w[slots].reshape(n_pad, 64, 8)
    ne = jnp.any((w > 0) & valid[:, None, None], -1)
    return jnp.sum(ne).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n_pad", "cap", "sdf_trunc"))
def _extract_clusters_compact(state: ActiveMapState, n_pad: int, cap: int,
                              sdf_trunc: float):
    """Device-side finalize extract, compacted into ONE u32 buffer.

    Shipping the full quantized (n_pad, 512) planes (67 MB at 64k blocks)
    would move mostly empty clusters.  Instead: quantize, pack each
    8-leaf cluster into two u32 words, drop empty clusters via a
    cumsum-scatter compaction, and return one flat buffer
    ``[dir keys (n_pad) | 5 rows x cap]`` (rows: cluster id = dir_index*64
    + cluster_idx, tsdf lo/hi, weight lo/hi; pad id = 0xFFFFFFFF).
    ``cap`` must be >= the live cluster count (_count_nonempty_clusters).
    """
    keys, q_sd, q_w, nonempty = _extract_blocks(state, n_pad, sdf_trunc)

    def pack2(q):                                  # (n_pad, 64, 8) u8
        q = q.astype(jnp.uint32)
        lo = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | \
            (q[..., 3] << 24)
        hi = q[..., 4] | (q[..., 5] << 8) | (q[..., 6] << 16) | \
            (q[..., 7] << 24)
        return lo.reshape(-1), hi.reshape(-1)

    t_lo, t_hi = pack2(q_sd)
    w_lo, w_hi = pack2(q_w)
    flat_ne = nonempty.reshape(-1)
    ids = jnp.arange(n_pad * 64, dtype=jnp.uint32)
    pos = jnp.cumsum(flat_ne.astype(jnp.int32)) - 1
    pos = jnp.where(flat_ne & (pos < cap), pos, cap)   # empties -> spill row
    rows = jnp.stack([ids, t_lo, t_hi, w_lo, w_hi])    # (5, n_pad*64)
    out = jnp.full((5, cap + 1), 0xFFFFFFFF, jnp.uint32)
    out = out.at[:, pos].set(rows, mode="drop")[:, :cap]
    keys_u32 = keys.astype(jnp.uint32).reshape(1, -1)
    return jnp.concatenate([keys_u32.reshape(-1), out.reshape(-1)])


def _unpack_cluster_buf(buf: np.ndarray, n_pad: int, cap: int, count: int,
                        origin: np.ndarray, config: MapConfig):
    """Host side of cluster extraction: the compacted u32 buffer from
    :func:`_extract_clusters_compact` -> sorted unique (cluster codes u64,
    tsdf words u64, weight words u64, n_voxels)."""
    keys = buf[:n_pad].astype(np.int32)
    body = buf[n_pad:].reshape(5, cap)[:, :count]
    ids = body[0].astype(np.int64)
    blk = (ids >> 6).astype(np.int64)
    cidx = (ids & 63).astype(np.uint64)

    # world 54-bit block codes -> 60-bit cluster codes
    wb = morton.np_block_key_to_world63(keys[blk], origin, config.block_bits)
    codes = (wb << np.uint64(6)) | cidx
    words_t = body[1].astype(np.uint64) | (body[2].astype(np.uint64) << 32)
    words_w = body[3].astype(np.uint64) | (body[4].astype(np.uint64) << 32)
    shifts = (np.uint64(8) * np.arange(8, dtype=np.uint64))[None, :]
    n_vox = int((((words_t[:, None] >> shifts) & np.uint64(0xFF))
                 != np.uint64(codec.EMPTY)).sum())

    order = np.argsort(codes, kind="stable")
    return codes[order], words_t[order], words_w[order], n_vox


def extract_clusters(state: ActiveMapState, config: MapConfig):
    """Device quantization + compaction + host unpack: active map ->
    sorted, unique (cluster_codes u64, words_tsdf u64, words_weight u64,
    n_voxels).  One scalar readback (live-cluster count) + one bulk
    transfer of ~20 bytes per live cluster."""
    n_blocks = int(state.n_blocks)
    if n_blocks == 0:
        z = np.zeros(0, np.uint64)
        return z, z.copy(), z.copy(), 0
    n_pad = max(1, 1 << (n_blocks - 1).bit_length())
    count = int(_count_nonempty_clusters(state, n_pad))
    if count == 0:
        z = np.zeros(0, np.uint64)
        return z, z.copy(), z.copy(), 0
    cap = cap_bucket(count)
    buf = np.asarray(_extract_clusters_compact(state, n_pad, cap,
                                               config.sdf_trunc))
    return _unpack_cluster_buf(buf, n_pad, cap, count,
                               np.asarray(state.origin_blocks), config)


def build_submap(levels: NodeLevels, codes, words_t, words_w, positions,
                 n_voxels: int = 0) -> Submap:
    """Bottom-up dual-DAG build from sorted unique leaf clusters
    (submap.hpp:31-60 in sort-group form); hash-conses into ``levels``."""
    if codes.shape[0] == 0:
        root = _add_empty_chain(levels)
        return Submap(root, root, list(positions), 0, 0)
    n_clusters = codes.shape[0]
    addr_t = levels.leaf_clusters.add_batch(words_t)
    addr_w = levels.leaf_clusters.add_batch(words_w)
    for depth in range(MAX_DEPTH - 1, -1, -1):
        parent = codes >> np.uint64(3)
        child_i = (codes & np.uint64(7)).astype(np.int64)
        starts = np.concatenate([[True], parent[1:] != parent[:-1]])
        group = np.cumsum(starts) - 1
        g = int(group[-1]) + 1 if group.size else 0
        kids_t = np.zeros((g, 8), np.uint32)
        kids_w = np.zeros((g, 8), np.uint32)
        kids_t[group, child_i] = addr_t
        kids_w[group, child_i] = addr_w
        addr_t = levels.nodes[depth].add_batch(kids_t)
        addr_w = levels.nodes[depth].add_batch(kids_w)
        codes = parent[starts]
    assert codes.size == 1 and int(codes[0]) == 0
    return Submap(int(addr_t[0]), int(addr_w[0]), list(positions),
                  n_clusters=n_clusters, n_voxels=n_voxels)


def finalize(state: ActiveMapState, levels: NodeLevels, config: MapConfig,
             positions: list) -> Submap:
    """Finalize the active map into a Submap, hash-consing into ``levels``."""
    from .state import warn_on_overflow
    warn_on_overflow(state)
    codes, words_t, words_w, n_vox = extract_clusters(state, config)
    return build_submap(levels, codes, words_t, words_w, positions, n_vox)


# ---------------------------------------------------------------------------
# Deferred (stream-friendly) finalization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PendingSubmap:
    """A rotated-out active map awaiting host materialization.

    Mid-stream submap rotation must not stall the insert pipeline: the host
    link moves ~23 MB/s with ~25 ms per round trip, so a synchronous
    finalize (10-40 MB cluster transfer + host DAG build) costs 1-2 s per
    rotation — the dominant term of streaming latency (measured, round 4).
    Round 5 removed the last rotation-time sync as well: even the combined
    counter READBACK stalls ~250 ms mid-stream, because its value depends
    on every queued insert, so fetching it drains the whole dispatch
    pipeline (measured: 2 rotations cost 490 ms of an 890 ms 11-scan
    stream).  ``start_finalize`` now just STASHES the rotated-out device
    state in this stub and returns — zero host syncs, zero device work on
    the stream; the counter readback, right-sized compaction and transfer
    all happen off-stream at the next drain (save/stats/checkpoint — or
    when ``MapConfig.max_pending_finalize`` stubs pile up).  Cost: the
    stub pins the full pool (2 x block_capacity x 512 f32) in device
    memory until then, bounded by ``max_pending_finalize``.
    """
    buf: object                # device u32 buffer (None for an empty map)
    n_pad: int
    cap: int
    count: int
    origin_blocks: np.ndarray | None
    positions: list
    anchor: object = None
    raw_state: object = None   # rotated-out ActiveMapState, still on device
    config: object = None      # MapConfig (needed to materialize off-stream)

    def _materialize_device(self) -> None:
        """Counter readback + right-sized device compaction (deferred off
        the stream); releases the pinned raw state."""
        if self.raw_state is None:
            return
        import warnings
        state, config = self.raw_state, self.config
        vals = np.asarray(_rotation_counters(state, config.block_capacity))
        n_blocks, count = int(vals[0]), int(vals[1])
        ovf = {k: int(v) for k, v in zip(
            ("point_overflow", "sample_overflow", "block_overflow",
             "touched_overflow"), vals[2:]) if int(v) > 0}
        if ovf:
            warnings.warn(
                f"map capacity overflow — dropped data: {ovf}; raise the "
                "corresponding MapConfig capacities (block_capacity/"
                "touched_capacity/max_points) or shrink the scan extent",
                RuntimeWarning, stacklevel=4)
        self.origin_blocks = np.asarray(state.origin_blocks)
        if n_blocks == 0 or count == 0:
            self.buf, self.count = None, 0
        else:
            self.n_pad = max(1, 1 << (n_blocks - 1).bit_length())
            self.cap = cap_bucket(count)
            self.count = count
            self.buf = _extract_clusters_compact(state, self.n_pad,
                                                 self.cap, config.sdf_trunc)
        self.raw_state = None          # release the pinned pool

    def start_copies(self) -> None:
        self._materialize_device()
        if self.buf is not None:
            try:
                self.buf.copy_to_host_async()
            except Exception:   # pragma: no cover - no async backend
                pass

    def finish(self, levels: NodeLevels, config: MapConfig) -> Submap:
        self._materialize_device()
        return finish_finalize(self, levels, config)


def cap_bucket(n: int) -> int:
    """Smallest {2^k, 1.5*2^k} >= n: finer than pow2 rounding so the
    cluster transfer ships <= 33% padding instead of <= 100%."""
    p = 1 << max(7, (max(n, 1) - 1).bit_length())
    if 3 * p // 4 >= n:
        return 3 * p // 4
    return p


@functools.partial(jax.jit, static_argnames=("cb",))
def _rotation_counters(state: ActiveMapState, cb: int):
    """Everything the host needs at rotation, in ONE transfer:
    [n_blocks, live clusters, point/sample/block/touched overflow]."""
    idx = jnp.arange(cb, dtype=jnp.int32)
    valid = idx < state.n_blocks
    idx_c = jnp.minimum(idx, jnp.maximum(state.n_blocks - 1, 0))
    slots = state.dir_slots[idx_c]
    w = state.pool_w[slots].reshape(cb, 64, 8)
    ne = jnp.any((w > 0) & valid[:, None, None], -1)
    count = jnp.sum(ne).astype(jnp.int32)
    return jnp.stack([state.n_blocks, count, state.point_overflow,
                      state.sample_overflow, state.block_overflow,
                      state.touched_overflow])


def start_finalize(state: ActiveMapState, config: MapConfig,
                   positions: list, anchor=None) -> PendingSubmap:
    """Begin finalizing the active map with ZERO host syncs.

    Just stashes the rotated-out device state (see PendingSubmap).  Even
    dispatching the compaction here would need the counter readback to
    size its static shapes, and that readback waits on every queued
    insert; nothing about the rotated-out state is time-critical, so ALL
    of it — readback, compaction, the 6-10 MB device->host copy —
    happens off-stream at the next drain."""
    return PendingSubmap(None, 0, 0, -1, None, list(positions), anchor,
                         raw_state=state, config=config)


def finish_finalize(pending: PendingSubmap, levels: NodeLevels,
                    config: MapConfig) -> Submap:
    """Materialize a PendingSubmap into the DAG (host)."""
    if pending.buf is None:
        sm = build_submap(levels, np.zeros(0, np.uint64),
                          np.zeros(0, np.uint64), np.zeros(0, np.uint64),
                          pending.positions, 0)
    else:
        buf = np.asarray(pending.buf)
        codes, words_t, words_w, n_vox = _unpack_cluster_buf(
            buf, pending.n_pad, pending.cap, pending.count,
            pending.origin_blocks, config)
        sm = build_submap(levels, codes, words_t, words_w,
                          pending.positions, n_vox)
    sm.anchor = pending.anchor
    return sm


def extract_raw_blocks(state, config: MapConfig):
    """Host-side pre-quantization block extract for the sharded merge:
    (world block codes u64[n], sd_sum f32[n, 512], w f32[n, 512])."""
    n_blocks = int(state.n_blocks)
    if n_blocks == 0:
        return (np.zeros(0, np.uint64), np.zeros((0, 512), np.float32),
                np.zeros((0, 512), np.float32))
    keys = np.asarray(state.dir_keys)[:n_blocks]
    slots = np.asarray(state.dir_slots)[:n_blocks]
    sd = np.asarray(state.pool_sd)[slots]
    w = np.asarray(state.pool_w)[slots]
    wb = morton.np_block_key_to_world63(keys, np.asarray(state.origin_blocks),
                                        config.block_bits)
    return wb, sd, w


def _quantize_pack_rows(codes: np.ndarray, sd: np.ndarray, w: np.ndarray,
                        config: MapConfig):
    """(world block codes u64[n], raw (sd_sum, weight) rows (n, 512)) ->
    sorted unique quantized clusters, merging duplicate block codes
    EXACTLY (accumulator rows sum before quantization, identically to a
    single pool that saw all samples).  Host-side; mirrors the device
    quantization of _extract_blocks."""
    order = np.argsort(codes, kind="stable")
    codes_s, sd_s, w_s = codes[order], sd[order], w[order]
    starts = np.flatnonzero(
        np.concatenate([[True], codes_s[1:] != codes_s[:-1]]))
    ucodes = codes_s[starts]
    sd_m = np.add.reduceat(sd_s, starts, axis=0)
    w_m = np.add.reduceat(w_s, starts, axis=0)

    occupied = w_m > 0
    mean = sd_m / np.maximum(w_m, 1.0)
    q_sd = np.where(occupied, codec.encode_sd(np, mean, config.sdf_trunc),
                    np.uint8(codec.EMPTY)).astype(np.uint8)
    q_w = np.where(occupied, codec.encode_weight(np, w_m),
                   np.uint8(codec.EMPTY)).astype(np.uint8)
    q_sd = q_sd.reshape(-1, 64, 8)
    q_w = q_w.reshape(-1, 64, 8)
    nonempty = occupied.reshape(-1, 64, 8).any(-1)

    cluster_codes = (ucodes[:, None] << np.uint64(6)) | \
        np.arange(64, dtype=np.uint64)[None, :]
    sel = nonempty.reshape(-1)
    ccodes = cluster_codes.reshape(-1)[sel]
    words_t = codec.pack_cluster_u64(np, q_sd.reshape(-1, 8)[sel])
    words_w = codec.pack_cluster_u64(np, q_w.reshape(-1, 8)[sel])
    return ccodes, words_t, words_w


def _count_voxels(words_t: np.ndarray) -> int:
    shifts = (np.uint64(8) * np.arange(8, dtype=np.uint64))[None, :]
    return int((((words_t[:, None] >> shifts) & np.uint64(0xFF))
                != np.uint64(codec.EMPTY)).sum())


@dataclasses.dataclass
class PendingShardedSubmap:
    """A rotated-out Morton-sharded active map awaiting materialization.

    The sharded analog of :class:`PendingSubmap` (VERDICT r4 task 3): the
    per-shard device compactions are dispatched at rotation; the cluster
    transfers and the host DAG build happen at the next drain point, so a
    sharded submap rotation no longer stalls the insert stream (measured
    1-2 s/rotation on the bench link when synchronous).

    ``shards``: per live shard (buf device u32, n_pad, cap, count).
    ``wb_dup``: world block codes owned by >1 shard (deferred halo rows) —
    their quantized clusters are dropped from every shard buffer at finish
    and replaced by ``dup_clusters``, pre-merged EXACTLY from the raw
    accumulator rows at start (identical to a single pool that saw all
    samples).
    """
    shards: list
    wb_dup: np.ndarray
    dup_clusters: tuple | None
    origin_blocks: np.ndarray
    positions: list
    anchor: object = None

    def start_copies(self) -> None:
        for buf, _, _, _ in self.shards:
            try:
                buf.copy_to_host_async()
            except Exception:   # pragma: no cover - no async backend
                pass

    def finish(self, levels: NodeLevels, config: MapConfig) -> Submap:
        return finish_finalize_sharded(self, levels, config)


def start_finalize_sharded(states: list, config: MapConfig,
                           positions: list,
                           anchor=None) -> PendingShardedSubmap:
    """Begin finalizing a sharded active map without draining the stream.

    Transfer-frugal (round 4): never gathers the full pool planes (2 x
    256 MiB per shard at defaults).  Per shard it reads one counter vector
    (n_blocks, live clusters, overflow counters — a single small
    transfer), dispatches the same quantized compacted cluster extraction
    the single-device finalize uses (~20 B per live cluster, transfer
    deferred), and — only when shards share a block key, i.e. halo rows
    were deferred by routing (``route_overflow`` > 0, typically never) —
    fetches those few blocks' raw accumulator rows and pre-merges them
    exactly.

    ``states`` may hold device or host arrays (gather_states_device /
    gather_states)."""
    import warnings
    cb = config.block_capacity
    per = [np.asarray(_rotation_counters(st, cb)) for st in states]
    ovf_tot = {}
    for vals in per:
        for k, v in zip(("point_overflow", "sample_overflow",
                         "block_overflow", "touched_overflow"), vals[2:]):
            if int(v) > 0:
                ovf_tot[k] = ovf_tot.get(k, 0) + int(v)
    if ovf_tot:
        warnings.warn(
            f"sharded map capacity overflow — dropped data: {ovf_tot}; "
            "raise the corresponding MapConfig capacities "
            "(block_capacity/touched_capacity/max_points) or shrink the "
            "scan extent", RuntimeWarning, stacklevel=3)

    origin = np.asarray(states[0].origin_blocks)
    # duplicate detection needs the directory snapshots — only possible
    # (and only fetched) with >1 shard
    wb_dup = np.zeros(0, np.uint64)
    dup_clusters = None
    shard_keys = [None] * len(states)
    if len(states) > 1:
        for i, (st, vals) in enumerate(zip(states, per)):
            nb = int(vals[0])
            shard_keys[i] = np.asarray(st.dir_keys[:nb]) if nb else \
                np.zeros(0, np.int32)
        all_keys = np.concatenate(shard_keys)
        uk, kcounts = np.unique(all_keys, return_counts=True)
        dup = uk[kcounts > 1]
        if dup.size:
            wb_dup = morton.np_block_key_to_world63(dup, origin,
                                                    config.block_bits)
            dup_codes_l, dup_sd_l, dup_w_l = [], [], []
            for st, vals, keys in zip(states, per, shard_keys):
                nb = int(vals[0])
                if nb == 0:
                    continue
                sel = np.nonzero(np.isin(keys, dup))[0]
                if sel.size == 0:
                    continue
                sl = np.asarray(st.dir_slots[:nb])[sel]
                dup_codes_l.append(morton.np_block_key_to_world63(
                    keys[sel], origin, config.block_bits))
                dup_sd_l.append(np.asarray(st.pool_sd[sl]))
                dup_w_l.append(np.asarray(st.pool_w[sl]))
            dup_clusters = _quantize_pack_rows(
                np.concatenate(dup_codes_l), np.concatenate(dup_sd_l),
                np.concatenate(dup_w_l), config)

    shards = []
    for st, vals in zip(states, per):
        nb, count = int(vals[0]), int(vals[1])
        if nb == 0 or count == 0:
            continue
        n_pad = max(1, 1 << (nb - 1).bit_length())
        cap = cap_bucket(count)
        buf = _extract_clusters_compact(st, n_pad, cap, config.sdf_trunc)
        shards.append((buf, n_pad, cap, count))
    return PendingShardedSubmap(shards, wb_dup, dup_clusters, origin,
                                list(positions), anchor)


def finish_finalize_sharded(pending: PendingShardedSubmap,
                            levels: NodeLevels,
                            config: MapConfig) -> Submap:
    """Materialize a PendingShardedSubmap into the DAG (host)."""
    codes_l, wt_l, ww_l = [], [], []
    for buf, n_pad, cap, count in pending.shards:
        b = np.asarray(buf)
        codes, wt, ww, _ = _unpack_cluster_buf(b, n_pad, cap, count,
                                               pending.origin_blocks,
                                               config)
        if pending.wb_dup.size:
            keep = ~np.isin((codes >> np.uint64(6)).astype(np.uint64),
                            pending.wb_dup)
            codes, wt, ww = codes[keep], wt[keep], ww[keep]
        codes_l.append(codes)
        wt_l.append(wt)
        ww_l.append(ww)
    if pending.dup_clusters is not None:
        ccodes, wt, ww = pending.dup_clusters
        codes_l.append(ccodes)
        wt_l.append(wt)
        ww_l.append(ww)
    if not codes_l:
        z = np.zeros(0, np.uint64)
        sm = build_submap(levels, z, z.copy(), z.copy(),
                          pending.positions, 0)
        sm.anchor = pending.anchor
        return sm
    codes = np.concatenate(codes_l)
    words_t = np.concatenate(wt_l)
    words_w = np.concatenate(ww_l)
    order = np.argsort(codes, kind="stable")
    codes, words_t, words_w = codes[order], words_t[order], words_w[order]
    sm = build_submap(levels, codes, words_t, words_w, pending.positions,
                      _count_voxels(words_t))
    sm.anchor = pending.anchor
    return sm


def finalize_sharded(states: list, levels: NodeLevels, config: MapConfig,
                     positions: list) -> Submap:
    """Finalize a Morton-sharded active map into a single Submap — the
    submap-merge step of SURVEY §5.8 (synchronous form;
    :func:`start_finalize_sharded` / :func:`finish_finalize_sharded` is
    the stream-friendly split)."""
    return finish_finalize_sharded(
        start_finalize_sharded(states, config, positions), levels, config)


def _add_empty_chain(levels: NodeLevels) -> int:
    addr = levels.leaf_clusters.add_batch(
        np.array([0xFFFFFFFFFFFFFFFF], np.uint64))
    for depth in range(MAX_DEPTH - 1, -1, -1):
        kids = np.zeros((1, 8), np.uint32)
        kids[0, 0] = addr[0]
        addr = levels.nodes[depth].add_batch(kids)
    return int(addr[0])
