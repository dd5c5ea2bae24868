"""Checkpoint / resume — absent from the reference, designed per SURVEY §5.4.

The reference never serializes its DAG; its only on-disk artifacts are the
final mesh and a debug .grid dump (reference: src/chad/detail/lvr2.cpp:170-200,
317-319) and there is no load path at all.  Here the full map state is
checkpointable:

* the DAG levels are flat arrays (uint32 node pools, uint64 cluster pool) —
  trivially serializable; the hash-consing dict indexes are rebuilt on load
  from the pools themselves,
* submaps are (root_tsdf, root_weight, trajectory) triples,
* the active (unfinalized) block pool is pulled from device and stored dense,
* the config is embedded as JSON so a checkpoint is self-describing.

This is also the elastic-recovery unit (SURVEY §5.3): finalized submaps are
content-addressed and idempotent to re-add, so after a chip/host loss only
the active scans since the last checkpoint need re-integration.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..config import MapConfig
from ..core import dag
from ..core.map import TSDFMap
from ..core.submap import Submap

FORMAT_VERSION = 2

# MapConfig fields that older checkpoints carry but that no longer exist:
# they selected kernels that were removed and do not change the map's
# contents, so loading drops them.  Any other unknown field still fails.
_REMOVED_CONFIG_FIELDS = frozenset(
    {"tile_nb", "sparse_tile_nb", "normals_impl", "sparse_impl",
     "sparse_points_per_block"})
# accumulate_impl values that named those kernels; they load as 'auto'
_REMOVED_ACCUMULATE_IMPLS = frozenset({"fused", "tile", "sample_tile",
                                       "pallas"})


def _active_state(m: TSDFMap):
    """The map's active state; a ShardedTSDFMap's shards are merged exactly
    on the host, so sharded checkpoints are topology-independent.

    The per-shard rows arrive via the in-graph all_gather extraction
    (occupied rows only, replicated to every process), so this works in
    multi-controller runs — every process computes the identical merged
    state — and never ships full 256 MiB pool planes."""
    stack = getattr(m, "state_stack", None)
    if stack is not None:
        from ..parallel.sharded import gather_states_global, \
            merge_states_host
        from ..parallel.sharded_map import _total_blocks
        if int(np.asarray(_total_blocks(stack))) == 0:
            return None
        states = gather_states_global(stack, m.mesh, m.config, m.axis)
        return merge_states_host(states, m.config)
    return m.state


def save_checkpoint(path: str, m: TSDFMap) -> None:
    m._drain_pending()          # materialize deferred rotations first
    arrays: dict[str, np.ndarray] = {}
    active = _active_state(m)
    meta: dict = {
        "format_version": FORMAT_VERSION,
        "config": dataclasses.asdict(m.config),
        "n_submaps": len(m.submaps),
        "submaps": [
            {"root_addr_tsdf": sm.root_addr_tsdf,
             "root_addr_weight": sm.root_addr_weight,
             "n_clusters": sm.n_clusters, "n_voxels": sm.n_voxels}
            for sm in m.submaps
        ],
        "has_active": active is not None,
        # round-trip the per-level dedup counters (they are the compression
        # metric; v1 checkpoints lost dupes_n on load)
        "level_counters": {
            "nodes": [[lv.uniques_n, lv.dupes_n] for lv in m.levels.nodes],
            "leaf_clusters": [m.levels.leaf_clusters.uniques_n,
                              m.levels.leaf_clusters.dupes_n],
        },
    }
    for d, lv in enumerate(m.levels.nodes):
        arrays[f"node_level_{d}"] = lv.raw.copy()
    arrays["leaf_clusters"] = m.levels.leaf_clusters.raw.copy()
    for i, sm in enumerate(m.submaps):
        arrays[f"submap_{i}_positions"] = np.asarray(sm.positions,
                                                    np.float32).reshape(-1, 3)
        if sm.anchor is not None:
            arrays[f"submap_{i}_anchor"] = np.asarray(sm.anchor, np.float64)
        if sm.corrected is not None:
            arrays[f"submap_{i}_corrected"] = np.asarray(sm.corrected,
                                                         np.float64)
    if active is not None:
        # occupied-only pool serialization: allocation is sequential
        # (core/integrate._directory_update assigns slot = n_blocks + rank),
        # so live rows are exactly pool[:n_blocks] — a dense-default 256 MiB
        # pool checkpoint shrinks to its occupied prefix
        nb = int(active.n_blocks)
        dir_keys = np.asarray(active.dir_keys)
        arrays["active_dir_keys"] = dir_keys[:nb]
        arrays["active_dir_slots"] = np.asarray(active.dir_slots)[:nb]
        arrays["active_pool_sd"] = np.asarray(active.pool_sd)[:nb]
        arrays["active_pool_w"] = np.asarray(active.pool_w)[:nb]
        arrays["active_origin"] = np.asarray(active.origin_blocks)
        arrays["active_counters"] = np.asarray([
            nb, int(active.point_overflow), int(active.sample_overflow),
            int(active.block_overflow), int(active.touched_overflow),
            int(active.tile_overflow)],
            np.int64)
        arrays["active_positions"] = np.asarray(m._positions,
                                                np.float32).reshape(-1, 3)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, mesh=None) -> TSDFMap:
    """Restore a map.  With ``mesh`` given, the active state is partitioned
    onto the mesh by Morton range and a ShardedTSDFMap is returned —
    checkpoints are topology-elastic (save on N shards, resume on M or on a
    single device)."""
    import jax.numpy as jnp
    from ..core.state import ActiveMapState

    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta["format_version"] not in (1, FORMAT_VERSION):
        raise ValueError(f"unsupported checkpoint version "
                         f"{meta['format_version']}")
    cfg_meta = {k: v for k, v in meta["config"].items()
                if k not in _REMOVED_CONFIG_FIELDS}
    if cfg_meta.get("accumulate_impl") in _REMOVED_ACCUMULATE_IMPLS:
        cfg_meta["accumulate_impl"] = "auto"
    config = MapConfig(**cfg_meta)
    m = TSDFMap(config=config)

    for d in range(dag.MAX_DEPTH):
        _restore_node_level(m.levels.nodes[d], z[f"node_level_{d}"])
    _restore_lc_level(m.levels.leaf_clusters, z["leaf_clusters"])
    lc = meta.get("level_counters")
    if lc is not None:   # exact dedup-counter round trip (v2)
        for lv, (u, dup) in zip(m.levels.nodes, lc["nodes"]):
            _set_counters(lv, int(u), int(dup))
        _set_counters(m.levels.leaf_clusters, int(lc["leaf_clusters"][0]),
                      int(lc["leaf_clusters"][1]))

    for i, sm_meta in enumerate(meta["submaps"]):
        pos = [p for p in z[f"submap_{i}_positions"]]
        sm = Submap(sm_meta["root_addr_tsdf"],
                    sm_meta["root_addr_weight"], pos,
                    sm_meta["n_clusters"], sm_meta["n_voxels"])
        if f"submap_{i}_anchor" in z:
            sm.anchor = np.asarray(z[f"submap_{i}_anchor"])
        if f"submap_{i}_corrected" in z:
            sm.corrected = np.asarray(z[f"submap_{i}_corrected"])
        m.submaps.append(sm)
    if meta["has_active"]:
        counters = [int(x) for x in z["active_counters"]]
        counters += [0] * (6 - len(counters))   # older checkpoints
        nb, po, so, bo, to, tlo = counters
        cb = config.block_capacity

        def pad_to(a, n, fill):
            a = np.asarray(a)
            if a.shape[0] >= n:
                return a
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[:a.shape[0]] = a
            return out

        INT32_MAX = np.int32(2**31 - 1)
        m.state = ActiveMapState(
            dir_keys=jnp.asarray(pad_to(z["active_dir_keys"], cb,
                                        INT32_MAX)),
            dir_slots=jnp.asarray(pad_to(z["active_dir_slots"], cb, 0)),
            n_blocks=jnp.int32(nb),
            pool_sd=jnp.asarray(pad_to(z["active_pool_sd"], cb, 0.0)),
            pool_w=jnp.asarray(pad_to(z["active_pool_w"], cb, 0.0)),
            origin_blocks=jnp.asarray(z["active_origin"]),
            point_overflow=jnp.int32(po), sample_overflow=jnp.int32(so),
            block_overflow=jnp.int32(bo), touched_overflow=jnp.int32(to),
            tile_overflow=jnp.int32(tlo),
        )
        m._positions = [p for p in z["active_positions"]]
    if mesh is None:
        return m
    from ..parallel.sharded import shard_state_host
    from ..parallel.sharded_map import ShardedTSDFMap
    sm = ShardedTSDFMap(config=config, mesh=mesh)
    sm.levels = m.levels
    sm.submaps = m.submaps
    sm._positions = m._positions
    if m.state is not None:
        sm.state_stack = shard_state_host(m.state, mesh, config)
        sm._origin = np.asarray(m.state.origin_blocks)
        # shard_state_host partitions by the static uniform bounds —
        # further inserts must route with the SAME ownership map
        from ..parallel.sharded import key_bounds
        sm._bounds = key_bounds(int(mesh.devices.size), config)
    return sm


def _set_counters(lv, uniques: int, dupes: int) -> None:
    if hasattr(lv, "set_counters"):     # native backend (read-only props)
        lv.set_counters(uniques, dupes)
    else:
        lv.uniques_n, lv.dupes_n = uniques, dupes


def _restore_node_level(lv, raw: np.ndarray) -> None:
    """Rebuild pool + hash index by replaying the packed layout."""
    if hasattr(lv, "restore"):          # native backend
        lv.restore(raw)
        return
    lv._raw = raw.copy()
    lv._occupied = raw.shape[0]
    lv._index.clear()
    addr = 1
    n = raw.shape[0]
    uniques = 0
    while addr < n:
        mask = int(raw[addr])
        cnt = bin(mask & 0xFF).count("1")
        kids = np.zeros(8, np.uint32)
        k = 0
        for ci in range(8):
            if mask & (1 << ci):
                kids[ci] = raw[addr + 1 + k]
                k += 1
        lv._index[kids.tobytes()] = addr
        addr += 1 + cnt
        uniques += 1
    lv.uniques_n = uniques
    lv.dupes_n = 0


def _restore_lc_level(lv, raw: np.ndarray) -> None:
    if hasattr(lv, "restore"):          # native backend
        lv.restore(raw)
        return
    lv._raw = raw.copy()
    lv._n = raw.shape[0]
    lv._index = {int(v): i for i, v in enumerate(raw) if i > 0}
    lv.uniques_n = raw.shape[0] - 1
    lv.dupes_n = 0
