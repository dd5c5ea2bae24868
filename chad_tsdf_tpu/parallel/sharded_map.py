"""ShardedTSDFMap — the user-facing sharded map orchestration.

The multi-device counterpart of ``core.map.TSDFMap`` (reference
``chad::TSDFMap``, include/chad/tsdf.hpp:21-171): same public surface —
``insert(points, position)``, ``save(filename)``, submap rotation every
``submap_distance`` metres of travel (src/chad/tsdf.cpp:46-61) — but the
active map is Morton-range sharded over a device mesh and every insert runs
the SPMD step of ``parallel.sharded`` (the single-device insert body per
shard, block-row halo exchange).  Finalization merges the per-shard pools
exactly (``core.submap.finalize_sharded``), so meshing, checkpointing,
stats and the rest of the single-device API are inherited unchanged from
TSDFMap.

This is SURVEY §7 steps 5-6: sharded insert -> rotation -> sharded finalize
-> mesh, one object.

Multi-controller: the same object runs across OS processes/hosts
(jax.distributed).  ``insert`` routes the (identically computed) split
through ``global_shard_array``; rotation/save/checkpoint use the in-graph
all_gather extraction (``parallel.sharded.start_finalize_sharded_global``),
so every process reads replicated buffers and deterministically builds the
identical submap DAG — proven by tests/test_distributed.py (2 processes x
4 devices, gloo), whose map digest matches a single-process run
bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import numpy as np

from ..config import MapConfig
from ..core import dag, integrate, submap as submap_mod
from ..core.map import LazyMetrics, TSDFMap
from ..core.state import origin_blocks_for_position
from . import sharded


# compiled sharded insert steps, shared across map instances: jax.jit
# caches per wrapped-function object, so per-instance steps would re-trace
# (and reload the whole compile) for every new ShardedTSDFMap
_STEP_CACHE: dict = {}


@jax.jit
def _total_blocks(state_stack):
    """Shard-summed active block count — jitted so it is legal on a
    multi-controller global array (eager ``.sum()`` would touch
    non-addressable shards)."""
    import jax.numpy as jnp
    return jnp.sum(state_stack.n_blocks)


@jax.jit
def _stacked_counters(state_stack):
    """Five overflow counters summed over the shard axis — one device
    reduction, one small transfer instead of a readback per counter."""
    import jax.numpy as jnp
    return jnp.stack([
        jnp.sum(state_stack.point_overflow),
        jnp.sum(state_stack.sample_overflow),
        jnp.sum(state_stack.block_overflow),
        jnp.sum(state_stack.touched_overflow),
        jnp.sum(state_stack.tile_overflow)])


class ShardedTSDFMap(TSDFMap):
    def __init__(self, sdf_res: float = 0.05, sdf_trunc: float = 0.1,
                 config: MapConfig | None = None, mesh=None,
                 halo_capacity: int | None = None, axis: str = "shard"):
        super().__init__(sdf_res, sdf_trunc, config)
        self.mesh = mesh if mesh is not None else sharded.make_mesh(axis=axis)
        self.axis = axis
        self.n_shards = int(self.mesh.devices.size)
        self.halo_capacity = halo_capacity
        # one compiled step per point bucket, built on first use — streaming
        # scans pad to the smallest bucket that fits, exactly like the
        # single-device path (core/map.py insert)
        self._steps: dict = {}
        self.state_stack = None
        self._origin = None
        self._bounds = None

    def _step_for(self, bucket: int):
        step = self._steps.get(bucket)
        if step is None:
            key = (self.config,
                   tuple(d.id for d in self.mesh.devices.flat),
                   self.axis, self.halo_capacity, bucket)
            cached = _STEP_CACHE.get(key)
            if cached is None:
                cfg = dataclasses.replace(self.config, max_points=bucket,
                                          point_buckets=())
                cached = sharded.make_sharded_insert(
                    cfg, self.mesh, halo_capacity=self.halo_capacity,
                    axis=self.axis)
                _STEP_CACHE[key] = cached
            step, cap = cached
            self.halo_capacity = cap
            self._steps[bucket] = step
        return step

    def _carve_step_for(self, bucket: int):
        key = ("carve", self.config,
               tuple(d.id for d in self.mesh.devices.flat),
               self.axis, bucket)
        cached = _STEP_CACHE.get(key)
        if cached is None:
            cfg = dataclasses.replace(self.config, max_points=bucket,
                                      point_buckets=())
            cached = sharded.make_sharded_carve(cfg, self.mesh,
                                                axis=self.axis)
            _STEP_CACHE[key] = cached
        return cached

    # -- the sharded active map replaces the single-device self.state ------
    def insert(self, points, position) -> dict:
        """Insert one scan across the shard mesh.

        Host-sync discipline matches the single-device path: metrics stay
        on device (LazyMetrics) and chunks pad to compile-shape buckets, so
        a streaming loop that ignores the return value issues zero host
        readbacks per insert.
        """
        t0 = time.perf_counter()
        points = np.ascontiguousarray(np.asarray(points, np.float32))
        if points.ndim != 2 or points.shape[1] != 3:
            raise ValueError("points must be (N, 3)")
        position = np.asarray(position, np.float32).reshape(3)

        if self.state_stack is None:
            self._start_submap(position)
        elif self._positions and np.linalg.norm(
                position - self._positions[0]) > self.config.submap_distance:
            self._finalize_active()
            self._start_submap(position)
        self._positions.append(position.copy())
        self._active_snapshot = None

        cap = self.config.max_points
        buckets = self.config.buckets
        batch = self.n_shards * cap
        metrics_acc: dict = {}
        for beg in range(0, max(len(points), 1), batch):
            chunk = points[beg:beg + batch]
            if self._bounds is None and self.n_shards > 1 and len(chunk):
                # occupancy-adaptive ownership partition, fixed for the
                # submap's lifetime (consistent row ownership); computed
                # from the submap's first NON-EMPTY chunk — an empty scan
                # must not lock in the static fallback below, whose
                # measured remote fraction is 43-98%
                # (scripts/sharded_overhead_bench.py).
                self._bounds = sharded.adaptive_bounds(
                    chunk, self._origin, self.n_shards, self.config)
            bounds = self._bounds if self._bounds is not None else \
                sharded.key_bounds(self.n_shards, self.config)
            if self.n_shards == 1:
                # no split needed (the pipeline Morton-sorts on device)
                shards = [chunk]
            else:
                shards = sharded.rebalance_chunks(
                    sharded.owner_split(chunk, bounds, self._origin,
                                        self.config), cap)
            per = max(len(c) for c in shards)
            bucket = next((b for b in buckets if b >= per), cap)
            padded = np.zeros((self.n_shards * bucket, 3), np.float32)
            n_per = np.zeros((self.n_shards,), np.int32)
            for i, c in enumerate(shards):
                padded[i * bucket:i * bucket + len(c)] = c
                n_per[i] = len(c)
            if self.config.packed_ingest:
                padded = integrate.pack_points(padded, position,
                                               self.config.sdf_res)
            if jax.process_count() > 1:
                # multi-controller: sharded jit inputs must be global
                # jax.Arrays — every process computes the identical full
                # split and contributes its addressable shards
                # (parallel/distributed.py)
                from jax.sharding import PartitionSpec as P

                from . import distributed
                padded = distributed.global_shard_array(
                    padded, self.mesh, P(self.axis))
                n_per = distributed.global_shard_array(
                    n_per, self.mesh, P(self.axis))
            self.state_stack, metrics = self._step_for(bucket)(
                self.state_stack, padded, n_per, position, bounds)
            if self.config.carve_steps > 0:
                # the carve step takes the full UNSPLIT chunk, replicated:
                # erosion-only lookup means each shard keeps exactly the
                # evidence landing in blocks it holds (make_sharded_carve)
                full = np.zeros((self.n_shards * bucket, 3), np.float32)
                full[:len(chunk)] = chunk
                if self.config.packed_ingest:
                    full = integrate.pack_points(full, position,
                                                 self.config.sdf_res)
                n_full = np.int32(len(chunk))
                if jax.process_count() > 1:
                    from jax.sharding import PartitionSpec as P

                    from . import distributed
                    full = distributed.global_shard_array(
                        full, self.mesh, P())
                self.state_stack, cmetrics = self._carve_step_for(bucket)(
                    self.state_stack, full, n_full, position)
                metrics.update(cmetrics)
            for k, v in metrics.items():
                metrics_acc[k] = (metrics_acc[k] + v) if k in metrics_acc \
                    else v
        metrics_acc = LazyMetrics(metrics_acc)
        if self.config.profile:
            jax.block_until_ready(self.state_stack.pool_sd)
            metrics_acc["wall_ms"] = (time.perf_counter() - t0) * 1e3
            print(f"insert   {metrics_acc.get('wall_ms', 0):8.2f} ms  "
                  f"samples={metrics_acc['n_valid_samples']} "
                  f"blocks={metrics_acc['n_blocks']} "
                  f"deferred={metrics_acc['route_overflow']}")
        self._n_inserts = getattr(self, "_n_inserts", 0) + 1
        # amortized like the single-device path: the stacked-counter check
        # costs one readback (also runs at rotation/stats/__del__)
        if self._n_inserts % 64 == 0 or self.config.profile:
            self._warn_overflow()
        self.last_metrics = metrics_acc
        return metrics_acc

    def _active_nonempty(self) -> bool:
        return self.state_stack is not None and \
            int(np.asarray(_total_blocks(self.state_stack))) > 0

    def _clear_active(self) -> None:
        self.state_stack = None
        self._origin = None
        self._bounds = None

    def _start_submap(self, position: np.ndarray) -> None:
        origin = origin_blocks_for_position(position, self.config)
        self._origin = origin
        self._bounds = None        # adaptive, set by the first insert
        self.state_stack = sharded.create_sharded_state(
            self.config, self.mesh, origin, axis=self.axis)
        self._positions = []

    def _finalize_active(self) -> None:
        """Fully deferred sharded rotation: stash the rotated-out
        ``state_stack`` with zero host syncs (even the counter readback
        would drain the dispatch pipeline mid-stream);
        counters, compaction, transfer and DAG build all happen at the
        next drain (``sharded.PendingShardedStub``)."""
        p = sharded.PendingShardedStub(
            self.state_stack, self.mesh, self.config, list(self._positions),
            self._anchor_from(self._positions), self.axis)
        self._pending.append(p)
        while len(self._pending) > self.config.max_pending_finalize:
            self.submaps.append(
                self._pending.pop(0).finish(self.levels, self.config))

    def _all_submaps(self):
        self._drain_pending()
        out = list(self.submaps)
        if self.state_stack is not None and \
                int(np.asarray(_total_blocks(self.state_stack))) > 0:
            if self._active_snapshot is None:
                scratch = dag.NodeLevels()
                p = sharded.start_finalize_sharded_global(
                    self.state_stack, self.mesh, self.config,
                    self._positions,
                    anchor=self._anchor_from(self._positions),
                    axis=self.axis)
                sm = p.finish(scratch, self.config)
                sm.levels = scratch
                self._active_snapshot = sm
            out.append(self._active_snapshot)
        return out

    def _stacked_overflow(self) -> dict:
        """All five overflow counters summed over shards in ONE transfer."""
        st = self.state_stack
        names = ("point_overflow", "sample_overflow", "block_overflow",
                 "touched_overflow", "tile_overflow")
        vals = np.asarray(_stacked_counters(st))
        return dict(zip(names, (int(v) for v in vals)))

    def _warn_overflow(self) -> None:
        """Sharded analog of TSDFMap._warn_overflow: lossy overflow on ANY
        shard must warn, not sit silently in stats()["overflow"] (the
        "counted, never silent" contract of core/state.py)."""
        if self.state_stack is None:
            return
        warned = getattr(self, "_overflow_warned", set())
        knob = {"point_overflow": "block_bits (local extent)",
                "sample_overflow": "block_bits (local extent)",
                "block_overflow": "block_capacity",
                "touched_overflow": "touched_capacity"}
        ovf = self._stacked_overflow()
        for name in self._LOSSY_OVERFLOWS:
            if name in warned or ovf[name] == 0:
                continue
            import warnings
            warnings.warn(
                f"ShardedTSDFMap: {name} = {ovf[name]} across shards — "
                f"samples were dropped and counted; the map is degraded "
                f"in those regions. Raise MapConfig.{knob[name]} to avoid "
                "this.", stacklevel=3)
            warned.add(name)
        self._overflow_warned = warned
        self._checked_at_insert = getattr(self, "_n_inserts", 0)

    def stats(self) -> dict:
        self._warn_overflow()
        self._drain_pending()
        s = self.levels.stats()
        s["n_submaps"] = len(self.submaps)
        s["n_shards"] = self.n_shards
        if self.state_stack is not None:
            st = self.state_stack
            s["active_blocks"] = int(np.asarray(_total_blocks(st)))
            ovf = self._stacked_overflow()
            s["overflow"] = {
                "points": ovf["point_overflow"],
                "samples": ovf["sample_overflow"],
                "blocks": ovf["block_overflow"],
                "touched": ovf["touched_overflow"],
                "tile": ovf["tile_overflow"],
            }
        return s
