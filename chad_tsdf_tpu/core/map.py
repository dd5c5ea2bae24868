"""TSDFMap — the public API.

Mirrors the reference's single entry class ``chad::TSDFMap`` (reference:
include/chad/tsdf.hpp:21-171, src/chad/tsdf.cpp:26-86):

* ``insert(points, position)``: submap-rotation check (>5 m travel =>
  finalize + fresh active map, tsdf.cpp:46-61), then the Morton -> sort ->
  normals -> DDA integrate pipeline — here one fused jit per chunk
  (core/integrate.py).
* ``save(filename)``: finalize the active submap and extract a marching-
  cubes mesh to PLY (tsdf.cpp:76-86).  Unlike the reference — which meshes
  only ``_submaps.front()`` (tsdf.cpp:85) and double-pushes the active
  submap when save() is called twice (known defects per SURVEY §7) — save()
  meshes the union of all submaps by default (``mesh_first_submap_only``
  restores parity) and is idempotent: the active snapshot is cached until
  the next insert invalidates it.

Also provided beyond the reference's built surface (its TODO list at
tsdf.hpp:158-161): ``leaf_items()`` iteration, ``raycast()``, ``merge()``,
and checkpointing (see chad_tsdf_tpu.io.checkpoint).
"""

from __future__ import annotations

import collections.abc
import time

import jax
import numpy as np

from .. import backend
from ..config import MapConfig
from ..mesh import grid as grid_io
from ..mesh import marching_cubes, write_ply
from ..ops import codec, morton
from . import carve, dag, integrate, submap as submap_mod
from .state import create_state, origin_blocks_for_position


class LazyMetrics(collections.abc.MutableMapping):
    """Per-insert metrics whose values stay on device until first read.

    A host scalar readback waits for every queued device step, so
    ``insert`` must not materialize its counters eagerly — a streaming
    loop that ignores the return value then runs sync-free.
    Reading any key converts (and caches) that value as a plain Python
    scalar; host-side floats (e.g. ``wall_ms``) pass through untouched.

    Deliberately NOT a dict subclass: ``dict(m)``, ``**m`` and ``==`` on a
    dict subclass hit CPython's concrete-dict fast paths and would leak
    raw device scalars past the converting ``__getitem__`` (advisor r3);
    as a ``MutableMapping`` every access route — including ``dict(m)``,
    ``**m``, ``items()``, equality — funnels through ``__getitem__``.
    ``raw(key)`` exposes the unconverted stored value (tests use it to
    assert the insert path did no readback).
    """

    def __init__(self, data=None):
        self._data = dict(data or {})

    def __getitem__(self, key):
        v = self._data[key]
        if not isinstance(v, (int, float)):
            v = v.item()
            self._data[key] = v
        return v

    def __setitem__(self, key, value):
        self._data[key] = value

    def __delitem__(self, key):
        del self._data[key]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def raw(self, key):
        """The stored value without scalar conversion (device array until
        someone reads the key)."""
        return self._data[key]

    def materialize(self) -> "LazyMetrics":
        for k in self._data:
            self[k]
        return self

    def copy(self) -> dict:
        return dict(self.materialize())

    def __repr__(self):
        return repr(dict(self.materialize()))


class TSDFMap:
    def __init__(self, sdf_res: float = 0.05, sdf_trunc: float = 0.1,
                 config: MapConfig | None = None):
        if config is None:
            config = MapConfig(sdf_res=sdf_res, sdf_trunc=sdf_trunc)
        elif (sdf_res, sdf_trunc) != (config.sdf_res, config.sdf_trunc):
            import dataclasses
            config = dataclasses.replace(config, sdf_res=sdf_res,
                                         sdf_trunc=sdf_trunc)
        self.config = config
        self.levels = dag.NodeLevels()
        self.submaps: list[submap_mod.Submap] = []
        self._pending: list[submap_mod.PendingSubmap] = []
        self.state = None
        self._positions: list[np.ndarray] = []
        self._active_snapshot: submap_mod.Submap | None = None
        self.last_metrics: dict = {}

    # ------------------------------------------------------------------
    @property
    def n_submaps(self) -> int:
        """Finalized submaps, including rotations still materializing."""
        return len(self.submaps) + len(self._pending)

    @property
    def sdf_res(self) -> float:
        return self.config.sdf_res

    @property
    def sdf_trunc(self) -> float:
        return self.config.sdf_trunc

    # ------------------------------------------------------------------
    def insert(self, points, position) -> dict:
        """Integrate one point cloud scanned from ``position``.

        points: array-like (N, 3) float; position: (3,) float.
        Returns the per-insert metrics dict.
        """
        t0 = time.perf_counter()
        points = np.ascontiguousarray(np.asarray(points, np.float32))
        if points.ndim != 2 or points.shape[1] != 3:
            raise ValueError("points must be (N, 3)")
        position = np.asarray(position, np.float32).reshape(3)

        # submap rotation policy (tsdf.cpp:46-61)
        if self.state is None:
            self._start_submap(position)
        elif self._positions and np.linalg.norm(
                position - self._positions[0]) > self.config.submap_distance:
            self._finalize_active()
            self._start_submap(position)
        self._positions.append(position.copy())
        self._active_snapshot = None

        cfg = self.config
        cap = cfg.max_points
        buckets = cfg.buckets
        metrics_acc: dict = {}
        for beg in range(0, max(len(points), 1), cap):
            chunk = points[beg:beg + cap]
            n = chunk.shape[0]
            # pad to the smallest compile-shape bucket that fits: streaming
            # scans (e.g. ~120k-point KITTI) skip most of the 1M-point
            # pipeline instead of paying full-shape padding every insert
            bucket = next((b for b in buckets if b >= n), cap)
            if n < bucket:
                chunk = np.concatenate(
                    [chunk, np.zeros((bucket - n, 3), np.float32)])
            if cfg.packed_ingest:
                q = integrate.pack_points(chunk, position, cfg.sdf_res)
                self.state, metrics = integrate.insert_step_packed(
                    self.state, q, np.int32(n), position, cfg)
                if cfg.carve_steps > 0:
                    self.state, cmetrics = carve.carve_step_packed(
                        self.state, q, np.int32(n), position, cfg)
                    metrics.update(cmetrics)
            else:
                self.state, metrics = integrate.insert_step(
                    self.state, chunk, np.int32(n), position, cfg)
                if cfg.carve_steps > 0:
                    self.state, cmetrics = carve.carve_step(
                        self.state, chunk, np.int32(n), position, cfg)
                    metrics.update(cmetrics)
            # accumulate on device: no host readback on the insert path
            # (LazyMetrics docstring — a sync here stalls the stream)
            for k, v in metrics.items():
                metrics_acc[k] = (metrics_acc[k] + v) if k in metrics_acc \
                    else v
        metrics_acc = LazyMetrics(metrics_acc)
        if self.config.profile:
            jax.block_until_ready(self.state.pool_sd)
            metrics_acc["wall_ms"] = (time.perf_counter() - t0) * 1e3
            print(f"insert   {metrics_acc.get('wall_ms', 0):8.2f} ms  "
                  f"samples={metrics_acc['n_valid_samples']} "
                  f"blocks={metrics_acc['n_blocks']}")
        self._n_inserts = getattr(self, "_n_inserts", 0) + 1
        # overflow check costs a readback — amortize it over the stream
        # (it also runs at every rotation/finalize, so nothing is missed
        # for long: the counters are cumulative per active map)
        if self._n_inserts % 64 == 0 or self.config.profile:
            self._warn_overflow()
        self.last_metrics = metrics_acc
        return metrics_acc

    # overflow kinds that silently degrade the map if ignored (dropped
    # content).  tile_overflow is excluded: it is always 0, kept only for
    # the checkpoint layout.
    _LOSSY_OVERFLOWS = ("point_overflow", "sample_overflow",
                        "block_overflow", "touched_overflow")

    def _warn_overflow(self) -> None:
        """Warn once per counter kind when dropped-data overflow appears.

        The reference's hashmap octree is unbounded; this build's static
        capacities drop-and-count instead (MapConfig docstring).  Counting
        alone is easy to ignore, so the first non-zero occurrence of each
        lossy counter raises a UserWarning naming the config knob to bump.
        """
        if self.state is None:
            return
        warned = getattr(self, "_overflow_warned", set())
        knob = {"point_overflow": "block_bits (local extent)",
                "sample_overflow": "block_bits (local extent)",
                "block_overflow": "block_capacity",
                "touched_overflow": "touched_capacity"}
        for name in self._LOSSY_OVERFLOWS:
            if name in warned:
                continue
            v = int(getattr(self.state, name))
            if v > 0:
                import warnings
                warnings.warn(
                    f"TSDFMap: {name} = {v} — samples were dropped and "
                    f"counted; the map is degraded in those regions. "
                    f"Raise MapConfig.{knob[name]} to avoid this.",
                    stacklevel=3)
                warned.add(name)
        self._overflow_warned = warned
        self._checked_at_insert = getattr(self, "_n_inserts", 0)

    def __del__(self):
        # a short-lived map (< 64 inserts, never rotated/stats'd/saved)
        # would otherwise drop data without ever warning (advisor r3).
        # Only read the counters when inserts happened SINCE the last
        # check: the readback waits for the device queue, and GC can fire
        # mid-stream — e.g. rebinding `m = TSDFMap(...)` while another map
        # streams.
        try:
            n = getattr(self, "_n_inserts", 0)
            if n and n != getattr(self, "_checked_at_insert", -1):
                self._warn_overflow()
        except Exception:
            pass

    def _start_submap(self, position: np.ndarray) -> None:
        origin = origin_blocks_for_position(position, self.config)
        self.state = create_state(self.config, origin)
        self._positions = []

    @staticmethod
    def _anchor_from(positions) -> np.ndarray:
        a = np.eye(4, dtype=np.float64)
        if positions:
            a[:3, 3] = np.asarray(positions[0], np.float64)
        return a

    def _finalize_active(self) -> None:
        """Fully deferred rotation: stash the rotated-out device state
        (submap_mod.start_finalize — zero host syncs; even a counter
        readback here would drain the dispatch pipeline); readback,
        compaction, transfer and DAG build all happen at
        :meth:`_drain_pending`."""
        p = submap_mod.start_finalize(
            self.state, self.config, self._positions,
            anchor=self._anchor_from(self._positions))
        self._pending.append(p)
        # bound device memory held by in-flight buffers; the oldest
        # transfer has had the longest to stream, so this rarely blocks
        while len(self._pending) > self.config.max_pending_finalize:
            self.submaps.append(
                self._pending.pop(0).finish(self.levels, self.config))

    def _drain_pending(self) -> None:
        """Materialize all pending (rotated-out) submaps, in order.

        All device->host copies are started first, so the transfer of
        submap k+1 overlaps the host DAG build of submap k."""
        for p in self._pending:
            p.start_copies()
        while self._pending:
            self.submaps.append(
                self._pending.pop(0).finish(self.levels, self.config))

    def _active_nonempty(self) -> bool:
        """Does the active (unfinalized) map hold any blocks?  Overridden
        by ShardedTSDFMap (whose active map lives in ``state_stack``) so
        every base-class policy check works for both layouts."""
        return self.state is not None and int(self.state.n_blocks) > 0

    def _clear_active(self) -> None:
        self.state = None

    def finalize_active(self) -> None:
        """Finalize the current active map into a submap immediately — the
        rotation step of tsdf.cpp:46-61, callable explicitly (e.g. before
        ``optimize_loop_closures`` so the last leg participates as a
        first-class submap rather than a transient snapshot)."""
        if self._active_nonempty():
            self._finalize_active()
        self._drain_pending()
        self._clear_active()
        self._positions = []
        self._active_snapshot = None

    # ------------------------------------------------------------------
    def _all_submaps(self) -> list[submap_mod.Submap]:
        """Finalized submaps plus a cached snapshot of the active one.

        The snapshot is consed into a throwaway scratch ``NodeLevels`` (the
        Submap carries it), so repeated save()/extract_mesh() on a live map
        never grows the persistent ``self.levels`` pools or skews their
        uniques/dupes compression counters."""
        self._drain_pending()
        out = list(self.submaps)
        if self.state is not None and int(self.state.n_blocks) > 0:
            if self._active_snapshot is None:
                scratch = dag.NodeLevels()
                sm = submap_mod.finalize(
                    self.state, scratch, self.config, self._positions)
                sm.levels = scratch
                sm.anchor = self._anchor_from(self._positions)
                self._active_snapshot = sm
            out.append(self._active_snapshot)
        return out

    def _sm_levels(self, sm: submap_mod.Submap) -> dag.NodeLevels:
        return sm.levels if sm.levels is not None else self.levels

    def _reanchor_codes(self, codes: np.ndarray,
                        transform: np.ndarray) -> np.ndarray:
        """Map world voxel codes through a rigid correction: decode to voxel
        centers, transform, re-discretize (floor(p/res), morton.hpp:71)."""
        coords = morton.np_decode63(codes)
        res = self.config.sdf_res
        centers = (coords.astype(np.float64) + 0.5) * res
        t = np.asarray(transform, np.float64)
        moved = centers @ t[:3, :3].T + t[:3, 3]
        vox = np.floor(moved / res).astype(np.int32)
        return morton.np_encode63(vox)

    def voxel_samples(self, submaps=None):
        """All (voxel Morton code uint64, signed distance f32) samples of
        the selected submaps' TSDF DAGs.

        Voxels seen by several submaps (overlap) are fused by a weighted
        mean over the stored quantized weights — what a single pool seeing
        all samples would produce, up to output-codec quantization.  (The
        reference sidesteps overlap by meshing only the first submap,
        tsdf.cpp:85.)  Submaps carrying a loop-closure correction
        (``optimize_loop_closures``) are re-anchored first.
        """
        if submaps is None:
            submaps = self._all_submaps()
        all_codes, all_sd, all_w = [], [], []
        for sm in submaps:
            levels = self._sm_levels(sm)
            ccodes, words_t = levels.walk_leaf_clusters(sm.root_addr_tsdf)
            _, words_w = levels.walk_leaf_clusters(sm.root_addr_weight)
            lt = codec.unpack_cluster_u64(np, words_t)        # (M, 8)
            lw = codec.unpack_cluster_u64(np, words_w)
            present = lt != codec.EMPTY
            vox_codes = (ccodes[:, None] << np.uint64(3)) | \
                np.arange(8, dtype=np.uint64)[None, :]
            sd = codec.decode_sd(np, lt, self.config.sdf_trunc)
            codes_i = vox_codes[present]
            if sm.corrected is not None:
                codes_i = self._reanchor_codes(codes_i, sm.corrected)
            all_codes.append(codes_i)
            all_sd.append(sd[present].astype(np.float32))
            all_w.append(np.maximum(lw[present].astype(np.float32), 1.0))
        if not all_codes:
            return np.zeros(0, np.uint64), np.zeros(0, np.float32)
        codes = np.concatenate(all_codes)
        sd = np.concatenate(all_sd)
        w = np.concatenate(all_w)
        order = np.argsort(codes, kind="stable")
        codes, sd, w = codes[order], sd[order], w[order]
        starts = np.flatnonzero(
            np.concatenate([[True], codes[1:] != codes[:-1]]))
        wsum = np.add.reduceat(w, starts)
        sdw = np.add.reduceat(sd * w, starts)
        return codes[starts], (sdw / wsum).astype(np.float32)

    def extract_mesh(self, optimize_iterations: int = 0,
                     optimize_method: str = "planar"):
        """Marching-cubes mesh of the map.

        ``optimize_iterations > 0`` runs contour optimization analogous to
        the reference's LVR2 ``optimizePlanarFaces(mesh, 5)``
        (lvr2.cpp:262-266): method ``"planar"`` (default) clusters planar
        regions and projects contour vertices onto plane intersections;
        ``"taubin"`` is the generic shrink-free smoother.
        """
        submaps = self._all_submaps()
        if self.config.mesh_first_submap_only and submaps:
            submaps = submaps[:1]   # reference parity (tsdf.cpp:85)
        codes, sd = self.voxel_samples(submaps)
        if backend.choose(self.config).mesh == "device":
            from ..mesh.device_mc import marching_cubes_device
            mesh = marching_cubes_device(codes, sd, self.config.sdf_res)
        else:
            mesh = marching_cubes(codes, sd, self.config.sdf_res)
        if optimize_iterations > 0:
            if optimize_method == "planar":
                from ..mesh.optimize import optimize_planar_faces
                mesh = optimize_planar_faces(mesh, optimize_iterations)
            elif optimize_method == "taubin":
                from ..mesh.optimize import taubin_smooth
                mesh = taubin_smooth(mesh, optimize_iterations)
            else:
                raise ValueError(f"bad optimize_method {optimize_method!r}")
        return mesh

    def save(self, filename: str) -> None:
        """Reconstruct the mesh and write it to ``filename`` (tsdf.cpp:76-86).

        Writes the optional .grid dump first when config.save_grid is set
        (the reference writes "hashgrid.grid" unconditionally, lvr2.cpp:290).
        With ``config.profile`` the ``sub fin`` / ``mesh`` stages print wall
        times — together with insert's stage prints this mirrors the
        reference's six always-on timers (morton.hpp:78,100, normals.hpp:146,
        octree.hpp:169, submap.hpp:105, tsdf.cpp:74).
        """
        t0 = time.perf_counter()
        submaps = self._all_submaps()      # finalizes the active snapshot
        t_fin = time.perf_counter() - t0
        mesh = self.extract_mesh()
        t_mesh = time.perf_counter() - t0 - t_fin
        if self.config.profile:
            print(f"sub fin  {t_fin * 1e3:8.2f} ms")
            print(f"mesh     {t_mesh * 1e3:8.2f} ms  "
                  f"({mesh.n_vertices} verts, {mesh.n_faces} faces)")
        self.last_metrics["sub_fin_ms"] = t_fin * 1e3
        self.last_metrics["mesh_ms"] = t_mesh * 1e3
        if self.config.save_grid:
            codes, sd = self.voxel_samples()
            grid_io.write_grid("hashgrid.grid", codes, sd,
                               self.config.sdf_res)
        write_ply(filename, mesh)

    def save_grid(self, filename: str) -> None:
        codes, sd = self.voxel_samples()
        grid_io.write_grid(filename, codes, sd, self.config.sdf_res)

    # ------------------------------------------------------------------
    def leaf_arrays(self, submap: submap_mod.Submap | None = None):
        """Vectorized leaf export: (world voxel coords (N, 3) int32,
        signed distances (N,) f32, weights (N,) uint8) over the selected
        submaps — the bulk form of :meth:`leaf_items`, usable at map scale
        (no per-voxel Python)."""
        submaps = [submap] if submap is not None else self._all_submaps()
        coords_l, sd_l, w_l = [], [], []
        for sm in submaps:
            levels = self._sm_levels(sm)
            ccodes, words_t = levels.walk_leaf_clusters(sm.root_addr_tsdf)
            _, words_w = levels.walk_leaf_clusters(sm.root_addr_weight)
            lt = codec.unpack_cluster_u64(np, words_t)
            lw = codec.unpack_cluster_u64(np, words_w)
            present = lt != codec.EMPTY
            vox_codes = (ccodes[:, None] << np.uint64(3)) | \
                np.arange(8, dtype=np.uint64)[None, :]
            coords_l.append(morton.np_decode63(vox_codes[present]))
            sd_l.append(codec.decode_sd(np, lt,
                                        self.config.sdf_trunc)[present])
            w_l.append(lw[present])
        if not coords_l:
            return (np.zeros((0, 3), np.int32), np.zeros(0, np.float32),
                    np.zeros(0, np.uint8))
        return (np.concatenate(coords_l), np.concatenate(sd_l),
                np.concatenate(w_l))

    def leaf_items(self, submap: submap_mod.Submap | None = None):
        """Iterate (world voxel coord (3,) int32, signed distance, weight)
        — the leaf-iterator API the reference sketches but never builds
        (tsdf.hpp:120-155).  For bulk access use :meth:`leaf_arrays`."""
        coords, sds, ws = self.leaf_arrays(submap)
        for i in range(coords.shape[0]):
            yield coords[i], float(sds[i]), int(ws[i])

    def _sorted_samples(self):
        """Code-sorted (codes, sd) for point queries, cached across calls
        (insert/rotation invalidates via ``_active_snapshot = None``)."""
        cache = getattr(self, "_query_cache", None)
        key = (len(self.submaps), len(self._pending),
               self._active_snapshot is not None)
        if cache is not None and cache[0] == key:
            return cache[1], cache[2]
        codes, sd = self.voxel_samples()        # already code-sorted/unique
        self._query_cache = (key, codes, sd)
        return codes, sd

    def raycast(self, origin, direction, max_dist: float = 100.0):
        """March a ray through the map; returns the first zero-crossing hit
        position or None — the reference's declared-but-unbuilt raycast
        (tsdf.hpp:158-161).  The sorted query index is cached, so repeated
        raycasts on an unchanged map cost one searchsorted each.

        EXACT voxel coverage: instead of fixed-step sampling (which can
        step across a thin surface at glancing incidence), every
        grid-plane crossing along the ray is enumerated — the vectorized
        equivalent of the Amanatides-Woo walk the integrator uses
        (ops/dda.py; octree.hpp:92-152) — so no voxel the ray passes
        through is ever skipped."""
        codes, sd = self._sorted_samples()
        if codes.shape[0] == 0:
            return None
        origin = np.asarray(origin, np.float64)
        direction = np.asarray(direction, np.float64)
        direction = direction / np.linalg.norm(direction)
        res = float(self.config.sdf_res)

        # all grid-plane crossing parameters t in (0, max_dist), per axis
        ts = [np.asarray([0.0, max_dist])]
        for k in range(3):
            dk = direction[k]
            if dk == 0.0:
                continue
            lo = origin[k] + min(0.0, dk * max_dist)
            hi = origin[k] + max(0.0, dk * max_dist)
            planes = np.arange(np.ceil(lo / res), np.floor(hi / res) + 1)
            tk = (planes * res - origin[k]) / dk
            ts.append(tk[(tk > 0.0) & (tk < max_dist)])
        t_all = np.sort(np.concatenate(ts))
        # midpoints of consecutive crossings are strictly inside one voxel
        mid = (t_all[:-1] + t_all[1:]) * 0.5
        pts = origin[None, :] + mid[:, None] * direction[None, :]
        vox = np.floor(pts / res).astype(np.int32)
        qc = morton.np_encode63(vox)
        pos = np.minimum(np.searchsorted(codes, qc), codes.shape[0] - 1)
        hitm = codes[pos] == qc
        vals = np.where(hitm, sd[pos], np.nan)
        sign = vals < 0
        crossings = np.nonzero(hitm[:-1] & hitm[1:] & ~sign[:-1] & sign[1:])[0]
        if crossings.size == 0:
            return None
        i = crossings[0]
        a, b = vals[i], vals[i + 1]
        frac = a / (a - b) if a != b else 0.5
        return origin + (mid[i] + frac * (mid[i + 1] - mid[i])) * direction

    def merge(self, other: "TSDFMap") -> None:
        """Merge another map's finalized submaps into this one — the
        reference's declared-but-unbuilt map merging (tsdf.hpp:161).
        DAG contents are re-consed into this map's levels."""
        for sm in other._all_submaps():
            levels = other._sm_levels(sm)
            codes, words_t = levels.walk_leaf_clusters(sm.root_addr_tsdf)
            _, words_w = levels.walk_leaf_clusters(sm.root_addr_weight)
            new_sm = _rebuild_submap(self.levels, codes, words_t, words_w,
                                     sm.positions)
            new_sm.anchor = sm.anchor
            new_sm.corrected = sm.corrected
            self.submaps.append(new_sm)

    def optimize_loop_closures(self, loop_edges=(), iterations: int = 20,
                               damping: float = 1e-6, mesh=None,
                               huber_delta: float = 1.0) -> dict:
        """Pose-graph loop closure over finalized submaps — the reference's
        roadmap item (README.md:59; declared surface tsdf.hpp:158-161).

        Odometry edges come from the stored submap anchors (measured
        relative pose between consecutive submaps); ``loop_edges`` is an
        iterable of ``(i, j, T_rel (4,4), weight)`` constraints from e.g.
        place recognition + scan matching (outside this library's scope).
        Gauss-Newton runs in ``slam/posegraph.py`` (with ``mesh`` given,
        per-edge normal-equation blocks reduce via psum over the device
        mesh).  Each submap is then re-anchored: the rigid correction
        ``T_opt[i] @ inv(anchor[i])`` is applied to its voxels at
        mesh/query time (voxel_samples/extract_mesh/raycast).

        Returns the optimizer stats dict (initial/final cost, iterations).
        """
        from ..slam import posegraph as pg
        if self._active_nonempty():
            # include the live map as a (snapshotted) trailing node so its
            # pose participates; its correction applies via the snapshot
            subs = self._all_submaps()
        else:
            self._drain_pending()
            subs = list(self.submaps)
        if len(subs) < 2:
            return {"initial_cost": 0.0, "final_cost": 0.0, "iterations": 0}
        anchors = np.stack([
            sm.anchor if sm.anchor is not None else np.eye(4)
            for sm in subs]).astype(np.float64)
        graph = pg.make_odometry_edges(anchors.astype(np.float32))
        for (i, j, z, w) in loop_edges:
            graph = pg.add_edge(graph, int(i), int(j),
                                np.asarray(z, np.float32), float(w))
        poses_opt, stats = pg.optimize_poses(
            graph, anchors.astype(np.float32), iterations=iterations,
            damping=damping, mesh=mesh, huber_delta=huber_delta)
        for sm, a, p in zip(subs, anchors, poses_opt):
            corr = p.astype(np.float64) @ np.linalg.inv(a)
            sm.corrected = None if np.allclose(corr, np.eye(4), atol=1e-7) \
                else corr
        self._query_cache = None       # re-anchoring moves voxels
        return stats

    def stats(self) -> dict:
        self._warn_overflow()
        self._drain_pending()
        s = self.levels.stats()
        s["n_submaps"] = len(self.submaps)
        if self.state is not None:
            s["active_blocks"] = int(self.state.n_blocks)
            s["overflow"] = {
                "points": int(self.state.point_overflow),
                "samples": int(self.state.sample_overflow),
                "blocks": int(self.state.block_overflow),
                "touched": int(self.state.touched_overflow),
                "tile": int(self.state.tile_overflow),
            }
        return s


# kept as an alias for tests and merge(): the canonical implementation
# lives in core/submap.py
_rebuild_submap = submap_mod.build_submap
