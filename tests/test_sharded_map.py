"""End-to-end ShardedTSDFMap: the user-facing sharded orchestration
(insert -> submap rotation -> finalize_sharded -> mesh) must reproduce the
single-device TSDFMap on the same scans (SURVEY §7 steps 5-6)."""

import numpy as np
import jax
import pytest

from chad_tsdf_tpu.config import MapConfig
from chad_tsdf_tpu.core.map import TSDFMap
from chad_tsdf_tpu.parallel import ShardedTSDFMap, make_mesh

CFG = MapConfig(max_points=512, block_capacity=4096, touched_capacity=2048,
                accumulate_impl="xla")

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def sphere_points(n, r=2.0, seed=0, centre=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.float32(centre) + d * r).astype(np.float32)


@needs_mesh
def test_sharded_map_matches_single_device():
    pts = sphere_points(4096)
    pos = np.zeros(3, np.float32)

    smap = ShardedTSDFMap(config=CFG, mesh=make_mesh(8))
    smap.insert(pts, pos)
    assert smap.last_metrics["route_overflow"] == 0

    ref = TSDFMap(config=CFG)
    for beg in range(0, 4096, CFG.max_points):
        ref.insert(pts[beg:beg + CFG.max_points], pos)

    codes_s, sd_s = smap.voxel_samples()
    codes_r, sd_r = ref.voxel_samples()
    np.testing.assert_array_equal(codes_s, codes_r)
    # normals differ at shard boundaries (sharded) vs chunk boundaries
    # (single-device streams 512-point chunks) — both quantized to 8 bits
    step = CFG.sdf_trunc / 127
    close = np.abs(sd_s - sd_r) <= 2 * step
    assert close.mean() > 0.98

    mesh_s = smap.extract_mesh()
    mesh_r = ref.extract_mesh()
    # mesh vertices live on the same voxel grid; counts nearly identical
    assert abs(len(mesh_s.vertices) - len(mesh_r.vertices)) <= \
        0.02 * len(mesh_r.vertices) + 2
    # every sharded vertex must lie near the analytic r=2 sphere
    rr = np.linalg.norm(mesh_s.vertices, axis=1)
    assert np.abs(rr - 2.0).max() < 3 * CFG.sdf_res


@needs_mesh
def test_sharded_map_rotation_and_save(tmp_path):
    smap = ShardedTSDFMap(config=CFG, mesh=make_mesh(8))
    smap.insert(sphere_points(2048, r=1.5), np.zeros(3, np.float32))
    # travel > submap_distance triggers rotation (tsdf.cpp:46-61 policy)
    far = np.float32([8.0, 0.0, 0.0])
    smap.insert(sphere_points(2048, r=1.5, seed=2, centre=(8.0, 0.0, 0.0)),
                far)
    # rotation is DEFERRED (start_finalize_sharded): the device compaction
    # is dispatched but the host DAG build waits for the next drain point
    assert len(smap._pending) == 1 and len(smap.submaps) == 0
    assert smap.n_submaps == 1               # first submap finalized
    stats = smap.stats()                     # drains the pending rotation
    assert len(smap.submaps) == 1 and not smap._pending
    assert stats["n_submaps"] == 1
    assert stats["active_blocks"] > 0

    out = tmp_path / "sharded.ply"
    smap.save(str(out))
    assert out.exists() and out.stat().st_size > 0

    # both spheres must be present in the merged mesh
    mesh = smap.extract_mesh()
    v = mesh.vertices
    d0 = np.linalg.norm(v, axis=1)
    d1 = np.linalg.norm(v - far[None, :], axis=1)
    near0 = np.abs(d0 - 1.5) < 3 * CFG.sdf_res
    near1 = np.abs(d1 - 1.5) < 3 * CFG.sdf_res
    assert near0.sum() > 50 and near1.sum() > 50
    assert (near0 | near1).all()


@needs_mesh
def test_sharded_insert_is_sync_free_and_bucketed():
    """Streaming parity with the single-device path: metric values stay on
    device until first read (no per-insert host sync), and small scans
    compile against the smallest point bucket that fits, not max_points."""
    cfg = MapConfig(max_points=1 << 15, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl="xla")
    smap = ShardedTSDFMap(config=cfg, mesh=make_mesh(8))
    m = smap.insert(sphere_points(4096), np.zeros(3, np.float32))
    # bypass LazyMetrics' converting __getitem__: the stored value must be
    # a device array, proving insert() itself did no readback
    raw = m.raw("n_blocks")
    assert not isinstance(raw, (int, float)), type(raw)
    # a 4096-point scan split over 8 shards (~512 each) must use the
    # smallest bucket, keeping the compile shape ~64x under max_points
    assert list(smap._steps) == [min(cfg.buckets)]
    assert min(cfg.buckets) < cfg.max_points
    # reading a metric materializes it
    assert m["n_blocks"] > 0


@needs_mesh
def test_sharded_steps_shared_across_instances():
    """Two maps with the same (config, mesh) must reuse the same compiled
    step — per-instance jits would re-trace and reload the whole compile
    for every new map."""
    cfg = MapConfig(max_points=1 << 12, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl="xla")
    mesh = make_mesh(8)
    m1 = ShardedTSDFMap(config=cfg, mesh=mesh)
    m1.insert(sphere_points(1024), np.zeros(3, np.float32))
    m2 = ShardedTSDFMap(config=cfg, mesh=mesh)
    m2.insert(sphere_points(1024), np.zeros(3, np.float32))
    (k1, s1), = m1._steps.items()
    (k2, s2), = m2._steps.items()
    assert k1 == k2 and s1 is s2


@needs_mesh
def test_sharded_packed_ingest_agrees():
    """Packed int16 ingestion through the sharded path must reproduce the
    f32 sharded map within the declared 3.1 mm input quantization."""
    import dataclasses

    cfg = MapConfig(max_points=1 << 12, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl="xla")
    pts = sphere_points(4096, r=1.5)
    pos = np.zeros(3, np.float32)
    m_plain = ShardedTSDFMap(config=cfg, mesh=make_mesh(8))
    m_plain.insert(pts, pos)
    m_packed = ShardedTSDFMap(
        config=dataclasses.replace(cfg, packed_ingest=True),
        mesh=make_mesh(8))
    m_packed.insert(pts, pos)

    c1, s1 = m_plain.voxel_samples()
    c2, s2 = m_packed.voxel_samples()
    common, i1, i2 = np.intersect1d(c1, c2, return_indices=True)
    assert common.shape[0] >= 0.95 * max(c1.shape[0], c2.shape[0])
    diff = np.abs(s1[i1] - s2[i2])
    assert float(np.median(diff)) < 0.004


def test_sharded_map_n1_matches_single_device_exactly():
    """At N=1 the sharded step must BE the single-device pipeline (no
    scratch pool, no routing, no second merge — VERDICT r4 task 1): the
    resulting map is bit-identical to TSDFMap on the same stream."""
    pts = sphere_points(1024, r=1.5)
    pos = np.zeros(3, np.float32)
    cfg = MapConfig(max_points=1024, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl="xla")

    smap = ShardedTSDFMap(config=cfg, mesh=make_mesh(1))
    smap.insert(pts, pos)
    assert smap.last_metrics["route_overflow"] == 0

    ref = TSDFMap(config=cfg)
    ref.insert(pts, pos)

    codes_s, sd_s = smap.voxel_samples()
    codes_r, sd_r = ref.voxel_samples()
    np.testing.assert_array_equal(codes_s, codes_r)
    np.testing.assert_array_equal(sd_s, sd_r)

    # the persistent pools themselves must agree bit-for-bit
    st = smap.state_stack
    np.testing.assert_array_equal(np.asarray(st.pool_sd[0]),
                                  np.asarray(ref.state.pool_sd))
    np.testing.assert_array_equal(np.asarray(st.pool_w[0]),
                                  np.asarray(ref.state.pool_w))


@needs_mesh
def test_sharded_rotation_defers_and_matches_sync(tmp_path):
    """The deferred start/finish split must produce the same submap DAG as
    the synchronous finalize_sharded, and the mesh after draining must
    contain both spheres (no content lost to deferral)."""
    from chad_tsdf_tpu.core import submap as submap_mod
    from chad_tsdf_tpu.core.dag import NodeLevels
    from chad_tsdf_tpu.parallel import sharded

    smap = ShardedTSDFMap(config=CFG, mesh=make_mesh(8))
    pts0 = sphere_points(2048, r=1.5, seed=21)
    smap.insert(pts0, np.zeros(3, np.float32))

    # synchronous oracle on the same (pre-rotation) sharded state
    levels_sync = NodeLevels(use_native=False)
    sm_sync = submap_mod.finalize_sharded(
        sharded.gather_states_device(smap.state_stack), levels_sync,
        CFG, list(smap._positions))

    far = np.float32([8.0, 0.0, 0.0])
    smap.insert(sphere_points(2048, r=1.5, seed=22, centre=(8.0, 0.0, 0.0)),
                far)
    assert len(smap._pending) == 1
    # the rotation must not have done ANY finalize work — no counter
    # readback, no compaction dispatch, no transfer (round 5: even the
    # counter fetch drains the dispatch pipeline mid-stream); everything
    # happens at drain
    pending = smap._pending[0]
    assert pending.inner is None, "finalize work ran at rotation"
    assert pending.state_stack is not None
    smap._drain_pending()
    assert pending.inner is not None        # ... and DOES happen at drain
    assert pending.state_stack is None      # pinned pools released
    sm_def = smap.submaps[0]

    c1, w1 = levels_sync.walk_leaf_clusters(sm_sync.root_addr_tsdf)
    c2, w2 = smap.levels.walk_leaf_clusters(sm_def.root_addr_tsdf)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(w1, w2)


def test_sharded_overflow_warns():
    """Lossy overflow on the sharded path must raise a UserWarning naming
    the config knob — not sit silently in stats (VERDICT r4 weak #3)."""
    import warnings as _w

    cfg = MapConfig(max_points=2048, block_capacity=64, touched_capacity=32,
                    accumulate_impl="xla")
    smap = ShardedTSDFMap(config=cfg, mesh=make_mesh(1))
    pts = sphere_points(2048, r=2.0, seed=30)
    smap.insert(pts, np.zeros(3, np.float32))
    with _w.catch_warnings(record=True) as rec:
        _w.simplefilter("always")
        smap.stats()
    msgs = [str(r.message) for r in rec]
    assert any("block_capacity" in m or "touched_capacity" in m
               for m in msgs), msgs

