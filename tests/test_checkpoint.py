"""Checkpoint round-trip tests (SURVEY §5.4 — no load path exists in the
reference; here the full map state must survive save/load bit-exactly)."""

import numpy as np

from chad_tsdf_tpu import MapConfig, TSDFMap
from chad_tsdf_tpu.io import load_checkpoint, save_checkpoint

SMALL = dict(max_points=2048, block_capacity=4096, touched_capacity=4096,
             accumulate_impl="xla")


def sphere_points(n, r=1.0, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def test_roundtrip_active_and_finalized(tmp_path):
    m = TSDFMap(config=MapConfig(**SMALL))
    m.insert(sphere_points(2048), np.zeros(3))
    m.finalize_active()
    m._start_submap(np.array([6.0, 0, 0], np.float32))
    m.insert(sphere_points(1024, seed=1) + np.array([6, 0, 0], np.float32),
             np.array([6.0, 0, 0]))

    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, m)
    m2 = load_checkpoint(p)

    assert len(m2.submaps) == len(m.submaps)
    assert int(m2.state.n_blocks) == int(m.state.n_blocks)
    np.testing.assert_array_equal(np.asarray(m2.state.pool_sd),
                                  np.asarray(m.state.pool_sd))
    np.testing.assert_array_equal(np.asarray(m2.state.pool_w),
                                  np.asarray(m.state.pool_w))
    c1, s1 = m.voxel_samples()
    c2, s2 = m2.voxel_samples()
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(s1, s2)

    # meshes identical
    mesh1 = m.extract_mesh()
    mesh2 = m2.extract_mesh()
    np.testing.assert_array_equal(mesh1.vertices, mesh2.vertices)
    np.testing.assert_array_equal(mesh1.faces, mesh2.faces)


def test_resume_continues_dedup(tmp_path):
    """Hash-consing must keep working after load: identical geometry added
    post-resume produces zero new unique nodes."""
    m = TSDFMap(config=MapConfig(**SMALL))
    pts = sphere_points(1024, seed=2)
    m.insert(pts, np.zeros(3))
    m.finalize_active()
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, m)

    m2 = load_checkpoint(p)
    u_before = [lv.uniques_n for lv in m2.levels.nodes]
    m2._start_submap(np.zeros(3, np.float32))
    m2.insert(pts, np.zeros(3))
    m2.finalize_active()
    assert [lv.uniques_n for lv in m2.levels.nodes] == u_before
    assert m2.submaps[0].root_addr_tsdf == m2.submaps[1].root_addr_tsdf


def test_insert_continues_after_load(tmp_path):
    m = TSDFMap(config=MapConfig(**SMALL))
    m.insert(sphere_points(1024, seed=3), np.zeros(3))
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, m)
    m2 = load_checkpoint(p)
    before = int(m2.state.n_blocks)
    m2.insert(sphere_points(1024, seed=4, r=1.2), np.zeros(3))
    assert int(m2.state.n_blocks) >= before


def test_elastic_recovery_after_crash(tmp_path):
    """SURVEY §5.3 failure recovery: kill a streaming run mid-mission,
    reload the last checkpoint, re-integrate only the scans since it, and
    require the recovered map to equal the uninterrupted run exactly
    (deterministic pipeline => bit-equal pools and DAGs)."""
    cfg = MapConfig(**SMALL)
    scans = [(sphere_points(1024, r=1.0 + 0.1 * i, seed=10 + i),
              np.zeros(3, np.float32)) for i in range(5)]

    # uninterrupted oracle
    oracle = TSDFMap(config=cfg)
    for pts, pos in scans:
        oracle.insert(pts, pos)

    # crashed run: checkpoint after scan 2, "lose" scans 3-4 in the crash
    victim = TSDFMap(config=cfg)
    for pts, pos in scans[:3]:
        victim.insert(pts, pos)
    ckpt = str(tmp_path / "mid.npz")
    save_checkpoint(ckpt, victim)
    victim.insert(*scans[3])          # integrated but never checkpointed
    del victim                        # the crash

    recovered = load_checkpoint(ckpt)
    for pts, pos in scans[3:]:        # re-integrate everything since ckpt
        recovered.insert(pts, pos)

    np.testing.assert_array_equal(np.asarray(recovered.state.pool_sd),
                                  np.asarray(oracle.state.pool_sd))
    np.testing.assert_array_equal(np.asarray(recovered.state.pool_w),
                                  np.asarray(oracle.state.pool_w))
    c1, s1 = oracle.voxel_samples()
    c2, s2 = recovered.voxel_samples()
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(s1, s2)


def test_counters_roundtrip_and_compact_pool(tmp_path):
    """v2 checkpoints: dedup counters survive load exactly and the active
    pool serializes only its occupied prefix."""
    cfg = MapConfig(**SMALL)
    m = TSDFMap(config=cfg)
    m.insert(sphere_points(2048), np.zeros(3))
    m.finalize_active()
    # force dupes: identical geometry again in a fresh submap
    m._start_submap(np.zeros(3, np.float32))
    m.insert(sphere_points(2048), np.zeros(3))
    m.finalize_active()
    m._start_submap(np.zeros(3, np.float32))
    m.insert(sphere_points(512, seed=3), np.zeros(3))

    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, m)
    m2 = load_checkpoint(p)
    assert m2.stats() == m.stats()    # uniques AND dupes identical

    # occupied-only: stored pool rows == n_blocks, not block_capacity
    z = np.load(p)
    assert z["active_pool_sd"].shape[0] == int(m.state.n_blocks)
    assert z["active_pool_sd"].shape[0] < cfg.block_capacity


def test_sharded_checkpoint_topology_elastic(tmp_path):
    """Checkpoint a ShardedTSDFMap (8 shards), resume on 4 shards AND on a
    single device; all three maps must agree voxel-for-voxel."""
    import jax
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from chad_tsdf_tpu.parallel import ShardedTSDFMap, make_mesh

    cfg = MapConfig(max_points=512, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl="xla")
    pts = sphere_points(4096, r=2.0, seed=13)
    pos = np.zeros(3, np.float32)

    m8 = ShardedTSDFMap(config=cfg, mesh=make_mesh(8))
    m8.insert(pts, pos)
    c0, s0 = m8.voxel_samples()

    p = str(tmp_path / "sharded.npz")
    save_checkpoint(p, m8)

    # resume single-device
    m1 = load_checkpoint(p)
    c1, s1 = m1.voxel_samples()
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_array_equal(s1, s0)

    # resume on a 4-device mesh and continue inserting
    m4 = load_checkpoint(p, mesh=make_mesh(4))
    c4, s4 = m4.voxel_samples()
    np.testing.assert_array_equal(c4, c0)
    np.testing.assert_array_equal(s4, s0)

    more = sphere_points(2048, r=1.0, seed=14)
    m4.insert(more, pos)
    m8.insert(more, pos)
    c4b, s4b = m4.voxel_samples()
    c8b, s8b = m8.voxel_samples()
    np.testing.assert_array_equal(c4b, c8b)
    # normals on 4 vs 8 shard splits differ at cut points; sd near-equal
    step = cfg.sdf_trunc / 127
    assert (np.abs(s4b - s8b) <= 2 * step).mean() > 0.98


def test_loads_checkpoint_with_removed_config_fields(tmp_path):
    """Checkpoints written before the kernel options were removed carry
    tile_nb / normals_impl / sparse_impl / sparse_tile_nb (and may name a
    removed accumulate backend); they must still load, to the same map."""
    import json

    m = TSDFMap(config=MapConfig(**SMALL))
    m.insert(sphere_points(2048), np.zeros(3))
    p = str(tmp_path / "new.npz")
    save_checkpoint(p, m)

    z = dict(np.load(p))
    meta = json.loads(bytes(z["__meta__"]).decode())
    meta["config"].update(tile_nb=48, normals_impl="auto", sparse_impl="seg",
                          sparse_tile_nb=128, sparse_points_per_block=64.0,
                          accumulate_impl="fused")
    z["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **z)

    m2 = load_checkpoint(old)
    assert m2.config.accumulate_impl == "auto"
    assert m2.config.block_capacity == SMALL["block_capacity"]
    c1, s1 = m.voxel_samples()
    c2, s2 = m2.voxel_samples()
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(s1, s2)

    meta["config"]["no_such_field"] = 1
    z["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(old, **z)
    import pytest
    with pytest.raises(TypeError):
        load_checkpoint(old)
