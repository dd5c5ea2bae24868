"""SPMD tests on the 8-device virtual CPU mesh (SURVEY §4: multi-host
without a cluster): the sharded insert must reproduce the single-device map
within float tolerance, lose zero samples under arbitrary skew, and keep
ownership exactly partitioned whenever no halo row was deferred."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from chad_tsdf_tpu.config import MapConfig
from chad_tsdf_tpu.core import integrate
from chad_tsdf_tpu.core.state import create_state, origin_blocks_for_position
from chad_tsdf_tpu.parallel import (create_sharded_state, gather_states,
                                    key_bounds, make_mesh,
                                    make_sharded_insert, morton_split)

CFG = MapConfig(max_points=512, block_capacity=4096, touched_capacity=2048,
                accumulate_impl="xla")

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def sphere_points(n, r=2.0, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def hotspot_points(n, seed=0, half=0.2):
    """All points inside one small region — the single-hotspot cloud that
    overflowed the round-2 sample routing (VERDICT weak #1)."""
    rng = np.random.default_rng(seed)
    return (np.float32([1.5, 1.5, 1.5]) +
            rng.uniform(-half, half, size=(n, 3)).astype(np.float32))


def pack_shards(chunks, cap):
    """Pad per-shard chunks to the static capacity; returns (points, n_per)."""
    n = len(chunks)
    pts = np.zeros((n * cap, 3), np.float32)
    n_per = np.zeros((n,), np.int32)
    for i, c in enumerate(chunks):
        assert len(c) <= cap
        pts[i * cap:i * cap + len(c)] = c
        n_per[i] = len(c)
    return pts, n_per


def run_sharded(pts, cfg=CFG, n_dev=8, split="morton", seed_pos=None,
                **step_kw):
    mesh = make_mesh(n_dev)
    pos = np.zeros(3, np.float32) if seed_pos is None else seed_pos
    origin = origin_blocks_for_position(pos, cfg)
    if split == "morton":
        chunks = morton_split(pts, n_dev, cfg.sdf_res)
    else:
        chunks = np.array_split(pts, n_dev)
    padded, n_per = pack_shards(chunks, cfg.max_points)
    state_stack = create_sharded_state(cfg, mesh, origin)
    step, _ = make_sharded_insert(cfg, mesh, **step_kw)
    bounds = jnp.asarray(key_bounds(n_dev, cfg))
    state_stack, metrics = step(state_stack, jnp.asarray(padded),
                                jnp.asarray(n_per), jnp.asarray(pos),
                                bounds)
    return state_stack, {k: int(v) for k, v in metrics.items()}, origin


def run_single(pts, cfg=CFG, origin=None):
    sd_cfg = MapConfig(**{**cfg.__dict__,
                          "max_points": max(len(pts), cfg.max_points),
                          "block_capacity": 16384,
                          "touched_capacity": 8192,
                          "accumulate_impl": "xla"})
    if origin is None:
        origin = origin_blocks_for_position(np.zeros(3, np.float32), sd_cfg)
    ref_state = create_state(sd_cfg, origin)
    padded = np.zeros((sd_cfg.max_points, 3), np.float32)
    padded[:len(pts)] = pts
    ref_state, m = integrate.insert_step(
        ref_state, jnp.asarray(padded), jnp.int32(len(pts)),
        jnp.zeros(3, jnp.float32), sd_cfg)
    return ref_state, sd_cfg, {k: int(v) for k, v in m.items()}


def merged_voxel_dict(states, cfg, allow_duplicates=False):
    from tests.test_integrate import pool_voxels
    out = {}
    for st in states:
        class S:  # pool_voxels expects attribute access with device arrays
            pass
        s = S()
        for k in ("dir_keys", "dir_slots", "pool_sd", "pool_w",
                  "origin_blocks"):
            setattr(s, k, np.asarray(getattr(st, k)))
        s.n_blocks = int(st.n_blocks)
        coords, sd, w = pool_voxels(s, cfg)
        for c, x, ww in zip(coords, sd, w):
            key = tuple(c)
            if key in out:
                assert allow_duplicates, "shards must own disjoint voxels"
                out[key] = (out[key][0] + x, out[key][1] + ww)
            else:
                out[key] = (x, ww)
    return out


@needs_mesh
def test_sharded_matches_single_device():
    pts = sphere_points(8 * CFG.max_points)
    state_stack, metrics, origin = run_sharded(pts)
    assert metrics["route_overflow"] == 0

    ref_state, sd_cfg, ref_metrics = run_single(pts, origin=origin)
    assert metrics["n_valid_samples"] == ref_metrics["n_valid_samples"]

    got = merged_voxel_dict(gather_states(state_stack), CFG)
    from tests.test_integrate import pool_voxels
    coords, sd, w = pool_voxels(ref_state, sd_cfg)
    want = {tuple(c): (x, ww) for c, x, ww in zip(coords, sd, w)}
    assert set(got) == set(want)
    diffs = []
    for k in want:
        assert got[k][1] == want[k][1]                  # identical weights
        diffs.append(abs(got[k][0] - want[k][0]))
    # signed distances differ only through normals: the Morton-contiguous
    # host split gives each shard a compact region, so neighbourhoods are
    # clipped only at the n-1 cut points.
    diffs = np.asarray(diffs)
    assert np.median(diffs) < 2e-3
    assert diffs.max() < 5e-2


@needs_mesh
def test_hotspot_zero_drops():
    """Single-hotspot cloud, adversarial random split: every shard's rows
    all target one owner — zero samples may be lost (VERDICT r2 task #1)."""
    pts = hotspot_points(8 * CFG.max_points, seed=7)
    state_stack, metrics, origin = run_sharded(pts, split="random")
    assert metrics["route_overflow"] == 0

    ref_state, sd_cfg, ref_metrics = run_single(pts, origin=origin)
    assert metrics["n_valid_samples"] == ref_metrics["n_valid_samples"]

    got = merged_voxel_dict(gather_states(state_stack), CFG)
    from tests.test_integrate import pool_voxels
    coords, sd, w = pool_voxels(ref_state, sd_cfg)
    want = {tuple(c): (x, ww) for c, x, ww in zip(coords, sd, w)}
    assert set(got) == set(want)
    for k in want:
        assert got[k][1] == want[k][1]   # every sample accounted for

    # the hotspot lives in one shard's range: that shard owns every block
    states = gather_states(state_stack)
    owners = [i for i, st in enumerate(states) if int(st.n_blocks) > 0]
    assert len(owners) == 1


@needs_mesh
def test_seg_impl_under_shard_map():
    """The 'seg' insert backend must run inside shard_map and give the
    single-device voxel set and weights."""
    cfg = MapConfig(max_points=1024, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl="seg")
    pts = sphere_points(8 * cfg.max_points, seed=5)
    state_stack, metrics, origin = run_sharded(pts, cfg=cfg)
    assert metrics["route_overflow"] == 0
    assert metrics["n_valid_samples"] > 0

    ref_state, sd_cfg, ref_metrics = run_single(pts, cfg=cfg, origin=origin)
    assert metrics["n_valid_samples"] == ref_metrics["n_valid_samples"]
    got = merged_voxel_dict(gather_states(state_stack), cfg)
    from tests.test_integrate import pool_voxels
    coords, sd, w = pool_voxels(ref_state, sd_cfg)
    want = {tuple(c): (x, ww) for c, x, ww in zip(coords, sd, w)}
    assert set(got) == set(want)
    for k in want:
        assert got[k][1] == want[k][1]


@needs_mesh
def test_ownership_partition():
    """With no deferred halo rows, every block a shard holds must be inside
    its Morton key range."""
    pts = sphere_points(8 * CFG.max_points, seed=3)
    state_stack, metrics, _ = run_sharded(pts, seed_pos=None)
    assert metrics["route_overflow"] == 0
    bounds = key_bounds(8, CFG)
    for d, st in enumerate(gather_states(state_stack)):
        nb = int(st.n_blocks)
        keys = np.asarray(st.dir_keys)[:nb]
        assert (keys >= bounds[d]).all() and (keys < bounds[d + 1]).all()


@needs_mesh
def test_sharded_determinism():
    n_dev = 8
    mesh = make_mesh(n_dev)
    pos = np.zeros(3, np.float32)
    origin = origin_blocks_for_position(pos, CFG)
    pts = sphere_points(n_dev * CFG.max_points, seed=4)
    chunks = morton_split(pts, n_dev, CFG.sdf_res)
    padded, n_per = pack_shards(chunks, CFG.max_points)
    step, _ = make_sharded_insert(CFG, mesh)
    bounds = jnp.asarray(key_bounds(n_dev, CFG))
    s1, _ = step(create_sharded_state(CFG, mesh, origin), jnp.asarray(padded),
                 jnp.asarray(n_per), jnp.asarray(pos), bounds)
    s2, _ = step(create_sharded_state(CFG, mesh, origin), jnp.asarray(padded),
                 jnp.asarray(n_per), jnp.asarray(pos), bounds)
    np.testing.assert_array_equal(np.asarray(s1.pool_sd),
                                  np.asarray(s2.pool_sd))


@needs_mesh
def test_deferred_rows_lossless():
    """Force a tiny halo capacity so rows defer: route_overflow > 0, yet the
    deferred rows stay in the sender's pool and finalize_sharded merges the
    duplicates exactly — zero loss end to end."""
    from chad_tsdf_tpu.core import submap as submap_mod
    from chad_tsdf_tpu.core.dag import NodeLevels

    # wider hotspot (~1 m cube -> dozens of blocks) + tiny per-pair capacity
    pts = hotspot_points(8 * CFG.max_points, seed=9, half=0.5)
    state_stack, metrics, origin = run_sharded(pts, split="random",
                                               halo_capacity=8)
    assert metrics["route_overflow"] > 0      # rows actually deferred

    # weights merged across duplicate blocks still match the oracle exactly
    ref_state, sd_cfg, ref_metrics = run_single(pts, origin=origin)
    assert metrics["n_valid_samples"] == ref_metrics["n_valid_samples"]
    got = merged_voxel_dict(gather_states(state_stack), CFG,
                            allow_duplicates=True)
    from tests.test_integrate import pool_voxels
    coords, sd, w = pool_voxels(ref_state, sd_cfg)
    want = {tuple(c): (x, ww) for c, x, ww in zip(coords, sd, w)}
    assert set(got) == set(want)
    for k in want:
        assert got[k][1] == want[k][1]

    # finalize merges duplicates pre-quantization: identical cluster codes
    levels = NodeLevels(use_native=False)
    sm = submap_mod.finalize_sharded(gather_states(state_stack), levels,
                                     CFG, [np.zeros(3, np.float32)])
    levels2 = NodeLevels(use_native=False)
    sm2 = submap_mod.finalize(ref_state, levels2, sd_cfg,
                              [np.zeros(3, np.float32)])
    codes_sh, words_sh = levels.walk_leaf_clusters(sm.root_addr_tsdf)
    codes_sd, words_sd = levels2.walk_leaf_clusters(sm2.root_addr_tsdf)
    np.testing.assert_array_equal(codes_sh, codes_sd)
    _, wsh = levels.walk_leaf_clusters(sm.root_addr_weight)
    _, wsd = levels2.walk_leaf_clusters(sm2.root_addr_weight)
    np.testing.assert_array_equal(wsh, wsd)   # weights quantize identically


@needs_mesh
def test_sharded_finalize_matches_single_device():
    """finalize_sharded over per-shard states == single-device finalize."""
    from chad_tsdf_tpu.core import submap as submap_mod
    from chad_tsdf_tpu.core.dag import NodeLevels

    pts = sphere_points(8 * CFG.max_points, seed=11)
    state_stack, metrics, origin = run_sharded(pts)
    assert metrics["route_overflow"] == 0

    levels = NodeLevels(use_native=False)
    sm = submap_mod.finalize_sharded(gather_states(state_stack), levels,
                                     CFG, [np.zeros(3, np.float32)])
    codes_sh, words_sh = levels.walk_leaf_clusters(sm.root_addr_tsdf)

    ref_state, sd_cfg, _ = run_single(pts, origin=origin)
    levels2 = NodeLevels(use_native=False)
    sm2 = submap_mod.finalize(ref_state, levels2, sd_cfg,
                              [np.zeros(3, np.float32)])
    codes_sd, words_sd = levels2.walk_leaf_clusters(sm2.root_addr_tsdf)

    np.testing.assert_array_equal(codes_sh, codes_sd)
    # words may differ in the last quantization bit where normals differ at
    # shard boundaries; must be overwhelmingly identical
    same = (words_sh == words_sd).mean()
    assert same > 0.97, same


@needs_mesh
def test_adaptive_bounds_and_owner_split():
    """Unit coverage for the occupancy-adaptive ownership helpers: bounds
    are monotone and span the key space; owner_split assigns every point
    to the shard owning its block; rebalance_chunks caps per-shard counts
    without losing points."""
    from chad_tsdf_tpu.core.state import origin_blocks_for_position
    from chad_tsdf_tpu.parallel import (adaptive_bounds, owner_split,
                                        point_block_keys)
    from chad_tsdf_tpu.parallel.sharded import rebalance_chunks

    pts = sphere_points(8192, r=2.0, seed=13)
    origin = origin_blocks_for_position(np.zeros(3, np.float32), CFG)
    bounds = adaptive_bounds(pts, origin, 8, CFG)
    assert bounds.shape == (9,)
    assert bounds[0] == 0 and int(bounds[-1]) == 1 << (3 * CFG.block_bits)
    assert (np.diff(bounds.astype(np.int64)) >= 0).all()

    chunks = owner_split(pts, bounds, origin, CFG)
    assert sum(len(c) for c in chunks) == len(pts)
    for me, c in enumerate(chunks):
        if len(c) == 0:
            continue
        keys = point_block_keys(c, origin, CFG)
        owner = np.clip(np.searchsorted(bounds, keys, side="right") - 1,
                        0, 7)
        assert (owner == me).all()

    # force skew, then rebalance into a tight cap
    skewed = [pts[:5000], pts[5000:5100]] + [pts[:0]] * 6
    cap = 1024
    out = rebalance_chunks(skewed, cap)
    assert all(len(c) <= cap for c in out)
    assert sum(len(c) for c in out) == 5100
