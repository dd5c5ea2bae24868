"""Space carving (core/carve.py) — the reference roadmap's last unbuilt
item (reference README.md:60).

Strategy: a numpy oracle replicates the carve sampling rule from its
definition (strided free-space samples, floor-voxelization, dedup to
per-voxel counts, allocated-blocks-only).  The bit-exact comparison uses
axis-aligned rays, where every f32 intermediate (r, u, u*t + p) is exact,
so XLA fma/fusion rounding cannot shift a sample across a voxel boundary;
generic geometry is covered end-to-end by the stale-wall mesh-erosion
test.
"""

import dataclasses

import jax
import numpy as np
import pytest

from chad_tsdf_tpu.config import MapConfig
from chad_tsdf_tpu.core import carve, integrate
from chad_tsdf_tpu.core.map import TSDFMap
from chad_tsdf_tpu.core.state import create_state, origin_blocks_for_position
from chad_tsdf_tpu.ops import morton


CFG = MapConfig(max_points=4096, block_capacity=4096,
                touched_capacity=1024, block_bits=7,
                accumulate_impl="xla",
                carve_steps=40, carve_stride=2.0, carve_subsample=1,
                carve_weight=1.0)

AXES = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                 [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)


def _pad(points, n_max):
    out = np.zeros((n_max, 3), np.float32)
    out[:len(points)] = points
    return out


def _wall(x, n=400, half=0.5, seed=0):
    """n points on the plane X=x, spread over [-half, half]^2 in (y, z)."""
    rng = np.random.default_rng(seed)
    yz = rng.uniform(-half, half, (n, 2))
    return np.column_stack([np.full(n, x, np.float32),
                            yz[:, 0], yz[:, 1]]).astype(np.float32)


def _carve_oracle_counts(points, position, config, origin_blocks):
    """Per-voxel free-space sample counts, straight from the definition
    (f32 arithmetic mirroring core/carve.carve_sample_keys)."""
    counts = {}
    extent = config.blocks_per_axis * 8
    ov = np.asarray(origin_blocks, np.int64) * 8
    pos = np.asarray(position, np.float32)
    inv = np.float32(1.0 / config.sdf_res)
    step_m = np.float32(config.carve_stride * config.sdf_res)
    trunc = np.float32(config.sdf_trunc)
    for p in np.asarray(points, np.float32)[::config.carve_subsample]:
        d = p - pos
        r = np.float32(np.sqrt(np.float32(
            d[0] * d[0] + d[1] * d[1] + d[2] * d[2])))
        safe = max(r, np.float32(1e-12))
        u = d / safe
        limit = r - trunc
        for i in range(config.carve_steps):
            t = np.float32(np.float32(i + 0.5) * step_m)
            if not t < limit:
                continue
            q = pos + u * t                       # f32 each component
            l = np.floor(q * inv).astype(np.int64) - ov
            if np.any(l < 0) or np.any(l >= extent):
                continue
            counts[tuple(l)] = counts.get(tuple(l), 0) + 1
    return counts


def test_carve_matches_oracle_and_never_allocates():
    """Axis-aligned rays: device pool deltas equal the oracle's per-voxel
    counts exactly, carving touches only allocated blocks and never
    allocates."""
    position = np.zeros(3, np.float32)
    # scan A allocates corridor blocks: returns laddered along each axis
    ladder = np.concatenate([AXES * k for k in
                             np.arange(0.4, 2.81, 0.2, dtype=np.float32)])
    pts_a = _pad(ladder, CFG.max_points)
    state = create_state(CFG, origin_blocks_for_position(position, CFG))
    state, _ = integrate.insert_step(state, pts_a, np.int32(len(ladder)),
                                     position, CFG)
    n_blocks0 = int(state.n_blocks)
    sd0 = np.asarray(state.pool_sd).copy()
    w0 = np.asarray(state.pool_w).copy()

    # scan B carves: one 3 m return along each axis (u exactly +-1)
    rays = AXES * np.float32(3.0)
    pts_b = _pad(rays, CFG.max_points)
    state, metrics = carve.carve_step(state, pts_b, np.int32(len(rays)),
                                      position, CFG)
    assert int(state.n_blocks) == n_blocks0          # erosion-only
    assert int(state.block_overflow) == 0

    dir_keys = np.asarray(state.dir_keys)
    dir_slots = np.asarray(state.dir_slots)
    live = dir_keys != np.int32(2**31 - 1)
    key_to_slot = dict(zip(dir_keys[live].tolist(),
                           dir_slots[live].tolist()))

    oracle = _carve_oracle_counts(rays, position, CFG,
                                  np.asarray(state.origin_blocks))
    assert oracle                                    # sampling happened

    d_sd = np.asarray(state.pool_sd) - sd0
    d_w = np.asarray(state.pool_w) - w0
    total = 0
    for (lx, ly, lz), c in oracle.items():
        bkey = int(morton.encode_block(lx >> 3, ly >> 3, lz >> 3))
        okey = int(morton.encode_offset(lx & 7, ly & 7, lz & 7))
        slot = key_to_slot.get(bkey)
        if slot is None:
            continue                      # unallocated: dropped by design
        total += c
        np.testing.assert_allclose(d_w[slot, okey], c * CFG.carve_weight,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            d_sd[slot, okey], c * CFG.sdf_trunc * CFG.carve_weight,
            rtol=1e-6)
    assert total > 0
    # nothing outside the oracle's voxels changed: total mass matches
    np.testing.assert_allclose(d_w.sum(), total * CFG.carve_weight,
                               rtol=1e-6)
    assert int(metrics["n_carve_samples"]) == total
    assert int(metrics["n_carve_dropped"]) == \
        sum(oracle.values()) - total


def test_carve_spares_own_truncation_band():
    """A ray's free-space samples stop sdf_trunc short of its return: no
    carve mass lands at or beyond the band-start voxel of a frontal wall."""
    position = np.zeros(3, np.float32)
    wall = _wall(2.0, seed=3)
    pts = _pad(wall, CFG.max_points)
    n = np.int32(len(wall))

    state = create_state(CFG, origin_blocks_for_position(position, CFG))
    state, _ = integrate.insert_step(state, pts, n, position, CFG)
    w0 = np.asarray(state.pool_w).copy()
    state, _ = carve.carve_step(state, pts, n, position, CFG)
    d_w = np.asarray(state.pool_w) - w0

    ov = np.asarray(state.origin_blocks)
    dir_keys = np.asarray(state.dir_keys)
    dir_slots = np.asarray(state.dir_slots)
    live = dir_keys != np.int32(2**31 - 1)
    # the stop rule is along the RAY: t < r - trunc, so a sample's
    # x-projection is bounded by 2 * (r - trunc) / r = 2 - 2*trunc/r,
    # maximized by the longest (most oblique) ray to the wall corners
    r_max = np.sqrt(2.0 ** 2 + 2 * 0.5 ** 2)
    x_band = int(np.floor(
        (2.0 - 2.0 * CFG.sdf_trunc / r_max) / CFG.sdf_res))
    carved = 0
    for bkey, slot in zip(dir_keys[live], dir_slots[live]):
        bx = int(morton.compact3_10(int(bkey)))
        for okey in np.flatnonzero(d_w[slot] != 0):
            ox = int(morton.compact3_3(int(okey)))
            vx = (bx * 8 + ox) + int(ov[0]) * 8
            carved += 1
            assert vx <= x_band, (
                f"carve mass beyond the band start at voxel x={vx}")
    assert carved > 0


def test_carve_erodes_stale_wall_from_mesh():
    """A wall is mapped, then disappears; subsequent scans observe through
    its position.  With carving on, the wall's zero crossing — and its
    mesh — is gone; the real far surface stays.  Without carving the
    residue persists (the failure mode carving exists to fix)."""
    # stride 1.0: consecutive samples sit closer than a voxel along the
    # ray (0.047 m in x for these rays), so every voxel of a crossed
    # column receives evidence; range 48 * 1.0 * 0.05 = 2.4 m... too
    # short for the 4 m rays -> 96 steps = 4.8 m
    cfg = dataclasses.replace(CFG, carve_steps=96, carve_stride=1.0)
    m = TSDFMap(config=cfg)
    position = np.float32([0, 0, 0])
    m.insert(_wall(2.0, n=800, seed=1), position)   # the (dynamic) object
    mesh0 = m.extract_mesh()
    near0 = np.sum(np.abs(mesh0.vertices[:, 0] - 2.0) < 0.15)
    assert near0 > 0                                # wall is in the mesh

    # object moves away: 16 scans now see a far wall at x = 4, wide
    # enough (half 1.2) that its rays blanket the old wall's full extent
    for i in range(16):
        m.insert(_wall(4.0, n=800, half=1.2, seed=10 + i), position)

    mesh1 = m.extract_mesh()
    near1 = np.sum(np.abs(mesh1.vertices[:, 0] - 2.0) < 0.15)
    far1 = np.sum(np.abs(mesh1.vertices[:, 0] - 4.0) < 0.15)
    assert near1 == 0, f"stale wall still meshed ({near1} verts)"
    assert far1 > 0                                 # real surface intact

    m2 = TSDFMap(config=dataclasses.replace(cfg, carve_steps=0))
    m2.insert(_wall(2.0, n=800, seed=1), position)
    for i in range(16):
        m2.insert(_wall(4.0, n=800, half=1.2, seed=10 + i), position)
    mesh2 = m2.extract_mesh()
    assert np.sum(np.abs(mesh2.vertices[:, 0] - 2.0) < 0.15) > 0


def test_carve_packed_matches_float():
    """The packed-ingest carve path equals the float path on points that
    sit exactly on the packing grid (res/8 multiples round-trip)."""
    position = np.zeros(3, np.float32)
    grid_pts = AXES * np.float32(2.5)          # multiples of res/8
    states = []
    for packed in (False, True):
        cfg = dataclasses.replace(CFG, packed_ingest=packed)
        m = TSDFMap(config=cfg)
        m.insert(grid_pts, position)
        states.append((np.asarray(m.state.pool_sd),
                       np.asarray(m.state.pool_w)))
    np.testing.assert_array_equal(states[0][0], states[1][0])
    np.testing.assert_array_equal(states[0][1], states[1][1])


def test_carve_deterministic():
    position = np.zeros(3, np.float32)
    wall = _wall(3.0, seed=7)
    pts = _pad(wall, CFG.max_points)
    n = np.int32(len(wall))
    pools = []
    for _ in range(2):
        state = create_state(CFG, origin_blocks_for_position(position, CFG))
        state, _ = integrate.insert_step(state, pts, n, position, CFG)
        state, _ = carve.carve_step(state, pts, n, position, CFG)
        pools.append((np.asarray(state.pool_sd), np.asarray(state.pool_w)))
    np.testing.assert_array_equal(pools[0][0], pools[1][0])
    np.testing.assert_array_equal(pools[0][1], pools[1][1])


def test_carve_off_by_default_and_validation():
    assert MapConfig().carve_steps == 0
    with pytest.raises(ValueError):
        MapConfig(carve_steps=8, carve_weight=0.0)
    with pytest.raises(ValueError):
        MapConfig(carve_steps=-1)


def test_sharded_carve_n1_matches_single_device_exactly():
    """At N=1 the sharded carve step runs the identical body on the
    identical replicated scan: pools bit-equal to TSDFMap with carving."""
    from chad_tsdf_tpu.parallel import ShardedTSDFMap, make_mesh

    position = np.zeros(3, np.float32)
    wall = _wall(2.5, n=600, seed=5)
    cfg = dataclasses.replace(CFG, max_points=1024)

    smap = ShardedTSDFMap(config=cfg, mesh=make_mesh(1))
    ref = TSDFMap(config=cfg)
    for beg in range(0, len(wall), 1024):
        smap.insert(wall[beg:beg + 1024], position)
        ref.insert(wall[beg:beg + 1024], position)

    st = smap.state_stack
    np.testing.assert_array_equal(np.asarray(st.pool_sd[0]),
                                  np.asarray(ref.state.pool_sd))
    np.testing.assert_array_equal(np.asarray(st.pool_w[0]),
                                  np.asarray(ref.state.pool_w))
    assert int(smap.last_metrics["n_carve_samples"]) == \
        int(ref.last_metrics["n_carve_samples"])


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_carve_erodes_stale_wall():
    """The sharded map with carving erodes a stale wall exactly like the
    single-device path: erosion-only replication applies each free-space
    sample on whichever shard holds its block."""
    from chad_tsdf_tpu.parallel import ShardedTSDFMap, make_mesh

    cfg = dataclasses.replace(CFG, carve_steps=96, carve_stride=1.0,
                              max_points=1024)
    m = ShardedTSDFMap(config=cfg, mesh=make_mesh(8))
    position = np.float32([0, 0, 0])
    stale = _wall(2.0, n=800, seed=1)
    for beg in range(0, len(stale), 1024):
        m.insert(stale[beg:beg + 1024], position)
    near0 = np.sum(np.abs(m.extract_mesh().vertices[:, 0] - 2.0) < 0.15)
    assert near0 > 0

    for i in range(16):
        far = _wall(4.0, n=800, half=1.2, seed=10 + i)
        for beg in range(0, len(far), 1024):
            m.insert(far[beg:beg + 1024], position)
    met = m.last_metrics
    assert int(met["n_carve_samples"]) > 0
    assert int(met["n_carve_dropped"]) >= 0

    mesh1 = m.extract_mesh()
    near1 = np.sum(np.abs(mesh1.vertices[:, 0] - 2.0) < 0.15)
    far1 = np.sum(np.abs(mesh1.vertices[:, 0] - 4.0) < 0.15)
    assert near1 == 0, f"stale wall still meshed ({near1} verts)"
    assert far1 > 0
