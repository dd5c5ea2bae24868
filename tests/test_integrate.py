"""Integration-step tests against the analytic sphere oracle (SURVEY §4:
for points on a radius-5 sphere scanned from the centre, the true signed
distance at voxel v is ``5 - |v|`` in the map's convention — positive toward
the scanner, negative behind the surface)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from chad_tsdf_tpu.config import MapConfig
from chad_tsdf_tpu.core import integrate
from chad_tsdf_tpu.core.state import create_state, origin_blocks_for_position

CFG = MapConfig(max_points=4096, block_capacity=4096, touched_capacity=4096,
                accumulate_impl="xla")


def sphere_points(n, r=5.0, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def run_insert(cfg, pts, pos, state=None):
    if state is None:
        state = create_state(cfg, origin_blocks_for_position(pos, cfg))
    n = pts.shape[0]
    pad = np.zeros((cfg.max_points, 3), np.float32)
    pad[:n] = pts
    return integrate.insert_step(state, jnp.asarray(pad), jnp.int32(n),
                                 jnp.asarray(pos, jnp.float32), cfg)


def pool_voxels(state, cfg):
    """Extract (world voxel coords, mean sd, weight) from the pool."""
    from chad_tsdf_tpu.ops import morton
    nb = int(state.n_blocks)
    keys = np.asarray(state.dir_keys)[:nb]
    slots = np.asarray(state.dir_slots)[:nb]
    w = np.asarray(state.pool_w)[slots]
    sd = np.asarray(state.pool_sd)[slots] / np.maximum(w, 1)
    bx, by, bz = (np.asarray(morton.decode_block(jnp.asarray(keys))[i])
                  for i in range(3))
    origin = np.asarray(state.origin_blocks)
    out = []
    offs = np.arange(512)
    ox = np.asarray(morton.decode_offset(jnp.asarray(offs))[0])
    oy = np.asarray(morton.decode_offset(jnp.asarray(offs))[1])
    oz = np.asarray(morton.decode_offset(jnp.asarray(offs))[2])
    coords = np.stack([
        (bx[:, None] + origin[0]) * 8 + ox[None, :],
        (by[:, None] + origin[1]) * 8 + oy[None, :],
        (bz[:, None] + origin[2]) * 8 + oz[None, :],
    ], axis=-1)
    occ = w > 0
    return coords[occ], sd[occ], w[occ]


def test_sphere_oracle():
    pts = sphere_points(4096)
    pos = np.zeros(3, np.float32)
    state, metrics = run_insert(CFG, pts, pos)
    assert int(metrics["n_valid_samples"]) > 4096 * 4
    coords, sd, w = pool_voxels(state, CFG)
    assert coords.shape[0] > 1000
    r = np.linalg.norm(coords * CFG.sdf_res, axis=1)
    want = np.clip(5.0 - r, -CFG.sdf_trunc, CFG.sdf_trunc)
    err = np.abs(sd - want)
    assert np.median(err) < 0.01
    assert np.percentile(err, 95) < 0.05


def test_no_overflow_counters():
    pts = sphere_points(4096)
    state, _ = run_insert(CFG, pts, np.zeros(3, np.float32))
    assert int(state.point_overflow) == 0
    assert int(state.sample_overflow) == 0
    assert int(state.block_overflow) == 0
    assert int(state.touched_overflow) == 0


def _check_against_bruteforce(cfg, pts, pos):
    """Pool contents must equal a scalar DDA + dict accumulation oracle."""
    from tests.test_dda import scalar_dda

    n = pts.shape[0]
    state, _ = run_insert(cfg, pts, pos)
    coords, sd, w = pool_voxels(state, cfg)
    got = {tuple(c): (s, ww) for c, s, ww in zip(coords, sd, w)}

    # oracle: same normals as the pipeline (read them via the same path)
    import jax.lax as lax
    from chad_tsdf_tpu.ops import morton, normals
    local, _ = morton.points_to_local_voxels(
        jnp.asarray(pts), jnp.asarray(state.origin_blocks) * 8,
        cfg.blocks_per_axis * 8, cfg.sdf_res)
    bk = morton.encode_block(local[:, 0] >> 3, local[:, 1] >> 3, local[:, 2] >> 3)
    ok = morton.encode_offset(local[:, 0] & 7, local[:, 1] & 7, local[:, 2] & 7)
    sb, so, perm = lax.sort((bk, ok, jnp.arange(n, dtype=jnp.int32)),
                            num_keys=2)
    pts_s = np.asarray(jnp.asarray(pts)[perm])
    nrm = np.asarray(normals.estimate_normals(
        jnp.asarray(pts_s), sb, so, jnp.ones(n, bool), jnp.asarray(pos)))

    acc: dict = {}
    for i in range(n):
        for v in scalar_dda(pts_s[i], pos, cfg.sdf_res, cfg.sdf_trunc):
            vpos = np.array(v, np.float64) * cfg.sdf_res
            s = float(np.dot(nrm[i], vpos - pts_s[i]))
            s = np.clip(s, -cfg.sdf_trunc, cfg.sdf_trunc)
            ssum, cnt = acc.get(v, (0.0, 0))
            acc[v] = (ssum + s, cnt + 1)

    assert set(got) == set(acc)
    for v, (ssum, cnt) in acc.items():
        s_got, w_got = got[v]
        assert w_got == cnt
        np.testing.assert_allclose(s_got, ssum / cnt, atol=1e-4)


def test_accumulation_matches_bruteforce():
    cfg = MapConfig(max_points=128, block_capacity=1024, touched_capacity=1024,
                    accumulate_impl="xla")
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    _check_against_bruteforce(cfg, pts, np.array([0.0, 0.0, 3.0], np.float32))


@pytest.mark.parametrize("impl", ["xla", "seg"])
@pytest.mark.parametrize("radius", [
    0.25,    # dense: hundreds of samples per touched block
    1.0,     # medium: plane fits dominate the normals
    5.0,     # sparse: ~1 point per block, mostly fallback normals
])
def test_impl_matches_bruteforce(impl, radius):
    cfg = MapConfig(max_points=256, block_capacity=2048,
                    touched_capacity=2048, accumulate_impl=impl)
    _check_against_bruteforce(cfg, sphere_points(256, r=radius, seed=4),
                              np.zeros(3, np.float32))


def test_incremental_matches_batch():
    """Two inserts must accumulate like the sum of both (associativity)."""
    pts = sphere_points(2048, seed=5)
    pos = np.zeros(3, np.float32)
    state, _ = run_insert(CFG, pts[:1024], pos)
    state, _ = run_insert(CFG, pts[1024:], pos, state=state)
    c2, sd2, w2 = pool_voxels(state, CFG)

    state_b, _ = run_insert(CFG, pts, pos)
    cb, sdb, wb = pool_voxels(state_b, CFG)
    a = {tuple(c): (s, ww) for c, s, ww in zip(c2, sd2, w2)}
    b = {tuple(c): (s, ww) for c, s, ww in zip(cb, sdb, wb)}
    assert set(a) == set(b)
    for k in a:
        assert a[k][1] == b[k][1]
        np.testing.assert_allclose(a[k][0], b[k][0], atol=1e-4)


def test_determinism():
    pts = sphere_points(2048, seed=6)
    pos = np.zeros(3, np.float32)
    s1, _ = run_insert(CFG, pts, pos)
    s2, _ = run_insert(CFG, pts, pos)
    np.testing.assert_array_equal(np.asarray(s1.pool_sd), np.asarray(s2.pool_sd))
    np.testing.assert_array_equal(np.asarray(s1.pool_w), np.asarray(s2.pool_w))
    np.testing.assert_array_equal(np.asarray(s1.dir_keys),
                                  np.asarray(s2.dir_keys))


def test_sort_points_order_contract():
    """sort_points_soa must produce exact (bkey, okey) lexicographic order
    with the INT32_MAX padding tail last, whatever its implementation."""
    rng = np.random.default_rng(7)
    n = 8192
    bkey = rng.integers(0, 500, n).astype(np.int32)
    okey = rng.integers(0, 512, n).astype(np.int32)
    bkey[rng.random(n) < 0.1] = np.int32(2**31 - 1)   # padding sentinels
    okey[bkey == 2**31 - 1] = np.int32(2**31 - 1)
    px = rng.normal(size=n).astype(np.float32)
    py = rng.normal(size=n).astype(np.float32)
    pz = rng.normal(size=n).astype(np.float32)

    sb, so, sx, sy, sz = integrate.sort_points_soa(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz),
        jnp.asarray(bkey), jnp.asarray(okey))
    rb, ro = jax.lax.sort((jnp.asarray(bkey), jnp.asarray(okey)), num_keys=2)
    np.testing.assert_array_equal(np.asarray(sb), np.asarray(rb))
    np.testing.assert_array_equal(np.asarray(so), np.asarray(ro))
    # coords still pair with their keys: recompute each point's key from the
    # sorted coords via the original mapping
    key_of = {}
    for i in range(n):
        key_of.setdefault((px[i], py[i], pz[i]), []).append(
            (int(bkey[i]), int(okey[i])))
    sx_n, sy_n, sz_n = np.asarray(sx), np.asarray(sy), np.asarray(sz)
    for i in range(0, n, 97):
        pair = (int(np.asarray(sb)[i]), int(np.asarray(so)[i]))
        assert pair in key_of[(sx_n[i], sy_n[i], sz_n[i])]


def test_seg_impl_matches_xla():
    """Differential: the sparse 'seg' path (voxel-sorted segment reduction
    + compacted scatter) must reproduce the XLA scatter oracle — identical
    directory, block count, exact weights; sd within the reassociation
    rounding of pre-summed segments (far below codec granularity)."""
    import dataclasses

    from chad_tsdf_tpu.io.kitti import synthetic_lidar_scan

    cfg_x = dataclasses.replace(CFG, accumulate_impl="xla",
                                block_capacity=1 << 14,
                                touched_capacity=1 << 13)
    cfg_s = dataclasses.replace(cfg_x, accumulate_impl="seg")

    lidar = synthetic_lidar_scan([0.0, 0.0, 0.0], seed=3)
    lidar = lidar[:: max(1, len(lidar) // 4096)][:4096]
    cases = [
        (sphere_points(4096), np.zeros(3, np.float32)),        # dense
        (lidar.astype(np.float32), np.float32([0, 0, 1.7])),   # sparse
    ]
    for pts, pos in cases:
        st_x = m_x = st_s = m_s = None
        for it in range(2):                 # fresh + steady-state insert
            st_x, m_x = run_insert(cfg_x, pts, pos, state=st_x)
            st_s, m_s = run_insert(cfg_s, pts, pos, state=st_s)
        assert int(st_x.n_blocks) == int(st_s.n_blocks)
        np.testing.assert_array_equal(np.asarray(st_x.dir_keys),
                                      np.asarray(st_s.dir_keys))
        np.testing.assert_array_equal(np.asarray(st_x.dir_slots),
                                      np.asarray(st_s.dir_slots))
        np.testing.assert_array_equal(np.asarray(st_x.pool_w),
                                      np.asarray(st_s.pool_w))
        np.testing.assert_allclose(np.asarray(st_x.pool_sd),
                                   np.asarray(st_s.pool_sd),
                                   rtol=0, atol=1e-5)
        for k in ("n_valid_samples", "n_touched_blocks", "n_blocks"):
            assert int(m_x[k]) == int(m_s[k]), k
        assert int(st_x.tile_overflow) == 0 and int(st_s.tile_overflow) == 0


def test_seg_impl_entry_bucket_branches():
    """The seg path's entry-bucket lax.switch must be exact in every
    branch: tiny clouds (S/4 bucket) and a pathological all-unique cloud
    that forces the full-S bucket both match the oracle."""
    import dataclasses

    cfg_x = dataclasses.replace(CFG, accumulate_impl="xla",
                                block_capacity=1 << 14,
                                touched_capacity=1 << 13)
    cfg_s = dataclasses.replace(cfg_x, accumulate_impl="seg")
    rng = np.random.default_rng(11)
    # widely scattered points: nearly every DDA sample lands in its own
    # voxel, pushing e_total toward S
    pts = rng.uniform(-100, 100, (4096, 3)).astype(np.float32)
    tiny = sphere_points(64, r=1.0)
    for pts_i in (tiny, pts):
        st_x, _ = run_insert(cfg_x, pts_i, np.zeros(3, np.float32))
        st_s, _ = run_insert(cfg_s, pts_i, np.zeros(3, np.float32))
        assert int(st_x.n_blocks) == int(st_s.n_blocks)
        np.testing.assert_array_equal(np.asarray(st_x.pool_w),
                                      np.asarray(st_s.pool_w))
        np.testing.assert_allclose(np.asarray(st_x.pool_sd),
                                   np.asarray(st_s.pool_sd),
                                   rtol=0, atol=1e-5)


def test_insert_steps_scan_matches_looped():
    """One-dispatch multi-step insert (lax.scan) must produce the identical
    state as the equivalent Python loop of insert_step calls."""
    cfg = CFG
    pts = sphere_points(2048)
    pos = np.zeros(3, np.float32)
    pad = np.zeros((cfg.max_points, 3), np.float32)
    pad[:2048] = pts
    points = jnp.asarray(pad)

    st_loop = create_state(cfg, origin_blocks_for_position(pos, cfg))
    for _ in range(3):
        st_loop, _ = integrate.insert_step(st_loop, points, jnp.int32(2048),
                                           jnp.asarray(pos), cfg)
    st_scan = create_state(cfg, origin_blocks_for_position(pos, cfg))
    st_scan = integrate.insert_steps_scan(st_scan, points, jnp.int32(2048),
                                          jnp.asarray(pos), cfg, 3)
    np.testing.assert_array_equal(np.asarray(st_loop.dir_keys),
                                  np.asarray(st_scan.dir_keys))
    np.testing.assert_array_equal(np.asarray(st_loop.pool_w),
                                  np.asarray(st_scan.pool_w))
    np.testing.assert_allclose(np.asarray(st_loop.pool_sd),
                               np.asarray(st_scan.pool_sd), rtol=0, atol=0)


@pytest.mark.parametrize("n_live", [40, 900])   # small and full row bucket
def test_update_pool_rows_matches_dense_add(n_live):
    """The sharded merge's row scatter must equal a dense numpy add of every
    row into its block's pool row (duplicate keys sum, empty keys drop)."""
    cfg = MapConfig(max_points=128, block_capacity=1024,
                    touched_capacity=512)
    rng = np.random.default_rng(n_live)
    p = 1024
    keys = np.full(p, 2**31 - 1, np.int32)
    keys[:n_live] = rng.integers(0, 300, n_live)         # with duplicates
    rng.shuffle(keys)
    psd = rng.uniform(-1, 1, (p, 512)).astype(np.float32)
    pw = rng.integers(0, 4, (p, 512)).astype(np.float32)

    state = create_state(cfg)
    state, metrics = integrate.update_pool_rows(
        state, jnp.asarray(keys), jnp.asarray(psd), jnp.asarray(pw),
        jnp.int32(0), jnp.int32(0), jnp.int32(0), cfg)

    uniq = np.unique(keys[keys != 2**31 - 1])
    assert int(state.n_blocks) == len(uniq)
    assert int(metrics["n_touched_blocks"]) == len(uniq)
    dk = np.asarray(state.dir_keys)[:len(uniq)]
    slots = np.asarray(state.dir_slots)[:len(uniq)]
    np.testing.assert_array_equal(dk, uniq)
    for k, slot in zip(dk, slots):
        sel = keys == k
        np.testing.assert_allclose(np.asarray(state.pool_sd)[slot],
                                   psd[sel].sum(0), rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(state.pool_w)[slot],
                                      pw[sel].sum(0))
    # nothing lands outside the allocated rows
    used = np.zeros(cfg.block_capacity, bool)
    used[slots] = True
    assert not np.asarray(state.pool_w)[~used].any()
