"""backend.choose — the one place that resolves the ``auto`` options."""

import itertools

import numpy as np
import pytest

from chad_tsdf_tpu import MapConfig, backend

_EXPECT_AUTO_MESH = {"gpu": "device", "cpu": "host"}


@pytest.mark.parametrize(
    "platform,insert,mesh",
    list(itertools.product(("gpu", "cpu"), ("auto", "xla", "seg"),
                           ("auto", "device", "host"))))
def test_choose(platform, insert, mesh):
    cfg = MapConfig(accumulate_impl=insert, mesh_impl=mesh)
    got = backend.choose(cfg, platform)
    # an explicit option always wins; auto inserts with xla everywhere
    assert got.insert == ("xla" if insert == "auto" else insert)
    assert got.mesh == (_EXPECT_AUTO_MESH[platform] if mesh == "auto"
                        else mesh)


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL"])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.choose(MapConfig(), platform)


def test_default_platform_is_jax_default_backend():
    import jax
    assert backend.choose(MapConfig()) == backend.choose(
        MapConfig(), jax.default_backend())


@pytest.mark.parametrize("removed", ["fused", "tile", "sample_tile",
                                     "pallas"])
def test_removed_accumulate_impls_are_rejected(removed):
    with pytest.raises(ValueError, match="accumulate_impl"):
        MapConfig(accumulate_impl=removed)


def _dense_cloud():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(4096, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * 0.5).astype(np.float32), np.zeros(3, np.float32)


def _sparse_cloud():
    from chad_tsdf_tpu.io.kitti import synthetic_lidar_scan
    pts = synthetic_lidar_scan([0.0, 0.0, 0.0], seed=1)[::32][:4096]
    return pts.astype(np.float32), np.float32([0.0, 0.0, 1.7])


@pytest.mark.parametrize("cloud", [_dense_cloud, _sparse_cloud],
                         ids=["dense", "sparse"])
def test_auto_insert_ignores_density(cloud):
    """Whatever the cloud's density, 'auto' runs exactly the xla path."""
    from chad_tsdf_tpu import TSDFMap

    pts, pos = cloud()
    kw = dict(max_points=4096, block_capacity=1 << 13,
              touched_capacity=1 << 12)
    m_auto = TSDFMap(config=MapConfig(**kw))
    m_xla = TSDFMap(config=MapConfig(accumulate_impl="xla", **kw))
    m_auto.insert(pts, pos)
    m_xla.insert(pts, pos)
    for f in ("dir_keys", "pool_w", "pool_sd"):
        np.testing.assert_array_equal(np.asarray(getattr(m_auto.state, f)),
                                      np.asarray(getattr(m_xla.state, f)))
