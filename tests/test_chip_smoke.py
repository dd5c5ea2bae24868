"""chip_smoke.py's phases at a tiny size on the CPU device, its refusal to
run without a GPU, and (marker ``gpu``) the same phases on a card."""

import dataclasses

import jax
import numpy as np
import pytest

import chip_smoke
from chad_tsdf_tpu import MapConfig


def tiny_sizes():
    return chip_smoke.Sizes(
        sphere_points=4096,
        sphere_cfg=MapConfig(max_points=4096, block_capacity=8192,
                             touched_capacity=8192),
        stream_scans=4,
        stream_cfg=MapConfig(max_points=8192, block_capacity=1 << 14,
                             touched_capacity=1 << 13, packed_ingest=True,
                             submap_distance=2.0),
        scan_stride=16, loop_points=2048, check_reference_mesh=False)


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture(scope="module")
def scans():
    return chip_smoke.stream_scans(tiny_sizes())


def test_main_refuses_a_non_gpu_backend(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""                       # no result line at all
    assert "not a GPU" in out.err


def test_phase_sphere_and_repeat(cpu, tmp_path):
    sizes = tiny_sizes()
    keep = {}
    res = chip_smoke.phase_sphere(sizes, cpu, cpu, str(tmp_path), keep)
    assert res["vs_cpu"]["voxels"] > 1000
    assert res["vs_cpu"]["max_sd_diff_m"] == 0.0     # same backend
    assert res["vs_cpu"]["rays_walking_differently"] == 0
    assert res["mesh_vertices"] > 0
    rep = chip_smoke.phase_repeat(sizes.sphere_cfg, keep["sphere_maps"])
    assert rep["bit_identical"]


def test_phase_xla_vs_seg(cpu, scans):
    res = chip_smoke.phase_xla_vs_seg(tiny_sizes(), cpu, scans)
    assert res["stream"]["scans"] == 2              # the first submap
    for case in ("sphere", "stream"):
        assert res[case]["vs"]["voxels"] > 0


def test_phase_stream_and_sharded_n1(cpu, scans, tmp_path):
    sizes = tiny_sizes()
    keep = {}
    res = chip_smoke.phase_stream(sizes, cpu, scans, str(tmp_path), keep)
    assert res["rotations"] == 1              # 2 submaps: 1 rotated + active
    assert res["mc"]["faces"] > 0
    n1 = chip_smoke.phase_sharded_n1(sizes, cpu, scans, keep["stream_map"],
                                     str(tmp_path))
    assert n1["vs_single"]["voxels"] == n1["checkpoint_roundtrip"]["voxels"]


def test_phase_four_cards_on_virtual_devices(scans, tmp_path):
    res = chip_smoke.phase_four_cards(tiny_sizes(), jax.devices()[:4],
                                      scans, str(tmp_path))
    assert res["cards"] == 4
    assert res["route_overflow"] == 0
    assert res["sd_within_2_steps"] > 0.98


def test_phase_pose_graph(cpu):
    res = chip_smoke.phase_pose_graph(tiny_sizes(), cpu, cpu)
    assert res["max_correction_diff"] == 0.0


def test_compare_states_rejects_a_changed_weight(cpu):
    sizes = tiny_sizes()
    m = chip_smoke.new_map(sizes.sphere_cfg, cpu)
    chip_smoke.insert_all(m, [(chip_smoke.sphere_points(1024),
                               np.zeros(3, np.float32))])
    st = m.state
    bumped = dataclasses.replace(st, pool_w=st.pool_w.at[0, 0].add(1.0))
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke.compare_states(st, bumped, 0.1)


def test_sd_tolerance_grows_with_weight():
    tol = chip_smoke.sd_tolerance(np.asarray([1.0, 1000.0]), 0.1)
    assert tol[0] == pytest.approx(0.1 / 32767 + 2 * 2.0 ** -24 * 0.1)
    assert tol[1] > tol[0]


@pytest.mark.gpu
def test_phases_on_gpu(gpu_device, scans, tmp_path):
    """The one-card phases at tiny size on the GPU, against the CPU."""
    cpu = jax.devices("cpu")[0]
    sizes = tiny_sizes()
    keep = {}
    chip_smoke.phase_sphere(sizes, gpu_device, cpu, str(tmp_path), keep)
    chip_smoke.phase_repeat(sizes.sphere_cfg, keep["sphere_maps"])
    chip_smoke.phase_xla_vs_seg(sizes, gpu_device, scans)
    chip_smoke.phase_stream(sizes, gpu_device, scans, str(tmp_path), keep)
    chip_smoke.phase_pose_graph(sizes, gpu_device, cpu)


def test_run_phases_reports_every_phase_and_fails_on_any(cpu, capsys):
    def bad():
        chip_smoke.check(False, "boom")

    ok = chip_smoke.run_phases([("good", lambda: {"x": 1.5}),
                                ("bad", bad),
                                ("after", lambda: {"y": 2})], cpu)
    assert not ok
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[good] PASS") and "x=1.5" in out[0]
    assert out[1] == "[bad] FAIL PhaseFailed: boom"
    assert out[2].startswith("[after] PASS")
