"""Pose-graph optimization tests (the reference's unbuilt loop-closure
roadmap, README.md:59): SE(3) round trips, drift correction on a loop, and
the mesh-distributed normal-equation reduction matching single-device."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from chad_tsdf_tpu.slam import (PoseGraph, make_odometry_edges,
                                optimize_poses, se3_exp, se3_log)
from chad_tsdf_tpu.slam.posegraph import add_edge


def circle_trajectory(n=16, radius=10.0):
    """Poses around a circle, heading tangent; closes a loop."""
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        c, s = np.cos(a), np.sin(a)
        R = np.array([[-s, 0, c], [c, 0, s], [0, 1, 0]], np.float64).T
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = [radius * c, radius * s, 0.0]
        poses.append(T)
    return np.asarray(poses)


def test_se3_exp_log_roundtrip():
    rng = np.random.default_rng(0)
    for scale in (1e-8, 1e-4, 0.1, 1.0, 2.5):
        xi = jnp.asarray(rng.normal(0, scale, 6))
        T = se3_exp(xi)
        back = se3_log(T)
        np.testing.assert_allclose(np.asarray(back), np.asarray(xi),
                                   rtol=1e-4, atol=1e-6)
        # exp produces a rigid transform
        R = np.asarray(T)[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


def test_jacobian_finite_at_zero_residual():
    """Converged edges must not poison H with NaNs (arccos-at-1 trap)."""
    from chad_tsdf_tpu.slam.posegraph import _edge_blocks
    gt = circle_trajectory()
    z = np.linalg.inv(gt[0]) @ gt[1]
    r, ji, jj = _edge_blocks(jnp.asarray(gt[0], jnp.float32),
                             jnp.asarray(gt[1], jnp.float32),
                             jnp.asarray(np.linalg.inv(z), jnp.float32),
                             jnp.float32(1.0))
    assert np.isfinite(np.asarray(r)).all()
    assert np.isfinite(np.asarray(ji)).all()
    assert np.isfinite(np.asarray(jj)).all()


def _drifted_problem(seed=1):
    gt = circle_trajectory()
    graph = make_odometry_edges(gt, noise=0.02, seed=seed)
    # loop closure: exact constraint last -> first
    z_loop = np.linalg.inv(gt[-1]) @ gt[0]
    graph = add_edge(graph, len(gt) - 1, 0, z_loop, weight=10.0)
    # initial guess: integrate the noisy odometry (drifts)
    init = [gt[0]]
    for k in range(len(gt) - 1):
        init.append(init[-1] @ graph.measurements[k].astype(np.float64))
    return gt, graph, np.asarray(init)


def test_loop_closure_reduces_drift():
    gt, graph, init = _drifted_problem()
    drift0 = np.linalg.norm(init[-1][:3, 3] - gt[-1][:3, 3])
    opt, stats = optimize_poses(graph, init, iterations=15)
    assert stats["final_cost"] < stats["initial_cost"] * 0.1
    # the loop-closed endpoint must be pulled (much) closer to ground truth
    drift1 = np.linalg.norm(opt[-1][:3, 3] - gt[-1][:3, 3])
    assert drift1 < 0.25 * drift0
    assert np.isfinite(opt).all()
    # gauge: node 0 stays anchored
    np.testing.assert_allclose(opt[0], gt[0], atol=1e-3)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_distributed_reduction_matches_single():
    from chad_tsdf_tpu.parallel import make_mesh
    gt, graph, init = _drifted_problem(seed=3)
    opt1, s1 = optimize_poses(graph, init, iterations=8)
    opt8, s8 = optimize_poses(graph, init, iterations=8, mesh=make_mesh(8))
    np.testing.assert_allclose(opt8, opt1, rtol=1e-3, atol=1e-4)
    assert abs(s8["final_cost"] - s1["final_cost"]) <= \
        1e-3 * max(1.0, s1["final_cost"])


def test_outlier_loop_edge_is_rejected():
    """One grossly wrong loop-closure constraint (the norm in real place
    recognition) must not corrupt the trajectory: Huber IRLS bounds its
    influence, and the result stays close to the outlier-free solution
    (VERDICT r4 task 6)."""
    gt, graph, init = _drifted_problem(seed=5)
    opt_clean, _ = optimize_poses(graph, init, iterations=20)

    # a wildly wrong loop edge: claims node 8 sits at node 2's pose
    # shifted 15 m — totally inconsistent with the circle
    bad_z = np.eye(4, dtype=np.float32)
    bad_z[:3, 3] = [15.0, -7.0, 3.0]
    graph_bad = add_edge(graph, 2, 8, bad_z, weight=1.0)

    opt_rob, stats = optimize_poses(graph_bad, init, iterations=20,
                                    huber_delta=1.0)
    assert stats["gated_edges"] == 1, stats      # exactly the bad edge
    err_rob = np.linalg.norm(opt_rob[:, :3, 3] - opt_clean[:, :3, 3],
                             axis=1)
    # robust solution within ~10 cm of the outlier-free one everywhere
    assert err_rob.max() < 0.1, err_rob.max()
    assert np.isfinite(opt_rob).all()

    # contrast: the plain quadratic IS corrupted by the same edge —
    # the robustness is doing real work, not riding a benign outlier
    opt_quad, _ = optimize_poses(graph_bad, init, iterations=20,
                                 huber_delta=0.0)
    err_quad = np.linalg.norm(opt_quad[:, :3, 3] - opt_clean[:, :3, 3],
                              axis=1)
    assert err_quad.max() > 10 * err_rob.max()


def test_large_drift_loop_closure_not_gated():
    """A CORRECT loop closure spanning large systematic drift must engage,
    not be mistaken for an outlier: biased odometry (constant rotational
    error per step) accumulates ~15 m of drift, and the truthful loop edge
    is the only thing that can fix it.  The robust default must converge
    like the plain quadratic does (code-review r5 finding #1)."""
    from chad_tsdf_tpu.slam.posegraph import PoseGraph, se3_exp

    gt = circle_trajectory()
    t = len(gt)
    bias = np.asarray(se3_exp(jnp.asarray(
        [0.0, 0.0, 0.0, 0.0, 0.0, np.deg2rad(6.0)])))
    edges, zs = [], []
    for i in range(t - 1):
        z = (np.linalg.inv(gt[i]) @ gt[i + 1]) @ bias
        edges.append((i, i + 1))
        zs.append(z)
    graph = PoseGraph(t, np.asarray(edges, np.int32),
                      np.asarray(zs, np.float32),
                      np.ones(len(edges), np.float32))
    z_loop = np.linalg.inv(gt[-1]) @ gt[0]
    graph = add_edge(graph, t - 1, 0, z_loop, weight=10.0)

    init = [gt[0]]
    for k in range(t - 1):
        init.append(init[-1] @ graph.measurements[k].astype(np.float64))
    init = np.asarray(init)
    drift0 = np.linalg.norm(init[-1][:3, 3] - gt[-1][:3, 3])
    assert drift0 > 5.0                       # the drift really is large

    opt, stats = optimize_poses(graph, init, iterations=20,
                                huber_delta=1.0)
    assert stats["gated_edges"] == 0, stats   # the loop edge survived
    drift1 = np.linalg.norm(opt[-1][:3, 3] - gt[-1][:3, 3])
    assert drift1 < 0.1 * drift0, (drift0, drift1)
    assert np.isfinite(opt).all()


def test_gauss_newton_step_matches_float64_solve():
    """The damped, gauge-fixed normal-equation solve must match a float64
    numpy solve to f32 accuracy (it runs at full f32 matmul precision, not
    the GPU's TF32 default)."""
    from chad_tsdf_tpu.slam.posegraph import gauss_newton_step

    rng = np.random.default_rng(5)
    n6 = 24
    a = rng.normal(size=(n6, n6))
    H = (a @ a.T / n6 + np.eye(n6)).astype(np.float32)
    b = rng.normal(size=n6).astype(np.float32)
    damping = 1e-6

    dx = np.asarray(gauss_newton_step(jnp.asarray(H), jnp.asarray(b),
                                      damping))
    H64, b64 = H.astype(np.float64), b.astype(np.float64)
    gauge = np.zeros(n6)
    gauge[:6] = 1e12
    Hd = H64 + np.diag(gauge + damping * np.maximum(np.diag(H64), 1.0))
    want = -np.linalg.solve(Hd, b64)
    np.testing.assert_allclose(dx, want, rtol=1e-4, atol=1e-6)
    assert np.abs(dx[:6]).max() < 1e-9          # node 0 is held fixed
