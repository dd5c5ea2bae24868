"""Pose-graph optimization — the reference's unbuilt "Loop closure" roadmap
item (reference README.md:59, declared-but-unbuilt surface at
include/chad/tsdf.hpp:158-161), designed per SURVEY §5.8: per-edge normal-
equation blocks are accumulated with a ``psum`` over a device mesh — the
distributed Schur-complement-style reduction — and the (small, submap-count-
sized) reduced system is solved identically on every shard.

Nodes are submap poses in SE(3); edges are relative-pose constraints:
odometry between consecutive submaps plus loop closures.  The residual of
edge (i, j) with measurement Z is ``log(Z^-1 · T_i^-1 · T_j)`` in the se(3)
tangent; Gauss-Newton/LM iterations linearize with jax autodiff (jacfwd over
the per-node local perturbations), so the exact reference Jacobians never
have to be hand-derived.  Everything is jnp and jittable; edge storage is
static-shaped with a validity mask.

The map stays consistent after optimization at submap granularity: submap
DAG contents are rigid bodies in their own frame — ``TSDFMap`` keeps
per-submap trajectories (core/map.py), so corrected poses re-anchor submaps
without touching voxel data (re-meshing applies the new anchors).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


def _full_f32(fn):
    """Run ``fn`` with f32 matrix products at full precision.

    GPUs run f32 matmuls in TF32 (~3 decimal digits) by default; the
    Gauss-Newton normal equations and the SE(3) maps need full f32.  The
    scope covers the jitted helpers too, since they trace inside it."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


# ---------------------------------------------------------------------------
# SE(3) exponential / logarithm (tangent = [rho, phi]: translation, rotation)
# ---------------------------------------------------------------------------

def _hat(v):
    x, y, z = v[0], v[1], v[2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y]),
        jnp.stack([z, zero, -x]),
        jnp.stack([-y, x, zero]),
    ])


@_full_f32
def se3_exp(xi):
    """se(3) tangent (6,) [rho, phi] -> (4, 4) homogeneous transform."""
    rho, phi = xi[:3], xi[3:]
    theta = jnp.sqrt(jnp.sum(phi * phi) + 1e-32)
    k = _hat(phi / theta)
    s, c = jnp.sin(theta), jnp.cos(theta)
    # Rodrigues; first-order series below 1e-6 (the 1e-32 guard keeps the
    # normalized axis finite so both branches are NaN-free under jacfwd)
    small = theta < 1e-6
    r_full = jnp.eye(3) + s * k + (1.0 - c) * (k @ k)
    r_small = jnp.eye(3) + _hat(phi)
    R = jnp.where(small, r_small, r_full)
    # left Jacobian V
    v_full = (jnp.eye(3) + (1.0 - c) / theta * k +
              (1.0 - s / theta) * (k @ k))
    v_small = jnp.eye(3) + 0.5 * _hat(phi)
    V = jnp.where(small, v_small, v_full)
    t = V @ rho
    top = jnp.concatenate([R, t[:, None]], axis=1)
    bot = jnp.asarray([[0.0, 0.0, 0.0, 1.0]])
    return jnp.concatenate([top, bot], axis=0)


@_full_f32
def se3_log(T):
    """(4, 4) homogeneous transform -> se(3) tangent (6,) [rho, phi].

    Uses the atan2 form so the derivative stays finite at the identity —
    arccos((tr-1)/2) has an infinite gradient at zero rotation, exactly
    where Gauss-Newton linearizes converged edges.  Valid for |theta| < pi
    (relative poses between consecutive linearization points)."""
    R = T[:3, :3]
    t = T[:3, 3]
    w_hat = (R - R.T) / 2.0
    w = jnp.stack([w_hat[2, 1], w_hat[0, 2], w_hat[1, 0]])   # = sin(th)*axis
    sin_t = jnp.sqrt(jnp.sum(w * w) + 1e-32)
    cos_t = jnp.clip((jnp.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arctan2(sin_t, cos_t)
    phi = w * (theta / sin_t)
    small = theta < 1e-6
    k = _hat(w / sin_t)                  # unit axis (guarded by 1e-32)
    v_full = (jnp.eye(3) + (1.0 - cos_t) / jnp.where(small, 1.0, theta) * k +
              (1.0 - sin_t / jnp.where(small, 1.0, theta)) * (k @ k))
    v_small = jnp.eye(3) + 0.5 * _hat(phi)
    V = jnp.where(small, v_small, v_full)
    rho = jnp.linalg.solve(V, t)
    return jnp.concatenate([rho, phi])


# ---------------------------------------------------------------------------
# Pose graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PoseGraph:
    n_nodes: int
    edges: np.ndarray          # (E, 2) int32 node indices (i, j)
    measurements: np.ndarray   # (E, 4, 4) float32 Z_ij: T_i^-1 T_j measured
    weights: np.ndarray        # (E,) float32 information scale per edge


@_full_f32
def make_odometry_edges(poses: np.ndarray, noise: float = 0.0,
                        seed: int = 0) -> PoseGraph:
    """Consecutive-pose odometry constraints from a trajectory (T, 4, 4);
    optional multiplicative tangent noise to simulate drift (for tests)."""
    t = poses.shape[0]
    rng = np.random.default_rng(seed)
    edges, zs = [], []
    for i in range(t - 1):
        z = np.linalg.inv(poses[i]) @ poses[i + 1]
        if noise > 0:
            xi = rng.normal(0, noise, 6)
            z = z @ np.asarray(se3_exp(jnp.asarray(xi)))
        edges.append((i, i + 1))
        zs.append(z)
    return PoseGraph(t, np.asarray(edges, np.int32),
                     np.asarray(zs, np.float32),
                     np.ones(len(edges), np.float32))


def add_edge(graph: PoseGraph, i: int, j: int, z: np.ndarray,
             weight: float = 1.0) -> PoseGraph:
    return PoseGraph(
        graph.n_nodes,
        np.concatenate([graph.edges, np.asarray([(i, j)], np.int32)]),
        np.concatenate([graph.measurements,
                        np.asarray(z, np.float32)[None]]),
        np.concatenate([graph.weights, np.asarray([weight], np.float32)]))


def _edge_residual(xi_i, xi_j, base_i, base_j, z_inv):
    """Residual of one edge at local perturbations (xi around base poses)."""
    ti = base_i @ se3_exp(xi_i)
    tj = base_j @ se3_exp(xi_j)
    return se3_log(z_inv @ jnp.linalg.solve(ti, tj))


_edge_jac = jax.jacfwd(_edge_residual, argnums=(0, 1))


def _edge_blocks(base_i, base_j, z_inv, w, huber_delta=0.0,
                 mode: str = "huber"):
    """Per-edge normal-equation blocks at xi = 0.

    Returns (r (6,), Ji (6,6), Jj (6,6)) scaled by sqrt(w) times the
    robust scale of the selected kernel:

    ``dcs`` (Dynamic Covariance Scaling, Agarwal et al. 2013): residual
    scale ``s = min(1, 2*phi / (phi + w*||r||^2))`` with ``phi =
    huber_delta^2`` — REDESCENDING: a grossly wrong constraint's pull
    ~ 1/||r||^3 -> 0, so it never gains the leverage to bend a floppy
    odometry chain (a convex kernel like Huber gets absorbed instead —
    measured on the circle+outlier problem in
    tests/test_posegraph.py::test_outlier_loop_edge_is_rejected).
    ``huber``: residual scale sqrt(min(1, d/||r||)) — convex, bounded
    influence.
    ``quad``: plain least squares.

    ``huber_delta <= 0`` disables robustification in any mode."""
    zero = jnp.zeros(6)
    r = _edge_residual(zero, zero, base_i, base_j, z_inv)
    ji, jj = _edge_jac(zero, zero, base_i, base_j, z_inv)
    hd = jnp.asarray(huber_delta, jnp.float32)
    if mode == "quad":
        scale = jnp.float32(1.0)
    elif mode == "dcs":
        phi = hd * hd
        chi2 = w * jnp.sum(r * r)
        scale = jnp.minimum(1.0, 2.0 * phi / (phi + chi2 + 1e-32))
    elif mode == "huber":
        rn = jnp.sqrt(jnp.sum(r * r) + 1e-32)
        scale = jnp.sqrt(jnp.minimum(1.0, hd / rn))
    else:
        raise ValueError(f"bad robust mode {mode!r}")
    sw = jnp.sqrt(w) * jnp.where(hd > 0, scale, 1.0)
    return r * sw, ji * sw, jj * sw


def _accumulate_normal_eq(poses, edges, z_inv, weights, valid, n_nodes,
                          huber_delta=0.0, mode: str = "huber"):
    """Dense H (6N, 6N) and b (6N,) from all edges (vmapped).

    Dense-H ceiling: H is (6N)^2 — fine to several hundred submaps
    (N=500: 3000^2 f32 = 36 MB, ms-scale solve), far beyond the submap
    counts a 5 m rotation policy produces per mission; beyond ~1000 nodes
    move to a sparse/Schur solve."""
    r, ji, jj = jax.vmap(
        lambda e, zi, w: _edge_blocks(poses[e[0]], poses[e[1]], zi, w,
                                      huber_delta, mode)
    )(edges, z_inv, weights)
    m = valid.astype(jnp.float32)
    r = r * m[:, None]
    ji = ji * m[:, None, None]
    jj = jj * m[:, None, None]

    n6 = 6 * n_nodes
    H = jnp.zeros((n6, n6))
    b = jnp.zeros(n6)
    ii = edges[:, 0] * 6
    jjx = edges[:, 1] * 6

    def upd(carry, t):
        H, b = carry
        i0, j0, rt, jit, jjt = t
        H = jax.lax.dynamic_update_slice(
            H, jax.lax.dynamic_slice(H, (i0, i0), (6, 6)) + jit.T @ jit,
            (i0, i0))
        H = jax.lax.dynamic_update_slice(
            H, jax.lax.dynamic_slice(H, (j0, j0), (6, 6)) + jjt.T @ jjt,
            (j0, j0))
        H = jax.lax.dynamic_update_slice(
            H, jax.lax.dynamic_slice(H, (i0, j0), (6, 6)) + jit.T @ jjt,
            (i0, j0))
        H = jax.lax.dynamic_update_slice(
            H, jax.lax.dynamic_slice(H, (j0, i0), (6, 6)) + jjt.T @ jit,
            (j0, i0))
        b = jax.lax.dynamic_update_slice(
            b, jax.lax.dynamic_slice(b, (i0,), (6,)) + jit.T @ rt, (i0,))
        b = jax.lax.dynamic_update_slice(
            b, jax.lax.dynamic_slice(b, (j0,), (6,)) + jjt.T @ rt, (j0,))
        return (H, b), None

    (H, b), _ = jax.lax.scan(upd, (H, b), (ii, jjx, r, ji, jj))
    cost = jnp.sum(r * r)
    return H, b, cost


def gauss_newton_step(H, b, damping: float):
    """Damped Gauss-Newton update ``dx`` from the normal equations, node 0
    gauge-fixed by lifting its diagonal block."""
    n6 = H.shape[0]
    gauge = jnp.zeros(n6).at[:6].set(1e12)
    Hd = H + jnp.diag(gauge + damping * jnp.maximum(jnp.diag(H), 1.0))
    return -jnp.linalg.solve(Hd, b)


@_full_f32
def optimize_poses(graph: PoseGraph, init_poses: np.ndarray,
                   iterations: int = 10, damping: float = 1e-6,
                   mesh=None, axis: str = "shard",
                   huber_delta: float = 1.0):
    """Gauss-Newton/LM over the pose graph; node 0 is gauge-fixed.

    Edges are robustified by default (``huber_delta`` = expected inlier
    residual scale in se(3) tangent units; set 0 for the plain quadratic)
    with a two-phase schedule: the first half of the iterations runs the
    redescending DCS kernel (a gross outlier's pull vanishes, so it never
    bends the trajectory), then edges whose residual norm still exceeds
    ``3 * huber_delta`` become GATE CANDIDATES.  Because a single
    high-residual edge is ambiguous — a wrong constraint, or a CORRECT
    loop closure spanning large drift that DCS starved of influence — the
    candidates are resolved by a hypothesis test: both models (edges
    dropped vs all edges kept) are optimized quadratically and the one
    with the lower bounded saturating cost wins.  A consistent graph
    drives every term to ~0, so a large-drift closure is KEPT and
    converges (tests/test_posegraph.py::
    test_large_drift_loop_closure_not_gated); an inconsistent edge
    saturates when dropped but smears residual over the whole graph when
    kept, so a gross outlier is REJECTED
    (tests/test_posegraph.py::test_outlier_loop_edge_is_rejected).
    ``stats["gated_edges"]`` reports how many were rejected.

    With ``mesh`` given, edges are sharded over the mesh axis and each
    shard contributes its partial H/b via ``psum`` (the distributed
    reduction of SURVEY §5.8) — the solve of the reduced system is
    replicated.  Returns (poses (N, 4, 4) np.float32, stats dict).
    """
    n = graph.n_nodes
    poses = jnp.asarray(init_poses, jnp.float32)
    z_inv = jnp.asarray(np.linalg.inv(
        graph.measurements.astype(np.float64)).astype(np.float32))
    edges = jnp.asarray(graph.edges)
    weights = jnp.asarray(graph.weights)
    e = edges.shape[0]

    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        n_dev = mesh.devices.size
        pad = (-e) % n_dev
        edges_p = jnp.pad(edges, ((0, pad), (0, 0)))
        zinv_p = jnp.pad(z_inv, ((0, pad), (0, 0), (0, 0)),
                         constant_values=0.0)
        # padded edges must stay invertible-ish for vmap; use identity
        zinv_p = zinv_p.at[e:].set(jnp.eye(4))
        w_p = jnp.pad(weights, (0, pad))
        valid = (jnp.arange(e + pad) < e)

        def make_acc(mode):
            def shard_acc(poses, edges_s, zinv_s, w_s, valid_s):
                H, b, cost = _accumulate_normal_eq(
                    poses, edges_s, zinv_s, w_s, valid_s, n, huber_delta,
                    mode)
                return (jax.lax.psum(H, axis), jax.lax.psum(b, axis),
                        jax.lax.psum(cost, axis))

            acc = jax.jit(jax.shard_map(
                shard_acc, mesh=mesh,
                in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
                out_specs=(P(), P(), P()), check_vma=False),
                donate_argnums=())
            return lambda p, w: acc(p, edges_p, zinv_p, w, valid)

        weights_run = w_p
    else:
        valid = jnp.ones(e, bool)

        def make_acc(mode):
            return jax.jit(lambda p, w: _accumulate_normal_eq(
                p, edges, z_inv, w, valid, n, huber_delta, mode))

        weights_run = weights

    if huber_delta > 0:
        modes = ["dcs"] * ((iterations + 1) // 2)
        modes += ["quad"] * (iterations - len(modes))
    else:
        modes = ["quad"] * iterations
    acc_cache = {m: make_acc(m) for m in (set(modes) | {"quad"})}
    accumulate = acc_cache[modes[0] if modes else "quad"]

    res_norms = jax.jit(lambda p: jnp.sqrt(jnp.sum(jax.vmap(
        lambda ee, zi: _edge_residual(jnp.zeros(6), jnp.zeros(6),
                                      p[ee[0]], p[ee[1]], zi)
    )(edges, z_inv) ** 2, axis=1)))

    apply_fn = jax.jit(lambda p, dx: jax.vmap(
        lambda T, x: T @ se3_exp(x))(p, dx.reshape(n, 6)))

    costs = []
    gated = 0
    init_poses_j = poses

    def run_phase(poses, weights_j, mode, n_iter):
        acc = acc_cache[mode]
        for _ in range(n_iter):
            H, b, cost = acc(poses, weights_j)
            costs.append(float(cost))
            poses = apply_fn(poses, gauss_newton_step(H, b, damping))
            if costs[-1] < 1e-18:
                break
        return poses

    def saturating_cost(poses):
        """Bounded (Geman-McClure-saturating) total cost over ALL edges:
        each edge contributes at most phi = huber_delta^2, so an
        unsatisfiable edge adds a constant instead of dominating — the
        model-selection score for the gate hypothesis test."""
        rn = np.asarray(res_norms(poses)).astype(np.float64)
        chi2 = np.asarray(weights, np.float64) * rn * rn
        phi = float(huber_delta) ** 2
        return float((phi * chi2 / (phi + chi2)).sum())

    n_dcs = sum(m == "dcs" for m in modes)
    n_quad = len(modes) - n_dcs
    if huber_delta > 0 and n_dcs:
        poses = run_phase(poses, weights_run, "dcs", n_dcs)
        rn = np.asarray(res_norms(poses))
        gate = rn[:e] > 3.0 * huber_delta
        gated = int(gate.sum())
        if gated == 0:
            poses = run_phase(poses, weights_run, "quad", n_quad)
        else:
            # A single high-residual edge is ambiguous: a grossly wrong
            # constraint (gate it) or a CORRECT loop closure closing a
            # large drift (keep it — DCS starved it of influence, so its
            # residual never shrank).  Decide by hypothesis test: optimize
            # both models quadratically and keep the one with the lower
            # SATURATING cost over all edges — a consistent graph drives
            # every term to ~0 (keep wins), an inconsistent edge saturates
            # at phi when dropped but smears bounded-but-nonzero residual
            # over the whole graph when kept (drop wins).
            wh = np.asarray(weights_run).copy()
            wh[:e] = np.where(gate, 0.0, np.asarray(weights))
            poses_drop = run_phase(poses, jnp.asarray(wh), "quad",
                                   max(n_quad, 1))
            poses_keep = run_phase(init_poses_j, weights_run, "quad",
                                   max(n_quad, n_dcs, 1))
            if saturating_cost(poses_keep) < saturating_cost(poses_drop):
                poses, gated = poses_keep, 0
            else:
                poses, weights_run = poses_drop, jnp.asarray(wh)
    else:
        poses = run_phase(poses, weights_run, "quad", iterations)
    # report costs on one consistent scale — the plain weighted quadratic
    # over the SURVIVING (non-gated) edges at the initial and final poses
    # (per-iteration robust costs are not comparable across kernel phases)
    quad_acc = acc_cache["quad"]
    _, _, init_cost = quad_acc(init_poses_j, weights_run)
    _, _, final_cost = quad_acc(poses, weights_run)
    return (np.asarray(poses),
            {"initial_cost": float(init_cost),
             "final_cost": float(final_cost),
             "iterations": len(costs),
             "gated_edges": gated})
