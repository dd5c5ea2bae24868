"""GPU smoke run: insert -> rotate -> save through the public entry points
at full size, every phase checked against a reference.

    python chip_smoke.py             # one GPU: phases 1-5 and the pose graph
    python chip_smoke.py --chips 4   # four GPUs: the sharded map only

Workloads:

* (a) the reference's canonical sphere (reference main.cpp:8-38): 1M points
  on a 5 m sphere, seed 420, sdf_res 0.05, sdf_trunc 0.1, default
  ``MapConfig`` (64k-block pool);
* (b) a KITTI-shaped LiDAR stream: ``io/kitti.synthetic_lidar_scan``
  (~120k points per scan), the bench.py stream config with the 6 m
  rotation distance of scripts/mesh_scale_bench.py — 40 scans, 8 submaps,
  every rotation finalized through the host DAG build, then a map-scale
  ``save()``.

Each phase prints one line: its sizes, its first-call time (compilation
plus one run — set-up), its warm time, the device's peak memory so far,
and its comparison with the tolerance it was held to.  References run on
the CPU backend of the same process (one process holds the card).  The
last line of stdout is ``{"ok": true, "device": {...}}`` only when every
phase passed; a failed phase, or a default backend other than the GPU,
exits non-zero without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

# --- tolerances -----------------------------------------------------------
# Per-voxel mean signed distance [m].  Weights are integer counts, exact in
# any order, but the sd sums are f32: the GPU's scatter-add accumulates in
# the order its atomics land, so a sum of w terms, each |x| <= trunc,
# reassociates by at most w * 2^-24 * trunc on either side; and a sample's
# sd can round to the neighbouring 16-bit quantum (trunc / 32767) when the
# two backends' f32 normals differ in the last bit.
_U = 2.0 ** -24
# GPU against CPU only: the two backends' f32 arithmetic differs in the last
# bit — the GPU's f32 sqrt and division are not correctly rounded, the CPU
# contracts a*b+c into fused multiply-adds — so a ray whose band start lands
# on a voxel boundary (or whose axis steps tie) walks into the neighbouring
# voxel on one backend.  Measured on the 1M-point sphere: 18 of 1M rays.
# Each such ray moves a few samples, so a few voxels' weights differ by one;
# this bounds the fraction of voxels that may (the directory must match).
CROSS_BACKEND_WEIGHT_FRACTION = 1e-4


def sd_tolerance(w, trunc: float):
    """Bound on |mean_a - mean_b| for a voxel of weight ``w``."""
    import numpy as np
    return trunc / 32767.0 + 2.0 * np.maximum(w, 1.0) * _U * trunc


# saved-mesh vertex RMSE against the reference's canonical-sphere mesh
# (tests/test_mesh.py::test_reference_mesh_rmse): one codec step plus half a
# voxel
def mesh_rmse_bound(res: float, trunc: float) -> float:
    return trunc / 127 + 0.5 * res


# device vs host marching cubes: 1e-6 m (tests/test_mesh.py), or two f32
# ulps of the coordinate where that is coarser — the GPU's f32 division in
# the edge interpolation is not correctly rounded, so a vertex can round to
# the neighbouring f32, and one ulp is 3.8e-6 m at 32-64 m from the origin
MC_VERTEX_ATOL = 1e-6


def mc_vertex_tolerance(v):
    import numpy as np
    return np.maximum(MC_VERTEX_ATOL,
                      2 * np.spacing(np.abs(v).astype(np.float32)))
# pose graph: both backends run full-f32 Gauss-Newton; the tolerance covers
# f32 rounding of 20 iterations and would catch TF32 products (~1e-3 rel)
POSE_ATOL = 1e-4


@dataclasses.dataclass(frozen=True)
class Sizes:
    sphere_points: int
    sphere_cfg: object          # MapConfig
    stream_scans: int
    stream_cfg: object          # MapConfig
    scan_stride: int            # keep every k-th point of a synthetic scan
    loop_points: int
    check_reference_mesh: bool  # the golden mesh is the full-size sphere


def full_sizes():
    from chad_tsdf_tpu import MapConfig
    return Sizes(
        sphere_points=1_000_000, sphere_cfg=MapConfig(),
        stream_scans=40,
        stream_cfg=MapConfig(block_capacity=1 << 16,
                             touched_capacity=1 << 15, packed_ingest=True,
                             submap_distance=6.0),
        scan_stride=1, loop_points=50_000, check_reference_mesh=True)


class PhaseFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


# --- workloads --------------------------------------------------------------
def sphere_points(n: int, seed: int = 420):
    """main.cpp:8-30: uniform directions (normalized cube samples) * 5 m."""
    import numpy as np
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1.0, 1.0, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * 5.0).astype(np.float32)


def stream_scans(sizes: Sizes):
    import numpy as np

    from chad_tsdf_tpu.io.kitti import synthetic_lidar_scan
    return [(synthetic_lidar_scan([1.5 * i, 0.0, 0.0],
                                  seed=i)[::sizes.scan_stride],
             np.float32([1.5 * i, 0.0, 1.7]))
            for i in range(sizes.stream_scans)]


def _sync(m) -> None:
    import jax
    jax.block_until_ready((getattr(m, "state_stack", None), m.state))


def insert_all(m, scans) -> float:
    """Stream ``scans`` into ``m``; wall seconds up to device completion."""
    t0 = time.perf_counter()
    for pts, pos in scans:
        m.insert(pts, pos)
    _sync(m)
    return time.perf_counter() - t0


def peak_mib(dev) -> float:
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 2 ** 20


# --- comparisons ------------------------------------------------------------
def compare_states(a, b, trunc: float,
                   weight_fraction: float = 0.0) -> dict:
    """Same directory; weights identical except on at most
    ``weight_fraction`` of the voxels; mean sd within sd_tolerance where
    the weights agree."""
    import numpy as np
    check(int(a.n_blocks) == int(b.n_blocks),
          f"n_blocks {int(a.n_blocks)} != {int(b.n_blocks)}")
    check(np.array_equal(np.asarray(a.dir_keys), np.asarray(b.dir_keys)),
          "block directory keys differ")
    check(np.array_equal(np.asarray(a.dir_slots), np.asarray(b.dir_slots)),
          "block directory slots differ")
    wa, wb = np.asarray(a.pool_w), np.asarray(b.pool_w)
    n_vox = int(np.sum((wa > 0) | (wb > 0)))
    n_w = int(np.sum(wa != wb))
    check(n_w <= weight_fraction * n_vox,
          f"{n_w} of {n_vox} voxel weights differ")
    same = (wa > 0) & (wa == wb)
    ma = np.asarray(a.pool_sd)[same] / wa[same]
    mb = np.asarray(b.pool_sd)[same] / wb[same]
    diff = np.abs(ma - mb)
    ratio = float((diff / sd_tolerance(wa[same], trunc)).max(initial=0.0))
    check(ratio <= 1.0, f"mean sd off by {diff.max():.3g} m "
          f"({ratio:.3g}x the per-voxel tolerance)")
    return {"voxels": n_vox, "weights_differ": n_w,
            "max_weight_diff": float(np.abs(wa - wb).max(initial=0.0)),
            "max_sd_diff_m": float(diff.max(initial=0.0)),
            "max_tol_ratio": ratio}


def compare_leaves(a, b, sd_atol: float) -> dict:
    """Same voxels, same weights, sd within ``sd_atol`` — on the
    (coords, sd, weight) triples of ``TSDFMap.leaf_arrays``."""
    import numpy as np
    ca, sa, wa = a
    cb, sb, wb = b
    check(ca.shape == cb.shape and np.array_equal(ca, cb),
          f"voxel sets differ ({len(ca)} vs {len(cb)})")
    check(np.array_equal(wa, wb), f"{int(np.sum(wa != wb))} weights differ")
    d = float(np.abs(sa - sb).max(initial=0.0))
    check(d <= sd_atol, f"sd off by {d:.3g} > {sd_atol:.3g}")
    return {"voxels": int(len(ca)), "max_sd_diff_m": d}


def compare_meshes(dev_mesh, host_mesh) -> dict:
    import numpy as np
    check(dev_mesh.vertices.shape == host_mesh.vertices.shape,
          f"vertex counts {len(dev_mesh.vertices)} vs "
          f"{len(host_mesh.vertices)}")
    diff = np.abs(dev_mesh.vertices - host_mesh.vertices)
    d = float(diff.max(initial=0))
    tol = mc_vertex_tolerance(host_mesh.vertices)
    check(bool(np.all(diff <= tol)), f"vertices off by {d:.3g} "
          f"(> {tol.ravel()[np.argmax((diff - tol).ravel())]:.3g})")
    f1 = {tuple(sorted(f)) for f in host_mesh.faces.tolist()}
    f2 = {tuple(sorted(f)) for f in dev_mesh.faces.tolist()}
    check(f1 == f2 and dev_mesh.faces.shape == host_mesh.faces.shape,
          "face sets differ")
    return {"vertices": int(len(dev_mesh.vertices)),
            "faces": int(len(dev_mesh.faces)), "max_vertex_diff": d}


# --- phases -----------------------------------------------------------------
def new_map(cfg, dev):
    import jax

    from chad_tsdf_tpu import TSDFMap
    with jax.default_device(dev):
        return TSDFMap(config=cfg)


def run_on(dev, fn, *args):
    import jax
    with jax.default_device(dev):
        return fn(*args)


def dda_disagreement(pts, origin, cfg, dev, ref_dev) -> int:
    """Rays whose plain DDA traversal differs between the two devices."""
    import jax
    import numpy as np

    from chad_tsdf_tpu.ops import dda

    def walk(d):
        f = jax.jit(lambda x, y, z, p: dda.traverse(
            x, y, z, p, cfg.sdf_res, cfg.sdf_trunc, cfg.dda_steps))
        args = [jax.device_put(a, d) for a in
                (pts[:, 0], pts[:, 1], pts[:, 2], origin)]
        return [np.asarray(o) for o in f(*args)]

    bad = np.zeros(len(pts), bool)
    for x, y in zip(walk(dev), walk(ref_dev)):
        bad |= np.any(x != y, axis=0)
    return int(bad.sum())


def phase_sphere(sizes: Sizes, dev, ref_dev, workdir: str,
                 keep: dict) -> dict:
    """1: sphere (a) on the device vs the same pipeline on the CPU; saved
    mesh against the reference's mesh.  Keeps two warm maps for phase 5
    in ``keep['sphere_maps']``."""
    import numpy as np

    from chad_tsdf_tpu.mesh import read_ply
    from chad_tsdf_tpu.mesh.rmse import vertex_rmse

    cfg = sizes.sphere_cfg
    pts = sphere_points(sizes.sphere_points)
    origin = np.zeros(3, np.float32)
    ply = os.path.join(workdir, "sphere.ply")

    cold = new_map(cfg, dev)
    t_first = run_on(dev, insert_all, cold, [(pts, origin)])
    t0 = time.perf_counter()
    run_on(dev, cold.save, ply)
    t_save_first = time.perf_counter() - t0

    warm = [new_map(cfg, dev) for _ in range(2)]
    t_warm = [run_on(dev, insert_all, m, [(pts, origin)]) for m in warm]
    keep["sphere_maps"] = warm
    t0 = time.perf_counter()
    run_on(dev, warm[0].save, ply)
    t_save = time.perf_counter() - t0

    ref = new_map(cfg, ref_dev)
    t_ref = run_on(ref_dev, insert_all, ref, [(pts, origin)])
    cmp = compare_states(warm[0].state, ref.state, cfg.sdf_trunc,
                         CROSS_BACKEND_WEIGHT_FRACTION)
    cmp["rays_walking_differently"] = dda_disagreement(pts, origin, cfg,
                                                       dev, ref_dev)

    out = {"tolerance": "same directory; weights differ on <= "
                        f"{CROSS_BACKEND_WEIGHT_FRACTION:g} of voxels; "
                        "sd <= trunc/32767 + 2*w*2^-24*trunc per voxel; "
                        "mesh RMSE < trunc/127 + res/2",
           "points": len(pts), "blocks": int(warm[0].state.n_blocks),
           "insert_first_s": t_first, "insert_warm_s": min(t_warm),
           "save_first_s": t_save_first, "save_warm_s": t_save,
           "cpu_insert_s": t_ref, "vs_cpu": cmp}
    mesh = read_ply(ply)
    out["mesh_vertices"] = int(mesh.n_vertices)
    if sizes.check_reference_mesh:
        ref_ply = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "golden", "reference_sphere.ply")
        rmse = vertex_rmse(mesh.vertices, read_ply(ref_ply).vertices)["rmse"]
        bound = mesh_rmse_bound(cfg.sdf_res, cfg.sdf_trunc)
        check(rmse < bound, f"mesh RMSE {rmse:.4g} >= {bound:.4g}")
        out["reference_mesh_rmse_m"] = rmse
        out["reference_mesh_bound_m"] = bound
    return out


def phase_xla_vs_seg(sizes: Sizes, dev, scans) -> dict:
    """2: the two insert backends on the device, on (a) and on the first
    submap of (b): same directory, weights, sd within tolerance."""
    import numpy as np

    from chad_tsdf_tpu import backend

    out = {"tolerance": "same directory and weights; "
                        "sd <= trunc/32767 + 2*w*2^-24*trunc per voxel"}
    first_submap = [s for s in scans
                    if np.linalg.norm(s[1] - scans[0][1])
                    <= sizes.stream_cfg.submap_distance]
    cases = {"sphere": (sizes.sphere_cfg,
                        [(sphere_points(sizes.sphere_points),
                          np.zeros(3, np.float32))]),
             "stream": (sizes.stream_cfg, first_submap)}
    for name, (cfg, feed) in cases.items():
        check(backend.choose(cfg).insert == "xla", "auto is not xla")
        res = {"scans": len(feed)}
        states = {}
        for impl in ("xla", "seg"):
            c = cfg if impl == "xla" else dataclasses.replace(
                cfg, accumulate_impl="seg")
            res[f"{impl}_first_s"] = run_on(dev, insert_all,
                                            new_map(c, dev), feed)
            m = new_map(c, dev)
            res[f"{impl}_warm_s"] = run_on(dev, insert_all, m, feed)
            states[impl] = m.state
        res["vs"] = compare_states(states["xla"], states["seg"],
                                   cfg.sdf_trunc)
        out[name] = res
    return out


def phase_stream(sizes: Sizes, dev, scans, workdir: str,
                 keep: dict) -> dict:
    """3: stream (b) end to end, then save() with device and host
    marching cubes, which must weld to the same mesh.  Keeps the map for
    phase 4 in ``keep['stream_map']``."""
    from chad_tsdf_tpu import backend
    from chad_tsdf_tpu.mesh import marching_cubes
    from chad_tsdf_tpu.mesh.device_mc import marching_cubes_device

    cfg = sizes.stream_cfg
    check(backend.choose(cfg).mesh == "device" or dev.platform != "gpu",
          "auto marching cubes is not the device path on the GPU")
    cold = new_map(cfg, dev)
    t_cold = run_on(dev, insert_all, cold, scans)
    run_on(dev, cold.extract_mesh)              # compiles the save path

    m = new_map(cfg, dev)
    t_stream = run_on(dev, insert_all, m, scans)
    keep["stream_map"] = m
    t0 = time.perf_counter()
    run_on(dev, m.save, os.path.join(workdir, "stream.ply"))
    t_save = time.perf_counter() - t0

    t0 = time.perf_counter()
    codes, sd = m.voxel_samples()
    t_vox = time.perf_counter() - t0
    t0 = time.perf_counter()
    dmesh = run_on(dev, marching_cubes_device, codes, sd, cfg.sdf_res)
    t_dmc = time.perf_counter() - t0
    t0 = time.perf_counter()
    hmesh = marching_cubes(codes, sd, cfg.sdf_res)
    t_hmc = time.perf_counter() - t0
    cmp = compare_meshes(dmesh, hmesh)
    return {"tolerance": "same faces; vertices within max(1e-6 m, "
                         "2 f32 ulp)",
            "scans": len(scans), "points": int(sum(len(p) for p, _ in scans)),
            "rotations": m.n_submaps, "voxels": int(len(codes)),
            "stream_first_s": t_cold, "stream_warm_s": t_stream,
            "save_warm_s": t_save, "voxel_samples_s": t_vox,
            "device_mc_s": t_dmc, "host_mc_s": t_hmc, "mc": cmp}


def phase_sharded_n1(sizes: Sizes, dev, scans, single_map,
                     workdir: str) -> dict:
    """4: ShardedTSDFMap on one device against TSDFMap on the same stream;
    checkpoint save + load round-trips the result."""
    from chad_tsdf_tpu.io.checkpoint import load_checkpoint, save_checkpoint
    from chad_tsdf_tpu.parallel import ShardedTSDFMap, make_mesh

    cfg = sizes.stream_cfg
    mesh = make_mesh(1)
    t_first = insert_all(ShardedTSDFMap(config=cfg, mesh=mesh), scans)
    sm = ShardedTSDFMap(config=cfg, mesh=mesh)
    t_warm = insert_all(sm, scans)
    # one codec step: identical code, but the GPU's f32 sums may land on
    # either side of an 8-bit quantization boundary
    cmp = compare_leaves(sm.leaf_arrays(), single_map.leaf_arrays(),
                         cfg.sdf_trunc / 127 + 1e-7)
    path = os.path.join(workdir, "n1.npz")
    t0 = time.perf_counter()
    save_checkpoint(path, sm)
    t_ckpt = time.perf_counter() - t0
    back = run_on(dev, load_checkpoint, path)
    rt = compare_leaves(back.leaf_arrays(), sm.leaf_arrays(), 0.0)
    return {"tolerance": "same voxels and weights; sd <= trunc/127; "
                         "checkpoint exact",
            "scans": len(scans), "stream_first_s": t_first,
            "stream_warm_s": t_warm, "vs_single": cmp,
            "checkpoint_s": t_ckpt, "checkpoint_roundtrip": rt}


def phase_repeat(cfg, maps) -> dict:
    """5: two runs of (a) — are the pools bit-identical?"""
    import numpy as np
    a, b = maps[0].state, maps[1].state
    bit = all(np.array_equal(np.asarray(getattr(a, f)),
                             np.asarray(getattr(b, f)))
              for f in ("dir_keys", "dir_slots", "pool_w", "pool_sd"))
    out = {"tolerance": "reports bit identity; same directory and "
                        "weights, sd <= trunc/32767 + 2*w*2^-24*trunc",
           "bit_identical": bit}
    if not bit:
        sd_a, sd_b = np.asarray(a.pool_sd), np.asarray(b.pool_sd)
        out["differing_sd_sums"] = int(np.sum(sd_a != sd_b))
        out["max_sd_sum_diff_m"] = float(np.abs(sd_a - sd_b).max())
    out["within_tolerance"] = compare_states(a, b, cfg.sdf_trunc)
    return out


def loop_closure_scenario(n_points: int):
    """examples/demo_loop_closure.py: two passes over a sphere, the second
    with injected odometry drift, one loop edge; returns submap 1's
    correction."""
    import numpy as np

    from chad_tsdf_tpu import MapConfig, TSDFMap
    rng = np.random.default_rng(7)
    d = rng.normal(size=(n_points, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * 2.0).astype(np.float32)
    drift = np.float32([0.35, 0.0, 0.0])
    pos2 = np.float32([0.6, 0.0, 0.0])
    m = TSDFMap(config=MapConfig(max_points=1 << 16,
                                 block_capacity=1 << 14,
                                 touched_capacity=1 << 13,
                                 submap_distance=0.5))
    m.insert(pts, np.zeros(3, np.float32))
    m.finalize_active()
    m.insert(pts + drift, pos2 + drift)
    m.finalize_active()
    z = np.eye(4)
    z[:3, 3] = pos2
    stats = m.optimize_loop_closures(loop_edges=[(0, 1, z, 1000.0)])
    return m.submaps[1].corrected, stats


def phase_pose_graph(sizes: Sizes, dev, ref_dev) -> dict:
    import numpy as np
    t0 = time.perf_counter()
    corr, stats = run_on(dev, loop_closure_scenario, sizes.loop_points)
    t_dev = time.perf_counter() - t0
    corr_ref, stats_ref = run_on(ref_dev, loop_closure_scenario,
                                 sizes.loop_points)
    d = float(np.abs(corr - corr_ref).max())
    check(d <= POSE_ATOL, f"correction off by {d:.3g} > {POSE_ATOL}")
    # the drift was +0.35 m in x: the correction must undo it
    check(abs(corr[0, 3] + 0.35) < 0.05, f"correction {corr[:3, 3]}")
    return {"tolerance": f"correction within {POSE_ATOL:g}",
            "points": sizes.loop_points, "first_s": t_dev,
            "max_correction_diff": d, "final_cost": stats["final_cost"],
            "cpu_final_cost": stats_ref["final_cost"]}


def phase_four_cards(sizes: Sizes, devices, scans, workdir: str) -> dict:
    """6: ShardedTSDFMap over four cards against TSDFMap on card 0;
    checkpoint saved on four, loaded on one."""
    import numpy as np

    from chad_tsdf_tpu.io.checkpoint import load_checkpoint, save_checkpoint
    from chad_tsdf_tpu.parallel import ShardedTSDFMap, make_mesh

    cfg = sizes.stream_cfg
    mesh = make_mesh(len(devices))
    t_first = insert_all(ShardedTSDFMap(config=cfg, mesh=mesh), scans)
    sm = ShardedTSDFMap(config=cfg, mesh=mesh)
    overflow, sent = [], []
    t0 = time.perf_counter()
    for pts, pos in scans:
        met = sm.insert(pts, pos)
        overflow.append(met.raw("route_overflow"))
        sent.append(met.raw("route_sent"))
    _sync(sm)
    t_warm = time.perf_counter() - t0
    single = new_map(cfg, devices[0])
    t_single = run_on(devices[0], insert_all, single, scans)

    ls, lr = sm.leaf_arrays(), single.leaf_arrays()
    check(np.array_equal(ls[0], lr[0]),
          f"voxel sets differ ({len(ls[0])} vs {len(lr[0])})")
    check(np.array_equal(ls[2], lr[2]), "weights differ")
    # normals are fitted per shard, so neighbourhoods cut at the n-1
    # ownership boundaries change sd there (tests/test_sharded_map.py)
    step = cfg.sdf_trunc / 127
    close = float(np.mean(np.abs(ls[1] - lr[1]) <= 2 * step))
    check(close > 0.98, f"only {close:.4f} of sd within 2 codec steps")

    path = os.path.join(workdir, "four.npz")
    save_checkpoint(path, sm)
    back = run_on(devices[0], load_checkpoint, path)
    rt = compare_leaves(back.leaf_arrays(), ls, cfg.sdf_trunc / 127 + 1e-7)
    return {"tolerance": "same voxels and weights; >= 98% of sd within "
                         "2 codec steps; checkpoint 4->1 within 1 step",
            "cards": len(devices), "scans": len(scans),
            "stream_first_s": t_first, "stream_warm_s": t_warm,
            "single_card_s": t_single,
            "route_overflow": int(sum(int(v) for v in overflow)),
            "halo_rows_sent": int(sum(int(v) for v in sent)),
            "sd_within_2_steps": close, "voxels": int(len(ls[0])),
            "checkpoint_4_to_1": rt}


# --- driver -----------------------------------------------------------------
def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k}={_fmt(x)}" for k, x in v.items()) + "}"
    return str(v)


def report(name: str, res: dict, dev) -> None:
    fields = ", ".join(f"{k}={_fmt(v)}" for k, v in res.items())
    print(f"[{name}] PASS peak_mib={peak_mib(dev):.1f} {fields}", flush=True)


def run_phases(phases, dev) -> bool:
    ok = True
    for name, fn in phases:
        try:
            res = fn()
        except Exception as e:      # report and go on; the run still fails
            ok = False
            traceback.print_exc()
            print(f"[{name}] FAIL {type(e).__name__}: {e}", flush=True)
            continue
        report(name, res, dev)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1,
                    help="4: run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX's default backend is "
              f"{devices[0].platform!r}, not a GPU", file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"chip_smoke: {args.chips} cards asked, {len(devices)} "
              "found", file=sys.stderr)
        return 2

    from chad_tsdf_tpu import native
    from chad_tsdf_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev, cpu = devices[0], jax.devices("cpu")[0]
    print(f"jax {jax.__version__}: {len(devices)} x {dev.device_kind}; "
          f"DAG build: {'native' if native.available() else 'numpy'}; "
          f"compile cache: {cache}", flush=True)

    sizes = full_sizes()
    t_start = time.perf_counter()
    scans = stream_scans(sizes)
    print(f"stream: {len(scans)} scans, "
          f"{sum(len(p) for p, _ in scans)} points, generated in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        if args.chips == 4:
            ok = run_phases([("phase6 four cards", lambda: phase_four_cards(
                sizes, devices[:4], scans, workdir))], dev)
        else:
            keep = {}
            ok = run_phases([
                ("phase1 sphere gpu-vs-cpu", lambda: phase_sphere(
                    sizes, dev, cpu, workdir, keep)),
                ("phase2 xla-vs-seg", lambda: phase_xla_vs_seg(
                    sizes, dev, scans)),
                ("phase3 stream+save", lambda: phase_stream(
                    sizes, dev, scans, workdir, keep)),
                ("phase4 sharded-n1+checkpoint", lambda: phase_sharded_n1(
                    sizes, dev, scans, keep["stream_map"], workdir)),
                ("phase5 repeatability", lambda: phase_repeat(
                    sizes.sphere_cfg, keep["sphere_maps"])),
                ("pose graph gpu-vs-cpu", lambda: phase_pose_graph(
                    sizes, dev, cpu)),
            ], dev)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
