"""Worker for the 2-process jax.distributed CPU test (run by
tests/test_distributed.py, one subprocess per process id).

Each process owns 4 virtual CPU devices; the global 8-device mesh runs the
sharded insert step with gloo collectives — the multi-host execution path of
SURVEY §5.8 without a cluster.  Prints one "DIST_OK {...}" JSON line on
success; the parent asserts on it.
"""

import json
import sys


def main():
    pid = int(sys.argv[1])
    port = sys.argv[2]

    import jax
    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    sys.path.insert(0, sys.argv[3])
    from chad_tsdf_tpu.config import MapConfig
    from chad_tsdf_tpu.core import integrate
    from chad_tsdf_tpu.core.state import (create_state,
                                          origin_blocks_for_position)
    from chad_tsdf_tpu.parallel import (create_sharded_state, distributed,
                                        make_mesh, make_sharded_insert,
                                        morton_split)
    from jax.sharding import PartitionSpec as P

    distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=pid)
    info = distributed.process_info()
    assert info["process_count"] == 2, info
    assert info["global_devices"] == 8, info

    cfg = MapConfig(max_points=512, block_capacity=4096,
                    touched_capacity=2048, accumulate_impl="xla")
    n_dev = 8
    mesh = make_mesh(n_dev)
    pos = np.zeros(3, np.float32)
    origin = origin_blocks_for_position(pos, cfg)

    # identical on every process: deterministic cloud + split
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n_dev * cfg.max_points, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * 2.0).astype(np.float32)
    chunks = morton_split(pts, n_dev, cfg.sdf_res)
    padded = np.zeros((n_dev * cfg.max_points, 3), np.float32)
    n_per = np.zeros((n_dev,), np.int32)
    for i, c in enumerate(chunks):
        padded[i * cfg.max_points:i * cfg.max_points + len(c)] = c
        n_per[i] = len(c)

    state_stack = create_sharded_state(cfg, mesh, origin)
    step, _ = make_sharded_insert(cfg, mesh)
    pts_g = distributed.global_shard_array(padded, mesh, P("shard"))
    n_per_g = distributed.global_shard_array(n_per, mesh, P("shard"))
    from chad_tsdf_tpu.parallel import key_bounds
    state_stack, metrics = step(state_stack, pts_g, n_per_g, pos,
                                key_bounds(n_dev, cfg))
    metrics = {k: int(v) for k, v in metrics.items()}       # replicated

    # global reductions over the distributed pool for the oracle check
    import jax.numpy as jnp

    @jax.jit
    def totals(stack):
        return (jnp.sum(stack.pool_w),
                jnp.sum(stack.n_blocks),
                jnp.sum(stack.point_overflow) +
                jnp.sum(stack.sample_overflow) +
                jnp.sum(stack.block_overflow) +
                jnp.sum(stack.touched_overflow))
    w_total, blocks_total, ovf_total = [float(x) for x in
                                        totals(state_stack)]

    # single-process oracle on local devices
    sd_cfg = MapConfig(max_points=n_dev * cfg.max_points,
                       block_capacity=16384, touched_capacity=8192,
                       accumulate_impl="xla")
    ref = create_state(sd_cfg, origin)
    ref, ref_m = integrate.insert_step(ref, jnp.asarray(pts),
                                       jnp.int32(len(pts)),
                                       jnp.asarray(pos), sd_cfg)
    assert metrics["route_overflow"] == 0, metrics
    assert metrics["n_valid_samples"] == int(ref_m["n_valid_samples"])
    assert int(blocks_total) == int(ref_m["n_blocks"]), (
        blocks_total, int(ref_m["n_blocks"]))
    assert ovf_total == 0
    ref_w = float(np.asarray(ref.pool_w).sum())
    assert w_total == ref_w, (w_total, ref_w)

    print("DIST_OK " + json.dumps({"pid": pid, **metrics,
                                   "w_total": w_total}), flush=True)

    # ---- phase 2: the user-facing ShardedTSDFMap lifecycle across the
    # 2-process mesh (VERDICT r4 task 2): insert -> rotation (deferred,
    # in-graph all_gather extraction) -> save -> checkpoint.  Every
    # process must build the IDENTICAL map; the parent test also checks
    # the digest against a single-process run of the same stream.
    import hashlib
    import os

    from chad_tsdf_tpu.io.checkpoint import save_checkpoint
    from chad_tsdf_tpu.parallel import ShardedTSDFMap

    def sphere(n, r, seed, centre):
        g = np.random.default_rng(seed)
        dd = g.normal(size=(n, 3))
        dd /= np.linalg.norm(dd, axis=1, keepdims=True)
        return (np.float32(centre) + dd * r).astype(np.float32)

    m = ShardedTSDFMap(config=cfg, mesh=mesh)
    m.insert(sphere(2048, 1.5, 100, (0, 0, 0)), np.zeros(3, np.float32))
    m.insert(sphere(2048, 1.5, 101, (8, 0, 0)), np.float32([8, 0, 1.7]))
    assert len(m._pending) == 1, "rotation must be deferred"

    ply_path = f"/tmp/dist_mesh_p{pid}.ply"
    m.save(ply_path)
    assert len(m.submaps) == 1, m.n_submaps
    codes, sd = m.voxel_samples()
    digest = hashlib.sha256(codes.tobytes() + sd.tobytes()).hexdigest()

    ckpt_path = f"/tmp/dist_ckpt_p{pid}.npz"
    save_checkpoint(ckpt_path, m)
    z = np.load(ckpt_path, allow_pickle=False)
    ck_digest = hashlib.sha256(
        z["active_dir_keys"].tobytes() + z["active_pool_sd"].tobytes() +
        z["active_pool_w"].tobytes()).hexdigest()

    st = m.stats()
    print("LIFECYCLE_OK " + json.dumps({
        "pid": pid, "digest": digest, "ck_digest": ck_digest,
        "n_submaps": st["n_submaps"], "n_voxels": int(len(codes)),
        "mesh_bytes": os.path.getsize(ply_path),
        "route_overflow": int(m.last_metrics.get("route_overflow", 0)),
    }), flush=True)


if __name__ == "__main__":
    main()
