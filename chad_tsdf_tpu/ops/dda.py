"""Fixed-budget Amanatides–Woo voxel traversal, vectorized over rays.

The reference walks each sensor ray through its truncation band with a
scalar DDA loop of data-dependent length (reference:
include/chad/detail/octree.hpp:90-152, citing "A fast voxel traversal
algorithm for ray tracing").  Data-dependent loops don't exist under XLA;
here the traversal is a ``lax.scan`` over a *static* step budget K with a
validity mask — every ray emits exactly K (voxel, valid) slots, and K is
chosen so no traversal is ever truncated (see MapConfig.dda_steps).

Layout note: everything is structure-of-arrays — per-axis 1-D (N,) arrays,
and (K, N) outputs.

Semantics replicated exactly (verified against a scalar port in tests):

* ray from ``point - dir*trunc`` to ``point + dir*trunc`` (octree.hpp:96-97),
* per-axis step = sign(voxel_final - voxel_start) (octree.hpp:103),
* tMax initialisation from floor/ceil of the start voxel boundary with
  +inf for zero-step axes (octree.hpp:108-121),
* step the axis with the smallest tMax, tie-break exactly as the nested ifs
  at octree.hpp:128-148,
* terminate (without emitting) when the stepped axis passes its final
  voxel; the start voxel is always emitted (octree.hpp:124-125).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# np (not jnp): a module-level device constant would initialise the XLA
# backend at import time, breaking jax.distributed.initialize ordering
_FMAX = np.float32(3.4028235e38)


def traverse(px, py, pz, position, sdf_res: float, sdf_trunc: float,
             num_steps: int):
    """Traverse rays through their truncation bands.

    Args:
      px, py, pz: (N,) float32 world point coordinates (ray endpoints).
      position: (3,) float32 scanner position (ray origins).
    Returns:
      (vx, vy, vz): each (K, N) int32 world voxel coordinates.
      valid: (K, N) bool — True where the slot holds a traversed voxel.
    """
    res = jnp.float32(sdf_res)
    trunc = jnp.float32(sdf_trunc)
    res_recip = jnp.float32(1.0 / sdf_res)

    dx = px - position[0]
    dy = py - position[1]
    dz = pz - position[2]
    norm = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    inv = 1.0 / norm
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    dir_ok = jnp.isfinite(dx) & jnp.isfinite(dy) & jnp.isfinite(dz)

    def axis_setup(p, d):
        start = p - d * trunc
        final = p + d * trunc
        vs = jnp.floor(start * res_recip).astype(jnp.int32)
        vf = jnp.floor(final * res_recip).astype(jnp.int32)
        sdir = jnp.sign(vf - vs).astype(jnp.int32)
        d_recip = 1.0 / d
        delta = jnp.abs(res * d_recip)
        bound = jnp.where(sdir < 0, res * jnp.floor(start * res_recip),
                          res * jnp.ceil(start * res_recip))
        tmax = jnp.abs((bound - start) * d_recip)
        tmax = jnp.where(sdir == 0, _FMAX, tmax)
        delta = jnp.where(sdir == 0, _FMAX, delta)
        return vs, vf, sdir, delta, tmax

    vsx, vfx, sx, dlx, tx = axis_setup(px, dx)
    vsy, vfy, sy, dly, ty = axis_setup(py, dy)
    vsz, vfz, sz, dlz, tz = axis_setup(pz, dz)

    def body(carry, _):
        vx, vy, vz, tx, ty, tz, alive = carry
        # axis selection replicating octree.hpp:128-148 nested conditionals:
        # if tx < ty: (tx < tz ? x : z) else: (ty < tz ? y : z)
        pick_x = (tx < ty) & (tx < tz)
        pick_y = (~(tx < ty)) & (ty < tz)
        pick_z = ~(pick_x | pick_y)

        nvx = jnp.where(pick_x, vx + sx, vx)
        nvy = jnp.where(pick_y, vy + sy, vy)
        nvz = jnp.where(pick_z, vz + sz, vz)
        ntx = jnp.where(pick_x, tx + dlx, tx)
        nty = jnp.where(pick_y, ty + dly, ty)
        ntz = jnp.where(pick_z, tz + dlz, tz)

        passed = jnp.where(
            pick_x, nvx == vfx + sx,
            jnp.where(pick_y, nvy == vfy + sy, nvz == vfz + sz))
        new_alive = alive & ~passed
        return ((nvx, nvy, nvz, ntx, nty, ntz, new_alive),
                (nvx, nvy, nvz, new_alive))

    carry0 = (vsx, vsy, vsz, tx, ty, tz, dir_ok)
    _, (ovx, ovy, ovz, ovalid) = jax.lax.scan(body, carry0, None,
                                              length=num_steps - 1)
    vx = jnp.concatenate([vsx[None, :], ovx], axis=0)
    vy = jnp.concatenate([vsy[None, :], ovy], axis=0)
    vz = jnp.concatenate([vsz[None, :], ovz], axis=0)
    valid = jnp.concatenate([dir_ok[None, :], ovalid], axis=0)
    return vx, vy, vz, valid


def signed_distances(vx, vy, vz, px, py, pz, nx, ny, nz, sdf_res: float,
                     sdf_trunc: float):
    """Projective signed distance per traversed voxel.

    Matches octree.hpp:156-159: ``sd = clamp(dot(normal, voxel*res - point),
    -trunc, +trunc)`` — the distance along the *surface normal*, measured at
    the voxel's grid position (its minimum corner, as in the reference).

    vx/vy/vz: (K, N) int32; px.../nx...: (N,) -> (K, N) f32.
    """
    res = jnp.float32(sdf_res)
    sd = (nx[None, :] * (vx.astype(jnp.float32) * res - px[None, :]) +
          ny[None, :] * (vy.astype(jnp.float32) * res - py[None, :]) +
          nz[None, :] * (vz.astype(jnp.float32) * res - pz[None, :]))
    return jnp.clip(sd, -sdf_trunc, sdf_trunc)
