"""Normal estimation from Morton neighbourhoods, vectorized.

The reference walks the Morton-sorted point list sequentially: for each point
it grows a neighbourhood by coarsening the Morton prefix 3 bits at a time
(up to 3 rounds — voxel, 2^3 block, 4^3 block) until it has >= 8 points,
fits a plane with the weighted-determinant covariance method, flips the
normal toward the scanner, and assigns it to the whole run (reference:
include/chad/detail/normals.hpp:81-148; plane fit at 10-80, credited to
"plane from points", ilikebigbits.com).

Array-program reformulation (order-independent, deterministic):

* points are sorted by their local (block, offset) Morton key;
* for depth d in {0,1,2} the points partition into *segments* of equal
  ``code >> 3d``; segment moments are computed with one segmented
  associative scan (no hashmaps, no scatter);
* each point uses the smallest depth whose full segment reaches
  ``min_points``; the plane fit then consumes the exact per-segment
  covariance; otherwise the fallback normal ``normalize(position - point)``
  is used (normals.hpp:127-134).

Layout note: all arrays are 1-D (N,) or feature-major (F, N) — see
ops/dda.py.

Two deliberate deviations from the reference, documented per SURVEY §7:
the reference's greedy cursor makes later points in a segment use only the
segment *suffix* and its forward walk never absorbs the final point
(normals.hpp:100, a bounds quirk); we use full segments for every point —
order-independent and strictly more data per fit.

Numerical care: covariance is accumulated from coordinates *relative to the
segment's first point* (shift-invariant), so second moments never suffer the
catastrophic cancellation a global cumsum-difference would have at world
scale.  The reference uses double precision (normals.hpp:12); the device
path runs in f32, so additionally the covariance is normalized to unit max
element before the quartic determinant weights (which would underflow
f32).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import segops


def _plane_normal_from_moments(n, s, ss):
    """Weighted-determinant plane normal from segment moments.

    ``n``: (N,) counts; ``s``: (3, N) coordinate sums; ``ss``: (6, N) sums
    of products (xx, xy, xz, yy, yz, zz) — all relative to an arbitrary
    per-segment shift.  Reproduces normals.hpp:10-80 in f32.
    Returns (nx, ny, nz) unit normals.
    """
    recip = 1.0 / jnp.maximum(n, 1.0)
    mx, my, mz = s[0] * recip, s[1] * recip, s[2] * recip
    xx = ss[0] * recip - mx * mx
    xy = ss[1] * recip - mx * my
    xz = ss[2] * recip - mx * mz
    yy = ss[3] * recip - my * my
    yz = ss[4] * recip - my * mz
    zz = ss[5] * recip - mz * mz

    # normalize covariance scale (reference computes in f64; the quartic
    # weights below underflow f32 for mm-scale neighbourhoods)
    m = jnp.maximum(jnp.abs(xx), jnp.abs(xy))
    m = jnp.maximum(m, jnp.abs(xz))
    m = jnp.maximum(m, jnp.abs(yy))
    m = jnp.maximum(m, jnp.abs(yz))
    m = jnp.maximum(m, jnp.abs(zz))
    msc = 1.0 / jnp.maximum(m, 1e-30)
    xx, xy, xz = xx * msc, xy * msc, xz * msc
    yy, yz, zz = yy * msc, yz * msc, zz * msc

    det_x = yy * zz - yz * yz
    ax0, ax1, ax2 = det_x, xz * yz - xy * zz, xy * yz - xz * yy
    w = det_x * det_x
    wx, wy, wz = ax0 * w, ax1 * w, ax2 * w

    det_y = xx * zz - xz * xz
    ay0, ay1, ay2 = xz * yz - xy * zz, det_y, xy * xz - yz * xx
    w = det_y * det_y
    w = jnp.where(wx * ay0 + wy * ay1 + wz * ay2 < 0.0, -w, w)
    wx, wy, wz = wx + ay0 * w, wy + ay1 * w, wz + ay2 * w

    det_z = xx * yy - xy * xy
    az0, az1, az2 = xy * yz - xz * yy, xy * xz - yz * xx, det_z
    w = det_z * det_z
    w = jnp.where(wx * az0 + wy * az1 + wz * az2 < 0.0, -w, w)
    wx, wy, wz = wx + az0 * w, wy + az1 * w, wz + az2 * w

    norm = jnp.sqrt(wx * wx + wy * wy + wz * wz)
    inv = 1.0 / jnp.maximum(norm, 1e-30)
    return wx * inv, wy * inv, wz * inv


def estimate_normals_soa(px, py, pz, block_keys, offsets, valid, position,
                         min_points: int = 8, max_depth: int = 3):
    """Estimate one normal per (sorted) point.

    Args:
      px, py, pz: (N,) f32 point coordinates in Morton order.
      block_keys / offsets: (N,) int32 local Morton key of each point's voxel.
      valid: (N,) bool — padding mask; invalid points get the fallback normal.
      position: (3,) scanner position.
    Returns:
      (nx, ny, nz): (N,) f32 unit normals, flipped toward the scanner
      (normals.hpp:117-118).
    """
    n = px.shape[0]

    # relative coordinates for numerically safe second moments
    # (anchor = the segment start at the COARSEST depth, shared by all finer
    # segments within it)
    coarse_key = offsets >> (3 * (max_depth - 1))
    coarse_flags = segops.boundary_flags((block_keys, coarse_key)) | \
        segops.boundary_flags(valid)
    anchors = segops.segment_broadcast_first(
        coarse_flags, jnp.stack([px, py, pz], axis=0))
    rx = px - anchors[0]
    ry = py - anchors[1]
    rz = pz - anchors[2]

    feats = jnp.stack([
        jnp.ones((n,), jnp.float32), rx, ry, rz,
        rx * rx, rx * ry, rx * rz, ry * ry, ry * rz, rz * rz,
    ], axis=0)                                           # (10, N)

    best = jnp.zeros((10, n), jnp.float32)
    found = jnp.zeros((n,), jnp.bool_)

    for depth in range(max_depth):
        key_d = offsets >> (3 * depth)
        flags = segops.boundary_flags((block_keys, key_d)) | \
            segops.boundary_flags(valid)
        run = segops.segmented_sum_scan(flags, feats)     # (10, N)
        seg = segops.segment_broadcast_last(flags, run)   # gather-free
        cnt = seg[0]
        ok = (~found) & (cnt >= float(min_points))
        best = jnp.where(ok[None, :], seg, best)
        found = found | ok

    nx, ny, nz = _plane_normal_from_moments(best[0], best[1:4], best[4:10])

    tx = position[0] - px
    ty = position[1] - py
    tz = position[2] - pz
    tn = jnp.sqrt(tx * tx + ty * ty + tz * tz)
    tinv = 1.0 / jnp.maximum(tn, 1e-30)
    tx, ty, tz = tx * tinv, ty * tinv, tz * tinv
    # flip plane normal toward the scanner (normals.hpp:117-118)
    flip = nx * tx + ny * ty + nz * tz < 0.0
    nx = jnp.where(flip, -nx, nx)
    ny = jnp.where(flip, -ny, ny)
    nz = jnp.where(flip, -nz, nz)
    # fallback: normalized point->scanner vector (normals.hpp:127-134)
    fb = (~found) | (~valid)
    return (jnp.where(fb, tx, nx), jnp.where(fb, ty, ny),
            jnp.where(fb, tz, nz))


def estimate_normals(points_sorted, block_keys, offsets, valid, position,
                     min_points: int = 8, max_depth: int = 3):
    """(N, 3)-array convenience wrapper around :func:`estimate_normals_soa`."""
    nx, ny, nz = estimate_normals_soa(
        points_sorted[:, 0], points_sorted[:, 1], points_sorted[:, 2],
        block_keys, offsets, valid, position, min_points, max_depth)
    return jnp.stack([nx, ny, nz], axis=-1)
