"""Morton (Z-order) codes as vectorized integer arithmetic.

The reference uses libmorton's BMI2 ``pdep/pext`` instructions for 63-bit
3D Morton codes (reference: include/chad/detail/morton.hpp:7-9,24-35).  XLA
has no pdep, so codes are built with the classic magic-number bit-spread,
which vectorizes as plain integer arithmetic.

Two key domains are used:

* **Device (int32)**: the active map lives in a submap-local coordinate frame
  (blocks of 8^3 voxels, up to 2**block_bits blocks per axis).  A local block
  key interleaves three ``block_bits``-wide coordinates into a single int32
  (30 bits for the default block_bits=10); the 9-bit intra-block offset
  interleaves three 3-bit coordinates.  Splitting the 39-bit local voxel code
  into ``(block_key, offset)`` keeps every hot sort/search on single int32
  keys, with no 64-bit integer arithmetic on the device.

* **Host (uint64)**: finalized submaps and meshing use the reference's global
  63-bit code: 21 bits per axis, signed coordinates biased by ``1 << 20``
  (morton.hpp:24-26).  Bit layout matches libmorton: x in bits 0,3,6,...,
  y in 1,4,7,..., z in 2,5,8,...  Because ``bias = 2**20 = 2**17 * 8``,
  ``encode63(block*8 + offset) == encode_block21(block + 2**17) << 9 | encode_offset(offset)``,
  so the device's (block, offset) split nests exactly inside the global code.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# device-side int32 codes
# ---------------------------------------------------------------------------


def spread3_10(x):
    """Spread the low 10 bits of ``x`` to bits 0,3,6,...,27 (int32)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def compact3_10(x):
    """Inverse of :func:`spread3_10`."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def encode_block(bx, by, bz):
    """Interleave three <=10-bit non-negative block coords into one int32."""
    return spread3_10(bx) | (spread3_10(by) << 1) | (spread3_10(bz) << 2)


def decode_block(key):
    """Inverse of :func:`encode_block` -> (bx, by, bz)."""
    return compact3_10(key), compact3_10(key >> 1), compact3_10(key >> 2)


def spread3_3(x):
    """Spread the low 3 bits of ``x`` to bits 0,3,6."""
    x = x & 0x7
    return (x & 1) | ((x & 2) << 2) | ((x & 4) << 4)


def compact3_3(x):
    return (x & 1) | ((x >> 2) & 2) | ((x >> 4) & 4)


def encode_offset(ox, oy, oz):
    """Interleave three 3-bit intra-block coords into a 9-bit offset code."""
    return spread3_3(ox) | (spread3_3(oy) << 1) | (spread3_3(oz) << 2)


def decode_offset(off):
    return compact3_3(off), compact3_3(off >> 1), compact3_3(off >> 2)


def voxel_to_block_offset(vx, vy, vz):
    """Local non-negative voxel coords -> (block int32 key, 9-bit offset)."""
    block = encode_block(vx >> 3, vy >> 3, vz >> 3)
    off = encode_offset(vx & 7, vy & 7, vz & 7)
    return block, off


def points_to_local_voxels(points, origin_voxel, extent_voxels, sdf_res):
    """Discretize world points to local non-negative voxel coordinates.

    Discretization is ``floor(p / res)`` exactly as the reference
    (morton.hpp:71).  ``origin_voxel`` is the world voxel coordinate of the
    local frame's corner; coordinates are clamped to ``[0, extent)`` and an
    out-of-range mask is returned so overflow can be counted, never silently
    dropped.
    """
    vox_world = jnp.floor(points * (1.0 / sdf_res)).astype(jnp.int32)
    local = vox_world - origin_voxel[None, :]
    in_range = jnp.all((local >= 0) & (local < extent_voxels), axis=-1)
    local = jnp.clip(local, 0, extent_voxels - 1)
    return local, in_range


# ---------------------------------------------------------------------------
# host-side uint64 codes (global 63-bit, reference morton.hpp semantics)
# ---------------------------------------------------------------------------

_BIAS21 = np.uint64(1 << 20)


def np_spread3_21(x: np.ndarray) -> np.ndarray:
    """Spread low 21 bits to bits 0,3,...,60 (numpy uint64)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def np_compact3_21(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x1249249249249249)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return x


def np_encode63(coords: np.ndarray) -> np.ndarray:
    """Signed int32 voxel coords (N,3) -> 63-bit Morton codes (N,) uint64.

    Matches reference MortonCode::encode (morton.hpp:24-28): coordinates are
    biased by ``1 << 20`` into unsigned 21-bit space before interleaving.
    """
    c = coords.astype(np.int64) + np.int64(1 << 20)
    x = np_spread3_21(c[..., 0].astype(np.uint64))
    y = np_spread3_21(c[..., 1].astype(np.uint64))
    z = np_spread3_21(c[..., 2].astype(np.uint64))
    return x | (y << np.uint64(1)) | (z << np.uint64(2))


def np_decode63(codes: np.ndarray) -> np.ndarray:
    """Inverse of :func:`np_encode63` -> signed int32 coords (N,3)."""
    x = np_compact3_21(codes)
    y = np_compact3_21(codes >> np.uint64(1))
    z = np_compact3_21(codes >> np.uint64(2))
    out = np.stack([x, y, z], axis=-1).astype(np.int64) - np.int64(1 << 20)
    return out.astype(np.int32)


def np_block_key_to_world63(block_keys: np.ndarray, origin_block: np.ndarray,
                            block_bits: int) -> np.ndarray:
    """Local int32 block keys -> 54-bit world *block* Morton codes (uint64).

    ``origin_block`` is the world block coordinate of local block (0,0,0).
    The result, shifted left by 9 and or-ed with an intra-block offset code,
    equals the reference's 63-bit voxel Morton code.
    """
    k = block_keys.astype(np.int64)
    bx = _np_compact3_10(k)
    by = _np_compact3_10(k >> 1)
    bz = _np_compact3_10(k >> 2)
    world = np.stack([bx, by, bz], axis=-1) + origin_block[None, :].astype(np.int64)
    # bias in block space: 2**20 voxels == 2**17 blocks
    b = world + np.int64(1 << 17)
    x = np_spread3_21(b[..., 0].astype(np.uint64))
    y = np_spread3_21(b[..., 1].astype(np.uint64))
    z = np_spread3_21(b[..., 2].astype(np.uint64))
    return x | (y << np.uint64(1)) | (z << np.uint64(2))


def _np_compact3_10(x):
    x = np.asarray(x, dtype=np.int64) & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x
