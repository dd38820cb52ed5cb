"""Morton (Z-order) codes for LBVH construction — all vectorized jnp.

The reference's `optixAccelBuild` hides BVH construction in the driver
(`include/optix_host.h:562`); this rebuild constructs an LBVH from
Morton-sorted primitive centroids (Karras-style), so the build itself is a
data-parallel program that runs on device (SURVEY.md §7 hard part #1).
"""
from __future__ import annotations

import jax.numpy as jnp

MORTON_BITS = 10  # per axis → 30-bit codes


def expand_bits(v):
    """Spread the low 10 bits of each lane: b9..b0 → b9 0 0 b8 0 0 ... b0."""
    v = jnp.asarray(v, jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton3d(points, lo, hi):
    """30-bit Morton codes for [N, 3] points quantized inside AABB (lo, hi)."""
    extent = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip((points - lo) / extent, 0.0, 1.0 - 1e-7)
    cells = (q * (1 << MORTON_BITS)).astype(jnp.uint32)
    xx = expand_bits(cells[:, 0])
    yy = expand_bits(cells[:, 1])
    zz = expand_bits(cells[:, 2])
    return (xx << 2) | (yy << 1) | zz
