"""Vector math over [..., 3] arrays (the `sutil/vec_math.h` equivalent).

The reference ships a 2.6 kLoC header of float2/3/4 operator overloads
(`SDK/sutil/vec_math.h`) used by every host and device file. In JAX the idiomatic
representation is structure-of-arrays: a "float3" is any jnp array whose last axis
has size 3, and every helper below broadcasts over arbitrary leading batch axes so
the same code path serves one ray or a [H, W]-tile of rays.

Everything is pure jnp → usable inside jit, Pallas kernels, grad, vmap, shard_map.
"""
from __future__ import annotations

import jax.numpy as jnp


def vec3(x, y, z, dtype=jnp.float32):
    """Build a [..., 3] vector by stacking components along a new last axis."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)), axis=-1)


def dot(a, b):
    """Batched dot product over the last axis, keepdims=False → [...]."""
    return jnp.sum(a * b, axis=-1)


def vdot(a, b):
    """Batched dot product keeping the reduced axis → [..., 1] (broadcast-friendly)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    """Batched cross product over the last axis (reference `vec_math.h` cross)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1)


def length(a):
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def length2(a):
    return dot(a, a)


def normalize(a, eps=1e-20):
    """Safe normalize: returns a / |a|, with |a| clamped away from zero."""
    return a * jnp.reciprocal(jnp.sqrt(jnp.maximum(dot(a, a), eps)))[..., None]


def reflect(i, n):
    """Mirror reflection of incident direction `i` about normal `n`.

    Matches the reference semantics (`sutil/vec_math.h` reflect): i points *toward*
    the surface; the result points away.
    """
    return i - 2.0 * vdot(i, n) * n


def refract(i, n, eta):
    """Snell refraction. Returns (direction, did_refract_mask).

    `i` points toward the surface, `n` away from it, `eta` = n_i / n_t.
    On total internal reflection the mask is False and the direction is zero
    (callers select reflection instead), mirroring `vec_math.h` refract which
    returns false on TIR.
    """
    eta = jnp.asarray(eta, jnp.float32)
    cos_i = -dot(i, n)
    sin2_t = (eta * eta) * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    ok = sin2_t <= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    d = eta[..., None] * i + (eta * cos_i - cos_t)[..., None] * n
    return jnp.where(ok[..., None], d, 0.0), ok


def faceforward(n, i, nref):
    """Flip n so it faces the half-space of i w.r.t. nref (`vec_math.h` faceforward)."""
    return n * jnp.sign(dot(i, nref))[..., None]


def lerp(a, b, t):
    return a + (b - a) * t


def clamp(x, lo, hi):
    return jnp.clip(x, lo, hi)


def luminance(rgb):
    """Rec.709 luminance (reference `cuda/helpers.h` luminance weights)."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def orthonormal_basis(n):
    """Build a right-handed ONB (tangent, bitangent) around unit normal n.

    Branchless Frisvad/Duff construction — replaces the reference's Onb struct
    (`SDK/optixPathTracer/optixPathTracer.cu:47-71`) without its if/else on n.z,
    which would be a divergent branch on a vector machine.
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], axis=-1)
    bt = jnp.stack([b, sign + ny * ny * a, -ny], axis=-1)
    return t, bt
