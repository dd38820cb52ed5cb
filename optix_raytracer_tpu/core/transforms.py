"""Affine 3-D transforms as [..., 3, 4] arrays (rotation|translation).

Replaces `SDK/sutil/Matrix.h` / `Quaternion.h` and the instance-transform
plumbing of the reference's IAS path (`OptixInstance::transform` is a row-major
3x4 — `include/optix_types.h:970-1010`; applied on-device via the transform
stack, `include/optix_device.h:728-868`). All helpers broadcast over leading
batch axes so a whole instance table transforms in one fused op.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST


def identity(batch_shape=()):
    m = jnp.zeros(batch_shape + (3, 4), jnp.float32)
    return m.at[..., :, :3].set(jnp.eye(3, dtype=jnp.float32))


def from_rotation_translation(rot, trans):
    """rot: [..., 3, 3], trans: [..., 3] → [..., 3, 4]."""
    return jnp.concatenate([rot, trans[..., :, None]], axis=-1)


def translate(t):
    return from_rotation_translation(jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                                                      jnp.shape(t)[:-1] + (3, 3)),
                                     jnp.asarray(t, jnp.float32))


def scale(s):
    s = jnp.asarray(s, jnp.float32)
    if s.ndim == 0:
        s = jnp.stack([s, s, s])
    rot = jnp.zeros(s.shape[:-1] + (3, 3), jnp.float32)
    for i in range(3):
        rot = rot.at[..., i, i].set(s[..., i])
    return from_rotation_translation(rot, jnp.zeros(s.shape[:-1] + (3,), jnp.float32))


def rotate(axis, angle):
    """Rodrigues rotation about unit `axis` by `angle` radians → [3, 4]."""
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1.0 - c
    rot = jnp.asarray([
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
    ], jnp.float32)
    return from_rotation_translation(rot, jnp.zeros(3, jnp.float32))


def compose(a, b):
    """Transform composition: apply b first, then a. Both [..., 3, 4]."""
    rot = jnp.einsum("...ij,...jk->...ik", a[..., :3], b[..., :3],
                     precision=_HIGHEST)
    trans = jnp.einsum("...ij,...j->...i", a[..., :3], b[..., 3],
                       precision=_HIGHEST) + a[..., 3]
    return from_rotation_translation(rot, trans)


def apply_point(m, p):
    """m: [..., 3, 4], p: [..., 3] → rotated + translated point."""
    return jnp.einsum("...ij,...j->...i", m[..., :3], p,
                      precision=_HIGHEST) + m[..., 3]


def apply_vector(m, v):
    """Rotation/scale only (directions, no translation)."""
    return jnp.einsum("...ij,...j->...i", m[..., :3], v, precision=_HIGHEST)


def apply_normal(m, n):
    """Transform a normal by the inverse-transpose of the linear part."""
    inv = jnp.linalg.inv(m[..., :3])
    return jnp.einsum("...ji,...j->...i", inv, n, precision=_HIGHEST)


def inverse(m):
    """Inverse of an affine [..., 3, 4] transform."""
    rinv = jnp.linalg.inv(m[..., :3])
    tinv = -jnp.einsum("...ij,...j->...i", rinv, m[..., 3],
                       precision=_HIGHEST)
    return from_rotation_translation(rinv, tinv)


def to_4x4(m):
    pad = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32),
                           m.shape[:-2] + (1, 4))
    return jnp.concatenate([m, pad], axis=-2)
