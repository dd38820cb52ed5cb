"""Motion blur: 2-keyframe vertex motion + SRT/matrix motion transforms.

Covers the reference's motion machinery:
- motion GAS with 2 vertex keys + time-sampled rays (`optixSimpleMotionBlur`,
  motion options on the accel build): triangles are interpolated per ray
  time and intersected directly (Möller–Trumbore over [N, M] with per-ray
  vertices — the Woop precompute can't be shared across times, so the moving
  path uses the direct formulation);
- motion spheres (the sample's custom motion sphere IS): centers lerped per
  ray time;
- SRT / matrix motion *transforms* over instances (`optixMotionGeometry.cpp:
  568-625`, `OptixSRTMotionTransform`): rays are transformed into object
  space at their time (scale/rotate-slerp/translate interpolation), the
  static geometry is intersected once, and hits map back — exactly the
  driver's motion-transform traversal semantics.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from ..core import pytree

from ..core.rays import Hits, Rays
from ..core.vecmath import cross, dot, normalize

_EPS = 1e-12


@pytree.dataclass
class MotionTriangles:
    """Triangle mesh with two vertex keyframes (t = 0 and t = 1)."""
    v0_0: jnp.ndarray  # [M, 3] key 0
    e1_0: jnp.ndarray
    e2_0: jnp.ndarray
    v0_1: jnp.ndarray  # [M, 3] key 1
    e1_1: jnp.ndarray
    e2_1: jnp.ndarray

    @classmethod
    def make(cls, verts0, verts1, indices):
        verts0 = jnp.asarray(verts0, jnp.float32)
        verts1 = jnp.asarray(verts1, jnp.float32)
        indices = jnp.asarray(indices, jnp.int32)

        def tables(v):
            v0 = v[indices[:, 0]]
            return (v0, v[indices[:, 1]] - v0, v[indices[:, 2]] - v0)

        a = tables(verts0)
        b = tables(verts1)
        return cls(v0_0=a[0], e1_0=a[1], e2_0=a[2],
                   v0_1=b[0], e1_1=b[1], e2_1=b[2])

    @classmethod
    def empty(cls):
        z = jnp.zeros((0, 3), jnp.float32)
        return cls(v0_0=z, e1_0=z, e2_0=z, v0_1=z, e1_1=z, e2_1=z)

    @property
    def num_triangles(self):
        return self.v0_0.shape[0]


def intersect_motion_triangles(geom: MotionTriangles, rays: Rays, times):
    """Closest hit of time-sampled rays against 2-key moving triangles.

    times: [N] in [0, 1]. Möller–Trumbore over lerped triangle data.
    """
    t_lerp = times[:, None, None]
    v0 = geom.v0_0[None] + t_lerp * (geom.v0_1 - geom.v0_0)[None]
    e1 = geom.e1_0[None] + t_lerp * (geom.e1_1 - geom.e1_0)[None]
    e2 = geom.e2_0[None] + t_lerp * (geom.e2_1 - geom.e2_0)[None]

    o = rays.origin[:, None, :]
    d = rays.direction[:, None, :]
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) < _EPS, 0.0, 1.0 / jnp.where(det == 0,
                                                                  1.0, det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    tt = dot(e2, qvec) * inv_det
    ok = ((jnp.abs(det) >= _EPS) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (tt > rays.tmin[:, None]) & (tt < rays.tmax[:, None]))
    tt = jnp.where(ok, tt, jnp.inf)
    best = jnp.argmin(tt, axis=1)
    rows = jnp.arange(rays.tmin.shape[0])
    bt = tt[rows, best]
    hit = jnp.isfinite(bt)
    n = normalize(cross(e1[rows, best], e2[rows, best]))
    return Hits(
        t=jnp.where(hit, bt, rays.tmax),
        prim_id=jnp.where(hit, best.astype(jnp.int32), -1),
        inst_id=jnp.where(hit, 0, -1),
        mat_id=jnp.where(hit, 0, -1),
        uv=jnp.stack([u[rows, best], v[rows, best]], axis=-1),
        normal=jnp.where(hit[:, None], n, 0.0),
    )


def intersect_motion_spheres(centers0, centers1, radii, rays: Rays, times):
    """Moving spheres (the motion-sphere custom IS of optixSimpleMotionBlur):
    centers lerp between keys per ray time."""
    centers0 = jnp.asarray(centers0, jnp.float32)
    centers1 = jnp.asarray(centers1, jnp.float32)
    radii = jnp.asarray(radii, jnp.float32)
    c = centers0[None] + times[:, None, None] * (centers1 - centers0)[None]
    o = rays.origin[:, None, :]
    d = rays.direction[:, None, :]
    oc = o - c
    b = dot(oc, d)
    cq = dot(oc, oc) - radii[None] ** 2
    disc = b * b - cq
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    tt = jnp.where(t0 > rays.tmin[:, None], t0, t1)
    ok = (disc > 0) & (tt > rays.tmin[:, None]) & (tt < rays.tmax[:, None])
    tt = jnp.where(ok, tt, jnp.inf)
    best = jnp.argmin(tt, axis=1)
    rows = jnp.arange(rays.tmin.shape[0])
    bt = tt[rows, best]
    hit = jnp.isfinite(bt)
    p = rays.origin + bt[:, None] * rays.direction
    n = normalize(p - c[rows, best])
    return Hits(
        t=jnp.where(hit, bt, rays.tmax),
        prim_id=jnp.where(hit, best.astype(jnp.int32), -1),
        inst_id=jnp.where(hit, 0, -1),
        mat_id=jnp.where(hit, best.astype(jnp.int32), -1),
        uv=jnp.zeros(bt.shape + (2,), jnp.float32),
        normal=jnp.where(hit[:, None], n, 0.0),
    )


# --- SRT motion transforms (OptixSRTMotionTransform) ---

@pytree.dataclass
class SRTKey:
    """One SRT key: scale [3], quaternion [4] (x,y,z,w), translation [3]."""
    scale: jnp.ndarray
    quat: jnp.ndarray
    trans: jnp.ndarray

    @classmethod
    def make(cls, scale=(1, 1, 1), quat=(0, 0, 0, 1), trans=(0, 0, 0)):
        q = jnp.asarray(quat, jnp.float32)
        return cls(scale=jnp.asarray(scale, jnp.float32),
                   quat=q / jnp.linalg.norm(q),
                   trans=jnp.asarray(trans, jnp.float32))


def _slerp(q0, q1, t):
    d = jnp.sum(q0 * q1)
    q1 = jnp.where(d < 0, -q1, q1)
    d = jnp.abs(d)
    theta = jnp.arccos(jnp.clip(d, -1.0, 1.0))
    sin_t = jnp.sin(theta)
    use_lerp = sin_t < 1e-4
    w0 = jnp.where(use_lerp, 1.0 - t, jnp.sin((1 - t) * theta) / jnp.maximum(sin_t, 1e-9))
    w1 = jnp.where(use_lerp, t, jnp.sin(t * theta) / jnp.maximum(sin_t, 1e-9))
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def _quat_rotate(q, v):
    """Rotate vectors v [..., 3] by quaternion(s) q [..., 4]."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def _quat_conj(q):
    return q * jnp.asarray([-1.0, -1.0, -1.0, 1.0])


def srt_interpolate(key0: SRTKey, key1: SRTKey, times):
    """Per-ray-time SRT: returns dict(scale [N,3], quat [N,4], trans [N,3])."""
    t = times[:, None]
    return dict(
        scale=key0.scale + t * (key1.scale - key0.scale),
        quat=_slerp(jnp.broadcast_to(key0.quat, (times.shape[0], 4)),
                    jnp.broadcast_to(key1.quat, (times.shape[0], 4)),
                    times),
        trans=key0.trans + t * (key1.trans - key0.trans),
    )


def rays_to_object_space(rays: Rays, srt):
    """Inverse-transform rays by per-ray SRT (object→world transform):
    the motion-transform traversal step (`optix_device.h:728-868` transform
    stack, one level)."""
    inv_q = _quat_conj(srt["quat"])
    o = _quat_rotate(inv_q, rays.origin - srt["trans"]) / srt["scale"]
    d = _quat_rotate(inv_q, rays.direction) / srt["scale"]
    # keep direction scale so reported t stays in world units
    return Rays(origin=o, direction=d, tmin=rays.tmin, tmax=rays.tmax)


def hits_to_world_space(hits: Hits, srt):
    """Map object-space hit normals back to world (rotation; inverse-scale
    for correct normal transform)."""
    n = _quat_rotate(srt["quat"], hits.normal / srt["scale"])
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return hits.replace(normal=jnp.where(hits.valid[..., None], n, 0.0))
