"""Brute-force all-rays × all-triangles intersection (dual backend).

For meshes up to a few thousand triangles (the whole OptiX sample suite's
geometry: Cornell = 32 tris, Whitted custom prims, one-triangle samples),
testing every ray against every triangle needs no incoherent gathers and no
divergent traversal — fully dense compute. This module is the "traversal
core" the driver hides behind `optixTrace` (`include/optix_device.h:61`) for
small scenes; `accel/lbvh.py` + `accel/traverse.py` take over for large ones.

Two implementations, chosen by `choose_impl`:
- **pallas** (GPU): the fused kernel of accel/pallas_bf.py — triangle
  constants as broadcast scalar loads, running-min closest hit in registers
  emitting normals/material ids directly.
- **xla** (every other platform, and the reference): two `[N,3] @ [3,3M]`
  matmuls at `Precision.HIGHEST` plus an elementwise/reduce epilogue,
  chunked over the ray axis to bound the [chunk, M] intermediates.

Intersection math: unit-triangle transform, see accel/geometry.py.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.rays import Hits, Rays
from . import pallas_bf
from .geometry import TriangleGeometry

_PREC = jax.lax.Precision.HIGHEST
_DEGEN_EPS = 1e-12

# Meshes up to this many triangles are intersected by brute force; larger
# ones get the threaded BVH (accel/traverse.py). The crossover has not been
# measured on the H100.
BRUTE_FORCE_MAX_TRIS = 512

IMPLS = ("auto", "xla", "pallas", "pallas_interpret")


def choose_impl(num_triangles: int, impl: str = "auto",
                platform: Optional[str] = None) -> str:
    """The brute-force implementation for a mesh: "pallas" (the fused GPU
    kernel), "xla", or "pallas_interpret" (only when asked for by name).
    "auto" takes the kernel on a GPU and XLA on every other platform."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl
    platform = platform or jax.default_backend()
    return ("pallas" if platform == "gpu"
            and 0 < num_triangles <= BRUTE_FORCE_MAX_TRIS else "xla")


# ---------------------------------------------------------------------------
# XLA matmul path
# ---------------------------------------------------------------------------

def _transform_rays(geom: TriangleGeometry, origin, direction):
    """Map rays into every triangle's unit frame. Returns ([N, M, 3] o', d')."""
    n = origin.shape[0]
    m = geom.num_triangles
    o_p = (jnp.dot(origin, geom.w_mat, precision=_PREC) + geom.w_off).reshape(n, m, 3)
    d_p = jnp.dot(direction, geom.w_mat, precision=_PREC).reshape(n, m, 3)
    return o_p, d_p


def _hit_matrix(geom: TriangleGeometry, rays: Rays):
    """Per-(ray, triangle) hit candidates: (t, u, v, hit_mask), each [N, M]."""
    o_p, d_p = _transform_rays(geom, rays.origin, rays.direction)
    dz = d_p[..., 2]
    safe_dz = jnp.where(jnp.abs(dz) < _DEGEN_EPS, _DEGEN_EPS, dz)
    t = -o_p[..., 2] / safe_dz
    u = o_p[..., 0] + t * d_p[..., 0]
    v = o_p[..., 1] + t * d_p[..., 1]
    hit = ((jnp.abs(dz) >= _DEGEN_EPS)
           & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > rays.tmin[:, None]) & (t < rays.tmax[:, None])
           & geom.valid[None, :])
    return t, u, v, hit


def _closest_chunk(geom: TriangleGeometry, tri_mat, rays: Rays) -> Hits:
    t, u, v, hit = _hit_matrix(geom, rays)
    t_masked = jnp.where(hit, t, jnp.inf)
    best = jnp.argmin(t_masked, axis=1)                     # [N]
    best_t = jnp.take_along_axis(t_masked, best[:, None], axis=1)[:, 0]
    any_hit_mask = jnp.isfinite(best_t)
    bu = jnp.take_along_axis(u, best[:, None], axis=1)[:, 0]
    bv = jnp.take_along_axis(v, best[:, None], axis=1)[:, 0]
    normal = geom.face_normal[best]
    mat = tri_mat[best] if tri_mat is not None else jnp.zeros_like(best)
    return Hits(
        t=jnp.where(any_hit_mask, best_t, rays.tmax),
        prim_id=jnp.where(any_hit_mask, best.astype(jnp.int32), -1),
        inst_id=jnp.where(any_hit_mask, 0, -1),
        mat_id=jnp.where(any_hit_mask, mat.astype(jnp.int32), -1),
        uv=jnp.stack([bu, bv], axis=-1),
        normal=jnp.where(any_hit_mask[:, None], normal, 0.0),
    )


def _occluded_chunk(geom: TriangleGeometry, rays: Rays) -> jnp.ndarray:
    _, _, _, hit = _hit_matrix(geom, rays)
    return jnp.any(hit, axis=1)


def _chunked(fn, rays: Rays, chunk_size):
    """Run `fn` over the flattened ray batch in fixed-size chunks via lax.map,
    bounding the [chunk, M] intermediates regardless of wavefront length.
    Padded tail rays have tmin=tmax=0 → no hits."""
    n = rays.tmin.shape[0]
    if chunk_size is None or n <= chunk_size:
        return fn(rays)
    pad = (-n) % chunk_size
    padded = jax.tree.map(
        lambda a: jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0), rays)
    chunks = jax.tree.map(
        lambda a: a.reshape((-1, chunk_size) + a.shape[1:]), padded)
    out = jax.lax.map(fn, chunks)
    return jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:])[:n], out)


# ---------------------------------------------------------------------------
# Public queries (flat or batched ray shapes)
# ---------------------------------------------------------------------------

def _flatten(rays: Rays):
    batch_shape = rays.batch_shape
    n = 1
    for s in batch_shape:
        n *= s
    flat = jax.tree.map(
        lambda a: a.reshape((n,) + a.shape[len(batch_shape):]), rays)
    return flat, batch_shape


def _unflatten(tree, batch_shape):
    return jax.tree.map(lambda a: a.reshape(batch_shape + a.shape[1:]), tree)


@functools.partial(jax.jit, static_argnames=("chunk_size", "impl"))
def intersect_closest(geom: TriangleGeometry, rays: Rays, tri_mat=None,
                      chunk_size: Optional[int] = 65536,
                      impl: str = "auto") -> Hits:
    """Closest-hit query over a ray batch of any shape → `Hits` (same batch).

    The `optixTrace` radiance-ray analogue (`SDK/cuda/whitted_cuda.h:90-126`
    traceRadiance) for a single-GAS scene. `tri_mat` ([M] i32) lets the
    intersector emit material ids with the hit.
    """
    flat, batch_shape = _flatten(rays)
    impl = choose_impl(geom.num_triangles, impl)
    if impl != "xla":
        tm = tri_mat if tri_mat is not None else jnp.zeros(
            (geom.num_triangles,), jnp.int32)
        out = pallas_bf.closest_hit(geom.tri_consts, tm, flat,
                                    interpret=(impl == "pallas_interpret"))
        hit_mask = out["prim_id"] >= 0
        hits = Hits(
            t=jnp.where(hit_mask, out["t"], flat.tmax),
            prim_id=out["prim_id"],
            inst_id=jnp.where(hit_mask, 0, -1),
            mat_id=out["mat_id"],
            uv=out["uv"],
            normal=out["normal"],
        )
    else:
        hits = _chunked(lambda r: _closest_chunk(geom, tri_mat, r), flat,
                        chunk_size)
    return _unflatten(hits, batch_shape)


@functools.partial(jax.jit, static_argnames=("chunk_size", "impl"))
def intersect_any(geom: TriangleGeometry, rays: Rays,
                  chunk_size: Optional[int] = 65536,
                  impl: str = "auto") -> jnp.ndarray:
    """Boolean occlusion query (shadow rays) — the `traceOcclusion` analogue
    (`SDK/cuda/whitted_cuda.h:128-160`, terminate-on-first-hit semantics)."""
    flat, batch_shape = _flatten(rays)
    impl = choose_impl(geom.num_triangles, impl)
    if impl != "xla":
        occ = pallas_bf.any_hit(geom.tri_consts, flat,
                                interpret=(impl == "pallas_interpret"))
    else:
        occ = _chunked(lambda r: _occluded_chunk(geom, r), flat, chunk_size)
    return occ.reshape(batch_shape)
