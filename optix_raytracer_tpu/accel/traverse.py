"""Stackless threaded-BVH traversal: one int32 of state per ray.

The software replacement for the driver's RT-core traversal behind `optixTrace`
(`include/optix_device.h:61`): every ray carries a single DFS node pointer;
the whole wavefront steps in lock-step through a `lax.while_loop` —
"hit the node's AABB and it's internal" → ptr+1 (descend), otherwise → the
node's escape index (skip the subtree). Leaves run the unit-triangle hit test
inline and shrink the ray's tmax, which prunes later subtrees. No stacks, no
per-ray divergence, no recursion (SURVEY.md §7 layer 2).

This is the portable (pure-jnp, gather-based) traversal used for meshes
past the brute-force limit (bruteforce.BRUTE_FORCE_MAX_TRIS); smaller
meshes take the brute-force intersector.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.rays import Hits, Rays
from .geometry import TriangleGeometry
from .lbvh import LBVH

_DEGEN_EPS = 1e-12
_HIGHEST = jax.lax.Precision.HIGHEST


def _woop_test(geom: TriangleGeometry, prim, o, d):
    """Single-triangle unit-space test per ray: prim [N] i32, o/d [N, 3].

    Returns (t, u, v, dz_ok). Uses the packed per-triangle constants
    (geometry.tri_consts) gathered per ray.
    """
    c = geom.tri_consts[prim]                 # [N, 16]
    m = c[:, 0:9].reshape(-1, 3, 3)
    off = c[:, 9:12]
    op = jnp.einsum("njk,nk->nj", m, o, precision=_HIGHEST) + off
    dp = jnp.einsum("njk,nk->nj", m, d, precision=_HIGHEST)
    dz = dp[:, 2]
    safe = jnp.where(jnp.abs(dz) < _DEGEN_EPS, _DEGEN_EPS, dz)
    t = -op[:, 2] / safe
    u = op[:, 0] + t * dp[:, 0]
    v = op[:, 1] + t * dp[:, 1]
    ok = (jnp.abs(dz) >= _DEGEN_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1.0)
    return t, u, v, ok


@functools.partial(jax.jit, static_argnames=("any_hit",))
def traverse(bvh: LBVH, geom: TriangleGeometry, tri_mat, rays: Rays,
             any_hit: bool = False):
    """Closest-hit (or any-hit) query through the threaded BVH.

    rays: flat [N]. Returns Hits (closest) or bool [N] (any_hit=True).
    """
    n = rays.tmin.shape[0]
    end = bvh.num_nodes

    state = dict(
        ptr=jnp.zeros(n, jnp.int32),
        t=rays.tmax,
        prim=jnp.full(n, -1, jnp.int32),
        u=jnp.zeros(n, jnp.float32),
        v=jnp.zeros(n, jnp.float32),
        done=jnp.zeros(n, bool),
    )

    # Robust slab reciprocal: clamp |d| away from zero so inv_d is finite.
    # With a true 1/0 = inf, an origin component exactly on a node bound
    # gives 0 * inf = NaN and the comparison silently drops the subtree.
    d = rays.direction
    d_safe = jnp.where(jnp.abs(d) < _DEGEN_EPS,
                       jnp.where(d < 0, -_DEGEN_EPS, _DEGEN_EPS), d)
    inv_d = 1.0 / d_safe

    def cond(state):
        return jnp.any(~state["done"])

    def step(state):
        ptr = jnp.minimum(state["ptr"], end - 1)
        lo = bvh.node_lo[ptr]
        hi = bvh.node_hi[ptr]
        skip = bvh.node_skip[ptr]
        prim = bvh.node_prim[ptr]
        live = ~state["done"]

        # slab test against current best t
        t0 = (lo - rays.origin) * inv_d
        t1 = (hi - rays.origin) * inv_d
        t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
        t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
        box_hit = (jnp.maximum(t_near, rays.tmin)
                   <= jnp.minimum(t_far, state["t"]))

        is_leaf = prim >= 0
        tt, uu, vv, ok = _woop_test(geom, jnp.maximum(prim, 0),
                                    rays.origin, rays.direction)
        tri_hit = (live & box_hit & is_leaf & ok
                   & (tt > rays.tmin) & (tt < state["t"]))

        new_t = jnp.where(tri_hit, tt, state["t"])
        new_prim = jnp.where(tri_hit, prim, state["prim"])
        new_u = jnp.where(tri_hit, uu, state["u"])
        new_v = jnp.where(tri_hit, vv, state["v"])

        descend = box_hit & ~is_leaf
        new_ptr = jnp.where(descend, ptr + 1, skip)
        if any_hit:
            done = state["done"] | tri_hit | (new_ptr >= end)
        else:
            done = state["done"] | (new_ptr >= end)
        return dict(ptr=jnp.where(live, new_ptr, state["ptr"]),
                    t=new_t, prim=new_prim, u=new_u, v=new_v, done=done)

    state = jax.lax.while_loop(cond, step, state)

    if any_hit:
        return state["prim"] >= 0

    hit = state["prim"] >= 0
    pid = jnp.maximum(state["prim"], 0)
    normal = geom.face_normal[pid]
    mat = (tri_mat[pid] if tri_mat is not None
           else jnp.zeros_like(pid))
    return Hits(
        t=jnp.where(hit, state["t"], rays.tmax),
        prim_id=jnp.where(hit, state["prim"], -1),
        inst_id=jnp.where(hit, 0, -1),
        mat_id=jnp.where(hit, mat.astype(jnp.int32), -1),
        uv=jnp.stack([state["u"], state["v"]], axis=-1),
        normal=jnp.where(hit[:, None], normal, 0.0),
    )
