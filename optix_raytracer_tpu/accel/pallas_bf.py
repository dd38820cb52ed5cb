"""Fused brute-force intersection kernels for the GPU (Pallas, Triton route).

The XLA brute-force intersector (accel/bruteforce.py) writes [N, 3M] ray
transforms and [N, M] t/u/v/hit planes to device memory and reads them
back for the argmin: about 1 KB per ray on the 32-triangle Cornell box.
These kernels keep the whole ray × triangle test in registers:

- one program owns a power-of-two block of rays in SoA layout (one ray per
  thread at the default 128 rays and 4 warps);
- a loop over the triangles reads each triangle's 15 constants (the
  unit-triangle transform of accel/geometry.py plus the face normal) as
  scalar loads, which L1 serves to the whole block as broadcasts;
- the closest hit is a running minimum in registers that emits t, prim,
  material, uv and normal directly, so shading needs no gathers.

Device-memory traffic is 32 B in and 36 B out per ray. A block whose rays
all have empty windows (tmax <= tmin: dead paths, masked shadow rays) skips
the triangle loop, and the any-hit loop stops once every ray of the block
is resolved.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

from ..core.rays import Rays

BLOCK_RAYS = 128        # rays per program (power of two)
NUM_WARPS = 4
NUM_STAGES = 1

_DEGEN_EPS = 1e-12


def _tri_test(tri_ref, t, ox, oy, oz, dx, dy, dz):
    """Unit-triangle-space hit candidate of triangle `t` for a ray block.

    Returns (tt, uu, vv, ok_geom): candidate distance, barycentrics, and
    the inside-and-not-parallel predicate (the caller adds the t window).
    """
    w = [tri_ref[t, k] for k in range(12)]
    opx = ox * w[0] + oy * w[1] + oz * w[2] + w[9]
    opy = ox * w[3] + oy * w[4] + oz * w[5] + w[10]
    opz = ox * w[6] + oy * w[7] + oz * w[8] + w[11]
    dpx = dx * w[0] + dy * w[1] + dz * w[2]
    dpy = dx * w[3] + dy * w[4] + dz * w[5]
    dpz = dx * w[6] + dy * w[7] + dz * w[8]
    tt = -opz / dpz
    uu = opx + tt * dpx
    vv = opy + tt * dpy
    ok = ((jnp.abs(dpz) > _DEGEN_EPS)
          & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0))
    return tt, uu, vv, ok


def _closest_kernel(tri_ref, mat_ref, ox_ref, oy_ref, oz_ref,
                    dx_ref, dy_ref, dz_ref, tmin_ref, tmax_ref,
                    t_out, id_out, mid_out, u_out, v_out,
                    nx_out, ny_out, nz_out, *, num_tris):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    tmin, tmax = tmin_ref[...], tmax_ref[...]

    zeros = jnp.zeros_like(ox)
    neg1 = jnp.full(ox.shape, -1, jnp.int32)
    init = (tmax, neg1, neg1, zeros, zeros, zeros, zeros, zeros)

    def body(t, carry):
        bt, bid, bmid, bu, bv, bnx, bny, bnz = carry
        tt, uu, vv, ok = _tri_test(tri_ref, t, ox, oy, oz, dx, dy, dz)
        ok = ok & (tt > tmin) & (tt < bt)      # running min => closest hit
        return (jnp.where(ok, tt, bt),
                jnp.where(ok, t, bid),
                jnp.where(ok, mat_ref[t], bmid),
                jnp.where(ok, uu, bu),
                jnp.where(ok, vv, bv),
                jnp.where(ok, tri_ref[t, 12], bnx),
                jnp.where(ok, tri_ref[t, 13], bny),
                jnp.where(ok, tri_ref[t, 14], bnz))

    live = jnp.max((tmax > tmin).astype(jnp.int32))
    bt, bid, bmid, bu, bv, bnx, bny, bnz = jax.lax.fori_loop(
        0, live * num_tris, body, init)
    t_out[...] = bt
    id_out[...] = bid
    mid_out[...] = bmid
    u_out[...] = bu
    v_out[...] = bv
    nx_out[...] = bnx
    ny_out[...] = bny
    nz_out[...] = bnz


def _anyhit_kernel(tri_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                   tmin_ref, tmax_ref, occ_out, *, num_tris):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    tmin, tmax = tmin_ref[...], tmax_ref[...]
    # Rays with an empty window are resolved (unoccluded) from the start.
    empty = (tmax <= tmin).astype(jnp.int32)

    def cond(carry):
        t, occ = carry
        return (t < num_tris) & (jnp.min(jnp.maximum(occ, empty)) == 0)

    def body(carry):
        t, occ = carry
        tt, _, _, ok = _tri_test(tri_ref, t, ox, oy, oz, dx, dy, dz)
        ok = ok & (tt > tmin) & (tt < tmax)
        return t + 1, jnp.maximum(occ, ok.astype(jnp.int32))

    _, occ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros(ox.shape, jnp.int32)))
    occ_out[...] = occ


def _ray_columns(rays: Rays, n_padded):
    """SoA ray columns padded to n_padded. Padding rays get tmin = tmax = 0:
    their (tmin, tmax) window is empty, so they never record a hit."""
    o, d = rays.origin, rays.direction
    cols = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
            rays.tmin, rays.tmax]
    pad = n_padded - rays.tmin.shape[0]
    return [jnp.pad(c.astype(jnp.float32), (0, pad)) for c in cols]


def _launch(kernel, n_tris, tables, rays, outs, block_rays, num_warps,
            interpret):
    n = rays.tmin.shape[0]
    n_padded = -(-n // block_rays) * block_rays
    ray_spec = pl.BlockSpec((block_rays,), lambda i: (i,))
    table_specs = [pl.BlockSpec(tb.shape, lambda i, nd=tb.ndim: (0,) * nd)
                   for tb in tables]
    res = pl.pallas_call(
        functools.partial(kernel, num_tris=n_tris),
        grid=(n_padded // block_rays,),
        in_specs=table_specs + [ray_spec] * 8,
        out_specs=[ray_spec] * len(outs),
        out_shape=[jax.ShapeDtypeStruct((n_padded,), dt) for dt in outs],
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(
            num_warps=num_warps, num_stages=NUM_STAGES),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(*tables, *_ray_columns(rays, n_padded))
    return [r[:n] for r in res]


@functools.partial(jax.jit, static_argnames=("block_rays", "num_warps",
                                             "interpret"))
def closest_hit(tri_consts, tri_mat, rays: Rays, block_rays: int = BLOCK_RAYS,
                num_warps: int = NUM_WARPS, interpret: bool = False):
    """Closest-hit query via the fused kernel.

    tri_consts: [M, 16] f32 (geometry.tri_consts); tri_mat: [M] i32.
    rays: flat [N]. Returns dict(t, prim_id, mat_id, uv, normal) with
    miss => prim_id = mat_id = -1, t = tmax, uv = normal = 0.
    """
    f32, i32 = jnp.float32, jnp.int32
    t, pid, mid, u, v, nx, ny, nz = _launch(
        _closest_kernel, tri_consts.shape[0],
        [tri_consts.astype(f32), tri_mat.astype(i32)], rays,
        [f32, i32, i32, f32, f32, f32, f32, f32], block_rays, num_warps,
        interpret)
    return dict(t=t, prim_id=pid, mat_id=mid,
                uv=jnp.stack([u, v], axis=-1),
                normal=jnp.stack([nx, ny, nz], axis=-1))


@functools.partial(jax.jit, static_argnames=("block_rays", "num_warps",
                                             "interpret"))
def any_hit(tri_consts, rays: Rays, block_rays: int = BLOCK_RAYS,
            num_warps: int = NUM_WARPS, interpret: bool = False):
    """Occlusion query via the fused kernel -> bool [N]."""
    (occ,) = _launch(_anyhit_kernel, tri_consts.shape[0],
                     [tri_consts.astype(jnp.float32)], rays, [jnp.int32],
                     block_rays, num_warps, interpret)
    return occ != 0
