"""Two-level acceleration: instances (IAS) over triangle GAS handles.

The reference's instance path: an `OptixInstance` array (row-major 3x4
transform + instanceId + sbtOffset, `include/optix_types.h:970-1010`) built
into an IAS (`Scene.cpp:1134-1213` buildInstanceAccel), traversed with the
device transform stack (`optix_device.h:728-868`).

Here: an instance table of affine transforms; traversal loops the
(static, usually small) instance list, transforms the wavefront into each
instance's object space, intersects the shared GAS once, and keeps the
per-ray minimum — the "transform stack" is a pair of affine maps applied to
whole arrays. Hits report inst_id and sbt-offset material ids
(`sbtOffset + geometryIndex*rayTypeCount + rayType` collapses to
`sbt_offset + tri_mat[prim]`, the indexing rule at `Scene.cpp:1154`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from ..core import pytree

from ..core import transforms as xf
from ..core.rays import Hits, Rays
from . import bruteforce as bf
from .geometry import TriangleGeometry


@pytree.dataclass
class InstanceTable:
    """SoA instance array over one shared (concatenated) GAS.

    Each instance references a STATIC triangle range [prim_lo, prim_hi) of
    the shared geometry — the analogue of one `OptixInstance` pointing at
    its mesh's GAS handle (`Scene.cpp:1150`, instance.traversableHandle).
    Ranges are static python ints so per-instance traversal slices the
    geometry at trace time with no masking cost; transforms stay traced
    arrays, so per-frame IAS matrix updates (`optixDynamicGeometry.cpp`
    updateMeshAccel's IAS refresh) are functional replaces — no rebuild.
    """
    transform: jnp.ndarray      # [I, 3, 4] object→world
    inv_transform: jnp.ndarray  # [I, 3, 4] world→object
    sbt_offset: jnp.ndarray     # [I] int32
    instance_id: jnp.ndarray    # [I] int32 (user-visible id)
    prim_ranges: tuple = pytree.field(pytree_node=False, default=())
    row_ids: bool = pytree.field(pytree_node=False, default=True)
    #   True when instance_id == row index (the default construction):
    #   lets shading look up per-hit instance transforms by inst_id

    @property
    def num(self):
        return self.transform.shape[0]

    @classmethod
    def empty(cls):
        return cls(transform=jnp.zeros((0, 3, 4), jnp.float32),
                   inv_transform=jnp.zeros((0, 3, 4), jnp.float32),
                   sbt_offset=jnp.zeros((0,), jnp.int32),
                   instance_id=jnp.zeros((0,), jnp.int32),
                   prim_ranges=())


def make_instances(transforms: Sequence, sbt_offsets=None,
                   instance_ids=None, prim_ranges=None,
                   num_prims: Optional[int] = None) -> InstanceTable:
    """Build an instance table. prim_ranges: per-instance (lo, hi) triangle
    range into the shared GAS; defaults to the whole geometry (requires
    num_prims when ranges are omitted and the table is used for tracing)."""
    import numpy as np
    transforms = jnp.asarray(np.stack([np.asarray(t, np.float32)[:3, :4]
                                       for t in transforms]))
    n = transforms.shape[0]
    inv = xf.inverse(transforms)
    if prim_ranges is None:
        prim_ranges = (((0, num_prims),) * n if num_prims is not None
                       else ())
    return InstanceTable(
        transform=transforms,
        inv_transform=inv,
        sbt_offset=jnp.asarray(sbt_offsets if sbt_offsets is not None
                               else jnp.zeros(n, jnp.int32), jnp.int32),
        instance_id=jnp.asarray(instance_ids if instance_ids is not None
                                else jnp.arange(n), jnp.int32),
        prim_ranges=tuple((int(lo), int(hi)) for lo, hi in prim_ranges),
        row_ids=instance_ids is None,
    )


def slice_geometry(geom: TriangleGeometry, lo: int, hi: int):
    """Static triangle-range view [lo, hi) of a concatenated geometry —
    the per-instance GAS handle. Pure slicing, no copies under jit."""
    return TriangleGeometry(
        vertices=geom.vertices,            # shared vertex pool
        indices=geom.indices[lo:hi],
        v0=geom.v0[lo:hi], e1=geom.e1[lo:hi], e2=geom.e2[lo:hi],
        face_normal=geom.face_normal[lo:hi],
        w_mat=geom.w_mat[:, 3 * lo:3 * hi],
        w_off=geom.w_off[3 * lo:3 * hi],
        valid=geom.valid[lo:hi],
        tri_consts=geom.tri_consts[lo:hi],
        corner_normal=geom.corner_normal[lo:hi],
        corner_uv=geom.corner_uv[lo:hi],
        tangent=geom.tangent[lo:hi],
        uv_density=geom.uv_density[lo:hi],
        smooth=geom.smooth,
    )


def intersect_instances(geom: TriangleGeometry, instances: InstanceTable,
                        rays: Rays, tri_mat=None,
                        chunk_size: Optional[int] = None,
                        impl: str = "auto") -> Hits:
    """Closest hit through the two-level structure (flat rays [N]).

    The instance loop is a static python loop — instance counts in the
    reference scenes are small (each iteration is one fused GAS query over
    the whole wavefront). Reported t stays in world units because object-
    space direction keeps its (possibly non-unit) scaled length.
    impl: the brute-force implementation (bruteforce.choose_impl).
    """
    n = rays.tmin.shape[0]
    best = Hits.none((n,), tmax=1e16)
    best = best.replace(t=rays.tmax)

    ranges = instances.prim_ranges or ((0, geom.num_triangles),) * instances.num
    for i in range(instances.num):
        lo, hi = ranges[i]
        inv = instances.inv_transform[i]
        o = xf.apply_point(jnp.broadcast_to(inv, (n, 3, 4)), rays.origin)
        d = xf.apply_vector(jnp.broadcast_to(inv, (n, 3, 4)), rays.direction)
        obj_rays = Rays(origin=o, direction=d, tmin=rays.tmin,
                        tmax=best.t)          # current-best culls later work
        sub = slice_geometry(geom, lo, hi)
        sub_mat = None if tri_mat is None else tri_mat[lo:hi]
        h = bf.intersect_closest(sub, obj_rays, tri_mat=sub_mat,
                                 chunk_size=chunk_size, impl=impl)
        h = h.replace(prim_id=jnp.where(h.valid, h.prim_id + lo, -1))
        closer = h.valid & (h.t < best.t)
        # Normal back to world: w_row = n_row @ L^-1 (the inverse-transpose
        # rule in row form) — inv_transform already holds L^-1, so this is
        # one matmul with NO per-ray matrix inverses (jnp.linalg.inv on a
        # broadcast [N,3,3] LU-decomposes per ray and OOMs at 2M rays).
        n_world = jnp.matmul(h.normal, inv[:, :3],
                             precision=jax.lax.Precision.HIGHEST)
        n_world = n_world / jnp.maximum(
            jnp.linalg.norm(n_world, axis=-1, keepdims=True), 1e-12)
        best = Hits(
            t=jnp.where(closer, h.t, best.t),
            prim_id=jnp.where(closer, h.prim_id, best.prim_id),
            inst_id=jnp.where(closer, instances.instance_id[i],
                              best.inst_id),
            mat_id=jnp.where(closer, h.mat_id + instances.sbt_offset[i],
                             best.mat_id),
            uv=jnp.where(closer[:, None], h.uv, best.uv),
            normal=jnp.where(closer[:, None], n_world, best.normal),
        )
    # misses keep mat/prim = -1
    miss = best.prim_id < 0
    return best.replace(mat_id=jnp.where(miss, -1, best.mat_id),
                        t=jnp.where(miss, rays.tmax, best.t))


def intersect_instances_any(geom: TriangleGeometry,
                            instances: InstanceTable, rays: Rays,
                            chunk_size: Optional[int] = None,
                            impl: str = "auto"):
    """Occlusion query through the two-level structure → bool [N]
    (terminate-on-first-hit semantics per instance)."""
    n = rays.tmin.shape[0]
    occ = jnp.zeros((n,), bool)
    ranges = instances.prim_ranges or ((0, geom.num_triangles),) * instances.num
    for i in range(instances.num):
        lo, hi = ranges[i]
        inv = instances.inv_transform[i]
        o = xf.apply_point(jnp.broadcast_to(inv, (n, 3, 4)), rays.origin)
        d = xf.apply_vector(jnp.broadcast_to(inv, (n, 3, 4)), rays.direction)
        # already-occluded lanes get an empty window, so the brute-force
        # kernel skips blocks made only of them
        obj_rays = Rays(origin=o, direction=d, tmin=rays.tmin,
                        tmax=jnp.where(occ, 0.0, rays.tmax))
        sub = slice_geometry(geom, lo, hi)
        occ = occ | bf.intersect_any(sub, obj_rays, chunk_size=chunk_size,
                                     impl=impl)
    return occ
