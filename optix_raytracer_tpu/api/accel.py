"""Acceleration-structure builds: the `optixAccelBuild` surface.

`optixAccelComputeMemoryUsage`/`optixAccelBuild`/`optixAccelCompact`/
`optixAccelRelocate` (`include/optix_host.h:544-694`) collapse to functional
builders over jnp arrays:
- build = construct the geometry tables (+LBVH when past the brute-force
  crossover); memory usage is exactly the array sizes (reported for parity);
- compaction is a no-op (arrays are dense by construction — the reference
  compacts because driver builds over-allocate, `optixPathTracer.cpp:622-683`);
- relocation is a no-op (XLA owns placement);
- refit (`OPTIX_BUILD_OPERATION_UPDATE`, `optixDynamicGeometry.cpp:412-435`)
  rebuilds the derived tables from moved vertices under jit — cheap and
  differentiable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

from ..accel.bruteforce import BRUTE_FORCE_MAX_TRIS
from ..accel.geometry import TriangleGeometry, build_triangle_geometry
from ..accel.lbvh import LBVH, build_lbvh
from ..accel.primitives import CustomPrims, make_prims


@dataclasses.dataclass
class TraversableHandle:
    """What `optixAccelBuild` returns: an opaque handle. Here it owns the
    geometry tables + optional LBVH and reports its memory like
    optixAccelComputeMemoryUsage."""
    geom: Optional[TriangleGeometry] = None
    prims: Optional[CustomPrims] = None
    bvh: Optional[LBVH] = None

    @property
    def memory_usage_bytes(self) -> int:
        import jax
        total = 0
        for part in (self.geom, self.prims, self.bvh):
            if part is not None:
                total += sum(x.size * x.dtype.itemsize
                             for x in jax.tree.leaves(part))
        return total

    @property
    def compacted_size_bytes(self) -> int:
        # dense by construction → compaction would save nothing
        return self.memory_usage_bytes


def build_gas(vertices, indices, normals=None, uvs=None,
              allow_update: bool = True,
              with_bvh: Optional[bool] = None) -> TraversableHandle:
    """Triangle GAS build (triangle build input, optix_types.h:632)."""
    geom = build_triangle_geometry(vertices, indices, normals=normals,
                                   uvs=uvs)
    if with_bvh is None:
        with_bvh = geom.num_triangles > BRUTE_FORCE_MAX_TRIS
    return TraversableHandle(
        geom=geom, bvh=build_lbvh(geom) if with_bvh else None)


def build_custom_gas(prim_descs) -> TraversableHandle:
    """Custom-primitive GAS (AABB build input, optix_types.h:925) — takes the
    analytic prim descriptors directly; the AABBs the reference feeds the
    driver are implied."""
    return TraversableHandle(prims=make_prims(prim_descs))


def refit_gas(handle: TraversableHandle, new_vertices) -> TraversableHandle:
    """GAS update-in-place (refit). Keeps topology; recomputes the derived
    per-triangle tables and the LBVH if present."""
    assert handle.geom is not None, "refit needs a triangle GAS"
    geom = build_triangle_geometry(new_vertices, handle.geom.indices)
    bvh = build_lbvh(geom) if handle.bvh is not None else None
    return TraversableHandle(geom=geom, prims=handle.prims, bvh=bvh)


def build_ias(instances_transforms, sbt_offsets=None, instance_ids=None):
    """Instance acceleration structure over a shared GAS — the
    `buildInstanceAccel` path (`Scene.cpp:1134-1213`). Returns an
    InstanceTable to pass to accel.tlas.intersect_instances."""
    from ..accel.tlas import make_instances
    return make_instances(instances_transforms, sbt_offsets, instance_ids)
