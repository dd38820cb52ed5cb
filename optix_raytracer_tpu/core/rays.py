"""Ray / hit SoA pytrees — the wavefront state carried through the engine.

The reference passes rays implicitly through `optixTrace` register arguments
(`include/optix_device.h:61-92`) and explicitly as structs in the headless
ray-casting service (`SDK/optixRaycasting/optixRaycastingKernels.h:35-47`:
`Ray{origin,tmin,dir,tmax}` / `Hit{t,geom_normal}`). Here both are first-class
structure-of-arrays pytrees: every field has an arbitrary (shared) batch shape,
so the same structs serve a single ray, a [H, W] camera grid, or a compacted
1-D wavefront queue, and shard transparently under `shard_map`.
"""
from __future__ import annotations

import jax.numpy as jnp
from . import pytree


@pytree.dataclass
class Rays:
    """A batch of rays. origin/direction: [..., 3]; tmin/tmax: [...]."""
    origin: jnp.ndarray
    direction: jnp.ndarray
    tmin: jnp.ndarray
    tmax: jnp.ndarray

    @property
    def batch_shape(self):
        return self.tmin.shape

    @classmethod
    def make(cls, origin, direction, tmin=1e-4, tmax=1e16):
        origin = jnp.asarray(origin, jnp.float32)
        direction = jnp.asarray(direction, jnp.float32)
        bs = origin.shape[:-1]
        return cls(
            origin=origin,
            direction=direction,
            tmin=jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), bs),
            tmax=jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), bs),
        )

    def at(self, t):
        """Point along the ray: origin + t * direction."""
        return self.origin + t[..., None] * self.direction


@pytree.dataclass
class Hits:
    """Closest-hit records for a batch of rays.

    t: [...] hit distance (tmax-sentinel when missed); prim_id / inst_id /
    mat_id: [...] int32 (-1 on miss); uv: [..., 2] surface parameters
    (triangle barycentrics, sphere/curve params — the
    `optixGetTriangleBarycentrics` analogue, reference
    `include/optix_device.h:1206`); normal: [..., 3] unit geometric normal.

    mat_id and normal are produced directly by the intersector (the fused
    brute-force kernel selects them during its running-min) so shading
    needs no per-hit gathers — the replacement for reading attributes out of SBT
    record pointers (`include/optix_device.h:1239` optixGetSbtDataPointer).
    """
    t: jnp.ndarray
    prim_id: jnp.ndarray
    inst_id: jnp.ndarray
    mat_id: jnp.ndarray
    uv: jnp.ndarray
    normal: jnp.ndarray

    @property
    def valid(self):
        return self.prim_id >= 0

    @classmethod
    def none(cls, batch_shape, tmax=1e16):
        return cls(
            t=jnp.full(batch_shape, tmax, jnp.float32),
            prim_id=jnp.full(batch_shape, -1, jnp.int32),
            inst_id=jnp.full(batch_shape, -1, jnp.int32),
            mat_id=jnp.full(batch_shape, -1, jnp.int32),
            uv=jnp.zeros(batch_shape + (2,), jnp.float32),
            normal=jnp.zeros(batch_shape + (3,), jnp.float32),
        )
