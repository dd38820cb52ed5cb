"""Light types: parallelogram area light, point, ambient, directional, volumetric.

Covers the reference's light set: `ParallelogramLight` (NEE target of the path
tracer, `SDK/optixPathTracer/optixPathTracer.h` + sampling at
`optixPathTracer.cu:382-409`), `Light::Point`/`Light::Ambient` with falloff
(`SDK/cuda/Light.h:31-71`), and imgui_test's point/directional/volumetric
variants with jittered `wi()` soft shadows (`SDK/imgui_test/light.h`,
`volumetric_light.h`). Lights are SoA tables: `kind` selects behavior
branchlessly, so one fused sample pass serves a heterogeneous light list.
"""
from __future__ import annotations

import jax.numpy as jnp
from ..core import pytree

from ..core import rng as _rng
from ..core.vecmath import cross, length, normalize

# Light kinds (the Light::Type tags of cuda/Light.h:33-38 + imgui_test variants)
POINT = 0
AMBIENT = 1
DIRECTIONAL = 2
PARALLELOGRAM = 3   # area light
VOLUMETRIC = 4      # sphere-ish soft light (imgui_test volumetric_light.h)


@pytree.dataclass
class ParallelogramLight:
    """Area light spanned by (v1, v2) from `corner` — the Cornell light
    (`optixPathTracer.cpp` light setup; sampled at `optixPathTracer.cu:382-409`)."""
    corner: jnp.ndarray     # [3]
    v1: jnp.ndarray         # [3]
    v2: jnp.ndarray         # [3]
    normal: jnp.ndarray     # [3] unit
    emission: jnp.ndarray   # [3]

    @classmethod
    def make(cls, corner, v1, v2, emission):
        corner = jnp.asarray(corner, jnp.float32)
        v1 = jnp.asarray(v1, jnp.float32)
        v2 = jnp.asarray(v2, jnp.float32)
        return cls(corner=corner, v1=v1, v2=v2,
                   normal=normalize(cross(v1, v2)),
                   emission=jnp.asarray(emission, jnp.float32))

    @property
    def area(self):
        return length(cross(self.v1, self.v2))

    def sample(self, u1, u2):
        """Uniform point on the quad; pdf = 1/area. u1/u2: [...] uniforms."""
        return self.corner + u1[..., None] * self.v1 + u2[..., None] * self.v2


@pytree.dataclass
class LightTable:
    """SoA table of simple lights (point/ambient/directional/volumetric).

    Mirrors the `BufferView<Light>` list in whitted LaunchParams
    (`SDK/cuda/whitted.h:101`) and imgui_test's light array. Fields are
    overloaded per kind: `position` is direction for DIRECTIONAL; `radius`
    only applies to VOLUMETRIC (soft-shadow jitter, volumetric_light.h wi()).
    """
    kind: jnp.ndarray       # [L] int32
    position: jnp.ndarray   # [L, 3]
    color: jnp.ndarray      # [L, 3]  (intensity-scaled)
    falloff: jnp.ndarray    # [L]  CONSTANT=0 → 1, LINEAR=1 → 1/d, QUADRATIC=2 → 1/d²
    radius: jnp.ndarray     # [L]

    @classmethod
    def make(cls, lights):
        """lights: list of dicts with keys kind, position, color, falloff, radius."""
        import numpy as np
        L = max(len(lights), 1)
        kind = np.zeros(L, np.int32)
        pos = np.zeros((L, 3), np.float32)
        col = np.zeros((L, 3), np.float32)
        fall = np.zeros(L, np.int32)
        rad = np.zeros(L, np.float32)
        for i, l in enumerate(lights):
            kind[i] = l["kind"]
            pos[i] = l.get("position", l.get("direction", (0, 0, 0)))
            col[i] = l["color"]
            fall[i] = l.get("falloff", 0)
            rad[i] = l.get("radius", 0.0)
        if not lights:
            col[0] = 0.0
        return cls(kind=jnp.asarray(kind), position=jnp.asarray(pos),
                   color=jnp.asarray(col), falloff=jnp.asarray(fall),
                   radius=jnp.asarray(rad))

    @property
    def num(self):
        return self.kind.shape[0]


def sample_light(table: LightTable, i: int, hit_pos, rng_state):
    """Direction/irradiance toward light `i` from `hit_pos` [..., 3].

    Returns (wi, dist, radiance, is_delta_ambient, rng_state). Volumetric
    lights jitter the target point in a radius ball for soft shadows
    (imgui_test volumetric_light.h `wi()`); ambient lights return radiance
    with no direction (dist = 0 → no shadow ray), matching
    `Light::Falloff`/ambient handling in `whitted.cu:232-288`.
    """
    kind = table.kind[i]
    pos = table.position[i]
    color = table.color[i]
    falloff = table.falloff[i]
    radius = table.radius[i]

    u1, u2, rng_state = _rng.uniform2(rng_state)
    u3, _, rng_state = _rng.uniform2(rng_state)
    from .sampling import uniform_sample_sphere
    jitter = uniform_sample_sphere(u1, u2) * (u3 ** (1.0 / 3.0))[..., None] * radius

    target = pos + jnp.where(kind == VOLUMETRIC, 1.0, 0.0) * jitter
    delta = target - hit_pos
    dist_point = length(delta)
    wi_point = delta / jnp.maximum(dist_point, 1e-12)[..., None]

    # Directional: `position` is the direction the light travels; wi = -dir.
    wi_dir = jnp.broadcast_to(-normalize(pos), hit_pos.shape)

    is_directional = kind == DIRECTIONAL
    is_ambient = kind == AMBIENT
    wi = jnp.where(is_directional, wi_dir, wi_point)
    dist = jnp.where(is_directional, 1e16, dist_point)

    atten = jnp.where(falloff == 0, 1.0,
                      jnp.where(falloff == 1,
                                1.0 / jnp.maximum(dist_point, 1e-6),
                                1.0 / jnp.maximum(dist_point * dist_point, 1e-6)))
    atten = jnp.where(is_directional | is_ambient, 1.0, atten)
    radiance = color * atten[..., None]
    return wi, dist, radiance, is_ambient, rng_state
