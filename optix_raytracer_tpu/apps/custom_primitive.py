"""optixCustomPrimitive equivalent: a user-supplied intersection program
over a custom AABB primitive.

Reference: `SDK/optixCustomPrimitive/` — the app registers a custom AABB
build input plus its own `__intersection__is` sphere intersector
(`optixCustomPrimitive.cu`, sphere config `optixCustomPrimitive.cpp:410-411`)
and shades the world-space normal `n * 0.5 + 0.5`
(`optixCustomPrimitive.cu:127-135`).

The "custom IS program" here is exactly what it is in the reference:
user code. `user_intersection` below lives in the APP, not the framework —
it is traced into the jitted render like any IS program group is compiled
into the pipeline. The framework contribution is the AABB slab pre-test
(the custom-AABB build-input role) that gates which rays run the user IS.
"""
from __future__ import annotations

import argparse

from ._cli import parse_dim

import jax
import jax.numpy as jnp
import numpy as np

from ..core import film
from ..core.camera import Camera, generate_rays
from ..io.image import save_image

SPHERE_CENTER = (0.0, 0.0, 0.0)
SPHERE_RADIUS = 1.5


def user_intersection(o, d, tmin, tmax):
    """The app's `__intersection__is`: analytic ray/sphere solve returning
    (t, hit) — reports the nearest root inside [tmin, tmax], exactly the
    reference intersector's contract (`optixReportIntersection`)."""
    c = jnp.asarray(SPHERE_CENTER, jnp.float32)
    oc = o - c
    b = jnp.sum(oc * d, axis=-1)
    cc = jnp.sum(oc * oc, axis=-1) - SPHERE_RADIUS * SPHERE_RADIUS
    disc = b * b - cc
    s = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0, t1 = -b - s, -b + s
    t = jnp.where((t0 >= tmin) & (t0 <= tmax), t0, t1)
    hit = (disc >= 0.0) & (t >= tmin) & (t <= tmax)
    return t, hit


def aabb_gate(o, d, tmin, tmax, lo, hi):
    """Slab test against the primitive's AABB — the custom build input
    (`optix_types.h:925` OptixBuildInputCustomPrimitiveArray): the user IS
    only runs for rays whose segment crosses the box."""
    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (far >= jnp.maximum(near, tmin)) & (near <= tmax)


def render(width=768, height=768):
    cam = Camera(eye=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                 fov_y=60.0, aspect=width / height).params()
    r = SPHERE_RADIUS
    lo = jnp.asarray(SPHERE_CENTER, jnp.float32) - r
    hi = jnp.asarray(SPHERE_CENTER, jnp.float32) + r

    @jax.jit
    def go(cam):
        rays, _ = generate_rays(cam, width, height, jitter=False)
        flat = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), rays)
        o, d = flat.origin, flat.direction
        crosses = aabb_gate(o, d, flat.tmin, flat.tmax, lo, hi)
        t, hit = user_intersection(o, d, flat.tmin, flat.tmax)
        hit = hit & crosses
        p = o + t[:, None] * d
        n = (p - jnp.asarray(SPHERE_CENTER, jnp.float32)) / r
        shade = n * 0.5 + 0.5                     # the reference CH
        miss = jnp.asarray([0.0, 0.0, 0.0])
        radiance = jnp.where(hit[:, None], shade, miss)
        return film.make_color(radiance.reshape(height, width, 3))

    return go(cam)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="custom AABB primitive + user IS (optixCustomPrimitive)")
    p.add_argument("--file", default="custom_primitive.png")
    p.add_argument("--dim", default="768x768")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    save_image(args.file, np.asarray(render(w, h)))
    print(f"wrote {args.file} ({w}x{h})")


if __name__ == "__main__":
    main()
