"""optixBoundValues equivalent: launch-param specialization at compile time.

Reference: `SDK/optixBoundValues/` — the path tracer's `light_samples`
launch param is baked into the module with
`OptixModuleCompileBoundValueEntry` (`optixBoundValues.cpp:742-750`), so the
device NEE loop compiles with a constant bound instead of reading params.

The mapping here (`api/module.py` Module.bound_values): a *runtime* launch
param is a traced device scalar — the NEE loop is a `lax.fori_loop` whose
bound XLA cannot unroll; a *bound* value is a Python constant baked at trace
time — the loop unrolls and the light-sample chain schedules statically.
Same image either way (verified here), different compiled code — exactly
the reference's trade.
"""
from __future__ import annotations

import argparse
import time

from ._cli import parse_dim

import jax
import jax.numpy as jnp
import numpy as np

from ..api.module import Module
from ..core import film
from ..core.camera import generate_rays
from ..core.rays import Rays
from ..io.image import save_image
from ..scene.builtins import cornell_box, cornell_camera
from ..wavefront.intersect import scene_closest, scene_any

SHADOW_EPS = 1e-2


def _nee_sample(scene, p, n, albedo, key, i):
    """One area-light sample from hit point p (optixPathTracer.cu:382-409)."""
    light = scene.area_light
    k = jax.random.fold_in(key, i)
    u = jax.random.uniform(k, (2,) + p.shape[:1])
    lp = light.sample(u[0], u[1])
    to_l = lp - p
    dist = jnp.linalg.norm(to_l, axis=-1)
    wi = to_l / jnp.maximum(dist, 1e-8)[:, None]
    ndl = jnp.maximum(jnp.sum(n * wi, axis=-1), 0.0)
    lndl = jnp.abs(jnp.sum(light.normal * wi, axis=-1))
    shadow = Rays(origin=p + SHADOW_EPS * wi, direction=wi,
                  tmin=jnp.zeros_like(dist),
                  tmax=dist - 2 * SHADOW_EPS)
    occluded = scene_any(scene, shadow)
    w = jnp.where(occluded, 0.0,
                  light.area * ndl * lndl
                  / jnp.maximum(dist * dist, 1e-8) / jnp.pi)
    return albedo * light.emission * w[:, None]


def make_raygen(scene, width, height):
    def raygen(cam, light_samples=None, *, bound_light_samples=None):
        """Direct-lighting raygen. `light_samples`: traced device int (the
        runtime launch param); `bound_light_samples`: Python int baked as a
        module bound value — the loop unrolls at trace time."""
        rays, _ = generate_rays(cam, width, height, jitter=False)
        flat = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), rays)
        hits = scene_closest(scene, flat)
        p = flat.origin + hits.t[:, None] * flat.direction
        n = hits.normal
        albedo = scene.materials.base_color[jnp.maximum(hits.mat_id, 0)]
        key = jax.random.PRNGKey(7)
        acc = jnp.zeros_like(p)
        if bound_light_samples is not None:        # specialized module
            for i in range(bound_light_samples):
                acc = acc + _nee_sample(scene, p, n, albedo, key, i)
            ls = float(bound_light_samples)
        else:                                      # runtime launch param
            def body(i, a):
                return a + _nee_sample(scene, p, n, albedo, key, i)
            acc = jax.lax.fori_loop(0, light_samples, body, acc)
            ls = light_samples.astype(jnp.float32)
        emitted = scene.materials.emission[jnp.maximum(hits.mat_id, 0)]
        radiance = jnp.where(hits.valid[:, None], emitted + acc / ls, 0.0)
        return film.make_color(radiance.reshape(height, width, 3))
    return raygen


def render(width=512, height=512, light_samples=4, bound=True):
    scene = cornell_box()
    cam = cornell_camera(width, height).params()
    raygen = make_raygen(scene, width, height)
    if bound:
        mod = Module({"__raygen__rg": raygen},
                     bound_values={"bound_light_samples": light_samples},
                     name="bound_values")
        fn = jax.jit(mod.get("__raygen__rg"))
        return fn(cam), fn
    fn = jax.jit(raygen)
    return fn(cam, jnp.int32(light_samples)), fn


def main(argv=None):
    p = argparse.ArgumentParser(
        description="bound-value module specialization (optixBoundValues)")
    p.add_argument("--file", default="bound_values.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--light-samples", type=int, default=4,
                   help="NEE samples per hit (the bound launch param)")
    p.add_argument("--no-bound", action="store_true",
                   help="keep light_samples a runtime launch param "
                        "(the reference's unspecialized module)")
    p.add_argument("--compare", action="store_true",
                   help="run both modules, assert identical images, "
                        "report times")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    if args.compare:
        imgs = {}
        for bound in (True, False):
            t0 = time.time()
            img, _ = render(w, h, args.light_samples, bound=bound)
            img = np.asarray(img)
            name = "bound" if bound else "runtime"
            print(f"{name:8s} compile+render {time.time() - t0:.2f}s")
            imgs[name] = img
        if not np.array_equal(imgs["bound"], imgs["runtime"]):
            raise SystemExit("bound != runtime image")
        print("bound and runtime images identical")
        img = imgs["bound"]
    else:
        img, _ = render(w, h, args.light_samples, bound=not args.no_bound)
        img = np.asarray(img)
    save_image(args.file, img)
    print(f"wrote {args.file} ({w}x{h}, light_samples={args.light_samples}, "
          f"{'bound' if not args.no_bound else 'runtime'})")


if __name__ == "__main__":
    main()
