"""ort-warm: pre-populate the persistent compile cache for standard shapes.

The reference ships a compiled-module disk cache precisely so users do not
pay the (minutes-long) shader compile on every run (`optix_host.h:136-228`,
env `OPTIX_CACHE_PATH`). The XLA analogue is JAX's persistent compilation
cache (core/compile_cache.py), but a *first-ever* run still pays the full
cold compile. This tool is the missing pre-warm:
run it once (install step, CI image bake, or while reading the docs) and
every later app/bench launch at a standard shape starts in seconds.

Each warm item executes ONE real launch at the target shape (compile +
first step); the persistent cache then carries the compiled executable
across processes. Warming is resumable — already-cached shapes fly through
in seconds, so re-running after an interrupt only pays for what's missing.

Usage:
    python tools/precompile.py                 # headline shapes (~3 items)
    python tools/precompile.py --full          # {1080p,768^2} x spl{1,16} x depth{2,3,4}
    python tools/precompile.py --shapes 512x512:4:3  # custom WxH:spl:depth
    python tools/precompile.py --cache-dir DIR

The default cache dir is the one every entry point uses:
JAX_COMPILATION_CACHE_DIR when set, else .jax_cache/ in the checkout.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# The headline shapes users actually hit: bench + pathtracer app defaults.
HEADLINE = [(1920, 1080, 16, 4), (1920, 1080, 1, 4), (768, 768, 16, 2)]
FULL = [(w, h, spl, d)
        for (w, h) in [(1920, 1080), (768, 768)]
        for spl in (1, 16)
        for d in (2, 3, 4)]


def parse_shape(spec: str):
    dim, spl, depth = spec.split(":")
    w, h = dim.lower().split("x")
    return int(w), int(h), int(spl), int(depth)


def warm(shapes, cache_dir=None) -> list:
    import jax
    if cache_dir is None:
        from optix_raytracer_tpu.core.compile_cache import enable_compile_cache
        enable_compile_cache()
    else:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

    from optix_raytracer_tpu.core.film import Film
    from optix_raytracer_tpu.scene.builtins import cornell_box, cornell_camera
    from optix_raytracer_tpu.wavefront.engine import render_accumulate

    scene = cornell_box()
    results = []
    for (w, h, spl, depth) in shapes:
        cam = cornell_camera(w, h).params()
        film = Film.create(h, w)
        t0 = time.time()
        film, rays = render_accumulate(scene, cam, film, w, h,
                                       samples_per_launch=spl,
                                       max_depth=depth, chunk_size=None)
        jax.block_until_ready(film.accum)
        dt = time.time() - t0
        results.append(((w, h, spl, depth), dt))
        print(f"# warmed {w}x{h} spl{spl} depth{depth}: {dt:.1f}s",
              flush=True)
    return results


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--full", action="store_true",
                   help="warm the full standard grid (12 shapes)")
    p.add_argument("--shapes", nargs="*", default=None,
                   help="custom WxH:spl:depth specs (overrides presets)")
    p.add_argument("--cache-dir", default=None,
                   help="cache directory (default: JAX_COMPILATION_CACHE_DIR "
                        "or .jax_cache/ in the checkout)")
    args = p.parse_args()
    shapes = ([parse_shape(s) for s in args.shapes] if args.shapes
              else (FULL if args.full else HEADLINE))
    from optix_raytracer_tpu.core.compile_cache import compile_cache_dir
    cache_dir = args.cache_dir or compile_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    print(f"# warming {len(shapes)} shapes into {cache_dir}", flush=True)
    t0 = time.time()
    results = warm(shapes, args.cache_dir)
    total = time.time() - t0
    print(f"# done: {len(results)} shapes in {total:.0f}s "
          f"(next run of each shape starts warm)")


if __name__ == "__main__":
    main()
