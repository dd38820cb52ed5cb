"""optixModuleCreateAbort equivalent: abortable out-of-process compilation.

Reference: `SDK/optixModuleCreateAbort/` — module compilation runs in a
spawned child process (`posix_spawn`, `optixModuleCreateAbort.cpp:30,76`)
with the compile options serialized to its CLI (`:786-835`); the parent
keeps rendering with the OLD pipeline and either hot-swaps when the child
finishes or kills it mid-compile (`:446,586-599`).

Mapping (`api/module.py` AbortableCompile): the child process (on the CPU
backend, so it never opens the card the parent holds) runs the
AOT `jit(...).lower().compile()`; `.poll()/.wait()/.abort()` mirror the
reference's process control. The render loop below keeps producing frames
with the current pipeline the whole time — the hot-swap flow.
"""
from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..api.module import AbortableCompile
from ..core import film
from ..io.image import save_image
from ..scene.builtins import whitted_scene, whitted_camera
from ..wavefront.whitted import render_whitted_sample

_ENTRY_SHAPES = [((256, 256), "float32")]


def heavy_entry(x):
    """The module being compiled out-of-process: a long unrolled matmul
    chain — enough XLA optimization work that aborting mid-compile is
    meaningful (the reference compiles a full path-tracer module)."""
    for i in range(120):
        x = jnp.tanh(x @ x.T * (1.0 / (i + 2.0)))
    return x


def render_frame(scene, cam, w, h, subframe):
    return np.asarray(film.make_color(
        render_whitted_sample(scene, cam, w, h, subframe, max_depth=2)))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="abortable out-of-process compile (optixModuleCreateAbort)")
    p.add_argument("--file", default="module_create_abort.png")
    p.add_argument("--dim", default="128x128")
    p.add_argument("--abort-after", type=float, default=0.5,
                   help="seconds before killing the first compile")
    p.add_argument("--no-abort", action="store_true",
                   help="let the first compile finish instead")
    args = p.parse_args(argv)
    from ._cli import parse_dim
    w, h = parse_dim(args.dim)

    scene = whitted_scene()
    cam = whitted_camera(w, h).params()
    # Warm the CURRENT pipeline first (the reference renders with the old
    # pipeline while the child compiles — it is already built).
    render_frame(scene, cam, w, h, 0)

    me = "optix_raytracer_tpu.apps.module_create_abort"
    compile1 = AbortableCompile(me, "heavy_entry", _ENTRY_SHAPES)
    print("child compile started (pid alive), rendering with the current "
          "pipeline meanwhile...")
    t0 = time.time()
    frames = 0
    while compile1.poll() is None:
        render_frame(scene, cam, w, h, frames)
        frames += 1
        if not args.no_abort and time.time() - t0 >= args.abort_after:
            compile1.abort()
            break
    status = compile1.poll()
    if args.no_abort or status is True:
        # Finished before any abort (or abort not requested).
        ok = compile1.wait()
        print(f"compile finished ok={ok} after {time.time() - t0:.2f}s "
              f"({frames} frames rendered during it)")
    else:
        print(f"aborted compile after {time.time() - t0:.2f}s "
              f"(killed mid-flight, status={status}; "
              f"{frames} frames rendered during it)")
        # Second compile runs to completion — the reference's hot-swap.
        t1 = time.time()
        compile2 = AbortableCompile(me, "heavy_entry", _ENTRY_SHAPES)
        while compile2.poll() is None:
            render_frame(scene, cam, w, h, frames)
            frames += 1
        print(f"second compile finished ok={compile2.wait()} in "
              f"{time.time() - t1:.2f}s; hot-swapping")
    img = render_frame(scene, cam, w, h, frames)
    save_image(args.file, img)
    print(f"wrote {args.file} ({w}x{h}, {frames + 1} frames total)")


if __name__ == "__main__":
    main()
