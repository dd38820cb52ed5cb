"""optixHello equivalent: the minimal bring-up path — one "raygen program"
writing a solid-color framebuffer.

Reference: `SDK/optixHello/optixHello.cpp` + `draw_solid_color.cu:39`
(`__raygen__draw_solid_color`: `params.image[idx] = color`). Here the whole
context→module→pipeline→SBT→launch ritual collapses to one jitted function —
which is the point: here the "pipeline" is an XLA executable and the "launch"
is calling it.
"""
from __future__ import annotations

import argparse

from ._cli import parse_dim

import jax
import jax.numpy as jnp
import numpy as np

from ..core import film
from ..io.image import save_image, to_ascii


def render(width=512, height=384, color=(0.462, 0.725, 0.0)):
    """Render the solid-color frame; returns uint8 RGBA [H, W, 4].

    The default color matches the reference's launch params
    (`optixHello.cpp` setup: RGB 0.462, 0.725, 0).
    """
    @jax.jit
    def go(color):
        radiance = jnp.broadcast_to(color, (height, width, 3))
        return film.make_color(radiance)

    return go(jnp.asarray(color, jnp.float32))


def main(argv=None):
    p = argparse.ArgumentParser(description="solid-color raygen (optixHello)")
    p.add_argument("--file", default="hello.png", help="output image path")
    p.add_argument("--dim", default="512x384", help="WxH")
    p.add_argument("--ascii", action="store_true", help="print ASCII preview")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    img = np.asarray(render(w, h))
    save_image(args.file, img)
    if args.ascii:
        print(to_ascii(img))
    print(f"wrote {args.file} ({w}x{h})")


if __name__ == "__main__":
    main()
