"""optixDisplacedMicromesh equivalent: displacement-tessellated triangles.

Reference: `SDK/optixDisplacedMicromesh/` — displacement micromaps (DMM)
subdivide base triangles and displace micro-vertices. Here the tessellation
happens at build time (accel/micromap.displace_mesh); the resulting dense
mesh renders through the normal pipeline (and past 512 triangles, through
the LBVH).
"""
from __future__ import annotations

import argparse

from ._cli import parse_dim

import numpy as np

from ..accel.micromap import displace_mesh
from ..core import film as film_mod
from ..core.camera import Camera
from ..io.image import save_image
from ..scene.device_scene import make_device_scene
from ..shade import materials as mat
from ..shade.lights import AMBIENT, DIRECTIONAL
from ..wavefront.whitted import render_whitted_sample


def make_displaced_plane(level=4):
    # base: two triangles spanning [-1, 1]²
    verts = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                     np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    up = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))

    def bumps(points, bary):
        x, z = points[:, 0], points[:, 2]
        return (0.22 * np.sin(3.5 * x) * np.cos(3.1 * z)
                + 0.08 * np.sin(9.0 * x + 4.0 * z)).astype(np.float32)

    return displace_mesh(verts, idx, bumps, directions=up, level=level)


def render(width=512, height=512, level=4, samples=4):
    verts, idx = make_displaced_plane(level)
    lights = [
        {"kind": DIRECTIONAL, "direction": (-0.5, -0.8, -0.3),
         "color": (0.95, 0.9, 0.8)},
        {"kind": AMBIENT, "color": (0.2, 0.22, 0.28)},
    ]
    scene = make_device_scene(
        verts, idx, np.zeros(len(idx), np.int32),
        [{"kind": mat.DIFFUSE, "base_color": (0.55, 0.5, 0.45)}],
        lights=lights, miss_color=(0.2, 0.25, 0.38))
    cam = Camera(eye=(1.8, 1.4, 2.2), lookat=(0, 0, 0), fov_y=40,
                 aspect=width / height).params()
    film = film_mod.Film.create(height, width)
    for _ in range(samples):
        radiance = render_whitted_sample(scene, cam, width, height,
                                         film.subframe, max_depth=2)
        film = film.accumulate(radiance)
    return film.accum, len(idx)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="displaced micromesh (optixDisplacedMicromesh)")
    p.add_argument("--file", default="micromesh.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--level", type=int, default=4,
                   help="subdivision level (4^level micro-tris per base)")
    p.add_argument("--samples", type=int, default=4)
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    accum, n_tris = render(w, h, level=args.level, samples=args.samples)
    save_image(args.file, np.asarray(film_mod.make_color(accum)))
    print(f"wrote {args.file} ({n_tris} micro-triangles, level {args.level})")


if __name__ == "__main__":
    main()
