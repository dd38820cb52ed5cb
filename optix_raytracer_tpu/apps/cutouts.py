"""optixCutouts equivalent: anyhit alpha-mask cutouts on the Cornell scene.

Reference: `SDK/optixCutouts/` — checkerboard and circle procedural cutout
masks applied via anyhit programs (`optixCutouts.cu:295,337`) on a
path-traced Cornell box. Here the masks are material properties
(`shade.materials.CUT_*`) honored by both radiance and shadow rays.
"""
from __future__ import annotations

import argparse

from ._cli import parse_dim

import numpy as np

from ..core import film as film_mod
from ..io.image import save_image
from ..scene import builtins
from ..scene.device_scene import make_device_scene
from ..shade import materials as mat
from ..shade.lights import ParallelogramLight
from ..wavefront.engine import render_accumulate


def cutout_cornell():
    """Cornell box whose tall block gets a checker cutout and short block a
    circle cutout (the sample's two masked objects)."""
    verts, idx, tri_mat = builtins.quads_to_triangles(builtins._CORNELL_QUADS)
    materials = [dict(m) for m in builtins.CORNELL_MATERIALS]
    materials.append({"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8),
                      "alpha_mode": mat.ALPHA_MASK, "cutout": mat.CUT_CHECKER,
                      "checker_scale": 4.0})
    materials.append({"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8),
                      "alpha_mode": mat.ALPHA_MASK, "cutout": mat.CUT_CIRCLE,
                      "checker_scale": 4.0})
    # tall block quads are indices 10..14 → triangles 20..29; short 5..9 → 10..19
    tri_mat = np.asarray(tri_mat)
    tri_mat[20:30] = 4   # tall block: checker cutout
    tri_mat[10:20] = 5   # short block: circle cutout
    # Per-face unit texcoords (the reference assigns texcoords to the cut
    # objects so the masks vary across each face, `optixCutouts.cu` g_uvs):
    # every quad's corners get (0,0)(1,0)(1,1)(0,1); checker_scale then
    # makes an s x s pattern per face.
    uvs = np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                  (len(verts) // 4, 1))
    light = ParallelogramLight.make(
        builtins.CORNELL_LIGHT_CORNER, builtins.CORNELL_LIGHT_V1,
        builtins.CORNELL_LIGHT_V2, builtins.CORNELL_LIGHT_EMISSION)
    return make_device_scene(verts, idx, tri_mat, materials, uvs=uvs,
                             area_light=light)


def cutout_grid(nx=40, ny=30):
    """A cutout scene past the brute-force limit: an nx x ny grid of quads
    in the y=300 plane, each quad exactly one checker cell (scale 1 with
    per-quad-offset uvs, so every triangle is CERTAIN opaque or
    transparent), over a solid floor. Exercises the opacity-micromap
    integration on the BVH traversal (the reference applies micromaps to
    any GAS, `optixOpacityMicromap.cpp:29-30`)."""
    verts, idx, uvs, tri_mat = [], [], [], []
    sx, sz = 500.0 / nx, 500.0 / ny
    for j in range(ny):
        for i in range(nx):
            b = len(verts)
            x0, z0 = i * sx, j * sz
            verts += [[x0, 300, z0], [x0 + sx, 300, z0],
                      [x0 + sx, 300, z0 + sz], [x0, 300, z0 + sz]]
            uvs += [[i, j], [i + 1, j], [i + 1, j + 1], [i, j + 1]]
            idx += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
            tri_mat += [1, 1]
    b = len(verts)
    verts += [[0, 0, 0], [500, 0, 0], [500, 0, 500], [0, 0, 500]]
    uvs += [[0, 0], [1, 0], [1, 1], [0, 1]]
    idx += [[b, b + 2, b + 1], [b, b + 3, b + 2]]
    tri_mat += [0, 0]
    materials = [
        {"kind": mat.DIFFUSE, "base_color": (0.7, 0.7, 0.7)},
        {"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8),
         "alpha_mode": mat.ALPHA_MASK, "cutout": mat.CUT_CHECKER,
         "checker_scale": 1.0},
    ]
    light = ParallelogramLight.make((150, 640, 150), (200, 0, 0),
                                    (0, 0, 200), (15.0, 15.0, 15.0))
    return make_device_scene(
        np.asarray(verts, np.float32), np.asarray(idx, np.int32),
        np.asarray(tri_mat, np.int32), materials,
        uvs=np.asarray(uvs, np.float32), area_light=light)


def render(width=768, height=768, samples=16, max_depth=4):
    scene = cutout_cornell()
    cam = builtins.cornell_camera(width, height).params()
    film = film_mod.Film.create(height, width)
    film, _ = render_accumulate(scene, cam, film, width, height,
                                samples_per_launch=samples,
                                max_depth=max_depth, chunk_size=None)
    return film.accum, film


def main(argv=None):
    p = argparse.ArgumentParser(description="alpha cutouts (optixCutouts)")
    p.add_argument("--file", default="cutouts.png")
    p.add_argument("--dim", default="768x768")
    p.add_argument("--samples", type=int, default=32)
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    accum, film = render(w, h, samples=args.samples)
    save_image(args.file, np.asarray(film_mod.make_color(accum)))
    print(f"wrote {args.file} ({w}x{h}, {int(film.subframe)} spp)")


if __name__ == "__main__":
    main()
