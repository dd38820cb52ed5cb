"""optixNVLink equivalent: topology-aware texture placement over the mesh.

Reference: `SDK/optixNVLink/` — discovers P2P islands over NVLink
(`computeP2PIslands`, `optixNVLink.cpp:1698-1712`), keeps ONE texture copy
per island on the least-loaded member and samples it over the link
(`loadTexture`, `:1524-1569`), choosing strategy from the topology
(`--peers none|nvlink|all`, `:759-772`).

Mapping (`multichip/memory.py`): the island is one host's devices (a
slice); the policy picks replicate / one-replica-per-island / global
sharding from the stack size vs a per-device budget, and XLA's GSPMD inserts
the cross-device gathers that the reference's P2P sampler does by hand. This app builds a textured
scene, reports the plan and the measured per-chip HBM bytes (replicated vs
placed), renders through the engine with the placed textures, and checks
the image matches the replicated render bit-exactly.
"""
from __future__ import annotations

import argparse

from ._cli import parse_dim

import jax
import numpy as np

from ..core import film as film_mod
from ..core.camera import Camera
from ..io.image import save_image
from ..multichip import memory, tiles
from ..scene.device_scene import make_device_scene
from ..shade import materials as mat
from ..shade.lights import ParallelogramLight
from ..wavefront.engine import render_accumulate


def textured_scene(tex_px=256, seed=0):
    """Floor + panel with base/normal/MR/emissive maps (the bench's 4-map
    PBR scene; texture size is the CLI's knob for pushing the placement
    policy across its replicate/shard thresholds)."""
    rng = np.random.default_rng(seed)
    tex_base = rng.uniform(0.1, 0.9, (tex_px, tex_px, 3)).astype(np.float32)
    nm = rng.normal(0, 0.2, (tex_px // 2, tex_px // 2, 3)).astype(np.float32)
    nm[..., 2] = 1.0
    nm /= np.linalg.norm(nm, axis=-1, keepdims=True)
    tex_norm = (nm * 0.5 + 0.5).astype(np.float32)
    tex_mr = rng.uniform(0, 1, (tex_px // 2, tex_px // 2, 3)).astype(
        np.float32)
    tex_em = rng.uniform(0, 0.2, (tex_px // 4, tex_px // 4, 3)).astype(
        np.float32)
    s = 3.0
    verts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s],
                      [-1.0, 0.0, -0.5], [1.0, 0.0, -0.5],
                      [1.0, 1.6, -0.5], [-1.0, 1.6, -0.5]], np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], np.int32)
    uvs = np.array([[0, 0], [4, 0], [4, 4], [0, 4],
                    [0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    mats = [{"kind": mat.PBR, "base_color": (1, 1, 1), "base_tex": 0,
             "normal_tex": 1, "mr_tex": 2, "emissive_tex": 3,
             "emission": (1.0, 1.0, 1.0), "metallic": 1.0,
             "roughness": 1.0}]
    light = ParallelogramLight.make((-1.0, 3.0, -1.0), (2, 0, 0),
                                    (0, 0, 2), (8.0, 8.0, 8.0))
    return make_device_scene(verts, idx, np.zeros(4, np.int32), mats,
                             uvs=uvs,
                             textures=[tex_base, tex_norm, tex_mr, tex_em],
                             area_light=light)


def render(scene, width, height, samples, max_depth=3):
    cam = Camera(eye=(0, 1.5, -4.5), lookat=(0, 0.6, 0), up=(0, 1, 0),
                 fov_y=40.0, aspect=width / height).params()
    film = film_mod.Film.create(height, width)
    film, _ = render_accumulate(scene, cam, film, width, height,
                                samples_per_launch=samples,
                                max_depth=max_depth, chunk_size=None)
    return np.asarray(film_mod.make_color(film.accum))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="topology-aware texture placement (optixNVLink)")
    p.add_argument("--file", default="nvlink.png")
    p.add_argument("--dim", default="256x256")
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--tex-size", type=int, default=256,
                   help="base texture resolution (push this up to cross "
                        "the placement thresholds)")
    p.add_argument("--budget-mb", type=float, default=None,
                   help="per-chip texture budget in MB (default: the "
                        "policy's 256 MB; small values force sharding — "
                        "the reference's --peers nvlink analogue)")
    p.add_argument("--rows", type=int, default=None,
                   help="mesh rows axis size (default: all devices)")
    p.add_argument("--check", action="store_true",
                   help="also render replicated and assert bit-identical")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)

    n_dev = len(jax.devices())
    n_rows = args.rows or n_dev
    mesh = tiles.make_mesh(n_rows=n_rows, n_samples=1,
                           devices=jax.devices()[:n_rows])
    scene = textured_scene(tex_px=args.tex_size)
    nbytes = memory.texture_nbytes(scene)
    budget = (int(args.budget_mb * (1 << 20)) if args.budget_mb is not None
              else memory.default_texture_budget())
    placed, report = memory.place_scene_textures(scene, mesh,
                                                 budget_bytes=budget)
    per_chip = memory.per_chip_texture_bytes(placed)
    print(f"devices: {n_dev} | texture stacks: {nbytes / 1e6:.2f} MB | "
          f"budget/chip: {budget / 1e6:.2f} MB")
    print(f"plan: mode={report['mode']} replicas={report['replicas']} "
          f"island_axes={report['island_axes']} | "
          f"per-chip {per_chip / 1e6:.2f} MB "
          f"({nbytes / max(per_chip, 1):.1f}x saving vs replicate)"
          if report["mode"] != "replicate" else
          f"plan: replicate on all {report['replicas']} chips "
          f"({per_chip / 1e6:.2f} MB/chip)")

    img = render(placed, w, h, args.samples)
    if args.check:
        ref = render(scene, w, h, args.samples)
        if not np.array_equal(img, ref):
            raise SystemExit("placed render != replicated render")
        print("placed render matches replicated render bit-exactly")
    save_image(args.file, img)
    print(f"wrote {args.file} ({w}x{h}, {args.samples} spp)")


if __name__ == "__main__":
    main()
