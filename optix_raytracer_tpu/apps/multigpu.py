"""optixMultiGPU equivalent: multi-chip tiled Cornell render over a mesh.

Reference: `SDK/optixMultiGPU/` — one context/pipeline/GAS per device,
interleaved static tile ownership (`sutil/WorkDistribution.h:50-81`),
per-device accumulation, zero-copy merge (`optixMultiGPU.cpp:1120-1168`).
Here: `multichip.tiles` shards the framebuffer rows over a
`jax.sharding.Mesh`; the scene pytree replicates automatically; the merge is
the sharded array itself. `--tint` adds the per-device color tint the
reference uses to visualize the work distribution (`optixMultiGPU.cu:303`).
"""
from __future__ import annotations

import argparse

from ._cli import parse_dim

import jax
import numpy as np

from ..core import film as film_mod
from ..io.image import save_image
from ..multichip import tiles
from ..scene.builtins import cornell_box, cornell_camera


def render(width=512, height=512, samples=8, n_rows=None, n_samples=1,
           tint=False, max_depth=3):
    n_dev = len(jax.devices())
    if n_rows is None:
        n_rows = n_dev // n_samples
    mesh = tiles.make_mesh(n_rows=n_rows, n_samples=n_samples,
                           devices=jax.devices()[: n_rows * n_samples])
    scene = cornell_box()
    cam = cornell_camera(width, height).params()
    film = tiles.shard_film(film_mod.Film.create(height, width), mesh)
    assert samples % n_samples == 0
    film = tiles.render_accumulate_sharded(
        scene, cam, film, mesh, width, height,
        samples_per_launch=samples // n_samples, max_depth=max_depth)
    accum = np.array(film.accum)   # host copy (writable for the tint)
    if tint:
        # visualize tile ownership like the reference's deviceColor()
        tile_h = height // n_rows
        tints = np.array([[1, .7, .7], [.7, 1, .7], [.7, .7, 1], [1, 1, .6],
                          [1, .6, 1], [.6, 1, 1], [1, .8, .6], [.8, .6, 1]])
        for r in range(n_rows):
            accum[r * tile_h:(r + 1) * tile_h] *= tints[r % len(tints)]
    return accum, film


def render_multihost(width, height, samples, sample_shards=1, max_depth=3):
    """Multi-host path: jax.distributed bring-up + one slice per process
    over the (slice, rows, samples) mesh — render-time collectives stay
    inside each host; the host network only moves final pixels
    (multichip/multislice.py)."""
    from ..multichip import distributed as dist
    from ..multichip import multislice as ms
    info = dist.initialize()
    mesh = dist.pod_mesh(samples_per_slice=sample_shards)
    scene = cornell_box()
    cam = cornell_camera(width, height).params()
    film = ms.shard_film(film_mod.Film.create(height, width), mesh)
    assert samples % sample_shards == 0
    film = ms.render_accumulate_multislice(
        scene, cam, film, mesh, width, height,
        samples_per_launch=samples // sample_shards, max_depth=max_depth)
    return np.array(film.accum), film, info


def main(argv=None):
    p = argparse.ArgumentParser(description="multi-chip tiles (optixMultiGPU)")
    p.add_argument("--file", default="multigpu.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--sample-shards", type=int, default=1)
    p.add_argument("--tint", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="jax.distributed bring-up + (slice, rows, samples) "
                        "mesh with one slice per host (env-configured: "
                        "JAX_COORDINATOR_ADDRESS/_NUM_PROCESSES/_PROCESS_ID"
                        "; single-process it degenerates to one slice)")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    if args.multihost:
        accum, film, info = render_multihost(
            w, h, samples=args.samples, sample_shards=args.sample_shards)
        if info.process_id == 0:
            save_image(args.file, np.asarray(film_mod.make_color(accum)))
            print(f"wrote {args.file} ({info.num_processes} hosts x "
                  f"{len(info.local_devices)} chips, "
                  f"{int(film.subframe)} spp)")
        return
    accum, film = render(w, h, samples=args.samples, n_rows=args.rows,
                         n_samples=args.sample_shards, tint=args.tint)
    save_image(args.file, np.asarray(film_mod.make_color(accum)))
    print(f"wrote {args.file} ({len(jax.devices())} devices, "
          f"{int(film.subframe)} spp)")


if __name__ == "__main__":
    main()
