"""Multi-chip rendering: device-mesh sharded tiles + sample parallelism.

The mesh form of the reference's multi-GPU machinery:

- `optixMultiGPU` replicates scene/pipeline per device and statically assigns
  interleaved 8×4 pixel tiles (`SDK/sutil/WorkDistribution.h:50-81`), merging
  into a zero-copy host framebuffer (`optixMultiGPU.cpp:1120-1168`). Here the
  framebuffer *is* a mesh-sharded jax array: each chip raygen-traces only its
  row-block of the image inside `shard_map`, the scene pytree is replicated,
  and "merging" is the sharded output array itself — assembled only
  if/when the host asks for it.
- `optixNVLink`'s topology discovery / P2P islands (`optixNVLink.cpp:1698`)
  collapse into the `jax.sharding.Mesh`. The mesh follows the algorithm
  alone (row tiles x sample shards): the devices of one host are joined
  all to all, so no device order is closer than another.
- Sample-parallel mode ("sp"): every chip renders the full frame with a
  different subframe seed and the results are mean-reduced with `psum` over
  the mesh axis — the latency-optimized interactive mode.

Both modes compose on a 2-D mesh (rows × samples).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core import film as film_mod
from ..scene.device_scene import DeviceScene
from ..wavefront.engine import render_sample

ROWS_AXIS = "rows"
SAMPLES_AXIS = "samples"


def make_mesh(n_rows: Optional[int] = None, n_samples: int = 1, devices=None) -> Mesh:
    """Build a (rows, samples) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    if n_rows is None:
        n_rows = len(devices) // n_samples
    assert n_rows * n_samples == len(devices), \
        f"mesh {n_rows}x{n_samples} != {len(devices)} devices"
    import numpy as np
    dev_grid = np.asarray(devices).reshape(n_rows, n_samples)
    return Mesh(dev_grid, (ROWS_AXIS, SAMPLES_AXIS))


@functools.partial(jax.jit,
                   static_argnames=("mesh", "width", "height",
                                    "samples_per_launch", "max_depth",
                                    "chunk_size"))
def render_accumulate_sharded(scene: DeviceScene, cam_params, film,
                              mesh: Mesh, width: int, height: int,
                              samples_per_launch: int = 1, max_depth: int = 4,
                              chunk_size: Optional[int] = None):
    """Progressive multi-chip render step.

    film.accum is sharded [H, W, 3] with rows split over ROWS_AXIS; each
    (row, sample) chip renders its row-block for its slice of the subframe
    range, then row-blocks mean-reduce over SAMPLES_AXIS via psum. Equivalent
    by construction to `samples_per_launch * samples_axis_size` sequential
    samples of the single-chip path (identical RNG streams — seeds come from
    global pixel index + subframe).
    """
    n_rows_shards = mesh.shape[ROWS_AXIS]
    n_samp_shards = mesh.shape[SAMPLES_AXIS]
    assert height % n_rows_shards == 0, (height, n_rows_shards)
    tile_h = height // n_rows_shards

    def shard_fn(scene, cam_params, accum_shard, subframe):
        row = jax.lax.axis_index(ROWS_AXIS)
        samp = jax.lax.axis_index(SAMPLES_AXIS)
        y0 = row * tile_h

        def body(i, carry):
            accum, local_sub = carry
            # Device `samp` renders subframe `subframe + i*n_samp + samp`.
            sub = subframe + i * n_samp_shards + samp
            radiance, _ = render_sample(
                scene, cam_params, width, tile_h, sub, max_depth=max_depth,
                chunk_size=chunk_size, y0=y0, full_width=width,
                full_height=height)
            # Progressive mean over global sample count.
            t = 1.0 / (local_sub.astype(jnp.float32) + 1.0)
            accum = accum + (radiance - accum) * t
            return accum, local_sub + 1

        # Each chip accumulates its own samples; the cross-chip sample mean
        # is a psum of equally-weighted partial means.
        local = jnp.zeros_like(accum_shard)
        local, _ = jax.lax.fori_loop(0, samples_per_launch, body,
                                     (local, jnp.zeros((), jnp.int32)))
        local = jax.lax.pmean(local, SAMPLES_AXIS)

        # Merge with prior progressive state.
        prev_n = subframe.astype(jnp.float32)
        new_n = jnp.float32(samples_per_launch * n_samp_shards)
        merged = (accum_shard * prev_n + local * new_n) / (prev_n + new_n)
        return merged

    spec_accum = P(ROWS_AXIS, None, None)
    # check_vma=False: the bounce loop's carry mixes device-varying ray state
    # with unvarying literals; the varying-axis inference is stricter than
    # needed here (every lane's compute is purely local until the pmean).
    shard = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), spec_accum, P()),
        out_specs=spec_accum, check_vma=False)

    new_accum = shard(scene, cam_params, film.accum, film.subframe)
    return film_mod.Film(
        accum=new_accum,
        subframe=film.subframe + samples_per_launch * n_samp_shards)


def shard_film(film, mesh: Mesh):
    """Place the film's accum buffer row-sharded on the mesh (device_put)."""
    sharding = NamedSharding(mesh, P(ROWS_AXIS, None, None))
    return film_mod.Film(accum=jax.device_put(film.accum, sharding),
                         subframe=jax.device_put(
                             film.subframe, NamedSharding(mesh, P())))


@functools.partial(jax.jit,
                   static_argnames=("mesh", "width", "height",
                                    "samples_per_launch", "max_depth",
                                    "chunk_size"))
def render_accumulate_interleaved(scene: DeviceScene, cam_params, film,
                                  mesh: Mesh, width: int, height: int,
                                  samples_per_launch: int = 1,
                                  max_depth: int = 4,
                                  chunk_size: Optional[int] = None):
    """Interleaved-row work distribution: chip r owns rows r, r+D, r+2D, …

    The round-robin assignment of `SDK/sutil/WorkDistribution.h:60-81`
    (8×4-pixel tiles rotated across GPUs) — load-balances scenes whose cost
    varies across the image. The sharded accum buffer holds chip-r's rows
    contiguously; `deinterleave_rows` reorders for display.
    """
    n_rows_shards = mesh.shape[ROWS_AXIS]
    assert height % n_rows_shards == 0
    tile_h = height // n_rows_shards

    def shard_fn(scene, cam_params, accum_shard, subframe):
        row = jax.lax.axis_index(ROWS_AXIS)

        def body(i, carry):
            accum, local_sub = carry
            sub = subframe + i
            radiance, _ = render_sample(
                scene, cam_params, width, tile_h, sub, max_depth=max_depth,
                chunk_size=chunk_size, y0=row, y_stride=n_rows_shards,
                full_width=width, full_height=height)
            t = 1.0 / (local_sub.astype(jnp.float32) + 1.0)
            return accum + (radiance - accum) * t, local_sub + 1

        local = jnp.zeros_like(accum_shard)
        local, _ = jax.lax.fori_loop(0, samples_per_launch, body,
                                     (local, jnp.zeros((), jnp.int32)))
        prev_n = subframe.astype(jnp.float32)
        new_n = jnp.float32(samples_per_launch)
        return (accum_shard * prev_n + local * new_n) / (prev_n + new_n)

    spec_accum = P(ROWS_AXIS, None, None)
    shard = shard_map(shard_fn, mesh=mesh,
                      in_specs=(P(), P(), spec_accum, P()),
                      out_specs=spec_accum, check_vma=False)
    new_accum = shard(scene, cam_params, film.accum, film.subframe)
    return film_mod.Film(accum=new_accum,
                         subframe=film.subframe + samples_per_launch)


def deinterleave_rows(accum, n_shards: int):
    """Reorder an interleaved sharded accum [H, W, 3] into display order:
    global row g lives at shard g % D, local row g // D."""
    h = accum.shape[0]
    tile_h = h // n_shards
    return (accum.reshape(n_shards, tile_h, *accum.shape[1:])
            .swapaxes(0, 1)
            .reshape(accum.shape))
