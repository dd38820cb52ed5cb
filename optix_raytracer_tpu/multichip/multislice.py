"""Multi-host (multi-slice) rendering: the host-network story.

The reference scales past one host with MPI-style replication + NVLink
islands per host (`optixNVLink.cpp:1698` topology discovery). The
multi-host analogue is a 3-axis mesh:

    ("slice", "rows", "samples")

- "slice" is the host-network axis: one entry per host (device group).
  Image rows are partitioned across slices, and — by construction — NO
  collective crosses this axis during rendering: each slice renders its
  own row band and the framebuffer stays sharded. The host network only
  moves pixels if/when the host gathers the final image (bulk, once per
  frame, latency-insensitive).
- "rows" and "samples" live inside a slice: row tiles plus the per-launch
  sample `pmean`, whose all-reduce stays on the intra-host link.

On this single-host environment the slice axis is exercised with virtual
CPU devices (tests) and the driver's multi-chip dry run; on a real pod the
same mesh maps slices to hosts via `jax.distributed` process groups.
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

SLICE_AXIS = "slice"
ROWS_AXIS = "rows"
SAMPLES_AXIS = "samples"


def make_multislice_mesh(n_slices: int, n_rows: int, n_samples: int = 1,
                         devices=None) -> Mesh:
    """(slice, rows, samples) mesh. On a pod, order devices so that each
    contiguous group of n_rows*n_samples belongs to one slice — then the
    samples/rows collectives are intra-slice (intra-host) by construction."""
    import numpy as np
    devices = devices if devices is not None else jax.devices()
    need = n_slices * n_rows * n_samples
    assert need == len(devices), (need, len(devices))
    grid = np.asarray(devices).reshape(n_slices, n_rows, n_samples)
    return Mesh(grid, (SLICE_AXIS, ROWS_AXIS, SAMPLES_AXIS))


def shard_film(film, mesh: Mesh):
    """Row-shard the accum over (slice, rows) jointly."""
    sharding = NamedSharding(mesh, P((SLICE_AXIS, ROWS_AXIS), None, None))
    return film_mod.Film(
        accum=jax.device_put(film.accum, sharding),
        subframe=jax.device_put(film.subframe, NamedSharding(mesh, P())))


@functools.partial(jax.jit,
                   static_argnames=("mesh", "width", "height",
                                    "samples_per_launch", "max_depth",
                                    "chunk_size"))
def render_accumulate_multislice(scene: DeviceScene, cam_params, film,
                                 mesh: Mesh, width: int, height: int,
                                 samples_per_launch: int = 1,
                                 max_depth: int = 4,
                                 chunk_size: Optional[int] = None):
    """Progressive render step over a (slice, rows, samples) mesh.

    Row band = (slice, row) pair; sample mean = pmean over SAMPLES_AXIS
    (intra-slice). Matches the single-chip accumulate exactly: RNG streams
    are seeded from global pixel index + subframe, independent of the
    tiling (`WorkDistribution.h:60-81` semantics)."""
    n_slices = mesh.shape[SLICE_AXIS]
    n_rows = mesh.shape[ROWS_AXIS]
    n_samp = mesh.shape[SAMPLES_AXIS]
    bands = n_slices * n_rows
    assert height % bands == 0, (height, bands)
    tile_h = height // bands

    def shard_fn(scene, cam_params, accum_shard, subframe):
        sl = jax.lax.axis_index(SLICE_AXIS)
        row = jax.lax.axis_index(ROWS_AXIS)
        samp = jax.lax.axis_index(SAMPLES_AXIS)
        y0 = (sl * n_rows + row) * tile_h

        def body(i, carry):
            accum, local_sub = carry
            sub = subframe + i * n_samp + samp
            radiance, _ = render_sample(
                scene, cam_params, width, tile_h, sub, max_depth=max_depth,
                chunk_size=chunk_size, y0=y0, full_width=width,
                full_height=height)
            t = 1.0 / (local_sub.astype(jnp.float32) + 1.0)
            return accum + (radiance - accum) * t, local_sub + 1

        local = jnp.zeros_like(accum_shard)
        local, _ = jax.lax.fori_loop(0, samples_per_launch, body,
                                     (local, jnp.zeros((), jnp.int32)))
        # Intra-slice collective: the sample mean stays inside the host.
        local = jax.lax.pmean(local, SAMPLES_AXIS)
        prev_n = subframe.astype(jnp.float32)
        new_n = jnp.float32(samples_per_launch * n_samp)
        return (accum_shard * prev_n + local * new_n) / (prev_n + new_n)

    spec_accum = P((SLICE_AXIS, ROWS_AXIS), None, None)
    shard = shard_map(shard_fn, mesh=mesh,
                      in_specs=(P(), P(), spec_accum, P()),
                      out_specs=spec_accum, check_vma=False)
    new_accum = shard(scene, cam_params, film.accum, film.subframe)
    return film_mod.Film(
        accum=new_accum,
        subframe=film.subframe + samples_per_launch * n_samp)
