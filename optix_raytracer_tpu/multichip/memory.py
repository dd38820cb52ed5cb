"""Distributed scene memory: the optixNVLink texture-placement policy.

The reference discovers P2P islands over NVLink, keeps ONE texture copy per
island placed on the least-loaded member, and lets peers sample it over the
link (`SDK/optixNVLink/optixNVLink.cpp:1524-1569` loadTexture,
`:1698-1712` computeP2PIslands). Here the island topology is the mesh
itself: the devices of one slice (one host) share the fast device-to-device
link (the NVLink role); the slice axis is the host-network boundary (the
no-P2P boundary). The policy here is the same decision, expressed as
shardings:

- small stacks  → REPLICATE: every chip keeps a local copy (the island-of-
  one case — fastest sampling, N× memory).
- big stacks    → SHARD_ISLAND: one replica per slice, spread across the
  slice's chips (`P(None, ("rows","samples"), ...)`); sampling rides
  intra-slice gathers, per-chip memory drops by the island size, and no
  gather ever crosses the host network — exactly one copy per island, as
  in the reference.
- huge stacks   → SHARD_GLOBAL: shard across every axis including slices
  (last resort; sampling may cross the host network).

The size heuristic replaces the reference's least-loaded-device pick: XLA
places shards deterministically, so "least loaded" reduces to choosing how
many chips share each replica.
"""
from __future__ import annotations

import math
from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .multislice import SLICE_AXIS
from .tiles import ROWS_AXIS

# Per-device texture budget before the policy stops replicating: geometry,
# film and wavefront state dominate device memory, so textures get a
# conservative 1/64 of what the allocator may use. Devices that report no
# limit (the CPU backend) get TEXTURE_BUDGET_FALLBACK.
TEXTURE_BUDGET_SHARE = 64
TEXTURE_BUDGET_FALLBACK = 256 << 20


def default_texture_budget(device=None) -> int:
    """Bytes of textures one device keeps before placement stops
    replicating, from the device's own memory limit."""
    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return TEXTURE_BUDGET_FALLBACK
    return int(limit) // TEXTURE_BUDGET_SHARE


def texture_nbytes(scene) -> int:
    """Total bytes of the scene's texture stacks (atlas + bundles)."""
    total = 0
    for arr in (scene.textures, scene.bundles, scene.bundle_quads):
        total += arr.size * arr.dtype.itemsize
    return int(total)


def plan_texture_placement(nbytes: int, mesh: Mesh,
                           budget_bytes: Optional[int] = None) -> dict:
    """Pick replicate / shard-per-island / shard-global from the stack size.

    Returns {mode, island_axes, per_chip_bytes, replicas} — `replicas` is
    the number of full copies across the whole mesh (the reference's
    one-per-island invariant). budget_bytes defaults to the mesh devices'
    default_texture_budget."""
    if budget_bytes is None:
        budget_bytes = default_texture_budget(mesh.devices.flat[0])
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_slices = shape.get(SLICE_AXIS, 1)
    island_axes = tuple(a for a in mesh.axis_names if a != SLICE_AXIS)
    n_island = max(1, math.prod(shape[a] for a in island_axes))
    n_total = n_slices * n_island
    if nbytes <= budget_bytes:
        return dict(mode="replicate", island_axes=(),
                    per_chip_bytes=nbytes, replicas=n_total)
    per_island = -(-nbytes // n_island)
    if per_island <= budget_bytes or n_slices == 1:
        return dict(mode="shard_island", island_axes=island_axes,
                    per_chip_bytes=per_island, replicas=n_slices)
    return dict(mode="shard_global",
                island_axes=(SLICE_AXIS,) + island_axes,
                per_chip_bytes=-(-nbytes // n_total), replicas=1)


def _island_size(axes: tuple, mesh: Mesh) -> int:
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    return max(1, math.prod(shape[a] for a in axes))


def place_scene_textures(scene, mesh: Mesh,
                         budget_bytes: Optional[int] = None):
    """Apply the placement plan to the scene's texture stacks.

    Returns (scene, report). Atlases ([T, H, W, C]) shard over their row
    dimension, the quad-row bundle table ([Q, 128]) over its row axis.
    Everything else in the scene stays replicated (the optixMultiGPU model
    for geometry)."""
    nbytes = texture_nbytes(scene)
    plan = plan_texture_placement(nbytes, mesh, budget_bytes)
    report = dict(plan, total_bytes=nbytes)
    if plan["mode"] == "replicate" or nbytes == 0:
        rep = NamedSharding(mesh, P())
        new = scene.replace(
            textures=jax.device_put(scene.textures, rep),
            bundles=jax.device_put(scene.bundles, rep),
            bundle_quads=jax.device_put(scene.bundle_quads, rep))
        return new, report

    axes = plan["island_axes"]
    n_shard = _island_size(axes, mesh)

    def put(arr, dim):
        # Pad the sharded dim to a multiple of the shard count — safe for
        # all three stacks: atlas/bundle lookups are bounded by their mip
        # tables and quad rows by quad_base, so pad rows are never read.
        import jax.numpy as jnp
        pad = (-arr.shape[dim]) % n_shard
        if pad:
            widths = [(0, 0)] * arr.ndim
            widths[dim] = (0, pad)
            arr = jnp.pad(arr, widths)
        spec = [None] * arr.ndim
        spec[dim] = axes if len(axes) > 1 else axes[0]
        return jax.device_put(arr, NamedSharding(mesh, P(*spec)))

    new = scene.replace(
        textures=(put(scene.textures, 1) if scene.textures.shape[0]
                  else scene.textures),
        bundles=(put(scene.bundles, 1) if scene.bundles.shape[0]
                 else scene.bundles),
        bundle_quads=(put(scene.bundle_quads, 0)
                      if scene.bundle_quads.shape[0]
                      else scene.bundle_quads))
    return new, report


def per_chip_texture_bytes(scene) -> int:
    """Measured bytes of the texture stacks on device 0 (addressable
    shards) — the test/bench observable for the HBM saving."""
    total = 0
    for arr in (scene.textures, scene.bundles, scene.bundle_quads):
        if arr.size == 0:
            continue
        shards = getattr(arr, "addressable_shards", None)
        if shards:
            dev0 = min(s.device.id for s in shards)
            total += sum(int(s.data.size) * arr.dtype.itemsize
                         for s in shards if s.device.id == dev0)
        else:
            total += arr.size * arr.dtype.itemsize
    return int(total)


def shard_scene_textures(scene, mesh: Mesh, axis: str = ROWS_AXIS):
    """Force row-sharded texture storage over `axis` (back-compat helper;
    prefer place_scene_textures for the policy)."""
    if scene.textures.shape[0] == 0:
        return scene
    sharding = NamedSharding(mesh, P(None, axis, None, None))
    return scene.replace(textures=jax.device_put(scene.textures, sharding))


def replicate_scene(scene, mesh: Mesh):
    """Explicitly replicate the whole scene pytree on every chip (the
    optixMultiGPU model: scene copy per device)."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sharding), scene)
