"""Micromaps: opacity classification + displaced micromeshes (build-time).

The reference builds two micromap flavors (`optixOpacityMicromapArrayBuild`,
`optixDisplacementMicromapArrayBuild`, `include/optix_host.h:731,807`):

- **Opacity micromaps** pre-classify sub-triangle regions of alpha-masked
  geometry as opaque / transparent / unknown so traversal can skip anyhit
  invocations (`optixOpacityMicromap` sample). Here: sample the cutout mask
  on a barycentric grid per triangle at a subdivision level and classify
  each micro-triangle; per-triangle summaries let the alpha-aware occlusion
  path short-circuit fully-opaque and fully-transparent triangles.
- **Displaced micromeshes** subdivide base triangles 4^level ways and push
  micro-vertices along interpolated directions by a displacement amount
  (`optixDisplacedMicromesh` sample). Here: a build-time tessellator that
  emits a plain (bigger) triangle mesh — more uniform triangles are
  exactly what the dense intersectors want.
"""
from __future__ import annotations

import numpy as np

# micro-triangle states (OptixOpacityMicromapState)
TRANSPARENT = 0
OPAQUE = 1
UNKNOWN_TRANSPARENT = 2
UNKNOWN_OPAQUE = 3


def _micro_corners(level: int):
    """Micro-triangle corner barycentrics at subdivision `level`:
    [T, 3, 2] (u, v) per corner, T = 4^level micro-triangles, enumerated
    row-major with upright-then-inverted per column — the same order
    `micro_index` reproduces from a hit barycentric."""
    n = 1 << level
    tris = []
    for row in range(n):
        for col in range(n - row):
            u0, v0 = col / n, row / n
            s = 1.0 / n
            # upright micro-tri
            tris.append(((u0, v0), (u0 + s, v0), (u0, v0 + s)))
            # inverted micro-tri
            if col < n - row - 1:
                tris.append(((u0 + s, v0), (u0 + s, v0 + s), (u0, v0 + s)))
    return np.asarray(tris, np.float32)


def _sample_points(sub: int = 3):
    """Barycentric sample lattice inside one micro-triangle (interior
    points of a sub x sub grid — strictly inside, so a sample never lands
    exactly on a mask edge shared with the neighbor)."""
    pts = []
    for i in range(sub):
        for j in range(sub - i):
            a = (i + 1.0 / 3.0) / sub
            b = (j + 1.0 / 3.0) / sub
            pts.append((1.0 - a - b, a, b))
    return np.asarray(pts, np.float32)                       # [K, 3]


def build_opacity_micromap(corner_uv, mask_fn, level: int = 3,
                           samples: int = 3):
    """Classify each triangle's micro-triangles against a cutout mask.

    corner_uv: [M, 3, 2] per-corner texture coords; mask_fn(uv [K, 2]) →
    bool [K] (True = hole/transparent). Classification is CONSERVATIVE:
    each micro-triangle is sampled at `samples*(samples+1)/2` interior
    points and labeled OPAQUE / TRANSPARENT only when every sample agrees,
    else UNKNOWN_OPAQUE (the 4-state mode of `optix_types.h`
    OptixOpacityMicromapFormat: traversal may then skip the anyhit program
    for the two certain states and must invoke it for UNKNOWN —
    `optixOpacityMicromap.cpp:29-30`).

    Returns (micro_states [M, T] uint8, tri_summary [M] uint8) with
    summary OPAQUE / TRANSPARENT only when every micro-triangle is certain
    and agrees, else UNKNOWN_OPAQUE.
    """
    corner_uv = np.asarray(corner_uv, np.float32)
    micro = _micro_corners(level)                            # [T, 3, 2]
    w_pts = _sample_points(samples)                          # [K, 3]
    # sample barycentrics (u, v) inside each micro-tri: [T, K, 2]
    suv = np.einsum("kc,tcx->tkx", w_pts, micro)
    u = suv[..., 0]                                          # [T, K]
    v = suv[..., 1]
    w = 1.0 - u - v
    # uv at each sample of each micro-tri of each base tri: [M, T, K, 2]
    uv = (w[None, ..., None] * corner_uv[:, None, None, 0]
          + u[None, ..., None] * corner_uv[:, None, None, 1]
          + v[None, ..., None] * corner_uv[:, None, None, 2])
    m, t, k = uv.shape[:3]
    holes = np.asarray(mask_fn(uv.reshape(-1, 2))).reshape(m, t, k)
    all_hole = holes.all(axis=2)
    any_hole = holes.any(axis=2)
    states = np.full((m, t), UNKNOWN_OPAQUE, np.uint8)
    states[all_hole] = TRANSPARENT
    states[~any_hole] = OPAQUE
    summary = np.full(m, UNKNOWN_OPAQUE, np.uint8)
    summary[(states == TRANSPARENT).all(axis=1)] = TRANSPARENT
    summary[(states == OPAQUE).all(axis=1)] = OPAQUE
    return states, summary


def micro_index(u, v, level: int):
    """Micro-triangle index for a hit barycentric (u, v) — jnp-traceable.

    Inverts `_micro_corners`'s enumeration: row-major over the v rows,
    2 entries per interior column (upright at 2*col, inverted at
    2*col + 1), row r holding 2*(n-r) - 1 entries so base(row) =
    row * (2n - row)."""
    import jax.numpy as jnp
    n = 1 << level
    fu = jnp.clip(u, 0.0, 1.0 - 1e-7) * n
    fv = jnp.clip(v, 0.0, 1.0 - 1e-7) * n
    col = jnp.floor(fu).astype(jnp.int32)
    row = jnp.floor(fv).astype(jnp.int32)
    # clamp to the triangular domain (u + v <= 1 up to float error)
    row = jnp.minimum(row, n - 1)
    col = jnp.minimum(col, n - 1 - row)
    inverted = ((fu - col) + (fv - row)) > 1.0
    # the last column of a row has no inverted twin
    inverted = inverted & (col < n - 1 - row)
    return row * (2 * n - row) + 2 * col + inverted.astype(jnp.int32)


def checker_mask(scale: float):
    """The optixCutouts checkerboard mask as a mask_fn."""
    def fn(uv):
        fu = uv * scale
        return (np.floor(fu[:, 0]) + np.floor(fu[:, 1])) % 2.0 < 1.0
    return fn


def circle_mask(scale: float, radius: float = 0.25):
    def fn(uv):
        cell = uv * scale - np.floor(uv * scale) - 0.5
        return (cell ** 2).sum(axis=1) < radius * radius
    return fn


# ---------------------------------------------------------------------------
# Displaced micromesh tessellation
# ---------------------------------------------------------------------------

def displace_mesh(vertices, indices, displacement, directions=None,
                  level: int = 3):
    """Subdivide each triangle 4^level ways and displace micro-vertices.

    displacement: callable(points [K, 3], uv_bary [K, 3]) → [K] amounts, or
    a constant float. directions: [V, 3] per-vertex displacement directions
    (default: area-weighted vertex normals, like the DMM sample's direction
    vectors). Returns (new_vertices [K, 3], new_indices [F, 3]) — micro
    vertices are NOT shared across base triangles (simple and vectorized;
    watertightness across bases comes from identical corner/edge
    evaluation).
    """
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    n = 1 << level

    if directions is None:
        directions = np.zeros_like(vertices)
        tri = vertices[indices]
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        for k in range(3):
            np.add.at(directions, indices[:, k], fn)
        norms = np.linalg.norm(directions, axis=1, keepdims=True)
        directions = directions / np.maximum(norms, 1e-20)

    # barycentric lattice (shared per base triangle)
    bary = []
    for row in range(n + 1):
        for col in range(n + 1 - row):
            bary.append((col / n, row / n))
    bary = np.asarray(bary, np.float32)              # [L, 2]
    u = bary[:, 0]
    v = bary[:, 1]
    w = 1.0 - u - v
    lattice = np.stack([w, u, v], axis=1)            # [L, 3]

    # lattice triangulation (same for every base tri)
    def row_start(row):
        return row * (n + 1) - row * (row - 1) // 2

    faces = []
    for row in range(n):
        for col in range(n - row):
            a = row_start(row) + col
            b = a + 1
            c = row_start(row + 1) + col
            faces.append((a, b, c))
            if col < n - row - 1:
                faces.append((b, row_start(row + 1) + col + 1, c))
    faces = np.asarray(faces, np.int32)              # [F0, 3]

    m = indices.shape[0]
    tri_v = vertices[indices]                        # [M, 3, 3]
    tri_d = directions[indices]                      # [M, 3, 3]
    pts = np.einsum("lk,mkx->mlx", lattice, tri_v)   # [M, L, 3]
    dirs = np.einsum("lk,mkx->mlx", lattice, tri_d)

    if callable(displacement):
        amounts = displacement(pts.reshape(-1, 3),
                               np.tile(lattice, (m, 1))).reshape(m, -1)
    else:
        amounts = np.full(pts.shape[:2], float(displacement), np.float32)
    new_pts = pts + dirs * amounts[..., None]

    L = lattice.shape[0]
    new_vertices = new_pts.reshape(-1, 3).astype(np.float32)
    offsets = (np.arange(m, dtype=np.int32) * L)[:, None, None]
    new_indices = (faces[None] + offsets).reshape(-1, 3).astype(np.int32)
    return new_vertices, new_indices
