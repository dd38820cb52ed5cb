"""Device triangle geometry + the matmul-form intersection precompute.

Role of `optixAccelBuild`'s triangle build input (`include/optix_types.h:632-799`)
and the driver's triangle intersector: a mesh becomes a `TriangleGeometry` pytree
holding both raw triangle data and a precomputed **unit-triangle (Woop-style)
affine transform per triangle**, packed so that transforming a whole wavefront of
rays into every triangle's local frame is two matmuls:

    O' = O @ W + C        # [N, 3] @ [3, 3M] + [3M]
    D' = D @ W            # [N, 3] @ [3, 3M]

In triangle t's local frame a point is v0 + u*e1 + v*e2 + w*n, so the hit test
collapses to elementwise math on (u, v, w) lanes: t = -O'w/D'w, u = O'u + t*D'u,
v = O'v + t*D'v, hit iff u>=0, v>=0, u+v<=1, t in (tmin, tmax). The XLA
brute-force intersector evaluates this as two matmuls over the wavefront;
the fused GPU kernel (accel/pallas_bf.py) reads the same per-triangle
constants (`tri_consts`) as scalars.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import pytree

from ..core.vecmath import cross, normalize


@pytree.dataclass
class TriangleGeometry:
    """A GAS over triangles (one geometry's worth; instances reference these).

    vertices/indices are retained for refit & shading lookups; v0/e1/e2 and the
    packed Woop transform (w_mat [3, 3M], w_off [3M]) are derived. face_normal is
    geometric (unnormalized cross(e1, e2) direction normalized).
    """
    vertices: jnp.ndarray      # [V, 3] f32
    indices: jnp.ndarray       # [M, 3] i32
    v0: jnp.ndarray            # [M, 3]
    e1: jnp.ndarray            # [M, 3]
    e2: jnp.ndarray            # [M, 3]
    face_normal: jnp.ndarray   # [M, 3] unit geometric normals
    w_mat: jnp.ndarray         # [3, 3M] packed world→unit-triangle linear maps
    w_off: jnp.ndarray         # [3M] packed translations
    valid: jnp.ndarray         # [M] bool — False for degenerate/padding triangles
    tri_consts: jnp.ndarray    # [M, 16] per-triangle kernel constants:
    #   [0:9]  m_inv rows (u row, v row, w row), zeroed for invalid tris
    #   [9:12] -m_inv @ v0 offsets
    #   [12:15] unit face normal, [15] pad
    corner_normal: jnp.ndarray  # [M, 3, 3] per-corner shading normals
    corner_uv: jnp.ndarray      # [M, 3, 2] per-corner texture coordinates
    tangent: jnp.ndarray        # [M, 3] uv-aligned tangent (normal mapping)
    uv_density: jnp.ndarray     # [M] sqrt(uv area / world area) — ray-cone
    #   footprint → texel footprint conversion for mip selection
    smooth: bool = pytree.field(pytree_node=False, default=False)
    #   True when real per-vertex normals were provided (corner_normal
    #   carries shading normals, not replicated face normals) — the engine
    #   interpolates them at hits only when this is set

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    @classmethod
    def empty(cls) -> "TriangleGeometry":
        import numpy as np
        return build_triangle_geometry(np.zeros((1, 3), np.float32),
                                       np.zeros((0, 3), np.int32))


def build_triangle_geometry(vertices, indices, normals=None,
                            uvs=None) -> TriangleGeometry:
    """Build the device tables for a triangle mesh. Pure jnp → jittable, so
    dynamic geometry can rebuild per frame (the `OPTIX_BUILD_OPERATION_UPDATE`
    refit path, reference `SDK/optixDynamicGeometry/optixDynamicGeometry.cpp:412-435`).

    normals/uvs: optional per-vertex [V, 3]/[V, 2] shading attributes (the
    GLTF NORMAL/TEXCOORD_0 accessors, `SDK/sutil/Scene.cpp` mesh load);
    default to face normals / zero uv.
    """
    vertices = jnp.asarray(vertices, jnp.float32)
    indices = jnp.asarray(indices, jnp.int32)
    v0 = vertices[indices[:, 0]]
    v1 = vertices[indices[:, 1]]
    v2 = vertices[indices[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    n = cross(e1, e2)
    n_len2 = jnp.sum(n * n, axis=-1)
    valid = n_len2 > 1e-24

    # Local frame matrix M_t = [e1 | e2 | n] (columns); its inverse maps world
    # offsets into (u, v, w). Closed-form adjugate/determinant inverse —
    # the batched LU of jnp.linalg.inv materializes ~6 KB of workspace per
    # matrix (23 GB at 4M triangles); the cofactor form is ~40 elementwise
    # ops and O(M) memory. Degenerate triangles (det ~ 0) divide by 1 and
    # are masked out of every hit test via `valid`.
    c0 = cross(e2, n)                                         # [M, 3]
    c1 = cross(n, e1)
    c2 = cross(e1, e2)
    det = jnp.sum(e1 * c0, axis=-1)                           # [M]
    inv_det = jnp.where(valid, 1.0 / jnp.where(valid, det, 1.0), 0.0)
    # rows of M^-1 are the cofactor columns / det
    m_inv = jnp.stack([c0, c1, c2], axis=1) * inv_det[:, None, None]

    # Zero the transform of degenerate triangles: a zeroed transform yields
    # d'_w = 0 for every ray, which every intersector masks out — so `valid`
    # never needs a separate lane in the hot kernels.
    m_inv = m_inv * valid[:, None, None]

    # Pack for the two-matmul form: O'[n, 3t+j] = sum_k O[n, k] * m_inv[t, j, k]
    # → W[k, 3t+j] = m_inv[t, j, k]; C[3t+j] = -m_inv[t, j, :] @ v0[t].
    M = indices.shape[0]
    offsets = -jnp.einsum("tjk,tk->tj", m_inv, v0,
                          precision=jax.lax.Precision.HIGHEST)   # [M, 3]
    w_mat = jnp.transpose(m_inv, (2, 0, 1)).reshape(3, 3 * M)
    w_off = offsets.reshape(3 * M)

    face_normal = normalize(n)
    tri_consts = jnp.concatenate([
        m_inv.reshape(M, 9), offsets, face_normal,
        jnp.zeros((M, 1), jnp.float32)], axis=1)

    if normals is not None:
        normals = jnp.asarray(normals, jnp.float32)
        corner_normal = normals[indices]                 # [M, 3, 3]
    else:
        corner_normal = jnp.broadcast_to(face_normal[:, None, :], (M, 3, 3))
    if uvs is not None:
        uvs = jnp.asarray(uvs, jnp.float32)
        corner_uv = uvs[indices]                         # [M, 3, 2]
    else:
        corner_uv = jnp.zeros((M, 3, 2), jnp.float32)

    # Tangent frame + uv density (normal mapping and ray-cone mip LOD,
    # the derivative data `MaterialData.h` textures get from rasterizers).
    duv1 = corner_uv[:, 1] - corner_uv[:, 0]             # [M, 2]
    duv2 = corner_uv[:, 2] - corner_uv[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    safe_det = jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    tangent_raw = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) / safe_det[:, None]
    # fall back to an arbitrary edge-aligned tangent for degenerate uvs
    tangent = jnp.where((jnp.abs(det) < 1e-12)[:, None], e1, tangent_raw)
    tangent = normalize(tangent)
    world_area2 = jnp.sqrt(jnp.maximum(n_len2, 1e-24))   # 2 * area
    uv_density = jnp.sqrt(jnp.abs(det) / world_area2)

    return TriangleGeometry(
        vertices=vertices, indices=indices, v0=v0, e1=e1, e2=e2,
        face_normal=face_normal, w_mat=w_mat, w_off=w_off, valid=valid,
        tri_consts=tri_consts, corner_normal=corner_normal,
        corner_uv=corner_uv, tangent=tangent, uv_density=uv_density,
        smooth=normals is not None,
    )


def shade_plane(geom: TriangleGeometry) -> jnp.ndarray:
    """Per-triangle shading attributes packed into ONE [M, 128] plane, so a
    wavefront's shading_frame costs a single row gather instead of
    eight. Rows are padded to 128 columns.

    Columns: v0(0:3) e1(3:6) e2(6:9) face_normal(9:12)
    corner_normal(12:21) corner_uv(21:27) tangent(27:30)
    uv_density(30) pad(31:128)."""
    m = geom.num_triangles
    return jnp.concatenate([
        geom.v0, geom.e1, geom.e2, geom.face_normal,
        geom.corner_normal.reshape(m, 9),
        geom.corner_uv.reshape(m, 6),
        geom.tangent,
        geom.uv_density[:, None],
        jnp.zeros((m, 97), jnp.float32),
    ], axis=1)


def shading_frame(geom: TriangleGeometry, prim_id, uv, plane=None):
    """Hit-point attributes for shading: position, geometric + interpolated
    shading normal, interpolated texture uv (+ tangent, uv_density).

    prim_id: [...] i32 (>=0), uv: [..., 2] barycentrics. ONE per-hit
    gather from the packed shade plane (see shade_plane). Mirrors the
    LocalGeometry fill-in of `SDK/cuda/LocalGeometry.h` (barycentric
    N/UV interpolation).
    """
    pid = jnp.maximum(prim_id, 0)
    if plane is None:
        plane = shade_plane(geom)
    row = plane[pid]                             # [..., 32] — one gather
    v0 = row[..., 0:3]
    e1 = row[..., 3:6]
    e2 = row[..., 6:9]
    n = row[..., 9:12]
    u, v = uv[..., 0], uv[..., 1]
    w = 1.0 - u - v
    pos = v0 + u[..., None] * e1 + v[..., None] * e2

    # Straight column-slice interpolation — no [N, 3, 3] reshapes of the
    # gathered rows.
    sn = (w[..., None] * row[..., 12:15] + u[..., None] * row[..., 15:18]
          + v[..., None] * row[..., 18:21])
    # Degenerate interpolation (zero-filled corner normals for meshes that
    # shipped none, or opposing normals cancelling) → geometric normal.
    sn_len = jnp.linalg.norm(sn, axis=-1, keepdims=True)
    sn = jnp.where(sn_len > 1e-6, sn / jnp.maximum(sn_len, 1e-12), n)
    tex_uv = (w[..., None] * row[..., 21:23] + u[..., None] * row[..., 23:25]
              + v[..., None] * row[..., 25:27])
    return {"position": pos, "normal": n, "shading_normal": sn,
            "uv": tex_uv, "tangent": row[..., 27:30],
            "uv_density": row[..., 30]}
