"""Material tables: the tagged-union material model as SoA device arrays.

Re-expresses `SDK/cuda/MaterialData.h:33-140` (tagged union of
PBR / GLASS / PHONG / CHECKER_PHONG + alpha modes) as structure-of-arrays: one
`kind` tag plus parameter planes, so a wavefront shades heterogeneous materials
with branchless selects (small material sets) or `lax.switch` over sorted
material segments (the `optixReorder`/SER analogue — see wavefront/engine.py).
Texture references are integer ids into the scene's texture atlas (scene/).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from ..core import pytree

# Material kinds (MaterialData.h Type tags + imgui_test DiffuseMaterial)
DIFFUSE = 0       # lambertian (imgui_test diffuse.h)
PBR = 1           # metallic-roughness GGX (MaterialData.h:62-84, whitted.cu CH)
GLASS = 2         # reflect/refract dielectric (MaterialData.h:86-103, shading.cu)
PHONG = 3         # phong lobes (MaterialData.h:105-117, shading.cu phongShade)
CHECKER = 4       # procedural checker phong (MaterialData.h:119-131)
EMISSIVE = 5      # pure emitter

# Alpha modes (MaterialData.h:39-44)
ALPHA_OPAQUE = 0
ALPHA_MASK = 1
ALPHA_BLEND = 2

# Cutout mask styles for ALPHA_MASK (the optixCutouts anyhit patterns:
# __anyhit__ah_checkerboard / __anyhit__ah_circle, optixCutouts.cu:295,337;
# TEXTURE reads the base-color texture's alpha channel)
CUT_NONE = 0
CUT_CHECKER = 1
CUT_CIRCLE = 2
CUT_TEXTURE = 3


@pytree.dataclass
class MaterialTable:
    kind: jnp.ndarray            # [K] int32
    base_color: jnp.ndarray      # [K, 3] albedo / diffuse color
    emission: jnp.ndarray        # [K, 3]
    metallic: jnp.ndarray        # [K]
    roughness: jnp.ndarray       # [K]
    ior: jnp.ndarray             # [K] index of refraction (glass)
    specular: jnp.ndarray        # [K, 3] phong Ks / glass reflection tint
    phong_exp: jnp.ndarray       # [K]
    checker1: jnp.ndarray        # [K, 3] secondary checker color
    checker_scale: jnp.ndarray   # [K]  checker frequency
    alpha_mode: jnp.ndarray      # [K] int32
    alpha_cutoff: jnp.ndarray    # [K]
    base_tex: jnp.ndarray        # [K] int32 texture id, -1 = none
    normal_tex: jnp.ndarray      # [K] int32 tangent-space normal map id
    mr_tex: jnp.ndarray          # [K] int32 metallic-roughness map id
                                 #   (glTF packing: G=roughness, B=metallic)
    emissive_tex: jnp.ndarray    # [K] int32 emissive map id
    kr: jnp.ndarray              # [K, 3] reflectivity (whitted glass/metal)
    cutout: jnp.ndarray          # [K] int32 CUT_* mask style
    # 16-channel material texture bundle id (scene/device_scene.py
    # pack_bundles); -1 = untextured. Defaults to -1s for tables built
    # before the scene wires bundles in.
    bundle: jnp.ndarray = None   # [K] int32

    @property
    def num(self):
        return self.kind.shape[0]


def make_material_table(materials) -> MaterialTable:
    """materials: list of dicts; unspecified fields get sensible defaults."""
    K = max(len(materials), 1)

    def plane(key, default, width=None):
        if width is None:
            out = np.full((K,), default, np.float32)
        else:
            out = np.tile(np.asarray(default, np.float32), (K, 1))
        for i, m in enumerate(materials):
            if key in m:
                out[i] = m[key]
        return jnp.asarray(out)

    kind = np.zeros(K, np.int32)
    alpha_mode = np.zeros(K, np.int32)
    base_tex = np.full(K, -1, np.int32)
    normal_tex = np.full(K, -1, np.int32)
    mr_tex = np.full(K, -1, np.int32)
    emissive_tex = np.full(K, -1, np.int32)
    cutout = np.zeros(K, np.int32)
    for i, m in enumerate(materials):
        kind[i] = m.get("kind", DIFFUSE)
        alpha_mode[i] = m.get("alpha_mode", ALPHA_OPAQUE)
        base_tex[i] = m.get("base_tex", -1)
        normal_tex[i] = m.get("normal_tex", -1)
        mr_tex[i] = m.get("mr_tex", -1)
        emissive_tex[i] = m.get("emissive_tex", -1)
        cutout[i] = m.get("cutout", CUT_NONE)

    return MaterialTable(
        kind=jnp.asarray(kind),
        base_color=plane("base_color", (0.8, 0.8, 0.8), 3),
        emission=plane("emission", (0.0, 0.0, 0.0), 3),
        metallic=plane("metallic", 0.0),
        roughness=plane("roughness", 0.5),
        ior=plane("ior", 1.5),
        specular=plane("specular", (0.0, 0.0, 0.0), 3),
        phong_exp=plane("phong_exp", 32.0),
        checker1=plane("checker1", (0.0, 0.0, 0.0), 3),
        checker_scale=plane("checker_scale", 1.0),
        alpha_mode=jnp.asarray(alpha_mode),
        alpha_cutoff=plane("alpha_cutoff", 0.5),
        base_tex=jnp.asarray(base_tex),
        normal_tex=jnp.asarray(normal_tex),
        mr_tex=jnp.asarray(mr_tex),
        emissive_tex=jnp.asarray(emissive_tex),
        kr=plane("kr", (0.0, 0.0, 0.0), 3),
        cutout=jnp.asarray(cutout),
        bundle=jnp.full((K,), -1, jnp.int32),
    )


_FIELDS = (  # (name, width, integer)
    ("kind", 1, True), ("base_color", 3, False), ("emission", 3, False),
    ("metallic", 1, False), ("roughness", 1, False), ("ior", 1, False),
    ("specular", 3, False), ("phong_exp", 1, False),
    ("checker1", 3, False), ("checker_scale", 1, False),
    ("kr", 3, False), ("base_tex", 1, True), ("normal_tex", 1, True),
    ("mr_tex", 1, True), ("emissive_tex", 1, True), ("alpha_mode", 1, True),
    ("alpha_cutoff", 1, False), ("cutout", 1, True), ("bundle", 1, True),
)


def _gather_onehot(table: MaterialTable, mid):
    """Small-table gather as a one-hot matmul.

    For the small material tables every real scene has (K <= 128 — the SBT
    rarely holds more distinct materials), one [N, K] one-hot matmul
    against a packed [K, 29] plane fetches every field at once instead of
    19 per-field gathers. It is bit-exact at HIGHEST precision: exactly
    one 1.0 x v term per row, the 0.0 x w terms vanish, f32 accumulate.
    """
    k = table.num
    cols = []
    for name, width, integer in _FIELDS:
        v = getattr(table, name)
        if v is None:
            v = jnp.full((k,), -1, jnp.int32)
        v = v.astype(jnp.float32)
        cols.append(v[:, None] if width == 1 else v)
    plane = jnp.concatenate(cols, axis=1)                  # [K, 29]
    shape = mid.shape
    flat = mid.reshape(-1)
    onehot = (flat[:, None] == jnp.arange(k)[None, :]).astype(jnp.float32)
    vals = jax.lax.dot(onehot, plane,
                       precision=jax.lax.Precision.HIGHEST)  # [N, 29]
    out, i = {}, 0
    for name, width, integer in _FIELDS:
        v = vals[:, i:i + width] if width > 1 else vals[:, i]
        v = v.reshape(shape + ((width,) if width > 1 else ()))
        out[name] = v.astype(jnp.int32) if integer else v
        i += width
    return out


def gather(table: MaterialTable, mat_id):
    """Per-hit material parameters from the table — the SBT data fetch of
    the closest-hit program (`optixGetSbtDataPointer`,
    `optix_device.h:1239`). Small tables go through the one-hot matmul
    (see _gather_onehot); big ones fall back to per-field gathers."""
    mid = jnp.maximum(mat_id, 0)
    if table.num <= 128:
        return _gather_onehot(table, mid)
    return {
        "kind": table.kind[mid],
        "base_color": table.base_color[mid],
        "emission": table.emission[mid],
        "metallic": table.metallic[mid],
        "roughness": table.roughness[mid],
        "ior": table.ior[mid],
        "specular": table.specular[mid],
        "phong_exp": table.phong_exp[mid],
        "checker1": table.checker1[mid],
        "checker_scale": table.checker_scale[mid],
        "kr": table.kr[mid],
        "base_tex": table.base_tex[mid],
        "normal_tex": table.normal_tex[mid],
        "mr_tex": table.mr_tex[mid],
        "emissive_tex": table.emissive_tex[mid],
        "alpha_mode": table.alpha_mode[mid],
        "alpha_cutoff": table.alpha_cutoff[mid],
        "cutout": table.cutout[mid],
        "bundle": (table.bundle[mid] if table.bundle is not None
                   else jnp.full(jnp.shape(mid), -1, jnp.int32)),
    }
