"""DeviceScene: everything the wavefront engine needs, as one pytree.

The analogue of the reference's launch-params + SBT package: the
`whitted::LaunchParams` device pointers (`SDK/cuda/whitted.h:89-107`) plus the
per-hitgroup geometry/material views the SBT records carry
(`SDK/sutil/Scene.cpp` createSBT). Because it is a pytree, the whole scene
donates/shards/jits as a unit; "updating the SBT" (dynamic materials,
`SDK/optixDynamicMaterials/`) is a functional record update.
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from ..core import pytree

from ..accel.bruteforce import BRUTE_FORCE_MAX_TRIS
from ..accel.geometry import TriangleGeometry, build_triangle_geometry
from ..accel.lbvh import LBVH, build_lbvh
from ..accel.motion import MotionTriangles
from ..accel.primitives import CustomPrims
from ..accel.tlas import InstanceTable
from ..accel.volume import DensityGrid
from ..shade.lights import LightTable, ParallelogramLight
from ..shade.materials import MaterialTable, make_material_table


@pytree.dataclass
class DeviceScene:
    geom: TriangleGeometry
    tri_mat: jnp.ndarray                 # [M] int32 material id per triangle
    prims: CustomPrims                   # analytic custom primitives
    materials: MaterialTable
    lights: LightTable                   # point/ambient/directional/volumetric
    area_light: ParallelogramLight       # NEE target (emission=0 disables)
    miss_color: jnp.ndarray              # [3] constant background
    textures: jnp.ndarray                # [T, TH, TW, 4] f32 mip atlas
    tex_size: jnp.ndarray                # [T, 2] i32 level-0 (h, w)
    tex_mip: jnp.ndarray                 # [T, L, 4] i32 (y, x, h, w) / level
    bvh: LBVH                            # threaded BVH (empty → brute force)
    # Two-level structure: when non-empty, `geom` is the OBJECT-space
    # concatenation of the instanced meshes and traversal goes through the
    # IAS path (accel/tlas.py) — per-frame instance matrix updates are
    # functional replaces, no geometry rebuild (`Scene.cpp:1134-1213`).
    instances: InstanceTable = pytree.field(
        default_factory=InstanceTable.empty)
    # Participating medium composited into the standard bounce loop
    # (`optixVolumeViewer/volume.cu:284-366`): segment transmittance,
    # single scattering toward the area light, attenuated NEE shadows.
    volume: DensityGrid = pytree.field(default_factory=DensityGrid.empty)
    volume_params: jnp.ndarray = pytree.field(
        default_factory=lambda: jnp.zeros((2,), jnp.float32))  # sigma_t, alb
    # 2-key motion triangles traced with per-path shutter times through the
    # standard path (`optixSimpleMotionBlur` motion GAS).
    motion_geom: MotionTriangles = pytree.field(
        default_factory=MotionTriangles.empty)
    motion_tri_mat: jnp.ndarray = pytree.field(
        default_factory=lambda: jnp.zeros((0,), jnp.int32))
    # Per-material 16-channel texture bundles (base/normal/emissive/mr in
    # channels): ONE sliced gather fetches a material's whole texture set
    # (pack_bundles; shade/texture.py sample_bundle).
    bundles: jnp.ndarray = pytree.field(
        default_factory=lambda: jnp.zeros((0, 1, 1, 16), jnp.float32))
    bundle_mip: jnp.ndarray = pytree.field(
        default_factory=lambda: jnp.zeros((0, 1, 4), jnp.int32))
    # Quad-row form of the bundle atlas: one [128] row per (bundle, level,
    # texel) holding the full 2x2x16 bilinear footprint, so a bundle fetch
    # is ONE [N, 128] row gather per mip level (pack_bundles).
    bundle_quads: jnp.ndarray = pytree.field(
        default_factory=lambda: jnp.zeros((0, 128), jnp.float32))
    bundle_quad_base: jnp.ndarray = pytree.field(
        default_factory=lambda: jnp.zeros((0, 1), jnp.int32))
    # --- Opacity micromaps (`optixOpacityMicromapArrayBuild`,
    # `optix_host.h:731`; consumed by the occlusion path the way the
    # driver's traversal skips anyhit programs for certain micro-tris,
    # `optixOpacityMicromap.cpp:29-30`) ---
    # Per-micro-triangle 4-state classification [M, 4^level] and the
    # per-triangle summary [M] (accel/micromap.py); empty when the scene
    # has no cutout materials or micromaps were disabled.
    omm_micro: jnp.ndarray = pytree.field(
        default_factory=lambda: jnp.zeros((0, 1), jnp.uint8))
    omm_summary: jnp.ndarray = pytree.field(
        default_factory=lambda: jnp.zeros((0,), jnp.uint8))
    # Occlusion-ray geometry split derived from the summaries: triangles
    # certain to occlude (summary OPAQUE + every non-cutout triangle) get
    # a first-hit-exit any-hit query; only summary-UNKNOWN triangles walk
    # the anyhit re-entry loop; summary-TRANSPARENT ones appear in
    # neither (they never block light).
    omm_solid_geom: "TriangleGeometry" = pytree.field(
        default_factory=TriangleGeometry.empty)
    omm_unknown_geom: "TriangleGeometry" = pytree.field(
        default_factory=TriangleGeometry.empty)
    omm_unknown_ids: jnp.ndarray = pytree.field(
        default_factory=lambda: jnp.zeros((0,), jnp.int32))
    # Threaded BVH over the certain-solid split, so LARGE cutout meshes
    # answer the one-shot occlusion query by traversal instead of brute
    # force (the reference applies micromaps on any GAS,
    # `optixOpacityMicromap.cpp:29-30`).
    omm_solid_bvh: LBVH = pytree.field(default_factory=LBVH.empty)
    omm_level: int = pytree.field(pytree_node=False, default=0)
    # Static feature flags (not traced): e.g. "cutouts" enables alpha-mask
    # pass-through in the integrators. Determined at scene-build time.
    features: tuple = pytree.field(pytree_node=False, default=())

    @property
    def num_triangles(self):
        return self.geom.num_triangles

    @property
    def has_cutouts(self):
        return "cutouts" in self.features

    @property
    def has_omm(self):
        return self.omm_summary.shape[0] > 0

    @property
    def omm_all_certain(self):
        """Static: every micro-triangle in the scene is certain (no UNKNOWN
        summaries), so micromap states fully determine pass-through and the
        radiance loop can skip mask evaluation entirely."""
        return self.has_omm and self.omm_unknown_ids.shape[0] == 0

    @property
    def has_pbr(self):
        return "pbr" in self.features

    @property
    def has_bvh(self):
        return self.bvh.num_nodes > 0

    @property
    def has_instances(self):
        return self.instances.num > 0

    @property
    def has_volume(self):
        return "volume" in self.features

    @property
    def has_motion(self):
        return self.motion_geom.num_triangles > 0

    @property
    def has_textures(self):
        return self.textures.shape[0] > 0


def _downsample2(img):
    """2x box filter with edge replication on odd dimensions."""
    import numpy as np
    h, w = img.shape[:2]
    if h > 1 and h % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
    if w > 1 and w % 2:
        img = np.concatenate([img, img[:, -1:]], axis=1)
    h2 = max(1, h // 2)
    w2 = max(1, w // 2)
    if h == 1:
        return 0.5 * (img[:, 0::2][:, :w2] + img[:, 1::2][:, :w2])
    if w == 1:
        return 0.5 * (img[0::2][:h2] + img[1::2][:h2])
    return 0.25 * (img[0::2, 0::2][:h2, :w2] + img[1::2, 0::2][:h2, :w2]
                   + img[0::2, 1::2][:h2, :w2] + img[1::2, 1::2][:h2, :w2])


def pack_textures(images):
    """List of [H, W, 3/4] uint8/float images → mip atlas + tables.

    The `cudaMallocArray`/texture-object table of `Scene.cpp:604` becomes
    one dense [T, H', W', 4] f32 atlas: level 0 at (0, 0); levels >= 1
    box-filtered and stacked in a right-hand strip (the classic 1.5x-width
    mip layout). Returns (textures, tex_size, tex_mip) where tex_size is
    the level-0 (h, w) per texture and tex_mip [T, L, 4] i32 holds each
    level's (y, x, h, w) atlas placement (h = 0 beyond a texture's chain).
    """
    import numpy as np
    if not images:
        return (jnp.zeros((0, 1, 1, 4), jnp.float32),
                jnp.zeros((0, 2), jnp.int32),
                jnp.zeros((0, 1, 4), jnp.int32))

    chains = []
    for im in images:
        im = np.asarray(im)
        if im.dtype == np.uint8:
            im = im.astype(np.float32) / 255.0
        if im.ndim == 2:
            im = im[..., None].repeat(3, axis=-1)
        if im.shape[-1] == 3:
            im = np.concatenate([im, np.ones_like(im[..., :1])], axis=-1)
        chain = [im.astype(np.float32)]
        while max(chain[-1].shape[0], chain[-1].shape[1]) > 1:
            chain.append(_downsample2(chain[-1]))
        chains.append(chain)

    n_levels = max(len(c) for c in chains)
    max_h = max(c[0].shape[0] for c in chains)
    max_w = max(c[0].shape[1] for c in chains)
    strip_w = max(max(lv.shape[1] for lv in c[1:]) if len(c) > 1 else 0
                  for c in chains)
    strip_h = max(sum(lv.shape[0] for lv in c[1:]) for c in chains)
    atlas_h = max(max_h, strip_h)
    atlas_w = max_w + strip_w

    out = np.zeros((len(images), atlas_h, atlas_w, 4), np.float32)
    sizes = np.zeros((len(images), 2), np.int32)
    mips = np.zeros((len(images), n_levels, 4), np.int32)
    for i, chain in enumerate(chains):
        h0, w0 = chain[0].shape[:2]
        out[i, :h0, :w0] = chain[0]
        sizes[i] = (h0, w0)
        mips[i, 0] = (0, 0, h0, w0)
        y = 0
        for li, lv in enumerate(chain[1:], start=1):
            hl, wl = lv.shape[:2]
            out[i, y:y + hl, max_w:max_w + wl] = lv
            mips[i, li] = (y, max_w, hl, wl)
            y += hl
    return jnp.asarray(out), jnp.asarray(sizes), jnp.asarray(mips)


def _resize_bilinear_np(img, h, w):
    import numpy as np
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img
    y = (np.arange(h) + 0.5) * sh / h - 0.5
    x = (np.arange(w) + 0.5) * sw / w - 0.5
    y0 = np.clip(np.floor(y).astype(int), 0, sh - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, sw - 1)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    fy = np.clip(y - y0, 0, 1)[:, None, None]
    fx = np.clip(x - x0, 0, 1)[None, :, None]
    a = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    b = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return a * (1 - fy) + b * fy


def pack_bundles(images, materials):
    """Material texture BUNDLES: one 16-channel image per material that
    references any texture, all its maps resampled to a common resolution
    and stacked in channels — base RGBA(0:4), normal RGB(4:7), emissive
    RGB(7:10), roughness(10, mr map G), metallic(11, mr map B). The
    engine then fetches a material's entire texture set with one
    (2,2,16)-slice gather per mip level (shade/texture.py sample_bundle)
    instead of 4 maps x 4 taps of scalar-slice gathers.

    Each mip level is stored with one extra wrapped row/col (border) so
    the 2x2 slice never crosses the wrap seam.

    Returns (bundles [B, H', W', 16] f32, bundle_mip [B, L, 4] i32,
    mat_bundle [K] i32 (-1 = untextured), bundle_quads [R, 128] f32,
    bundle_quad_base [B, L] i32).
    """
    import numpy as np
    imgs = []
    for im in images:
        im = np.asarray(im)
        if im.dtype == np.uint8:
            im = im.astype(np.float32) / 255.0
        if im.ndim == 2:
            im = im[..., None].repeat(3, axis=-1)
        if im.shape[-1] == 3:
            im = np.concatenate([im, np.ones_like(im[..., :1])], axis=-1)
        imgs.append(im.astype(np.float32))

    def mat_tex_ids(m):
        g = (lambda k: int(m.get(k, -1))) if isinstance(m, dict) else (
            lambda k: int(getattr(m, k, -1)))
        return (g("base_tex"), g("normal_tex"), g("mr_tex"),
                g("emissive_tex"))

    mat_bundle = np.full(len(materials), -1, np.int32)
    keys = {}
    bundles = []
    for k, m in enumerate(materials):
        ids = mat_tex_ids(m)
        if all(i < 0 for i in ids):
            continue
        if ids in keys:
            mat_bundle[k] = keys[ids]
            continue
        h = max(imgs[i].shape[0] for i in ids if i >= 0)
        w = max(imgs[i].shape[1] for i in ids if i >= 0)
        b = np.zeros((h, w, 16), np.float32)
        b[..., 0:4] = (1.0, 1.0, 1.0, 1.0)
        b[..., 4:7] = (0.5, 0.5, 1.0)
        b[..., 7:12] = 1.0
        bi, ni, mi, ei = ids
        if bi >= 0:
            b[..., 0:4] = _resize_bilinear_np(imgs[bi], h, w)[..., 0:4]
        if ni >= 0:
            b[..., 4:7] = _resize_bilinear_np(imgs[ni], h, w)[..., 0:3]
        if ei >= 0:
            b[..., 7:10] = _resize_bilinear_np(imgs[ei], h, w)[..., 0:3]
        if mi >= 0:
            mr = _resize_bilinear_np(imgs[mi], h, w)
            b[..., 10] = mr[..., 1]         # roughness (G)
            b[..., 11] = mr[..., 2]         # metallic (B)
        keys[ids] = len(bundles)
        mat_bundle[k] = len(bundles)
        bundles.append(b)

    if not bundles:
        return (jnp.zeros((0, 1, 1, 16), jnp.float32),
                jnp.zeros((0, 1, 4), jnp.int32),
                jnp.asarray(mat_bundle),
                jnp.zeros((0, 128), jnp.float32),
                jnp.zeros((0, 1), jnp.int32))

    chains = []
    for b in bundles:
        chain = [b]
        while max(chain[-1].shape[0], chain[-1].shape[1]) > 1:
            chain.append(_downsample2(chain[-1]))
        chains.append(chain)

    def bordered(lv):
        # +1 wrapped row/col on the high side
        lv = np.concatenate([lv, lv[:1]], axis=0)
        return np.concatenate([lv, lv[:, :1]], axis=1)

    n_levels = max(len(c) for c in chains)
    max_h = max(c[0].shape[0] for c in chains) + 1
    max_w = max(c[0].shape[1] for c in chains) + 1
    strip_w = max((max(lv.shape[1] + 1 for lv in c[1:]) if len(c) > 1
                   else 0) for c in chains)
    strip_h = max(sum(lv.shape[0] + 1 for lv in c[1:]) for c in chains)
    atlas_h = max(max_h, strip_h)
    atlas_w = max_w + strip_w
    out = np.zeros((len(bundles), atlas_h, atlas_w, 16), np.float32)
    mips = np.zeros((len(bundles), n_levels, 4), np.int32)
    for i, chain in enumerate(chains):
        h0, w0 = chain[0].shape[:2]
        out[i, :h0 + 1, :w0 + 1] = bordered(chain[0])
        mips[i, 0] = (0, 0, h0, w0)
        y = 0
        for li, lv in enumerate(chain[1:], start=1):
            hl, wl = lv.shape[:2]
            out[i, y:y + hl + 1, max_w:max_w + wl + 1] = bordered(lv)
            mips[i, li] = (y, max_w, hl, wl)
            y += hl + 1

    # Quad rows: every (bundle, level, texel) gets one 128-lane row holding
    # its full 2x2 bilinear footprint (2x2x16 channels, zero-padded to
    # 128). A bilinear bundle fetch is then ONE [N, 128] row gather instead
    # of a (2,2,16)-slice gather; memory trades 8x for gather count.
    quad_rows = []
    quad_base = np.zeros((len(bundles), n_levels), np.int32)
    r = 0
    for i, chain in enumerate(chains):
        for li in range(n_levels):
            yo, xo, hl, wl = mips[i, li]
            quad_base[i, li] = r
            if hl == 0:
                continue
            win = out[i, yo:yo + hl + 1, xo:xo + wl + 1]   # bordered level
            q = np.zeros((hl * wl, 128), np.float32)
            for dy in range(2):
                for dx in range(2):
                    q[:, (dy * 2 + dx) * 16:(dy * 2 + dx + 1) * 16] = \
                        win[dy:dy + hl, dx:dx + wl].reshape(hl * wl, 16)
            quad_rows.append(q)
            r += hl * wl
    quads = (np.concatenate(quad_rows, axis=0) if quad_rows
             else np.zeros((0, 128), np.float32))
    return (jnp.asarray(out), jnp.asarray(mips), jnp.asarray(mat_bundle),
            jnp.asarray(quads), jnp.asarray(quad_base))


def _build_scene_omm(materials, tri_mat, corner_uv, textures, level):
    """Opacity-micromap classification for every cutout-material triangle.

    Role of `optixOpacityMicromapArrayBuild` + the per-triangle usage
    counts of the build input (`optix_host.h:731`): each triangle whose
    material carries an alpha mask gets 4^level micro-triangle states
    sampled from that material's mask function (checker / circle /
    base-texture alpha, `optixCutouts.cu:295,337`), conservatively —
    OPAQUE/TRANSPARENT only when certain. Non-cutout triangles are
    summary-OPAQUE (they always occlude).

    Returns (micro_states [M, 4^level] uint8, summary [M] uint8).
    """
    import numpy as np
    from ..accel import micromap as mm
    from ..shade.materials import (ALPHA_MASK, CUT_CHECKER, CUT_CIRCLE,
                                   CUT_TEXTURE)

    m_tris = int(tri_mat.shape[0])
    states = np.full((m_tris, 4 ** level), mm.OPAQUE, np.uint8)
    summary = np.full((m_tris,), mm.OPAQUE, np.uint8)

    def tex_alpha_mask(tex_id, cutoff):
        img = np.asarray(textures[tex_id])
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        alpha = (img[..., 3] if img.ndim == 3 and img.shape[-1] == 4
                 else np.ones(img.shape[:2], np.float32))

        def fn(uv):
            h, w = alpha.shape
            x = np.floor((uv[:, 0] % 1.0) * w).astype(np.int64) % w
            y = np.floor((uv[:, 1] % 1.0) * h).astype(np.int64) % h
            return alpha[y, x] < cutoff
        return fn

    for k, mdef in enumerate(materials):
        if not isinstance(mdef, dict):
            continue
        if mdef.get("alpha_mode", 0) != ALPHA_MASK:
            continue
        kind = mdef.get("cutout", 0)
        scale = float(mdef.get("checker_scale", 1.0))
        if kind == CUT_CHECKER:
            fn = mm.checker_mask(scale)
        elif kind == CUT_CIRCLE:
            fn = mm.circle_mask(scale)
        elif (kind == CUT_TEXTURE and len(textures)
                and int(mdef.get("base_tex", -1)) >= 0):
            fn = tex_alpha_mask(int(mdef["base_tex"]),
                                float(mdef.get("alpha_cutoff", 0.5)))
        else:
            continue        # alpha-masked but no mask function: solid
        sel = np.nonzero(tri_mat == k)[0]
        if not len(sel):
            continue
        st, su = mm.build_opacity_micromap(corner_uv[sel], fn, level=level)
        states[sel] = st
        summary[sel] = su
    return states, summary


def _build_bvh_if_large(geom: TriangleGeometry) -> Optional[LBVH]:
    """Threaded BVH for a mesh past the brute-force limit, else None.
    Prefers the native host-side SAH builder (better trees for static
    scenes) and falls back to the on-device LBVH."""
    if geom.num_triangles <= BRUTE_FORCE_MAX_TRIS:
        return None
    from ..accel import native
    bvh = native.build_bvh_sah(geom)
    return bvh if bvh is not None else build_lbvh(geom)


def make_device_scene(vertices, indices, tri_mat, materials,
                      area_light: Optional[ParallelogramLight] = None,
                      lights=(), prims: Optional[CustomPrims] = None,
                      miss_color=(0.0, 0.0, 0.0), normals=None, uvs=None,
                      textures=(), bvh: Optional[LBVH] = None,
                      instances: Optional[InstanceTable] = None,
                      volume: Optional[DensityGrid] = None,
                      volume_sigma: float = 8.0, volume_albedo: float = 0.9,
                      motion=None, opacity_micromaps: bool = True,
                      omm_level: int = 3) -> DeviceScene:
    """Build the device scene.

    Traversal follows the triangle count: a mesh over BRUTE_FORCE_MAX_TRIS
    triangles gets a threaded BVH (native SAH build, device LBVH when the
    native builder is unavailable); smaller meshes are brute-forced.
    bvh: a BVH already built for this geometry (skips the build).
    Instanced scenes traverse through the IAS path (accel/tlas.py).
    motion: optional dict(verts0, verts1, indices, tri_mat=0) — 2-key
    moving triangles traced with per-path times through the main engine."""
    if area_light is None:
        area_light = ParallelogramLight.make(
            (0, 0, 0), (1, 0, 0), (0, 0, 1), (0.0, 0.0, 0.0))
    tex, tex_size, tex_mip = pack_textures(list(textures))
    mat_table = (materials if isinstance(materials, MaterialTable)
                 else make_material_table(materials))
    if textures is not None and len(list(textures)) and isinstance(
            materials, (list, tuple)):
        (bundles, bundle_mip, mat_bundle,
         bundle_quads, bundle_quad_base) = pack_bundles(
            list(textures), materials)
        mat_table = mat_table.replace(bundle=jnp.asarray(mat_bundle))
    else:
        bundles = jnp.zeros((0, 1, 1, 16), jnp.float32)
        bundle_mip = jnp.zeros((0, 1, 4), jnp.int32)
        bundle_quads = jnp.zeros((0, 128), jnp.float32)
        bundle_quad_base = jnp.zeros((0, 1), jnp.int32)
    geom = build_triangle_geometry(vertices, indices, normals=normals,
                                   uvs=uvs)
    tri_mat_arr = jnp.asarray(tri_mat, jnp.int32)
    if bvh is None and instances is None:
        bvh = _build_bvh_if_large(geom)
    features = []
    if isinstance(materials, (list, tuple)):
        if any(m.get("cutout", 0) or m.get("alpha_mode", 0) == 1
               for m in materials):
            features.append("cutouts")
        from ..shade.materials import GLASS, PBR
        if any(m.get("kind", 0) == GLASS for m in materials):
            features.append("glass")
        def _is_mirror(m):
            return (m.get("kind", 0) == PBR and m.get("metallic", 0.0) > 0.99
                    and m.get("roughness", 0.5) <= 0.05)
        if any(_is_mirror(m) for m in materials):
            features.append("mirror")
        if any(m.get("kind", 0) == PBR and not _is_mirror(m)
               for m in materials):
            features.append("pbr")   # rough metallic-roughness GGX lanes
    else:
        # pre-built MaterialTable: assume every material family is possible
        features += ["glass", "mirror", "pbr"]
    if volume is not None:
        features.append("volume")
    # --- opacity micromaps for cutout scenes (occlusion fast path) ---
    omm = {}

    def _aux_cutout_free():
        # The OMM occlusion path answers prim/motion occlusion with plain
        # first-hit any-hit queries; that is only exact when no custom-prim
        # or motion-triangle material is an alpha-mask cutout.
        import numpy as np

        def mat_is_cut(i):
            m = materials[int(i)]
            return bool(m.get("cutout", 0)) or m.get("alpha_mode", 0) == 1

        if prims is not None and prims.num:
            if any(mat_is_cut(i) for i in np.asarray(prims.mat_id)):
                return False
        if motion is not None:
            mt = motion.get("tri_mat", 0)
            ids = (np.asarray(mt).ravel() if hasattr(mt, "__len__")
                   else np.asarray([mt]))
            if any(mat_is_cut(i) for i in ids):
                return False
        return True

    if (opacity_micromaps and "cutouts" in features
            and isinstance(materials, (list, tuple)) and instances is None
            and _aux_cutout_free()):
        import numpy as np
        from ..accel.micromap import OPAQUE, TRANSPARENT
        tm_np = np.asarray(tri_mat)
        cu_np = np.asarray(geom.corner_uv)
        idx_np = np.asarray(indices, np.int32)
        states, summary = _build_scene_omm(materials, tm_np, cu_np,
                                           list(textures or ()), omm_level)
        solid = summary == OPAQUE
        unknown = (summary != OPAQUE) & (summary != TRANSPARENT)
        unknown_ids = np.nonzero(unknown)[0].astype(np.int32)
        solid_geom_ = build_triangle_geometry(
            vertices, idx_np[solid], normals=normals, uvs=uvs)
        solid_bvh = _build_bvh_if_large(solid_geom_)
        omm = dict(
            omm_micro=jnp.asarray(states),
            omm_summary=jnp.asarray(summary),
            omm_level=omm_level,
            omm_solid_geom=solid_geom_,
            omm_unknown_geom=build_triangle_geometry(
                vertices, idx_np[unknown], normals=normals, uvs=uvs),
            omm_unknown_ids=jnp.asarray(unknown_ids),
            **({"omm_solid_bvh": solid_bvh}
               if solid_bvh is not None else {}),
        )
    mgeom = MotionTriangles.empty()
    mmat = jnp.zeros((0,), jnp.int32)
    if motion is not None:
        mgeom = MotionTriangles.make(motion["verts0"], motion["verts1"],
                                     motion["indices"])
        mt = motion.get("tri_mat", 0)
        mmat = (jnp.asarray(mt, jnp.int32) if hasattr(mt, "__len__")
                else jnp.full((mgeom.num_triangles,), int(mt), jnp.int32))
    return DeviceScene(
        features=tuple(features),
        volume=volume if volume is not None else DensityGrid.empty(),
        volume_params=jnp.asarray([volume_sigma, volume_albedo],
                                  jnp.float32),
        motion_geom=mgeom,
        motion_tri_mat=mmat,
        geom=geom,
        bvh=bvh if bvh is not None else LBVH.empty(),
        instances=(instances if instances is not None
                   else InstanceTable.empty()),
        tri_mat=tri_mat_arr,
        prims=prims if prims is not None else CustomPrims.empty(),
        materials=mat_table,
        lights=LightTable.make(list(lights)),
        area_light=area_light,
        miss_color=jnp.asarray(miss_color, jnp.float32),
        textures=tex,
        tex_size=tex_size,
        tex_mip=tex_mip,
        bundles=bundles,
        bundle_mip=bundle_mip,
        bundle_quads=bundle_quads,
        bundle_quad_base=bundle_quad_base,
        **omm,
    )
