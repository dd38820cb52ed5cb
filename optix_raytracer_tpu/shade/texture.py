"""Texture sampling: bilinear + trilinear-mipmap lookup into the mip atlas.

Replaces `cudaTextureObject_t` sampling in the PBR closest-hit
(`SDK/cuda/whitted.cu:160-168` sampleTexture, `MaterialData.h:62-73`). XLA
reaches no texture units, so this is four gathers + a lerp per level — SURVEY.md §7
hard part #4. Wrap addressing, linear filtering; texel centers at
half-integer uv like CUDA's normalized-coordinate linear mode. Mip level
selection uses the ray-cone footprint (cone width x per-triangle uv
density), the standard RT substitute for raster derivatives.
"""
from __future__ import annotations

import jax.numpy as jnp


def sample_bilinear(textures, tex_size, tex_id, uv):
    """textures: [T, H, W, 4]; tex_size: [T, 2]; tex_id: [...] i32 (-1 = none
    → white); uv: [..., 2]. Returns RGBA [..., 4]."""
    tid = jnp.maximum(tex_id, 0)
    hw = tex_size[tid].astype(jnp.float32)          # [..., 2] (h, w)
    h, w = hw[..., 0], hw[..., 1]

    # wrap addressing, texel centers at (i + 0.5)
    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def texel(xi, yi):
        xi = jnp.mod(xi.astype(jnp.int32), jnp.maximum(w.astype(jnp.int32), 1))
        yi = jnp.mod(yi.astype(jnp.int32), jnp.maximum(h.astype(jnp.int32), 1))
        return textures[tid, yi, xi]

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    rgba = ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)
    return jnp.where((tex_id >= 0)[..., None], rgba,
                     jnp.ones_like(rgba))


def _sample_level(textures, tex_mip, tid, uv, level):
    """Bilinear fetch from one mip level of the atlas (wrap addressing
    inside the level's (y, x, h, w) window)."""
    entry = tex_mip[tid, level].astype(jnp.float32)     # [..., 4] y x h w
    y_off, x_off = entry[..., 0], entry[..., 1]
    h = jnp.maximum(entry[..., 2], 1.0)
    w = jnp.maximum(entry[..., 3], 1.0)

    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def texel(xi, yi):
        xi = jnp.mod(xi, w).astype(jnp.int32) + x_off.astype(jnp.int32)
        yi = jnp.mod(yi, h).astype(jnp.int32) + y_off.astype(jnp.int32)
        return textures[tid, yi, xi]

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def sample_bundle(bundles, bundle_mip, bundle_id, uv, texel_scale=None,
                  quads=None, quad_base=None):
    """Trilinear fetch from the 16-channel MATERIAL BUNDLE atlas.

    One material = one bundle image carrying base RGBA(0:4),
    normal RGB(4:7), emissive RGB(7:10), roughness(10), metallic(11) in
    its channels, mip chain with a +1 wrapped border per level. The whole
    material's texture set is fetched with ONE (2,2,16)-slice gather per
    mip level instead of the 4 maps x 4 taps of the naive path.

    bundles: [B, H', W', 16]; bundle_mip: [B, L, 4] i32 (y x h w; h/w are
    LOGICAL level sizes, each level stored with one extra wrapped
    row/col). bundle_id -1 → neutral (white base, flat normal, unit
    scalars). Returns [..., 16].

    quads/quad_base (device_scene.pack_bundles): the quad-row atlas —
    one [128] row per (bundle, level, texel) carrying the whole 2x2x16
    bilinear footprint. When given, each mip fetch is ONE [N, 128] row
    gather instead of the (2,2,16)-slice form.
    """
    import jax

    neutral = jnp.asarray(
        [1, 1, 1, 1, 0.5, 0.5, 1.0, 1, 1, 1, 1, 1, 0, 0, 0, 0],
        jnp.float32)
    if bundles.shape[0] == 0:
        # scene has a texture atlas but no material references any map
        return jnp.broadcast_to(neutral, uv.shape[:-1] + (16,))
    bid = jnp.maximum(bundle_id, 0)
    n_b = bundle_mip.shape[0]
    n_levels = bundle_mip.shape[1]

    def tiny_fetch(idx, plane, k):
        """Per-lane row fetch from a tiny [k, C] table as a one-hot
        matmul (sample_bundle needs ~7 such lookups: mip entries, chain
        lengths, quad bases). Exact at HIGHEST precision: one 1.0 x v
        term per row. Past 128 rows the [N, k] one-hot moves more memory
        than the gather it replaces (materials.gather uses the same
        cutoff), so fall back."""
        if k > 128:
            return plane[idx]
        sh = idx.shape
        onehot = (idx.reshape(-1)[:, None]
                  == jnp.arange(k)[None, :]).astype(jnp.float32)
        vals = jax.lax.dot(onehot, plane.astype(jnp.float32),
                           precision=jax.lax.Precision.HIGHEST)
        return vals.reshape(sh + (plane.shape[1],))

    # Per-bundle constants via ONE one-hot fetch: [dim0, chain_len]
    chain_b = jnp.sum((bundle_mip[:, :, 2] > 0), axis=1)      # [B]
    dim_b = jnp.maximum(bundle_mip[:, 0, 2], bundle_mip[:, 0, 3])
    bconst = tiny_fetch(bid, jnp.stack(
        [dim_b, chain_b], axis=1), n_b)                       # [..., 2]
    dim0, chain_len = bconst[..., 0], bconst[..., 1]
    if texel_scale is None or n_levels == 1:
        lod = jnp.zeros(uv.shape[:-1], jnp.float32)
    else:
        lod = jnp.log2(jnp.maximum(texel_scale * dim0, 1.0))
    lod = jnp.clip(lod, 0.0, chain_len - 1.0)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, (chain_len - 1.0).astype(jnp.int32))
    f = (lod - l0.astype(jnp.float32))[..., None]

    use_quads = (quads is not None and quad_base is not None
                 and quads.shape[0] > 0)
    # Flattened (bundle, level) constant plane for the per-level one-hot
    # fetch: y x h w [+ quad row base].
    cols = [bundle_mip.reshape(n_b * n_levels, 4)]
    if use_quads:
        cols.append(quad_base.reshape(n_b * n_levels, 1))
    lv_plane = jnp.concatenate(cols, axis=1)

    def level(lv):
        entry = tiny_fetch(bid * n_levels + lv, lv_plane,
                           n_b * n_levels)                # [..., 4 or 5]
        y_off, x_off = entry[..., 0], entry[..., 1]
        h = jnp.maximum(entry[..., 2], 1.0)
        w = jnp.maximum(entry[..., 3], 1.0)
        u = uv[..., 0] - jnp.floor(uv[..., 0])
        v = uv[..., 1] - jnp.floor(uv[..., 1])
        x = u * w - 0.5
        y = v * h - 0.5
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        # wrap the BASE corner; the +1 border row/col covers the far taps
        xi_l = jnp.mod(x0, w).astype(jnp.int32)
        yi_l = jnp.mod(y0, h).astype(jnp.int32)
        if use_quads:
            row = (entry[..., 4].astype(jnp.int32)
                   + yi_l * w.astype(jnp.int32) + xi_l)
            q = quads[row]                           # [..., 128] one gather
            c00 = q[..., 0:16]
            c01 = q[..., 16:32]
            c10 = q[..., 32:48]
            c11 = q[..., 48:64]
        else:
            xi = xi_l + x_off.astype(jnp.int32)
            yi = yi_l + y_off.astype(jnp.int32)
            idx = jnp.stack([bid.reshape(-1), yi.reshape(-1),
                             xi.reshape(-1)], axis=1)
            dn = jax.lax.GatherDimensionNumbers(
                offset_dims=(1, 2, 3), collapsed_slice_dims=(0,),
                start_index_map=(0, 1, 2))
            quad = jax.lax.gather(bundles, idx, dn,
                                  slice_sizes=(1, 2, 2, bundles.shape[-1]),
                                  mode="clip")
            quad = quad.reshape(uv.shape[:-1] + quad.shape[1:])
            c00 = quad[..., 0, 0, :]
            c01 = quad[..., 0, 1, :]
            c10 = quad[..., 1, 0, :]
            c11 = quad[..., 1, 1, :]
        return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
                + (c10 * (1 - fx) + c11 * fx) * fy)

    out = (1.0 - f) * level(l0) + f * level(l1)
    return jnp.where((bundle_id >= 0)[..., None], out, neutral)


def sample_trilinear(textures, tex_mip, tex_id, uv, texel_scale=None):
    """Trilinear mipmapped fetch → RGBA [..., 4] (tex_id -1 → white).

    texel_scale: per-sample world-space footprint x uv-density (ray-cone
    width x triangle uv density). lod = log2(footprint in level-0 texels);
    None or 0 degrades to level-0 bilinear.
    """
    tid = jnp.maximum(tex_id, 0)
    n_levels = tex_mip.shape[1]
    if texel_scale is None or n_levels == 1:
        lod = jnp.zeros(uv.shape[:-1], jnp.float32)
    else:
        dim0 = jnp.maximum(tex_mip[tid, 0, 2],
                           tex_mip[tid, 0, 3]).astype(jnp.float32)
        lod = jnp.log2(jnp.maximum(texel_scale * dim0, 1.0))
    # clamp to each texture's own chain length (h = 0 marks past-the-end)
    chain_len = jnp.sum((tex_mip[tid, :, 2] > 0).astype(jnp.float32),
                        axis=-1)
    lod = jnp.clip(lod, 0.0, chain_len - 1.0)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, (chain_len - 1.0).astype(jnp.int32))
    f = (lod - l0.astype(jnp.float32))[..., None]
    rgba = ((1.0 - f) * _sample_level(textures, tex_mip, tid, uv, l0)
            + f * _sample_level(textures, tex_mip, tid, uv, l1))
    return jnp.where((tex_id >= 0)[..., None], rgba, jnp.ones_like(rgba))


# --------------------------------------------------------------------------
# Texture footprint queries (optixTexFootprint2D{,Lod,Grad} parity,
# `optix_device.h:1551-1591`): which texel region a filtered fetch would
# touch, and whether it spans one or two mip levels. The reference uses
# these for demand-loaded sparse textures; here they serve the same role
# for host-side tile streaming decisions (and they make mip selection
# inspectable in tests). All vectorized over a [..., 2] uv batch.
# --------------------------------------------------------------------------

def _footprint_at_level(tex_mip, tid, uv, level, du=None, dv=None):
    """Texel rect of a bilinear fetch at `level`: lo (x, y) and size,
    wrap-addressed, grown by the uv-gradient extent when given."""
    entry = tex_mip[tid, level].astype(jnp.float32)        # [..., 4] y x h w
    h, w = entry[..., 2], entry[..., 3]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    ex = jnp.zeros_like(fx) if du is None else 0.5 * jnp.abs(du) * w
    ey = jnp.zeros_like(fy) if dv is None else 0.5 * jnp.abs(dv) * h
    x0 = jnp.floor(fx - ex)
    y0 = jnp.floor(fy - ey)
    x1 = jnp.floor(fx + ex) + 1.0
    y1 = jnp.floor(fy + ey) + 1.0
    return {
        "lo": jnp.stack([jnp.mod(x0, w), jnp.mod(y0, h)], -1
                        ).astype(jnp.int32),
        "size": jnp.stack([jnp.minimum(x1 - x0 + 1.0, w),
                           jnp.minimum(y1 - y0 + 1.0, h)], -1
                          ).astype(jnp.int32),
        "level_dim": jnp.stack([w, h], -1).astype(jnp.int32),
    }


def tex_footprint_2d_lod(tex_mip, tex_id, uv, lod, coarse: bool = False):
    """optixTexFootprint2DLod: footprint of a tex2DLod fetch at explicit
    `lod`. Returns dict(level, lo, size, level_dim, single_mip); `coarse`
    selects the coarser of the two levels a fractional lod spans."""
    tid = jnp.maximum(tex_id, 0)
    chain_len = jnp.sum((tex_mip[tid, :, 2] > 0).astype(jnp.float32),
                        axis=-1)
    lod = jnp.clip(jnp.asarray(lod, jnp.float32), 0.0, chain_len - 1.0)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, (chain_len - 1.0).astype(jnp.int32))
    single = (lod == l0.astype(jnp.float32)) | (l1 == l0)
    level = jnp.where(jnp.asarray(coarse) & ~single, l1, l0)
    out = _footprint_at_level(tex_mip, tid, uv, level)
    out["level"] = level
    out["single_mip"] = single
    return out


def tex_footprint_2d_grad(tex_mip, tex_id, uv, duv_dx, duv_dy,
                          coarse: bool = False):
    """optixTexFootprint2DGrad: footprint of a tex2DGrad fetch whose lod
    comes from the uv screen-space gradients ([..., 2] each) — the same
    log2(max texel extent) rule as `sample_trilinear`'s ray-cone scale."""
    tid = jnp.maximum(tex_id, 0)
    dim0 = jnp.maximum(tex_mip[tid, 0, 2],
                       tex_mip[tid, 0, 3]).astype(jnp.float32)
    ext = jnp.maximum(
        jnp.sqrt(jnp.sum(jnp.square(duv_dx), -1)),
        jnp.sqrt(jnp.sum(jnp.square(duv_dy), -1)))
    lod = jnp.log2(jnp.maximum(ext * dim0, 1.0))
    out = tex_footprint_2d_lod(tex_mip, tex_id, uv, lod, coarse=coarse)
    # grow the chosen level's rect by the anisotropic gradient extent
    scale = jnp.exp2(-out["level"].astype(jnp.float32))
    du = (jnp.abs(duv_dx[..., 0]) + jnp.abs(duv_dy[..., 0])) * scale
    dv = (jnp.abs(duv_dx[..., 1]) + jnp.abs(duv_dy[..., 1])) * scale
    grown = _footprint_at_level(tex_mip, tid, uv, out["level"], du, dv)
    grown["level"] = out["level"]
    grown["single_mip"] = out["single_mip"]
    return grown


def tex_footprint_2d(tex_mip, tex_id, uv, texel_scale=None):
    """optixTexFootprint2D: footprint with the implicit lod the sampler
    itself would choose (`sample_trilinear`'s ray-cone texel_scale)."""
    tid = jnp.maximum(tex_id, 0)
    if texel_scale is None:
        lod = jnp.zeros(uv.shape[:-1], jnp.float32)
    else:
        dim0 = jnp.maximum(tex_mip[tid, 0, 2],
                           tex_mip[tid, 0, 3]).astype(jnp.float32)
        lod = jnp.log2(jnp.maximum(texel_scale * dim0, 1.0))
    return tex_footprint_2d_lod(tex_mip, tex_id, uv, lod)
