"""Edge-avoiding à-trous wavelet denoiser with albedo/normal guide layers.

The role of the OptiX AI denoiser (`optixDenoiserCreate/Setup/Invoke`,
`include/optix_host.h:814-1028`): reconstruct a clean image from a noisy
Monte-Carlo render using auxiliary guide layers (albedo, normal — the same
guide layers the reference consumes, `OptixDenoiserGuideLayer`). Instead of a
pretrained CNN (whose weights we cannot ship), this is an SVGF-style
edge-avoiding à-trous filter: hierarchical 5×5 B3-spline passes with
bilateral weights on luminance/normal/albedo, plus albedo demodulation so
texture detail survives. Pure jnp stencil ops (edge-replicated shifts) →
fuses into a handful of elementwise passes. Temporal mode warps the previous output by a
flow field and blends (the OPTIX_DENOISER_MODEL_KIND_TEMPORAL role).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# 1-D B3-spline taps; the 2-D kernel is the outer product.
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_OFFSETS = (-2, -1, 0, 1, 2)


def _luminance(rgb):
    return (rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152
            + rgb[..., 2] * 0.0722)


def _shift2d(img, dy, dx):
    """Shifted view with edge replication (matches jnp.roll in the interior).

    jnp.roll would wrap taps around image borders — with iterations=5 the
    footprint reaches 64 px, so opposite edges would bleed into each other
    and denoise_tiled would wrap inside each tile (visible seams). The
    reference denoiser clamps at borders; so do we.
    """
    h, w = img.shape[0], img.shape[1]
    ys = jnp.clip(jnp.arange(h) - dy, 0, h - 1)
    xs = jnp.clip(jnp.arange(w) - dx, 0, w - 1)
    return img[ys][:, xs]


def _box3(x):
    acc = jnp.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + _shift2d(x, dy, dx)
    return acc / 9.0


@functools.partial(jax.jit, static_argnames=("iterations",))
def denoise(beauty, albedo=None, normal=None, iterations: int = 5,
            sigma_color: float = 4.0, sigma_normal: float = 64.0,
            sigma_albedo: float = 8.0):
    """Denoise a linear-radiance image [H, W, 3] → [H, W, 3].

    albedo/normal: optional [H, W, 3] guide layers (same meaning as the
    reference's guide layers). More iterations → larger filter footprint
    (2^iterations pixels).

    The luminance edge-stop is SVGF-style: differences are measured in units
    of the *local luminance standard deviation* (3×3 moments, re-estimated
    per iteration), so the filter is exposure-invariant — it smooths where
    differences look like noise and stops where they exceed `sigma_color`
    local sigmas, at any HDR scale.
    """
    beauty = jnp.asarray(beauty, jnp.float32)
    has_albedo = albedo is not None
    if has_albedo:
        albedo = jnp.asarray(albedo, jnp.float32)
        # Demodulate: filter irradiance, keep texture detail intact.
        signal = beauty / jnp.maximum(albedo, 1e-3)
    else:
        signal = beauty
    if normal is not None:
        normal = jnp.asarray(normal, jnp.float32)

    out = signal
    for it in range(iterations):
        step = 1 << it
        lum0 = _luminance(out)
        mu = _box3(lum0)
        sigma = jnp.sqrt(jnp.maximum(_box3(lum0 * lum0) - mu * mu, 0.0))
        denom = sigma_color * sigma + 1e-3 + 1e-2 * jnp.abs(mu)
        acc = jnp.zeros_like(out)
        wsum = jnp.zeros(out.shape[:2] + (1,), jnp.float32)
        for iy, wy in zip(_OFFSETS, _B3):
            for ix, wx in zip(_OFFSETS, _B3):
                dy, dx = iy * step, ix * step
                tap = _shift2d(out, dy, dx)
                w = jnp.full(out.shape[:2], wy * wx, jnp.float32)
                # luminance edge-stopping in local-noise units
                dl = jnp.abs(_luminance(tap) - lum0)
                w = w * jnp.exp(-dl / denom)
                if normal is not None:
                    ndot = jnp.sum(_shift2d(normal, dy, dx) * normal, -1)
                    w = w * jnp.power(jnp.maximum(ndot, 0.0), sigma_normal)
                if has_albedo:
                    da = jnp.abs(_shift2d(albedo, dy, dx) - albedo).sum(-1)
                    w = w * jnp.exp(-da * sigma_albedo)
                acc = acc + tap * w[..., None]
                wsum = wsum + w[..., None]
        out = acc / jnp.maximum(wsum, 1e-8)

    if has_albedo:
        out = out * jnp.maximum(albedo, 1e-3)
    return out


@jax.jit
def warp_by_flow(prev_output, flow):
    """Bilinear back-warp of the previous frame: out(p) = prev(p - flow(p)),
    flow in pixels, previous→current like the reference's flow layer."""
    h, w = prev_output.shape[:2]
    yy = jnp.arange(h, dtype=jnp.float32)[:, None]
    xx = jnp.arange(w, dtype=jnp.float32)[None, :]
    src_y = yy - flow[..., 1]
    src_x = xx - flow[..., 0]
    y0 = jnp.clip(jnp.floor(src_y), 0, h - 2)
    x0 = jnp.clip(jnp.floor(src_x), 0, w - 2)
    fy = (src_y - y0)[..., None]
    fx = (src_x - x0)[..., None]
    y0i = y0.astype(jnp.int32)
    x0i = x0.astype(jnp.int32)
    p00 = prev_output[y0i, x0i]
    p10 = prev_output[y0i, x0i + 1]
    p01 = prev_output[y0i + 1, x0i]
    p11 = prev_output[y0i + 1, x0i + 1]
    return (p00 * (1 - fx) + p10 * fx) * (1 - fy) \
        + (p01 * (1 - fx) + p11 * fx) * fy


def denoise_temporal(beauty, prev_output, flow, albedo=None, normal=None,
                     iterations: int = 5, alpha: float = 0.2, core=None):
    """Temporal mode: warp the previous denoised frame by `flow` and blend
    before spatial filtering (`OPTIX_DENOISER_MODEL_KIND_TEMPORAL`,
    `optix_types.h:1609-1635`). `core` overrides the spatial filter
    (e.g. the trained KPCNN)."""
    warped = warp_by_flow(prev_output, flow)
    blended = alpha * beauty + (1.0 - alpha) * warped
    if core is not None:
        return core(blended, albedo, normal)
    return denoise(blended, albedo=albedo, normal=normal,
                   iterations=iterations)


def denoise_tiled(beauty, albedo=None, normal=None, tile: int = 256,
                  overlap: int = 32, core=None, **kw):
    """Tile-wise invocation with overlap windows for images larger than
    memory — `optixUtilDenoiserInvokeTiled` (`optix_denoiser_tiling.h:223`,
    overlap sizing `optix_host.h:857-865`). `core` overrides the spatial
    filter applied per tile."""
    import numpy as np
    h, w = beauty.shape[:2]
    out = np.zeros((h, w, 3), np.float32)
    y = 0
    while y < h:
        x = 0
        y0 = max(0, y - overlap)
        y1 = min(h, y + tile + overlap)
        while x < w:
            x0 = max(0, x - overlap)
            x1 = min(w, x + tile + overlap)
            sub = lambda img: None if img is None else img[y0:y1, x0:x1]
            if core is not None:
                den = core(beauty[y0:y1, x0:x1], sub(albedo), sub(normal))
            else:
                den = denoise(beauty[y0:y1, x0:x1], albedo=sub(albedo),
                              normal=sub(normal), **kw)
            oy = y - y0
            ox = x - x0
            ny = min(tile, h - y)
            nx = min(tile, w - x)
            out[y:y + ny, x:x + nx] = np.asarray(
                den[oy:oy + ny, ox:ox + nx])
            x += tile
        y += tile
    return out


def compute_intensity(beauty):
    """`optixDenoiserComputeIntensity` (`optix_host.h:1002`): inverse average
    log-luminance, used to pre-scale HDR inputs."""
    lum = _luminance(jnp.asarray(beauty, jnp.float32))
    avg_log = jnp.mean(jnp.log(jnp.maximum(lum, 1e-8)))
    return 1.0 / jnp.maximum(jnp.exp(avg_log), 1e-8)


def compute_average_color(beauty):
    """`optixDenoiserComputeAverageColor` (`optix_host.h:1023`)."""
    return jnp.mean(jnp.asarray(beauty, jnp.float32), axis=(0, 1))
