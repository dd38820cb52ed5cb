"""Kernel-prediction CNN denoiser — the trained-model backend.

The reference's denoiser is a pretrained neural net invoked through
`optixDenoiserCreate/Setup/Invoke` (`include/optix_host.h:829-1028`,
model kinds `optix_types.h:1609-1635`). This is the equivalent here:
a small encoder/decoder CNN that consumes the same guide layers the
reference does (noisy beauty + albedo + normal) and predicts a per-pixel
5x5 filter kernel applied to the albedo-demodulated irradiance
(kernel prediction keeps colors plausible and can't invent energy the
way direct-prediction nets can). Weights are trained in-repo by
tools/train_denoiser.py on renders from THIS framework's path tracer
(random Cornell-variant scenes, low-spp input vs high-spp target) and
shipped as an npz checkpoint.

Everything is NHWC lax.conv — XLA hands these to cuDNN on a GPU; the whole
network is a single fused jit program at inference.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

KERNEL_SIZE = 5                        # predicted filter footprint
_KK = KERNEL_SIZE * KERNEL_SIZE
_EPS = 1e-3

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "weights",
                            "kpcnn.npz")
# 2x-upscale weights: the SAME architecture trained on bilinear-upsampled
# low-res noisy input + full-res guide layers → full-res clean (the
# OPTIX_DENOISER_MODEL_KIND_UPSCALE2X role, optix_types.h:1609-1635).
UPSCALE_WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "weights",
                                    "kpcnn_up2x.npz")
# Temporal weights: 13-channel input (the 10 spatial features + 3 channels
# of flow-reprojected previous-output log-irradiance) — the
# OPTIX_DENOISER_MODEL_KIND_TEMPORAL role.
TEMPORAL_WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "weights",
                                     "kpcnn_temporal.npz")


def upsample2x_bilinear(img):
    """[..., H, W, C] → [..., 2H, 2W, C] bilinear (align-corners=False)."""
    h, w = img.shape[-3], img.shape[-2]
    y = (jnp.arange(2 * h) + 0.5) / 2.0 - 0.5
    x = (jnp.arange(2 * w) + 0.5) / 2.0 - 0.5
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 1)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)
    fy = jnp.clip(y - y0, 0.0, 1.0)[:, None, None]
    fx = jnp.clip(x - x0, 0.0, 1.0)[None, :, None]
    r0 = (jnp.take(img, y0, axis=-3) * (1 - fy)
          + jnp.take(img, y1, axis=-3) * fy)
    return (jnp.take(r0, x0, axis=-2) * (1 - fx)
            + jnp.take(r0, x1, axis=-2) * fx)

# (name, out_channels, stride) — a compact 3-scale encoder/decoder.
# Decoder levels upsample (nearest) and concat the matching skip.
_ENC = (("e0", 32), ("e1", 48), ("e2", 64))
_DEC = (("d1", 48), ("d0", 32))


def _conv(params, name, x, relu=True):
    w = params[name + "_w"]
    b = params[name + "_b"]
    y = jax.lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32) + b
    return jax.nn.relu(y) if relu else y


def _down(x):
    return jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (1, 2, 2, 1), (1, 2, 2, 1), "VALID") * 0.25


def _up(x):
    n, h, w, c = x.shape
    x = jnp.broadcast_to(x[:, :, None, :, None, :], (n, h, 2, w, 2, c))
    return x.reshape(n, h * 2, w * 2, c)


def init_params(rng, cin: int = 10, out_alpha: bool = False) -> dict:
    """He-initialized parameter pytree (dict of arrays).

    cin: input feature channels — 10 spatial (log-irradiance 3, albedo 3,
    normal 3, local variance 1), 13 for the temporal variant (+3 of
    reprojected-history log-irradiance).
    out_alpha: one extra output channel — a per-pixel PREDICTED history
    blend (sigmoid): the temporal-KPCN design where the net itself
    decides how much converged history to copy vs how much filtered
    current frame to keep (the reference's TEMPORAL kinds' stability
    mechanism). Inference detects it from the out-conv width."""
    params = {}
    keys = jax.random.split(rng, 16)
    ki = iter(keys)

    def add(name, cin, cout, k=3):
        params[name + "_w"] = (jax.random.normal(next(ki), (k, k, cin, cout))
                               * np.sqrt(2.0 / (k * k * cin))).astype(
                                   jnp.float32)
        params[name + "_b"] = jnp.zeros((cout,), jnp.float32)

    add("in0", cin, _ENC[0][1])
    prev = _ENC[0][1]
    for name, ch in _ENC:
        add(name, prev, ch)
        prev = ch
    # decoder: up(prev) concat skip
    skips = [ch for _, ch in _ENC[:-1]][::-1]            # [48, 32]
    for (name, ch), skip in zip(_DEC, skips):
        add(name, prev + skip, ch)
        prev = ch
    add("out", prev, _KK + int(out_alpha), k=3)
    return params


def apply_net(params, feats):
    """feats [N, H, W, 10|13] → per-pixel kernel logits [N, H, W, 25]
    (+1 history-blend logit when the out conv carries it)."""
    x = _conv(params, "in0", feats)
    skips = []
    for i, (name, _) in enumerate(_ENC):
        x = _conv(params, name, x)
        if i < len(_ENC) - 1:
            skips.append(x)
            x = _down(x)
    for (name, _), skip in zip(_DEC, skips[::-1]):
        x = jnp.concatenate([_up(x), skip], axis=-1)
        x = _conv(params, name, x)
    return _conv(params, "out", x, relu=False)


def _shift(img, dy, dx):
    """Edge-replicated shift of [N, H, W, C] (same policy as atrous)."""
    h, w = img.shape[1], img.shape[2]
    ys = jnp.clip(jnp.arange(h) - dy, 0, h - 1)
    xs = jnp.clip(jnp.arange(w) - dx, 0, w - 1)
    return img[:, ys][:, :, xs]


def apply_kernel(logits, img):
    """Apply the predicted (softmaxed) per-pixel kernel to img."""
    weights = jax.nn.softmax(logits, axis=-1)            # [N, H, W, 25]
    acc = jnp.zeros_like(img)
    r = KERNEL_SIZE // 2
    i = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            acc = acc + weights[..., i:i + 1] * _shift(img, dy, dx)
            i += 1
    return acc


def _features(beauty, albedo, normal, history=None):
    """Network input features + the demodulated irradiance to filter.

    history: optional [N, H, W, 3] flow-reprojected previous output
    (radiance) — appended as 3 demodulated log-irradiance channels for
    the temporal variant."""
    irr = beauty / (albedo + _EPS)                       # demodulate texture
    log_irr = jnp.log1p(irr)
    lum = (0.2126 * beauty[..., 0] + 0.7152 * beauty[..., 1]
           + 0.0722 * beauty[..., 2])
    # local luminance variance as a noise-level cue
    mean = jax.lax.reduce_window(
        lum, 0.0, jax.lax.add, (1, 3, 3), (1, 1, 1), "SAME") / 9.0
    mean2 = jax.lax.reduce_window(
        lum * lum, 0.0, jax.lax.add, (1, 3, 3), (1, 1, 1), "SAME") / 9.0
    var = jnp.sqrt(jnp.maximum(mean2 - mean * mean, 0.0))
    parts = [log_irr, albedo, normal, var[..., None]]
    if history is not None:
        parts.append(jnp.log1p(jnp.maximum(history, 0.0)
                               / (albedo + _EPS)))
    feats = jnp.concatenate(parts, axis=-1)
    return feats, irr


@jax.jit
def denoise_kp(params, beauty, albedo=None, normal=None, emission=None,
               history=None):
    """Denoise [H, W, 3] (or [N, H, W, 3]) HDR beauty with guide layers.

    Albedo/normal default to neutral guides when a caller has no AOVs
    (quality degrades gracefully; the reference also accepts beauty-only).
    emission: optional noise-free primary-hit emitter radiance
    (render_aovs "emission") — subtracted before filtering and added
    back after, so the predicted kernels never blur an emitter's hard
    edge (the dominant error source of pure kernel prediction: a softmax
    kernel cannot exceed its neighbourhood maximum).
    """
    batched = beauty.ndim == 4
    if not batched:
        beauty = beauty[None]
        albedo = None if albedo is None else albedo[None]
        normal = None if normal is None else normal[None]
        emission = None if emission is None else emission[None]
        history = None if history is None else history[None]
    if albedo is None:
        albedo = jnp.ones_like(beauty)
    if normal is None:
        normal = jnp.zeros_like(beauty)
    if emission is not None:
        beauty = jnp.maximum(beauty - emission, 0.0)
        if history is not None:
            history = jnp.maximum(history - emission, 0.0)
    h, w = beauty.shape[1], beauty.shape[2]
    # pad to a multiple of 4 (two downsamples)
    ph = (-h) % 4
    pw = (-w) % 4
    pad = lambda x: jnp.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)),
                            mode="edge")
    beauty_p, albedo_p, normal_p = pad(beauty), pad(albedo), pad(normal)
    history_p = None if history is None else pad(history)

    feats, irr = _features(beauty_p, albedo_p, normal_p,
                           history=history_p)
    logits = apply_net(params, feats)
    filtered = apply_kernel(logits[..., :_KK], irr)
    if history_p is not None and logits.shape[-1] > _KK:
        # predicted history blend (temporal-KPCN): the net outputs a
        # per-pixel sigmoid weight copying the reprojected history's
        # demodulated irradiance — converged history ⇒ α→1, disocclusion
        # or mis-warp ⇒ α→0 (it sees both streams in its inputs).
        alpha = jax.nn.sigmoid(logits[..., _KK:_KK + 1])
        hist_irr = jnp.maximum(history_p, 0.0) / (albedo_p + _EPS)
        filtered = filtered + alpha * (hist_irr - filtered)
    out = filtered * (albedo_p + _EPS)                   # remodulate
    out = out[:, :h, :w]
    if emission is not None:
        out = out + emission
    return out if batched else out[0]


def upscale2x_kp(params, beauty_lr, albedo=None, normal=None,
                 emission=None):
    """2x upscale + denoise: bilinear-lift the low-res beauty, then run
    the kernel-prediction net (trained for this input distribution) with
    FULL-RES guide layers — the reference upscaler's recipe of hi-res
    guides steering low-res radiance (`optix_types.h` UPSCALE2X model).
    albedo/normal/emission must already be full-res (2H, 2W)."""
    up = upsample2x_bilinear(beauty_lr)
    return denoise_kp(params, up, albedo=albedo, normal=normal,
                      emission=emission)


@functools.lru_cache(maxsize=2)
def load_params(path: str = WEIGHTS_PATH):
    """Load a shipped checkpoint (None if not trained yet)."""
    if not os.path.exists(path):
        return None
    data = np.load(path)
    return {k: jnp.asarray(data[k]) for k in data.files}


def save_params(params, path: str = WEIGHTS_PATH):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    load_params.cache_clear()


def has_weights() -> bool:
    return os.path.exists(WEIGHTS_PATH)


def has_upscale_weights() -> bool:
    return os.path.exists(UPSCALE_WEIGHTS_PATH)


def has_temporal_weights() -> bool:
    return os.path.exists(TEMPORAL_WEIGHTS_PATH)
