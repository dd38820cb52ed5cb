"""Optical flow between two frames: coarse-to-fine block matching.

The `optixOpticalFlow` capability (`SDK/optixOpticalFlow/`, using the
denoiser stack's flow model): estimate per-pixel 2-D motion from frame A to
frame B, in pixels, suitable as the temporal denoiser's flow guide layer.
Implementation: an image pyramid (2× average pooling) with exhaustive ±R
integer search per level on luminance SSD, refined level by level — entirely
dense tensor ops (every candidate displacement is a shifted-difference
reduction), which is the data-parallel formulation of block matching.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _lum(img):
    img = jnp.asarray(img, jnp.float32)
    if img.ndim == 3:
        return (img[..., 0] * 0.2126 + img[..., 1] * 0.7152
                + img[..., 2] * 0.0722)
    return img


def _downsample(img):
    h, w = img.shape
    h2, w2 = h // 2 * 2, w // 2 * 2
    img = img[:h2, :w2]
    return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                   + img[0::2, 1::2] + img[1::2, 1::2])


def _warp(img, flow):
    h, w = img.shape
    yy = jnp.arange(h, dtype=jnp.float32)[:, None] + flow[..., 1]
    xx = jnp.arange(w, dtype=jnp.float32)[None, :] + flow[..., 0]
    y0 = jnp.clip(jnp.floor(yy), 0, h - 2)
    x0 = jnp.clip(jnp.floor(xx), 0, w - 2)
    fy = yy - y0
    fx = xx - x0
    y0 = y0.astype(jnp.int32)
    x0 = x0.astype(jnp.int32)
    return ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
            + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy)


def _box_blur(img, r=2):
    k = 2 * r + 1
    out = img
    for axis in (0, 1):
        acc = jnp.zeros_like(out)
        for o in range(-r, r + 1):
            acc = acc + jnp.roll(out, o, axis=axis)
        out = acc / k
    return out


def _search_level(a, b, flow, radius: int):
    """Refine integer flow at one level: argmin over (2r+1)^2 shifted SSDs of
    b warped by (flow + candidate) against a."""
    best_cost = jnp.full(a.shape, jnp.inf, jnp.float32)
    best_dx = jnp.zeros(a.shape, jnp.float32)
    best_dy = jnp.zeros(a.shape, jnp.float32)
    b_warp = _warp(b, flow)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            cand = jnp.roll(b_warp, (-dy, -dx), axis=(0, 1))
            cost = _box_blur((a - cand) ** 2, r=2)
            better = cost < best_cost
            best_cost = jnp.where(better, cost, best_cost)
            best_dx = jnp.where(better, float(dx), best_dx)
            best_dy = jnp.where(better, float(dy), best_dy)
    return flow + jnp.stack([best_dx, best_dy], axis=-1)


@functools.partial(jax.jit, static_argnames=("levels", "radius"))
def optical_flow(frame_a, frame_b, levels: int = 4, radius: int = 2):
    """Flow from frame_a to frame_b → [H, W, 2] (x, y) in pixels.

    Total search range ≈ radius * (2^levels - 1) pixels.
    """
    a = _lum(frame_a)
    b = _lum(frame_b)
    pyr_a, pyr_b = [a], [b]
    for _ in range(levels - 1):
        if min(pyr_a[-1].shape) < 8:
            break
        pyr_a.append(_downsample(pyr_a[-1]))
        pyr_b.append(_downsample(pyr_b[-1]))

    flow = jnp.zeros(pyr_a[-1].shape + (2,), jnp.float32)
    for lvl in range(len(pyr_a) - 1, -1, -1):
        if flow.shape[:2] != pyr_a[lvl].shape:
            # upsample flow to this level (nearest ×2, scaled)
            flow = 2.0 * jnp.repeat(jnp.repeat(flow, 2, 0), 2, 1)
            flow = flow[:pyr_a[lvl].shape[0], :pyr_a[lvl].shape[1]]
            pad_y = pyr_a[lvl].shape[0] - flow.shape[0]
            pad_x = pyr_a[lvl].shape[1] - flow.shape[1]
            if pad_y or pad_x:
                flow = jnp.pad(flow, ((0, pad_y), (0, pad_x), (0, 0)),
                               mode="edge")
        flow = _search_level(pyr_a[lvl], pyr_b[lvl], flow, radius)
    return flow
