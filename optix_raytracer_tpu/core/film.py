"""Film: progressive accumulation buffer, tone mapping, sRGB, uchar4 conversion.

Replaces the reference's accumulation + display-buffer path:
  - progressive accumulation lerp `accum = lerp(accum_prev, new, 1/(subframe+1))`
    (`SDK/optixPathTracer/optixPathTracer.cu:308-319`, imgui_test film
    `SDK/imgui_test/optixTriangle.h:52-57`),
  - linear→sRGB conversion + float3→uchar4 `make_color`
    (`SDK/cuda/helpers.h:35-66`),
  - the `CUDAOutputBuffer<uchar4>` framebuffer object (`sutil/CUDAOutputBuffer.h`)
    becomes a plain device array returned from jit (XLA owns staging; the four
    CUDA transport modes collapse to device-resident + host fetch).
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np
from . import pytree


@pytree.dataclass
class Film:
    """Progressive-render state: accum buffer + subframe counter.

    This is also the checkpointable render state (SURVEY.md §5 checkpoint/resume):
    it is a pytree, so `orbax`/`np.savez` snapshots of (accum, subframe) resume a
    progressive render exactly.

    Optional per-pixel variance tracking (`create(track_variance=True)`):
    `sq` holds the running mean of SQUARED per-launch radiance estimates and
    `launches` counts accumulate() calls. The standard error of the mean
    (`variance_of_mean`) then gates the denoiser's never-worse blend — a
    converged pixel keeps its input exactly instead of eating the filter's
    bias floor. Valid when every launch carries the same sample count (the
    progressive loop's invariant).
    """
    accum: jnp.ndarray      # [H, W, 3] float32 linear radiance mean
    subframe: jnp.ndarray   # int32 scalar — samples accumulated so far
    sq: Optional[jnp.ndarray] = None        # [H, W, 3] mean of estimate²
    launches: Optional[jnp.ndarray] = None  # int32 scalar accumulate() calls

    @classmethod
    def create(cls, height, width, track_variance: bool = False):
        return cls(accum=jnp.zeros((height, width, 3), jnp.float32),
                   subframe=jnp.zeros((), jnp.int32),
                   sq=(jnp.zeros((height, width, 3), jnp.float32)
                       if track_variance else None),
                   launches=(jnp.zeros((), jnp.int32)
                             if track_variance else None))

    def accumulate(self, radiance):
        """One progressive step: accum ← lerp(accum, radiance, 1/(subframe+1)).

        Matches `optixPathTracer.cu:312-318` exactly (running mean over
        subframes).
        """
        t = 1.0 / (self.subframe.astype(jnp.float32) + 1.0)
        sq, launches = self.sq, self.launches
        if sq is not None:
            tl = 1.0 / (launches.astype(jnp.float32) + 1.0)
            sq = sq + (radiance * radiance - sq) * tl
            launches = launches + 1
        return Film(accum=self.accum + (radiance - self.accum) * t,
                    subframe=self.subframe + 1, sq=sq, launches=launches)

    def variance_of_mean(self):
        """Per-pixel stderr² of `accum` (None when tracking is off) over L
        equal-spp estimates: `sq - accum²` is the BIASED variance v_b
        (second moment minus squared mean), the unbiased sample variance
        is v_b·L/(L-1), and Var(mean) = s²/L — so the two L factors cancel
        to v_b/(L-1)."""
        if self.sq is None:
            return None
        L = self.launches.astype(jnp.float32)
        var_est = jnp.maximum(self.sq - self.accum * self.accum, 0.0)
        return var_est / jnp.maximum(L - 1.0, 1.0)

    def reset(self):
        """Camera moved / resized → restart accumulation
        (`optixPathTracer.cpp:480-481`)."""
        return Film(accum=jnp.zeros_like(self.accum),
                    subframe=jnp.zeros_like(self.subframe),
                    sq=None if self.sq is None else jnp.zeros_like(self.sq),
                    launches=(None if self.launches is None
                              else jnp.zeros_like(self.launches)))


def linear_to_srgb(c):
    """Exact sRGB OETF (reference `cuda/helpers.h:37-42` toSRGB)."""
    c = jnp.clip(c, 0.0, 1.0)
    lo = 12.92 * c
    hi = 1.055 * jnp.power(jnp.maximum(c, 1e-8), 1.0 / 2.4) - 0.055
    return jnp.where(c < 0.0031308, lo, hi)


def srgb_to_linear(c):
    c = jnp.clip(c, 0.0, 1.0)
    lo = c / 12.92
    hi = jnp.power((c + 0.055) / 1.055, 2.4)
    return jnp.where(c < 0.04045, lo, hi)


def make_color(radiance):
    """float3 linear radiance → uint8 RGBA, sRGB-encoded.

    The `make_color` device helper (`cuda/helpers.h:57-66`): clamp, sRGB,
    quantize with the reference's `quantizeUnsigned8Bits` rounding
    (x*255.99999 floor).
    """
    srgb = linear_to_srgb(radiance)
    rgb = jnp.clip(srgb * 255.99999, 0.0, 255.0).astype(jnp.uint8)
    alpha = jnp.full(rgb.shape[:-1] + (1,), 255, jnp.uint8)
    return jnp.concatenate([rgb, alpha], axis=-1)


def to_display(accum):
    """Device-side accum → uint8 RGBA framebuffer (jit-friendly)."""
    return make_color(accum)


class OutputBuffer:
    """Host-facing framebuffer wrapper (the `CUDAOutputBuffer<uchar4>` analogue,
    `sutil/CUDAOutputBuffer.h:45-94`).

    Here there is one transport: device array → host numpy on `get_host()`.
    `map()/unmap()` are kept as no-op context points so ported sample code reads
    the same.
    """

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self._device = jnp.zeros((height, width, 4), jnp.uint8)

    def map(self):
        return self._device

    def unmap(self):
        pass

    def set(self, device_rgba):
        self._device = device_rgba

    def get_host(self) -> np.ndarray:
        return np.asarray(self._device)

    def resize(self, width: int, height: int):
        if (width, height) != (self.width, self.height):
            self.__init__(width, height)
