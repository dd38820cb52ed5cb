"""Structured device-exception surface (optixThrowException parity).

The reference's device exceptions (`optix_device.h:1263-1432`) give each
launch a structured error channel: exception programs receive codes like
`OPTIX_EXCEPTION_CODE_INVALID_RAY` (non-finite ray origin/direction) next
to user-thrown codes, instead of silently corrupting the image. Under jit
a launch cannot branch to an exception program, so the equivalent here
is an *error pytree*: per-stage counters accumulated alongside
the launch and surfaced through the context log callback when validation
mode is on (`optixDeviceContextCreate` validation ALL,
`optixPathTracer.cpp:566-569`).

Counters (one per built-in exception code analogue):
  invalid_ray         raygen produced a non-finite origin/direction or an
                      inverted [tmin, tmax] interval — the semantics of
                      OPTIX_EXCEPTION_CODE_INVALID_RAY.
  nonfinite_radiance  a NaN/Inf escaped shading into this launch's
                      radiance sum (per pixel, counted once).
  negative_radiance   shading produced a negative radiance component.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.camera import generate_rays


@functools.partial(jax.jit, static_argnames=("width", "height"))
def check_raygen(cam_params, width: int, height: int):
    """invalid_ray count over this launch's primary rays (center taps —
    jitter cannot repair a non-finite camera basis)."""
    rays, _ = generate_rays(cam_params, width, height, jitter=False)
    bad = (~jnp.isfinite(rays.origin).all(-1)
           | ~jnp.isfinite(rays.direction).all(-1)
           | ~jnp.isfinite(rays.tmin) | ~jnp.isfinite(rays.tmax)
           | (rays.tmin > rays.tmax))
    return jnp.sum(bad.astype(jnp.int32))


@jax.jit
def check_radiance(rad_sum):
    """nonfinite/negative counts over a launch's per-pixel radiance sum
    [H, W, 3] (counted per pixel)."""
    nonfinite = ~jnp.isfinite(rad_sum).all(-1)
    negative = (jnp.where(jnp.isfinite(rad_sum), rad_sum, 0.0) < 0.0
                ).any(-1)
    return {
        "nonfinite_radiance": jnp.sum(nonfinite.astype(jnp.int32)),
        "negative_radiance": jnp.sum(negative.astype(jnp.int32)),
    }


def launch_diagnostics(cam_params, film_before, film_after, width, height):
    """Error pytree for one progressive launch: raygen validity plus the
    launch's radiance delta recovered from the films' accumulation-lerp
    states (`optixPathTracer.cu:312-318`: accum_n = lerp carries the
    per-launch sum as (n+1)*accum_{n+1} - n*accum_n)."""
    n0 = film_before.subframe.astype(jnp.float32)
    n1 = film_after.subframe.astype(jnp.float32)
    rad_sum = film_after.accum * n1 - film_before.accum * n0
    diag = {"invalid_ray": check_raygen(cam_params, width, height)}
    diag.update(check_radiance(rad_sum))
    return diag


def format_exceptions(diag) -> str:
    """One log line per fired counter (the exception-program printf role,
    `optix_device.h:1305-1318`)."""
    parts = [f"{k}={int(v)}" for k, v in sorted(diag.items()) if int(v)]
    return "; ".join(parts)
