"""Counter-based, stateless-seedable RNG for the wavefront engine.

The reference seeds a per-pixel LCG with a TEA hash of (pixel index, subframe)
and draws with `rnd()` (`SDK/cuda/random.h:32-71`). That scheme is already the
right shape for a wavefront — a pure function of integer state, no shared tables — so we
keep its structure (TEA seed + LCG advance) and add a stronger PCG-hash float
path. All ops are elementwise uint32 arithmetic over arbitrary batch shapes:
one call produces random numbers for an entire ray wavefront, and results are
reproducible under any sharding because state is per-ray data.
"""
from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def tea(val0, val1, rounds: int = 4):
    """TEA hash of two uint32s → uint32 seed (reference `cuda/random.h:34-49`)."""
    v0 = jnp.asarray(val0).astype(_U32)
    v1 = jnp.asarray(val1).astype(_U32)
    s0 = _U32(0)
    for _ in range(rounds):
        s0 = s0 + _U32(0x9E3779B9)
        v0 = v0 + (((v1 << 4) + _U32(0xA341316C)) ^ (v1 + s0) ^ ((v1 >> 5) + _U32(0xC8013EA4)))
        v1 = v1 + (((v0 << 4) + _U32(0xAD90777D)) ^ (v0 + s0) ^ ((v0 >> 5) + _U32(0x7E95761E)))
    return v0


def pcg(state):
    """One counter-hash RNG step: returns (output_word, next_state).

    LCG state advance + a lowbias32-style finalizer. All shifts are by
    constants (unlike classic PCG's data-dependent shift) so the identical
    sequence is reproducible inside Pallas kernels, where per-lane
    variable shifts are not guaranteed to lower.
    """
    state = jnp.asarray(state).astype(_U32)
    new_state = state * _U32(747796405) + _U32(2891336453)
    x = new_state
    x = (x ^ (x >> 16)) * _U32(0x7FEB352D)
    x = (x ^ (x >> 15)) * _U32(0x846CA68B)
    x = x ^ (x >> 16)
    return x, new_state


def lcg_step(state):
    """Reference LCG advance (`cuda/random.h:53-60`)."""
    return jnp.asarray(state).astype(_U32) * _U32(1664525) + _U32(1013904223)


def _to_unit_float(bits):
    """uint32 → float32 in [0, 1) using the top 24 bits (exact in f32)."""
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def seed(pixel_index, subframe):
    """Per-ray RNG state from (pixel linear index, subframe/sample index).

    Mirrors `tea<4>(idx.y*w + idx.x, subframe_index)` at
    `SDK/optixPathTracer/optixPathTracer.cu:258`.
    """
    return tea(pixel_index, subframe)


def uniform(state):
    """Draw one uniform [0,1) float per lane; returns (u, next_state)."""
    word, next_state = pcg(state)
    return _to_unit_float(word), next_state


def uniform2(state):
    """Draw two independent uniforms; returns (u1, u2, next_state)."""
    u1, state = uniform(state)
    u2, state = uniform(state)
    return u1, u2, state
