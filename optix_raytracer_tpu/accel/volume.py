"""Fog-volume rendering: dense density grids with ray marching.

The optixVolumeViewer capability (`SDK/optixVolumeViewer/`): a fog volume as
a custom primitive over a density grid (`volume.cu:284` __intersection__
volume, transmittance estimation in the closest-hit `volume.cu:310`,
NanoVDB-backed). Re-design: the sparse VDB tree becomes a dense
[D³] grid (device memory is plentiful; dense sampling vectorizes), the per-ray DDA
becomes fixed-step marching in a `lax.fori_loop` — every lane samples the
grid by trilinear gather per step — and light transmittance comes from a
precomputed directional shadow grid (a cumulative optical-depth sweep, one
pass, instead of secondary marches per step).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from ..core import pytree

from ..core.rays import Rays
from ..core.aabb import intersect_ray


@pytree.dataclass
class DensityGrid:
    """Dense density volume in a world AABB."""
    density: jnp.ndarray    # [D, D, D] f32 (z, y, x order)
    lo: jnp.ndarray         # [3]
    hi: jnp.ndarray         # [3]

    @property
    def res(self):
        return self.density.shape[0]

    @classmethod
    def empty(cls):
        return cls(density=jnp.zeros((1, 1, 1), jnp.float32),
                   lo=jnp.zeros((3,), jnp.float32),
                   hi=jnp.ones((3,), jnp.float32))


def sample_grid(grid: DensityGrid, pts):
    """Trilinear density at world points [..., 3] (0 outside). Supports
    non-cubic [D, H, W] grids (e.g. loaded NanoVDB volumes)."""
    res = jnp.asarray(grid.density.shape[::-1], jnp.float32)  # (x, y, z)
    g = (pts - grid.lo) / (grid.hi - grid.lo) * (res - 1)
    inside = jnp.all((pts >= grid.lo) & (pts <= grid.hi), axis=-1)
    g = jnp.clip(g, 0.0, res - 1.001)
    i0 = jnp.floor(g).astype(jnp.int32)
    f = g - i0
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    d = grid.density

    def at(dx, dy, dz):
        return d[z0 + dz, y0 + dy, x0 + dx]

    c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    val = ((c00 * (1 - fy) + c10 * fy) * (1 - fz)
           + (c01 * (1 - fy) + c11 * fy) * fz)
    return jnp.where(inside, val, 0.0)


def _segment_window(grid: DensityGrid, origin, direction, t0, t1):
    """Clip [t0, t1] to the grid AABB → (near, span)."""
    inv_d = 1.0 / jnp.where(jnp.abs(direction) < 1e-12, 1e-12, direction)
    a = (grid.lo - origin) * inv_d
    b = (grid.hi - origin) * inv_d
    t_enter = jnp.max(jnp.minimum(a, b), axis=-1)
    t_exit = jnp.min(jnp.maximum(a, b), axis=-1)
    near = jnp.maximum(t0, t_enter)
    far = jnp.minimum(t1, t_exit)
    return near, jnp.maximum(far - near, 0.0)


def optical_depth(grid: DensityGrid, origin, direction, t0, t1,
                  sigma_t, num_steps: int = 16):
    """tau along the ray segment [t0, t1] (fixed-step quadrature) — the
    transmittance estimator of `volume.cu:310` for T = exp(-tau)."""
    near, span = _segment_window(grid, origin, direction, t0, t1)
    dt = span / num_steps

    def body(i, tau):
        p = origin + (near + (i + 0.5) * dt)[..., None] * direction
        return tau + sample_grid(grid, p) * dt

    tau = jax.lax.fori_loop(0, num_steps,
                            body, jnp.zeros(t0.shape, jnp.float32))
    return tau * sigma_t


def sample_scatter(grid: DensityGrid, origin, direction, t0, t1, sigma_t,
                   u, num_steps: int = 16):
    """Distance-sample one single-scatter point along [t0, t1].

    Inverse-transform sampling on the marched optical depth: t_s is
    distributed ∝ sigma_t(t)·T(t) within the segment, so the camera-side
    transmittance cancels against the pdf and the single-scatter
    estimator collapses to  L ≈ w · albedo · phase · L_nee(t_s)  with
    w = 1 − exp(−tau_total). Returns (t_s [N], w [N], tau_total [N]).

    This replaces the deterministic per-step light marches of the first
    design: one stochastic point per segment lets the engine afford a REAL
    shadow query (geometry occlusion + area-light sampling) at that point
    (`volume.cu:310-366` does per-step center-sampled light only).
    """
    near, span = _segment_window(grid, origin, direction, t0, t1)
    dt = span / num_steps

    def step_tau(_, i):
        p = origin + (near + (i + 0.5) * dt)[..., None] * direction
        return None, sample_grid(grid, p) * dt * sigma_t

    _, dtaus = jax.lax.scan(step_tau, None,
                            jnp.arange(num_steps))       # [S, N]
    cum = jnp.cumsum(dtaus, axis=0)                      # tau at step ends
    tau_total = cum[-1]
    w = -jnp.expm1(-tau_total)                           # 1 - e^-tau
    target = -jnp.log1p(-jnp.clip(u, 0.0, 1.0 - 1e-6) * w)
    idx = jnp.clip(jnp.sum((cum < target[None]).astype(jnp.int32), axis=0),
                   0, num_steps - 1)
    cum_start = jnp.where(idx > 0,
                          jnp.take_along_axis(
                              cum, jnp.maximum(idx - 1, 0)[None], axis=0)[0],
                          0.0)
    dtau_i = jnp.take_along_axis(dtaus, idx[None], axis=0)[0]
    frac = jnp.clip((target - cum_start)
                    / jnp.where(dtau_i > 1e-12, dtau_i, 1e-12), 0.0, 1.0)
    t_s = near + (idx.astype(jnp.float32) + frac) * dt
    return t_s, w, tau_total


def segment_scatter_nee(grid: DensityGrid, origin, direction, t0, t1,
                        sigma_t, scatter_albedo, light,
                        num_steps: int = 16, light_steps: int = 8):
    """Single scattering along [t0, t1] toward a parallelogram area light
    → (tau [N], inscatter [N, 3]).

    Per step: isotropic phase 1/(4pi), light sampled at its center
    (deterministic — the segment integral itself is the stochastic part via
    pixel jitter), light-ward transmittance by a short optical-depth march.
    The engine composites this inside the standard bounce loop — the role
    of `optixVolumeViewer`'s in-scatter estimate (`volume.cu:310-366`).
    """
    near, span = _segment_window(grid, origin, direction, t0, t1)
    dt = span / num_steps
    lc = light.corner + 0.5 * light.v1 + 0.5 * light.v2

    def body(i, carry):
        tau, rad = carry
        t = near + (i + 0.5) * dt
        p = origin + t[..., None] * direction
        dens = sample_grid(grid, p)
        dtau = sigma_t * dens * dt
        trans_cam = jnp.exp(-tau)
        delta = lc - p
        dist2 = jnp.maximum(jnp.sum(delta * delta, axis=-1), 1e-12)
        dist = jnp.sqrt(dist2)
        wi = delta / dist[..., None]
        ln_dl = jnp.abs(jnp.sum(light.normal * wi, axis=-1))
        tau_l = optical_depth(grid, p, wi, jnp.zeros_like(dist), dist,
                              sigma_t, num_steps=light_steps)
        li = (light.emission[None, :] * (ln_dl * light.area / dist2
                                         / (4.0 * jnp.pi))[..., None]
              * jnp.exp(-tau_l)[..., None])
        rad = rad + (trans_cam * scatter_albedo * dtau)[..., None] * li
        return tau + dtau, rad

    tau0 = jnp.zeros(t0.shape, jnp.float32)
    rad0 = jnp.zeros(t0.shape + (3,), jnp.float32)
    return jax.lax.fori_loop(0, num_steps, body, (tau0, rad0))


def light_transmittance_grid(grid: DensityGrid, light_dir, sigma_t: float):
    """Precompute per-voxel transmittance toward a directional light by a
    cumulative optical-depth sweep along the dominant light axis (replaces
    per-step secondary marches). light_dir must be a concrete (host) tuple —
    the sweep axis is a static choice."""
    import numpy as np
    ld = np.asarray(light_dir, np.float32)
    axis = int(np.argmax(np.abs(ld)))
    sign = float(np.sign(ld[axis]))
    d = grid.density
    # axis order in the array is (z, y, x) → array axis = 2 - axis
    arr_axis = 2 - axis
    cell = (grid.hi[axis] - grid.lo[axis]) / d.shape[arr_axis]
    tau = jnp.cumsum(d, axis=arr_axis) * cell * sigma_t
    if sign > 0:  # light travels +axis ⇒ looking upstream means reverse
        total = jnp.sum(d, axis=arr_axis, keepdims=True) * cell * sigma_t
        tau = total - tau
    return jnp.exp(-tau)


@functools.partial(jax.jit, static_argnames=("num_steps", "light_dir"))
def march(grid: DensityGrid, rays: Rays, light_dir, light_color,
          sigma_t: float = 8.0, ambient=0.15, num_steps: int = 96,
          bg_radiance=None, bg_t=None):
    """Single-scattering fixed-step march → (radiance [N, 3]).

    Composites over optional background radiance/depth (mesh hits behind or
    inside the volume), like the reference's mesh+volume composited scene.
    """
    n = rays.tmin.shape[0]
    inv_d = 1.0 / rays.direction
    hit, t_enter = intersect_ray(grid.lo, grid.hi, rays.origin, inv_d,
                                 rays.tmin, rays.tmax)
    # exit distance
    t0 = (grid.lo - rays.origin) * inv_d
    t1 = (grid.hi - rays.origin) * inv_d
    t_exit = jnp.min(jnp.maximum(t0, t1), axis=-1)
    t_far = jnp.minimum(t_exit, bg_t if bg_t is not None else rays.tmax)
    t_near = jnp.maximum(t_enter, rays.tmin)
    seg = jnp.maximum(t_far - t_near, 0.0)
    dt = seg / num_steps

    # light_dir is a static tuple (the shadow-sweep axis is a static choice)
    shadow = light_transmittance_grid(grid, light_dir, sigma_t)
    shadow_grid = DensityGrid(density=shadow, lo=grid.lo, hi=grid.hi)
    light_color = jnp.asarray(light_color, jnp.float32)

    def body(i, carry):
        trans, rad = carry
        t = t_near + (i + 0.5) * dt
        p = rays.origin + t[:, None] * rays.direction
        dens = sample_grid(grid, p)
        alpha = sigma_t * dens * dt
        light_t = sample_grid(shadow_grid, p)
        inscatter = (light_color[None, :] * light_t[:, None]
                     + ambient) * alpha[:, None]
        rad = rad + trans[:, None] * inscatter
        trans = trans * jnp.exp(-alpha)
        return trans, rad

    trans = jnp.ones((n,), jnp.float32)
    rad = jnp.zeros((n, 3), jnp.float32)
    trans, rad = jax.lax.fori_loop(0, num_steps, body, (trans, rad))

    if bg_radiance is not None:
        rad = rad + trans[:, None] * bg_radiance
    return rad, trans


def pyroclastic_ball(res: int = 64, seed: int = 0) -> DensityGrid:
    """Procedural puffball density (the demo volume): radial falloff warped
    by value noise — the role of the sample's smoke.nvdb asset."""
    import numpy as np
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (9, 9, 9)).astype(np.float32)
    # trilinear-upsample noise to res³
    zoom = res / 8.0
    idx = np.minimum((np.arange(res) / zoom), 7.999)
    i0 = idx.astype(np.int32)
    f = (idx - i0).astype(np.float32)

    def lerp_axis(a, axis):
        sl0 = np.take(a, i0, axis=axis)
        sl1 = np.take(a, np.minimum(i0 + 1, 8), axis=axis)
        shape = [1, 1, 1]
        shape[axis] = res
        return sl0 + (sl1 - sl0) * f.reshape(shape)

    noise = lerp_axis(lerp_axis(lerp_axis(coarse, 0), 1), 2)
    zz, yy, xx = np.meshgrid(*([np.linspace(-1, 1, res)] * 3), indexing="ij")
    r = np.sqrt(xx * xx + yy * yy + zz * zz)
    dens = np.clip(0.72 + 0.45 * noise - r, 0.0, 1.0)
    return DensityGrid(density=jnp.asarray(dens, jnp.float32),
                       lo=jnp.asarray([-1.0, -1.0, -1.0]),
                       hi=jnp.asarray([1.0, 1.0, 1.0]))
