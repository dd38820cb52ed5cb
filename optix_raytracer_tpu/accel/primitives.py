"""Analytic custom primitives: sphere, sphere shell, parallelogram.

Re-expresses the reference's custom-primitive intersection programs — the
AABB build inputs + `__intersection__*` device programs of the Whitted sample
(`SDK/cuda/geometry.cu:38-143` parallelogram & sphere-shell,
`SDK/cuda/sphere.cu:37` sphere, wired in `SDK/optixWhitted/optixWhitted.cpp:
381-430`) and the built-in sphere primitive (`optixSphere`,
`include/optix_host.h:409` optixBuiltinISModuleGet). Here each primitive
type is a vectorized analytic solve over the whole wavefront; a scene's
custom prims live in one SoA table and are tested brute-force (they number
in the tens in every reference scene).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import pytree

from ..core.rays import Hits, Rays
from ..core.vecmath import cross, dot, normalize

SPHERE = 0
SPHERE_SHELL = 1
PARALLELOGRAM = 2
CAPSULE = 3        # round linear curve segment (the curve-primitive backend)
SWEPT_QUAD = 4     # true swept quadratic curve segment (round bspline span)
SWEPT_CUBIC = 5    # true swept cubic curve segment (bspline/catmullrom/bezier)

_BIG = 1e30
_SWEPT_COARSE = 16  # coarse curve-parameter scan points (phi is degree 6
                    # for cubics — up to 3 local minima — so scan densely)
_SWEPT_NEWTON = 6   # minimization refinement steps


@pytree.dataclass
class CustomPrims:
    """SoA table of analytic primitives.

    params layout per kind:
      SPHERE:        [cx, cy, cz, r, 0...]
      SPHERE_SHELL:  [cx, cy, cz, r_inner, r_outer, 0...]
      PARALLELOGRAM: [ax, ay, az, v1x, v1y, v1z, v2x, v2y, v2z, 0...]
        (anchor + edge vectors; plane normal derived)
      SWEPT_QUAD:    [a0(3), a1(3), a2(3), r0, r1, r2, u0, u1, 0...]
        position C(s) = a0 + a1 s + a2 s^2, radius r(s) = r0 + r1 s + r2 s^2
        over s in [0, 1] — one quadratic-bspline span in power basis. The
        driver's built-in ROUND_QUADRATIC_BSPLINE intersector role
        (`optix_device.h:610-699`), solved lock-step: coarse scan + Newton
        minimization of the point-to-ray-axis quartic, then swept-sphere
        fix-point refinement — fixed iteration counts, no divergence.
      SWEPT_CUBIC:   [a0(3), a1(3), a2(3), a3(3), r0, r1, r2, r3, u0, u1]
        degree-3 span in power basis (cubic bspline / Catmull-Rom / Bézier
        — the ROUND_CUBIC_* builtin intersectors): same scan+Newton scheme
        with phi of degree 6.
    """
    kind: jnp.ndarray     # [P] int32
    params: jnp.ndarray   # [P, 18] f32
    mat_id: jnp.ndarray   # [P] int32

    @property
    def num(self):
        return self.kind.shape[0]

    @classmethod
    def empty(cls):
        return cls(kind=jnp.zeros((0,), jnp.int32),
                   params=jnp.zeros((0, 18), jnp.float32),
                   mat_id=jnp.zeros((0,), jnp.int32))


def make_prims(prims) -> CustomPrims:
    """prims: list of dicts {kind, mat_id, center/radius/... per kind}."""
    import numpy as np
    p = max(len(prims), 0)
    kind = np.zeros(p, np.int32)
    params = np.zeros((p, 18), np.float32)
    mat = np.zeros(p, np.int32)
    for i, pr in enumerate(prims):
        kind[i] = pr["kind"]
        mat[i] = pr.get("mat_id", 0)
        if pr["kind"] == SPHERE:
            params[i, :3] = pr["center"]
            params[i, 3] = pr["radius"]
        elif pr["kind"] == SPHERE_SHELL:
            params[i, :3] = pr["center"]
            params[i, 3] = pr["radius_inner"]
            params[i, 4] = pr["radius_outer"]
        elif pr["kind"] == PARALLELOGRAM:
            params[i, :3] = pr["anchor"]
            params[i, 3:6] = pr["v1"]
            params[i, 6:9] = pr["v2"]
        elif pr["kind"] == CAPSULE:
            params[i, :3] = pr["p0"]
            params[i, 3:6] = pr["p1"]
            params[i, 6] = pr["radius"]
        elif pr["kind"] == SWEPT_QUAD:
            params[i, 0:3] = pr["a0"]
            params[i, 3:6] = pr["a1"]
            params[i, 6:9] = pr["a2"]
            params[i, 9:12] = pr["r"]
            params[i, 12:14] = pr.get("u_range", (0.0, 1.0))
        elif pr["kind"] == SWEPT_CUBIC:
            params[i, 0:3] = pr["a0"]
            params[i, 3:6] = pr["a1"]
            params[i, 6:9] = pr["a2"]
            params[i, 9:12] = pr["a3"]
            params[i, 12:16] = pr["r"]
            params[i, 16:18] = pr.get("u_range", (0.0, 1.0))
        else:
            raise ValueError(f"unknown prim kind {pr['kind']}")
    return CustomPrims(kind=jnp.asarray(kind), params=jnp.asarray(params),
                       mat_id=jnp.asarray(mat))


def _sphere_ts(o, d, center, radius):
    """Both sphere intersections (t_near, t_far); misses → +BIG."""
    oc = o - center
    b = dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    ok = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    return (jnp.where(ok, t0, _BIG), jnp.where(ok, t1, _BIG))


def _prim_candidates(prims: CustomPrims, rays: Rays):
    """All candidate hits: t [N, P], normals [N, P, 3], uv [N, P, 2].

    For multi-surface prims (sphere, shell) the nearest valid crossing in
    (tmin, tmax) is chosen per primitive; normals face outward from the
    sphere center on outer surfaces and inward on the shell's inner surface
    (matching the hit-kind normals of `cuda/geometry.cu:67-143`).
    """
    o = rays.origin[:, None, :]        # [N, 1, 3]
    d = rays.direction[:, None, :]
    tmin = rays.tmin[:, None]
    tmax = rays.tmax[:, None]

    center = prims.params[None, :, 0:3]
    kind = prims.kind[None, :]

    # --- sphere (outer radius r = params[3]) ---
    r_sph = prims.params[None, :, 3]
    ts0, ts1 = _sphere_ts(o, d, center, r_sph)

    # --- shell (inner r3, outer r4) ---
    r_in = prims.params[None, :, 3]
    r_out = prims.params[None, :, 4]
    to0, to1 = _sphere_ts(o, d, center, r_out)
    ti0, ti1 = _sphere_ts(o, d, center, r_in)

    # --- parallelogram ---
    v1 = prims.params[None, :, 3:6]
    v2 = prims.params[None, :, 6:9]
    n_pg = cross(v1, v2)
    n_pg = n_pg / jnp.maximum(jnp.sqrt(dot(n_pg, n_pg)), 1e-20)[..., None]
    denom = dot(n_pg, d)
    safe_denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    t_pg = dot(prims.params[None, :, 0:3] - o, n_pg) / safe_denom
    p_pg = o + t_pg[..., None] * d
    rel = p_pg - prims.params[None, :, 0:3]
    v1_len2 = jnp.maximum(dot(v1, v1), 1e-20)
    v2_len2 = jnp.maximum(dot(v2, v2), 1e-20)
    a1 = dot(rel, v1) / v1_len2
    a2 = dot(rel, v2) / v2_len2
    pg_ok = ((jnp.abs(denom) >= 1e-12)
             & (a1 >= 0.0) & (a1 <= 1.0) & (a2 >= 0.0) & (a2 <= 1.0))
    t_pg = jnp.where(pg_ok, t_pg, _BIG)

    # --- capsule (round linear curve segment; the built-in linear curve
    # intersector role, optix_device.h:610-699 / optixCurves) ---
    pa = prims.params[None, :, 0:3]
    pb = prims.params[None, :, 3:6]
    r_cap = prims.params[None, :, 6]
    ba = pb - pa
    oa = o - pa
    baba = jnp.maximum(dot(ba, ba), 1e-12)
    bard = dot(ba, d)
    baoa = dot(ba, oa)
    rdoa = dot(d, oa)
    oaoa = dot(oa, oa)
    a_c = baba - bard * bard
    b_c = baba * rdoa - baoa * bard
    c_c = baba * oaoa - baoa * baoa - r_cap * r_cap * baba
    h_c = b_c * b_c - a_c * c_c
    safe_a = jnp.where(jnp.abs(a_c) < 1e-12, 1e-12, a_c)
    t_body = (-b_c - jnp.sqrt(jnp.maximum(h_c, 0.0))) / safe_a
    y_c = baoa + t_body * bard
    body_ok = (h_c > 0.0) & (y_c > 0.0) & (y_c < baba)
    t_body = jnp.where(body_ok, t_body, _BIG)
    # sphere caps at both endpoints
    tc0a, tc0b = _sphere_ts(o, d, pa, r_cap)
    tc1a, tc1b = _sphere_ts(o, d, pb, r_cap)
    # cap hits only count on the outward half (standard capsule clipping)
    def _cap_valid(tc, pc):
        p = o + tc[..., None] * d
        yy = dot(p - pa, ba)
        return jnp.where((yy <= 0.0) | (yy >= baba), tc, _BIG)
    t_cap = jnp.minimum(jnp.minimum(_cap_valid(tc0a, pa), _cap_valid(tc0b, pa)),
                        jnp.minimum(_cap_valid(tc1a, pb), _cap_valid(tc1b, pb)))

    # --- swept curves (true round bspline/catmullrom/bezier spans) ---
    # Quadratic and cubic spans share one solver: a quad span is a cubic
    # with a3 = r3 = 0 (the coefficient layouts differ — select per kind).
    is_cub = (kind == SWEPT_CUBIC)
    is_cub3 = is_cub[..., None]
    sa0 = prims.params[None, :, 0:3]
    sa1 = prims.params[None, :, 3:6]
    sa2 = prims.params[None, :, 6:9]
    sa3 = jnp.where(is_cub3, prims.params[None, :, 9:12], 0.0)
    sr0 = jnp.where(is_cub, prims.params[None, :, 12],
                    prims.params[None, :, 9])
    sr1 = jnp.where(is_cub, prims.params[None, :, 13],
                    prims.params[None, :, 10])
    sr2 = jnp.where(is_cub, prims.params[None, :, 14],
                    prims.params[None, :, 11])
    sr3 = jnp.where(is_cub, prims.params[None, :, 15], 0.0)

    def _curve_pt(sv):
        s1 = sv[..., None]
        return sa0 + s1 * (sa1 + s1 * (sa2 + s1 * sa3))

    def _curve_r(sv):
        return jnp.maximum(sr0 + sv * (sr1 + sv * (sr2 + sv * sr3)), 1e-6)

    # phi(s) = |perp(C(s) - o)|^2 - r(s)^2 — degree 6 in s (perp = the
    # component orthogonal to the unit ray direction; projection is linear,
    # so project the power-basis coefficients once).
    def _perp(v):
        return v - dot(v, d)[..., None] * d

    q0 = _perp(sa0 - o)
    q1 = _perp(sa1)
    q2 = _perp(sa2)
    q3 = _perp(sa3)
    A0 = dot(q0, q0) - sr0 * sr0
    A1 = 2 * dot(q0, q1) - 2 * sr0 * sr1
    A2 = dot(q1, q1) + 2 * dot(q0, q2) - (sr1 * sr1 + 2 * sr0 * sr2)
    A3 = 2 * (dot(q0, q3) + dot(q1, q2)) - 2 * (sr0 * sr3 + sr1 * sr2)
    A4 = (dot(q2, q2) + 2 * dot(q1, q3)
          - (sr2 * sr2 + 2 * sr1 * sr3))
    A5 = 2 * dot(q2, q3) - 2 * sr2 * sr3
    A6 = dot(q3, q3) - sr3 * sr3

    def _phi(sv):
        return A0 + sv * (A1 + sv * (A2 + sv * (
            A3 + sv * (A4 + sv * (A5 + sv * A6)))))

    def _sphere_entry_scan(sv):
        cc = _curve_pt(sv)
        rr = _curve_r(sv)
        oc = o - cc
        b = dot(oc, d)
        c = dot(oc, oc) - rr * rr
        disc = b * b - c
        tt = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
        return jnp.where((disc > 0.0) & (tt > 0.0), tt, _BIG)

    # Coarse scan tracks TWO candidates: the phi minimizer (catches thin
    # basins the scan straddles) and the in-basin point with the smallest
    # sphere-entry t. Degree-6 phi can have up to 3 negative basins, and
    # the global phi minimum need not be the basin nearest along the ray —
    # refining only it returns the wrong (farther) intersection for rays
    # that pass close to a curled strand twice.
    s_best = jnp.zeros(A0.shape, jnp.float32)
    phi_best = jnp.full(A0.shape, _BIG, jnp.float32)
    s_tmin = jnp.zeros(A0.shape, jnp.float32)
    t_scan = jnp.full(A0.shape, _BIG, jnp.float32)
    for kk in range(_SWEPT_COARSE + 1):
        sv = jnp.full(A0.shape, kk / _SWEPT_COARSE, jnp.float32)
        ph = _phi(sv)
        closer = ph < phi_best
        s_best = jnp.where(closer, sv, s_best)
        phi_best = jnp.where(closer, ph, phi_best)
        tt = jnp.where(ph < 0.0, _sphere_entry_scan(sv), _BIG)
        nearer = tt < t_scan
        s_tmin = jnp.where(nearer, sv, s_tmin)
        t_scan = jnp.where(nearer, tt, t_scan)
    # Newton refinement of the minimizer (phi' degree 5, phi'' degree 4),
    # safeguarded by the step clip so a flat phi'' can't fling s away from
    # the scanned basin.
    for _ in range(_SWEPT_NEWTON):
        dphi = A1 + s_best * (2 * A2 + s_best * (
            3 * A3 + s_best * (4 * A4 + s_best * (
                5 * A5 + s_best * 6 * A6))))
        ddphi = 2 * A2 + s_best * (6 * A3 + s_best * (
            12 * A4 + s_best * (20 * A5 + s_best * 30 * A6)))
        stepn = dphi / jnp.where(jnp.abs(ddphi) < 1e-9, 1e-9, ddphi)
        s_best = jnp.clip(s_best - jnp.clip(stepn, -0.25, 0.25), 0.0, 1.0)

    # swept-sphere fix-point: t from the sphere at C(s), s from the curve
    # point nearest the hit — 2 rounds converge for span-sized segments.
    def _sphere_entry(sv):
        cc = _curve_pt(sv)
        rr = _curve_r(sv)
        oc = o - cc
        b = dot(oc, d)
        c = dot(oc, oc) - rr * rr
        disc = b * b - c
        return (-b - jnp.sqrt(jnp.maximum(disc, 0.0)), disc > 0.0)

    def _project_to_curve(s_init, p):
        """Newton on psi(s) = (C(s) - p) . C'(s): nearest curve parameter."""
        s = s_init
        for _ in range(2):
            cc = _curve_pt(s)
            s1 = s[..., None]
            cd = sa1 + s1 * (2.0 * sa2 + s1 * 3.0 * sa3)
            cdd = 2.0 * sa2 + s1 * 6.0 * sa3
            psi = dot(cc - p, cd)
            dpsi = dot(cd, cd) + dot(cc - p, cdd)
            s = jnp.clip(
                s - psi / jnp.where(jnp.abs(dpsi) < 1e-9, 1e-9, dpsi),
                0.0, 1.0)
        return s

    def _refine(s0):
        # The swept volume is the union over s of balls B(C(s), r(s)), so
        # for an exterior origin EVERY per-s sphere entry is an upper bound
        # on the true entry t and the min over evaluated candidates
        # converges to it. The fix-point (project the current hit point to
        # the curve, re-enter that sphere) proposes better s values, but a
        # step can overshoot on curled spans — so keep the best (smallest
        # valid) t seen across ALL evaluations, never the last one.
        s = s0
        t, ok = _sphere_entry(s)
        s_out = s
        t_out = jnp.where(ok, t, _BIG)
        for _ in range(2):
            p_sw = o + t[..., None] * d
            s = _project_to_curve(s, p_sw)
            t, ok = _sphere_entry(s)
            tv = jnp.where(ok, t, _BIG)
            better = tv < t_out
            s_out = jnp.where(better, s, s_out)
            t_out = jnp.where(better, tv, t_out)
        return s_out, t_out

    s_a, t_a = _refine(s_best)
    t_a = jnp.where(phi_best < 0.0, t_a, _BIG)
    s_b, t_b = _refine(s_tmin)
    t_b = jnp.where(t_scan < _BIG, t_b, _BIG)
    use_b = t_b < t_a
    sw_s = jnp.where(use_b, s_b, s_a)
    t_swept = jnp.minimum(t_a, t_b)

    in_range = lambda t: (t > tmin) & (t < tmax)

    # nearest valid candidate per prim
    def pick(*ts):
        t_best = jnp.full(ts[0].shape, _BIG, jnp.float32)
        for t in ts:
            t_ok = jnp.where(in_range(t), t, _BIG)
            t_best = jnp.minimum(t_best, t_ok)
        return t_best

    t_sphere = pick(ts0, ts1)
    t_shell = pick(to0, to1, ti0, ti1)
    t_para = pick(t_pg)
    t_capsule = pick(t_body, t_cap)
    t_swq = pick(t_swept)

    is_swq = (kind == SWEPT_QUAD) | (kind == SWEPT_CUBIC)
    t = jnp.where(kind == SPHERE, t_sphere,
                  jnp.where(kind == SPHERE_SHELL, t_shell,
                            jnp.where(kind == CAPSULE, t_capsule,
                                      jnp.where(is_swq, t_swq,
                                                t_para))))

    # normals at the chosen t
    p_hit = o + t[..., None] * d
    rel_c = p_hit - center
    rad = jnp.sqrt(jnp.maximum(dot(rel_c, rel_c), 1e-20))
    n_sphere = rel_c / rad[..., None]
    # shell: inner-surface hits get inward normals
    is_inner = jnp.abs(rad - r_in) < jnp.abs(rad - r_out)
    n_shell = jnp.where(((kind == SPHERE_SHELL) & is_inner)[..., None],
                        -n_sphere, n_sphere)
    # capsule: normal from the closest axis point; u = clamped axis parameter
    # (the strand-u attribute of curve hits, optixHair strand-u shading)
    y_hit = jnp.clip(dot(p_hit - pa, ba) / baba, 0.0, 1.0)
    axis_pt = pa + y_hit[..., None] * ba
    n_capsule = (p_hit - axis_pt) / jnp.maximum(r_cap, 1e-12)[..., None]
    # swept curve: project the hit point back onto the curve for the
    # normal/strand-u (same Newton projection as the intersector)
    s_n = _project_to_curve(sw_s, p_hit)
    c_n = _curve_pt(s_n)
    n_swq = (p_hit - c_n) / _curve_r(s_n)[..., None]
    n_swq = n_swq / jnp.maximum(
        jnp.sqrt(dot(n_swq, n_swq)), 1e-12)[..., None]
    su0 = jnp.where(is_cub, prims.params[None, :, 16],
                    prims.params[None, :, 12])
    su1 = jnp.where(is_cub, prims.params[None, :, 17],
                    prims.params[None, :, 13])
    u_swq = su0 + (su1 - su0) * s_n
    normal = jnp.where((kind == PARALLELOGRAM)[..., None], n_pg,
                       jnp.where((kind == CAPSULE)[..., None], n_capsule,
                                 jnp.where(is_swq[..., None],
                                           n_swq, n_shell)))

    uv = jnp.where((kind == PARALLELOGRAM)[..., None],
                   jnp.stack([a1, a2], axis=-1),
                   jnp.where((kind == CAPSULE)[..., None],
                             jnp.stack([y_hit, jnp.zeros_like(y_hit)], -1),
                             jnp.where(is_swq[..., None],
                                       jnp.stack([u_swq,
                                                  jnp.zeros_like(u_swq)],
                                                 -1),
                                       jnp.stack(
                                           [0.5 + jnp.arctan2(
                                               rel_c[..., 2], rel_c[..., 0])
                                            / (2 * jnp.pi),
                                            0.5 - jnp.arcsin(jnp.clip(
                                                rel_c[..., 1] / rad, -1, 1))
                                            / jnp.pi], axis=-1))))
    return t, normal, uv


def intersect_prims_closest(prims: CustomPrims, rays: Rays) -> Hits:
    """Closest hit over the custom-prim table (flat rays [N])."""
    t, normal, uv = _prim_candidates(prims, rays)
    best = jnp.argmin(t, axis=1)
    n = rays.tmin.shape[0]
    rows = jnp.arange(n)
    bt = t[rows, best]
    hit = bt < _BIG
    return Hits(
        t=jnp.where(hit, bt, rays.tmax),
        prim_id=jnp.where(hit, best.astype(jnp.int32), -1),
        inst_id=jnp.where(hit, 0, -1),
        mat_id=jnp.where(hit, prims.mat_id[best], -1),
        uv=uv[rows, best],
        normal=jnp.where(hit[:, None], normal[rows, best], 0.0),
    )


def intersect_prims_any(prims: CustomPrims, rays: Rays) -> jnp.ndarray:
    t, _, _ = _prim_candidates(prims, rays)
    return jnp.any(t < _BIG, axis=1)


def merge_hits(a: Hits, b: Hits, prim_offset: int = 0) -> Hits:
    """Combine two closest-hit results, keeping the nearer; b's prim ids get
    `prim_offset` added (so triangle ids and custom-prim ids stay disjoint,
    like SBT geometry-index offsets at `Scene.cpp:1154`)."""
    b_wins = (b.prim_id >= 0) & ((a.prim_id < 0) | (b.t < a.t))
    pick = lambda x, y: jnp.where(b_wins, y, x)
    pick3 = lambda x, y: jnp.where(b_wins[..., None], y, x)
    return Hits(
        t=pick(a.t, b.t),
        prim_id=pick(a.prim_id,
                     jnp.where(b.prim_id >= 0, b.prim_id + prim_offset, -1)),
        inst_id=pick(a.inst_id, b.inst_id),
        mat_id=pick(a.mat_id, b.mat_id),
        uv=pick3(a.uv, b.uv),
        normal=pick3(a.normal, b.normal),
    )
