"""The wavefront execution engine: the `optixLaunch` of this framework.

Where the reference launches a driver megakernel whose raygen program loops
bounces with divergent `optixTrace` calls per pixel
(`SDK/optixPathTracer/optixPathTracer.cu:249-320`, `include/optix_host.h:521`),
this engine runs the whole wavefront in lock-step: a `lax.fori_loop` over bounce
depth carrying a structure-of-arrays path state, with

  raygen  →  intersect (brute force / BVH traversal)  →  shade (branchless
  material select over the SoA material table = the SBT dispatch)  →  NEE
  shadow rays  →  sample next direction  →  Russian roulette,

all masked by an `active` lane predicate instead of thread divergence. The
payload registers of `optixTrace` (`include/optix_device.h:380-449`) become the
carried pytree; `MAX_TRACE_DEPTH` becomes the loop bound; ray types
(RADIANCE/OCCLUSION, `SDK/cuda/whitted.h:80-86`) become the closest-hit vs
any-hit intersector entry points.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..accel import bruteforce as bf
from .intersect import scene_any, scene_closest
from ..core import rng as _rng
from ..core.camera import generate_rays
from ..core.rays import Rays
from ..core.vecmath import cross, dot, normalize, reflect, refract
from ..shade import materials as mats
from ..shade.sampling import cosine_sample_hemisphere
from ..scene.device_scene import DeviceScene

# Shadow/secondary-ray epsilons, relative to the classic scene scale. The
# reference uses absolute 0.01/1e-4 epsilons at Cornell scale
# (`optixPathTracer.cu:394-400` traceOcclusion(tmin=0.01, tmax=dist-0.01)).
RAY_TMIN = 1e-2
SHADOW_TMAX_SCALE = 1.0 - 1e-3


def _pbr_brdf(n, wo, wi, albedo, metallic, roughness):
    """Metallic-roughness BRDF f(wo, wi): lambert·(1-metal) + GGX spec.

    The whitted PBR closest-hit model (`SDK/cuda/whitted.cu:170-260`) made
    integrable: Smith-Schlick GGX visibility, Schlick fresnel with
    f0 = lerp(0.04, albedo, metallic). Returns f [..., 3].
    """
    h = normalize(wo + wi)
    n_dl = jnp.maximum(dot(n, wi), 0.0)
    n_dv = jnp.maximum(dot(n, wo), 1e-4)
    n_dh = jnp.maximum(dot(n, h), 0.0)
    h_dv = jnp.maximum(dot(h, wo), 0.0)
    a = jnp.maximum(roughness, 0.05) ** 2
    a2 = a * a
    denom = n_dh * n_dh * (a2 - 1.0) + 1.0
    d_term = a2 / jnp.maximum(jnp.pi * denom * denom, 1e-8)
    k = (jnp.maximum(roughness, 0.05) + 1.0) ** 2 / 8.0
    g = (n_dv / (n_dv * (1 - k) + k)) * (n_dl / jnp.maximum(
        n_dl * (1 - k) + k, 1e-8))
    f0 = 0.04 * (1.0 - metallic)[..., None] + metallic[..., None] * albedo
    fres = f0 + (1.0 - f0) * (1.0 - h_dv)[..., None] ** 5
    spec = fres * (d_term * g / jnp.maximum(4.0 * n_dv * n_dl, 1e-8))[..., None]
    diff = albedo * (1.0 - metallic)[..., None] / jnp.pi
    return jnp.where((n_dl > 0)[..., None], diff + spec, 0.0)


def _pbr_pdf(n, wo, wi, roughness, p_spec):
    """One-sample-MIS pdf of the cosine⊕GGX mixture used to sample wi."""
    h = normalize(wo + wi)
    n_dl = jnp.maximum(dot(n, wi), 0.0)
    n_dh = jnp.maximum(dot(n, h), 0.0)
    h_dv = jnp.maximum(dot(h, wo), 1e-6)
    a = jnp.maximum(roughness, 0.05) ** 2
    a2 = a * a
    denom = n_dh * n_dh * (a2 - 1.0) + 1.0
    d_term = a2 / jnp.maximum(jnp.pi * denom * denom, 1e-8)
    pdf_ggx = d_term * n_dh / jnp.maximum(4.0 * h_dv, 1e-8)
    pdf_cos = n_dl / jnp.pi
    return p_spec * pdf_ggx + (1.0 - p_spec) * pdf_cos


def _nee_direct_light(scene: DeviceScene, hit_p, n, throughput_albedo, rng,
                      chunk_size, pbr=None, times=None, mask=None,
                      impl="auto"):
    """Next-event estimation against the parallelogram area light.

    Estimator matches the reference path tracer (`optixPathTracer.cu:375-409`):
    uniform point on the quad, weight = nDl * LnDl * A / (π d²), applied to the
    albedo-scaled throughput (implicitly the ρ/π lambert BRDF). When `pbr` is
    given (dict with albedo/metallic/roughness/wo/is_pbr/throughput), PBR
    lanes instead evaluate the full metallic-roughness BRDF toward the light.
    Returns (contribution [N,3], rng).
    """
    light = scene.area_light
    u1, u2, rng = _rng.uniform2(rng)
    lp = light.corner + u1[..., None] * light.v1 + u2[..., None] * light.v2
    delta = lp - hit_p
    dist2 = jnp.maximum(dot(delta, delta), 1e-12)
    dist = jnp.sqrt(dist2)
    wi = delta / dist[..., None]
    n_dl = dot(n, wi)
    ln_dl = jnp.abs(dot(jnp.broadcast_to(light.normal, wi.shape), wi))
    facing = n_dl > 0.0

    # Lanes whose contribution is masked out anyway (miss/dead/specular or
    # facing away) get an empty ray window: the brute-force kernel skips
    # ray blocks made only of such lanes, and BVH lanes finish at once.
    shadow_live = facing if mask is None else (facing & mask)
    shadow_rays = Rays(origin=hit_p, direction=wi,
                       tmin=jnp.full(dist.shape, RAY_TMIN, jnp.float32),
                       tmax=jnp.where(shadow_live,
                                      dist * SHADOW_TMAX_SCALE, 0.0))
    occluded = scene_any(scene, shadow_rays, chunk_size=chunk_size,
                         times=times, impl=impl)

    # Transmittance-weighted NEE: attenuate the shadow ray through the
    # participating medium (volume.cu:310 transmittance estimate).
    vol_t = 1.0
    if scene.has_volume:
        from ..accel import volume as vol
        tau_l = vol.optical_depth(scene.volume, hit_p, wi,
                                  jnp.zeros_like(dist), dist,
                                  scene.volume_params[0])
        vol_t = jnp.exp(-tau_l)

    weight = jnp.where(facing & ~occluded,
                       vol_t * n_dl * ln_dl * light.area / (jnp.pi * dist2),
                       0.0)
    contrib = throughput_albedo * light.emission * weight[..., None]
    if pbr is not None:
        # full-BRDF estimator: T · f(wo,wi) · nDl · LnDl · A / d²
        f = _pbr_brdf(n, pbr["wo"], wi, pbr["albedo"], pbr["metallic"],
                      pbr["roughness"])
        w2 = jnp.where(facing & ~occluded,
                       vol_t * n_dl * ln_dl * light.area / dist2, 0.0)
        contrib_pbr = pbr["throughput"] * f * light.emission * w2[..., None]
        contrib = jnp.where(pbr["is_pbr"][..., None], contrib_pbr, contrib)
    return contrib, rng


def trace_paths(scene: DeviceScene, rays: Rays, rng, max_depth: int = 4,
                chunk_size: Optional[int] = 65536, pixel_spread=0.0,
                active0=None, impl: str = "auto"):
    """Integrate radiance along a wavefront of camera rays → [N, 3].

    The per-pixel bounce loop of `optixPathTracer.cu:281-304`, restructured as
    a lock-step loop over the whole wavefront. Supports DIFFUSE/EMISSIVE (NEE +
    cosine BSDF), PBR (diffuse + mirror blend by metallic), GLASS
    (fresnel-weighted reflect/refract), PHONG/CHECKER (treated as diffuse with
    their diffuse color) — branchless selects, since a wavefront carries few
    distinct kinds.

    impl: "auto" (the traversal `intersect.traversal` picks) or "xla"
    (brute force through the plain XLA intersector, never a hand-written
    kernel). Returns (radiance [N, 3], rng [N], rays_traced).
    """
    n_rays = rays.tmin.shape[0]
    if scene.has_motion:
        # One shutter time per path (optixSimpleMotionBlur: rays carry a
        # random time; every segment of the path shares it).
        path_time, _, rng = _rng.uniform2(rng)
    else:
        path_time = jnp.zeros((n_rays,), jnp.float32)
    if active0 is None:
        active0 = jnp.ones((n_rays,), bool)
    else:
        # Lanes dead on arrival (e.g. strip-padding rows past the frame,
        # render_sample_group): empty ray window so the traversal skips
        # them, excluded from radiance and ray accounting.
        rays = rays.replace(tmax=jnp.where(active0, rays.tmax, 0.0))
    state = dict(
        rays=rays,
        time=path_time,
        throughput=jnp.ones((n_rays, 3), jnp.float32),
        radiance=jnp.zeros((n_rays, 3), jnp.float32),
        rng=rng,
        active=active0,
        prev_specular=jnp.ones((n_rays,), bool),  # depth-0 emission counts
        # Accumulated path length: with pixel_spread it gives the ray-cone
        # width for mip selection (cone = spread * distance).
        path_len=jnp.zeros((n_rays,), jnp.float32),
        # Rays actually traced (closest-hit + shadow), for Mrays/s accounting —
        # the reference's per-launch ray count is w*h*spl*(bounces+shadows).
        rays_traced=jnp.zeros((), jnp.float32),
    )

    def bounce(depth, state):
        rays = state["rays"]
        active = state["active"]
        throughput = state["throughput"]
        radiance = state["radiance"]
        rng = state["rng"]

        hits = scene_closest(scene, rays, chunk_size=chunk_size,
                             times=state["time"], impl=impl)
        hit_valid = hits.valid & active

        # --- participating medium along this segment (volume.cu:284-366):
        # distance-sampled single scattering toward the area light, with
        # REAL occlusion — one stochastic scatter point per segment (pdf ∝
        # sigma_t·T, so camera-side transmittance cancels), then an
        # area-light NEE shadow ray from it through geometry AND volume.
        if scene.has_volume:
            from ..accel import volume as vol
            sigma_t = scene.volume_params[0]
            v_albedo = scene.volume_params[1]
            seg_far = jnp.where(hits.valid, hits.t, rays.tmax)
            u_s, u_l1, rng = _rng.uniform2(rng)
            u_l2, _, rng = _rng.uniform2(rng)
            t_s, w_s, tau = vol.sample_scatter(
                scene.volume, rays.origin, rays.direction, rays.tmin,
                seg_far, sigma_t, u_s)
            light = scene.area_light
            p_s = rays.origin + t_s[..., None] * rays.direction
            lp = (light.corner + u_l1[..., None] * light.v1
                  + u_l2[..., None] * light.v2)
            delta = lp - p_s
            dist2 = jnp.maximum(dot(delta, delta), 1e-12)
            dist = jnp.sqrt(dist2)
            wi_s = delta / dist[..., None]
            ln_dl = jnp.abs(dot(jnp.broadcast_to(light.normal, wi_s.shape),
                                wi_s))
            scatter_live = active & (w_s > 1e-6)
            vol_shadow = Rays(
                origin=p_s, direction=wi_s,
                tmin=jnp.full(dist.shape, RAY_TMIN, jnp.float32),
                tmax=jnp.where(scatter_live, dist * SHADOW_TMAX_SCALE, 0.0))
            occ_s = scene_any(scene, vol_shadow, chunk_size=chunk_size,
                              times=state["time"], impl=impl)
            tau_l = vol.optical_depth(scene.volume, p_s, wi_s,
                                      jnp.zeros_like(dist), dist, sigma_t)
            li = (light.emission * (ln_dl * light.area / dist2)[..., None]
                  * jnp.exp(-tau_l)[..., None])
            inscatter = (w_s * v_albedo / (4.0 * jnp.pi))[..., None] * li
            radiance = radiance + jnp.where(
                (scatter_live & ~occ_s)[..., None],
                throughput * inscatter, 0.0)
            throughput = throughput * jnp.exp(-tau)[..., None]

        # --- miss program: constant background (whitted.cu:139-147) ---
        radiance = radiance + jnp.where(
            (active & ~hits.valid)[..., None],
            throughput * scene.miss_color, 0.0)

        # --- closest-hit: surface attributes come straight from the
        # intersector (no gathers); material params via the small-table gather.
        m = mats.gather(scene.materials, hits.mat_id)

        d = rays.direction
        # Two-sided shading normal (faceforward(N, -D, N),
        # optixPathTracer.cu:341).
        geom_n = hits.normal
        albedo_tex = None
        tex_alpha = None
        surf_uv = hits.uv
        if scene.has_textures or scene.has_cutouts or scene.geom.smooth:
            # Smooth-mesh path: interpolate vertex normals/uv; sample the
            # base-color texture when present (whitted.cu:160-168).
            # Custom-prim hits keep the analytic normal/uv.
            from ..accel.geometry import shading_frame
            is_tri = hits.prim_id < scene.num_triangles
            frame = shading_frame(scene.geom,
                                  jnp.minimum(jnp.maximum(hits.prim_id, 0),
                                              scene.num_triangles - 1),
                                  hits.uv)
            if not scene.has_instances:
                geom_n = jnp.where(is_tri[..., None],
                                   frame["shading_normal"], geom_n)
            elif scene.instances.row_ids:
                # Instanced hits: corner normals live in object space —
                # apply the hit instance's normal transform (the device
                # transform-stack role, optix_device.h:728-868). inst_id
                # == table row for default-constructed tables. Row form
                # w = n @ L^-1 over the gathered inverse linear parts —
                # never invert per hit (a [N,3,3] LU OOMs at 2M rays).
                rinv = scene.instances.inv_transform[
                    jnp.maximum(hits.inst_id, 0)][..., :, :3]
                n_w = jnp.einsum("...j,...jk->...k",
                                 frame["shading_normal"], rinv,
                                 precision=jax.lax.Precision.HIGHEST)
                n_w = n_w / jnp.maximum(
                    jnp.linalg.norm(n_w, axis=-1, keepdims=True), 1e-12)
                geom_n = jnp.where((is_tri & (hits.inst_id >= 0))[..., None],
                                   n_w, geom_n)
            surf_uv = jnp.where(is_tri[..., None], frame["uv"], hits.uv)
            if scene.has_textures:
                from ..shade.texture import sample_bundle
                pid = jnp.minimum(jnp.maximum(hits.prim_id, 0),
                                  scene.num_triangles - 1)
                # Ray-cone mip LOD: footprint = spread * total path length,
                # converted to texels by the triangle's uv density.
                cone = pixel_spread * (state["path_len"]
                                       + jnp.where(hit_valid, hits.t, 0.0))
                texel_scale = jnp.where(
                    is_tri, cone * frame["uv_density"], 0.0)

                # One gather per mip level fetches the whole material
                # texture set (base/normal/emissive/mr bundled in
                # channels) instead of per-map trilinear fetches.
                b16 = sample_bundle(scene.bundles, scene.bundle_mip,
                                    jnp.where(is_tri, m["bundle"], -1),
                                    surf_uv, texel_scale=texel_scale,
                                    quads=scene.bundle_quads,
                                    quad_base=scene.bundle_quad_base)
                rgba = b16[..., 0:4]
                albedo_tex = jnp.where(
                    (is_tri & (m["base_tex"] >= 0))[..., None],
                    rgba[..., :3], 1.0)
                tex_alpha = jnp.where(is_tri & (m["base_tex"] >= 0),
                                      rgba[..., 3], 1.0)
                # metallic-roughness map (glTF packing: G=rough, B=metal,
                # MaterialData.h:84-90 use in whitted.cu:213-224)
                has_mr = is_tri & (m["mr_tex"] >= 0)
                m["roughness"] = jnp.where(has_mr,
                                           m["roughness"] * b16[..., 10],
                                           m["roughness"])
                m["metallic"] = jnp.where(has_mr,
                                          m["metallic"] * b16[..., 11],
                                          m["metallic"])
                # emissive map (MaterialData.h:99-103)
                has_em = is_tri & (m["emissive_tex"] >= 0)
                m["emission"] = jnp.where(has_em[..., None],
                                          m["emission"] * b16[..., 7:10],
                                          m["emission"])
                # tangent-space normal map (MaterialData.h:62-73): TBN from
                # the uv-aligned per-triangle tangent, Gram-Schmidt against
                # the interpolated shading normal.
                has_nm = is_tri & (m["normal_tex"] >= 0)
                nm = b16[..., 4:7] * 2.0 - 1.0
                tan = frame["tangent"]
                t_ = tan - geom_n * dot(tan, geom_n)[..., None]
                t_ = t_ / jnp.maximum(
                    jnp.linalg.norm(t_, axis=-1, keepdims=True), 1e-8)
                b_ = cross(geom_n, t_)
                n_mapped = normalize(t_ * nm[..., 0:1] + b_ * nm[..., 1:2]
                                     + geom_n * nm[..., 2:3])
                geom_n = jnp.where(has_nm[..., None], n_mapped, geom_n)
        n = geom_n * jnp.sign(-dot(geom_n, d))[..., None]
        hit_p = rays.at(hits.t)

        # --- anyhit alpha cutouts (optixCutouts.cu:295,337) ---
        # A masked-out hit is a pass-through: the ray continues unshaded, as
        # if the anyhit program had called optixIgnoreIntersection().
        is_cut = jnp.zeros_like(hit_valid)
        if scene.has_cutouts:
            from ..shade.materials import CUT_CHECKER, CUT_CIRCLE, CUT_TEXTURE
            if scene.omm_all_certain:
                # Micromap states decide every pass-through: the radiance
                # anyhit lookup collapses to one per-triangle summary
                # fetch and the mask (checker math / texture alpha) is
                # never evaluated — the radiance-ray side of the driver
                # skipping anyhit programs for certain micro-triangles
                # (`optixOpacityMicromap.cpp:29-30`).
                from ..accel.micromap import TRANSPARENT
                pid = jnp.clip(hits.prim_id, 0,
                               scene.omm_summary.shape[0] - 1)
                hole = scene.omm_summary[pid] == TRANSPARENT
            else:
                fu = surf_uv * m["checker_scale"][..., None]
                cell = fu - jnp.floor(fu) - 0.5
                checker_hole = jnp.mod(jnp.floor(fu[..., 0])
                                       + jnp.floor(fu[..., 1]), 2.0) < 1.0
                circle_hole = (cell[..., 0] ** 2
                               + cell[..., 1] ** 2) < 0.25 ** 2
                alpha = (tex_alpha if tex_alpha is not None
                         else jnp.ones_like(hits.t))
                tex_hole = alpha < m["alpha_cutoff"]
                cut_kind = m["cutout"]
                hole = jnp.where(cut_kind == CUT_CHECKER, checker_hole,
                                 jnp.where(cut_kind == CUT_CIRCLE,
                                           circle_hole,
                                           jnp.where(cut_kind == CUT_TEXTURE,
                                                     tex_hole, False)))
                if scene.has_omm:
                    # Mixed scene: certain summaries / micro-states
                    # override the mask result (bit-identical by
                    # construction — states are derived from these same
                    # masks at build time, accel/micromap.py). Prim and
                    # motion hits are unaffected: their materials are
                    # cutout-free by the build-time OMM gate, so
                    # alpha_mode != 1 keeps is_cut False below.
                    from ..accel.micromap import (OPAQUE, TRANSPARENT,
                                                  micro_index)
                    pid = jnp.clip(hits.prim_id, 0,
                                   scene.omm_summary.shape[0] - 1)
                    summ = scene.omm_summary[pid]
                    mid = micro_index(hits.uv[..., 0], hits.uv[..., 1],
                                      scene.omm_level)
                    st = jnp.take_along_axis(
                        scene.omm_micro[pid], mid[..., None],
                        axis=-1)[..., 0]
                    hole = jnp.where(
                        summ == TRANSPARENT, True,
                        jnp.where(summ == OPAQUE, False,
                                  jnp.where(st == TRANSPARENT, True,
                                            jnp.where(st == OPAQUE, False,
                                                      hole))))
            is_cut = hit_valid & (m["alpha_mode"] == 1) & hole
            hit_valid = hit_valid & ~is_cut

        # Emission: counted only when the previous bounce was specular (or the
        # primary ray) — NEE covers diffuse-seen emitters.
        take_emission = hit_valid & state["prev_specular"]
        radiance = radiance + jnp.where(
            take_emission[..., None], throughput * m["emission"], 0.0)

        kind = m["kind"]
        albedo = m["base_color"]
        if albedo_tex is not None:
            albedo = albedo * albedo_tex
        is_glass = kind == mats.GLASS
        # perfect mirror = fully metallic AND polished; everything else PBR
        # goes through the GGX importance-sampled path
        is_mirror = ((kind == mats.PBR) & (m["metallic"] > 0.99)
                     & (m["roughness"] <= 0.05))
        is_pbr = (kind == mats.PBR) & ~is_mirror
        is_specular = is_glass | is_mirror
        is_diffuse = ~is_specular

        # --- NEE direct lighting for diffuse/PBR lanes ---
        # diffuse lanes: f = ρ/π (the estimator folds ρ into throughput and
        # π into the weight, optixPathTracer.cu:375-409). PBR lanes swap in
        # the metallic-roughness BRDF (kd(1-metal)/π + GGX spec).
        t_albedo = throughput * albedo
        contrib, rng = _nee_direct_light(
            scene, hit_p, n, t_albedo, rng, chunk_size,
            pbr=(dict(albedo=albedo, metallic=m["metallic"],
                      roughness=m["roughness"], wo=-d, is_pbr=is_pbr,
                      throughput=throughput) if scene.has_pbr else None),
            times=state["time"], mask=hit_valid & is_diffuse, impl=impl)
        radiance = radiance + jnp.where((hit_valid & is_diffuse)[..., None],
                                        contrib, 0.0)

        # --- sample next direction ---
        u1, u2, rng = _rng.uniform2(rng)
        d_diffuse = cosine_sample_hemisphere(u1, u2, n)
        d_mirror = normalize(reflect(d, n))

        pbr_throughput = None
        if scene.has_pbr:
            # One-sample MIS between the cosine and GGX lobes (PBR lanes).
            from ..shade.sampling import ggx_sample_half_vector
            rough = jnp.maximum(m["roughness"], 0.05)
            metal = m["metallic"]
            u5p, u6p, rng = _rng.uniform2(rng)
            h_vec = ggx_sample_half_vector(u5p, u6p, n, rough)
            d_ggx = normalize(reflect(d, h_vec))
            p_spec = jnp.clip(0.5 * metal + 0.1, 0.05, 0.95)
            u7p, _, rng = _rng.uniform2(rng)
            choose_spec = u7p < p_spec
            d_pbr = jnp.where(choose_spec[..., None], d_ggx, d_diffuse)
            f_pbr = _pbr_brdf(n, -d, d_pbr, albedo, metal, rough)
            pdf_pbr = _pbr_pdf(n, -d, d_pbr, rough, p_spec)
            n_dl_pbr = jnp.maximum(dot(n, d_pbr), 0.0)
            valid_dir = (n_dl_pbr > 1e-5) & (pdf_pbr > 1e-7)
            w_pbr = jnp.where(valid_dir[..., None],
                              f_pbr * (n_dl_pbr / jnp.maximum(pdf_pbr,
                                                              1e-7))[..., None],
                              0.0)
            pbr_throughput = throughput * w_pbr
            d_diffuse = jnp.where(is_pbr[..., None], d_pbr, d_diffuse)

        # Glass: fresnel (Schlick) choose reflect/refract
        entering = dot(d, geom_n) < 0.0
        eta = jnp.where(entering, 1.0 / m["ior"], m["ior"])
        d_refr, refr_ok = refract(d, n, eta)
        cos_i = jnp.clip(-dot(d, n), 0.0, 1.0)
        r0 = ((m["ior"] - 1.0) / (m["ior"] + 1.0)) ** 2
        fresnel = r0 + (1.0 - r0) * (1.0 - cos_i) ** 5
        u3, _u4, rng = _rng.uniform2(rng)
        glass_reflect = (~refr_ok) | (u3 < fresnel)
        d_glass = jnp.where(glass_reflect[..., None], d_mirror, normalize(d_refr))

        new_dir = jnp.where(is_glass[..., None], d_glass,
                            jnp.where(is_mirror[..., None], d_mirror, d_diffuse))

        # Throughput update: diffuse cosine-sampled → *albedo
        # (f·cos/pdf = ρ, optixPathTracer.cu:366-373); mirror/glass → tint.
        spec_tint = jnp.where(jnp.any(m["kr"] > 0.0, axis=-1, keepdims=True),
                              m["kr"], albedo)
        new_throughput = jnp.where(is_specular[..., None],
                                   throughput * spec_tint,
                                   t_albedo)
        if pbr_throughput is not None:
            new_throughput = jnp.where(is_pbr[..., None], pbr_throughput,
                                       new_throughput)

        # Cut lanes pass straight through: same direction, same throughput,
        # origin nudged past the surface (optixIgnoreIntersection semantics).
        if scene.has_cutouts:
            new_dir = jnp.where(is_cut[..., None], d, new_dir)
            new_throughput = jnp.where(is_cut[..., None], throughput,
                                       new_throughput)

        # Offset along the outgoing side to avoid self-intersection.
        offset_n = jnp.where(dot(new_dir, n)[..., None] >= 0.0, n, -n)
        if scene.has_cutouts:
            offset_n = jnp.where(is_cut[..., None], d, offset_n)
        new_rays = Rays(origin=hit_p + offset_n * RAY_TMIN,
                        direction=new_dir,
                        tmin=jnp.full(hits.t.shape, RAY_TMIN, jnp.float32),
                        # Dead lanes (miss/terminated) get an empty window
                        # (set below), so later bounces skip them.
                        tmax=jnp.full(hits.t.shape, 1e16, jnp.float32))

        # --- Russian roulette (optixPathTracer.cu:294-298) after depth 1 ---
        u5, _, rng = _rng.uniform2(rng)
        q = jnp.clip(jnp.max(new_throughput, axis=-1), 0.05, 1.0)
        do_rr = depth >= 1
        survive = jnp.where(do_rr, u5 < q, True)
        if scene.has_cutouts:
            survive = survive | is_cut   # pass-throughs are never terminated
            q = jnp.where(is_cut, 1.0, q)
        new_throughput = jnp.where(do_rr,
                                   new_throughput / q[..., None], new_throughput)

        rays_traced = (state["rays_traced"]
                       + jnp.sum(active.astype(jnp.float32))
                       + jnp.sum((hit_valid & is_diffuse).astype(jnp.float32)))

        new_active = hit_valid & survive
        prev_spec_next = is_specular
        if scene.has_cutouts:
            new_active = (hit_valid | is_cut) & survive
            prev_spec_next = jnp.where(is_cut, state["prev_specular"],
                                       is_specular)
        new_rays = new_rays.replace(
            tmax=jnp.where(new_active, new_rays.tmax, 0.0))

        return dict(
            rays=new_rays,
            time=state["time"],
            throughput=new_throughput,
            radiance=radiance,
            rng=rng,
            active=new_active,
            prev_specular=prev_spec_next,
            path_len=state["path_len"] + jnp.where(hit_valid, hits.t, 0.0),
            rays_traced=rays_traced,
        )

    state = jax.lax.fori_loop(0, max_depth, bounce, state)
    return state["radiance"], state["rng"], state["rays_traced"]


def render_sample(scene: DeviceScene, cam_params, width: int, height: int,
                  subframe, max_depth: int = 4,
                  chunk_size: Optional[int] = 65536,
                  y0=0, full_width=None, full_height=None, y_stride=1,
                  impl: str = "auto"):
    """One progressive sample for a [height, width] pixel tile → radiance.

    The `launchSubframe` body (`optixPathTracer.cpp:488-511`): seed per-pixel
    RNG from (global pixel index, subframe), jittered raygen, full path trace.
    With (y0, full_*) set, renders a row-tile of a larger frame — the
    per-device launch of the multi-GPU path (`optixMultiGPU.cpp:562-594`).
    """
    n = width * height
    full_w = width if full_width is None else full_width
    # Global pixel index keeps RNG streams identical no matter how the frame
    # is tiled across chips (idx.y*w + idx.x, optixPathTracer.cu:258).
    gy = (jnp.arange(height, dtype=jnp.uint32)[:, None] * jnp.uint32(y_stride)
          + jnp.uint32(y0))
    gx = jnp.arange(width, dtype=jnp.uint32)[None, :]
    pixel_idx = (gy * jnp.uint32(full_w) + gx).reshape(n)
    rng = _rng.seed(pixel_idx, jnp.asarray(subframe, jnp.uint32))
    rng2d = rng.reshape(height, width)
    rays, rng2d = generate_rays(cam_params, width, height, rng_state=rng2d,
                                y0=y0, full_width=full_width,
                                full_height=full_height, y_stride=y_stride)
    rays = jax.tree.map(
        lambda a: a.reshape((n,) + a.shape[2:]), rays)
    # Pixel cone spread for ray-cone mip selection: vertical NDC spans
    # 2|V| over full_h pixels of |W| focal length.
    full_h = height if full_height is None else full_height
    pixel_spread = (2.0 * jnp.linalg.norm(cam_params["V"])
                    / (full_h * jnp.maximum(
                        jnp.linalg.norm(cam_params["W"]), 1e-8)))
    radiance, _, rays_traced = trace_paths(scene, rays, rng2d.reshape(n),
                                           max_depth=max_depth,
                                           chunk_size=chunk_size,
                                           pixel_spread=pixel_spread,
                                           impl=impl)
    return radiance.reshape(height, width, 3), rays_traced


def render_sample_group(scene: DeviceScene, cam_params, width: int,
                        height: int, subframe, spl: int, max_depth: int = 4,
                        chunk_size: Optional[int] = 65536,
                        y0=0, full_width=None, full_height=None,
                        impl: str = "auto"):
    """`spl` progressive samples for a [height, width] tile traced as ONE
    sample-major wavefront → (radiance SUM [h, w, 3], rays_traced).

    Lane layout is pixel-major x sample-minor: ray p*spl + s is sample s
    of pixel p, seeded `seed(pixel_idx, subframe + s)` — the exact RNG
    streams the sequential `render_sample` loop consumes, so the summed
    radiance matches it (same estimator, optixPathTracer.cu:306-319).
    Neighbouring lanes then share their bounce-1 origin and their NEE
    light direction, which keeps a block of rays on nearby geometry.
    """
    n = width * height
    full_w = width if full_width is None else full_width
    gy = jnp.arange(height, dtype=jnp.uint32)[:, None] + jnp.uint32(y0)
    gx = jnp.arange(width, dtype=jnp.uint32)[None, :]
    pixel_idx = gy * jnp.uint32(full_w) + gx                      # [h, w]
    sub = (jnp.asarray(subframe, jnp.uint32)
           + jnp.arange(spl, dtype=jnp.uint32)[:, None, None])    # [spl,1,1]
    rng = _rng.seed(pixel_idx[None], sub)                         # [spl,h,w]
    rays, rng = generate_rays(cam_params, width, height, rng_state=rng,
                              y0=y0, full_width=full_width,
                              full_height=full_height)

    def to_flat(a):
        return jnp.moveaxis(a, 0, 2).reshape((n * spl,) + a.shape[3:])

    rays = jax.tree.map(to_flat, rays)
    full_h = height if full_height is None else full_height
    pixel_spread = (2.0 * jnp.linalg.norm(cam_params["V"])
                    / (full_h * jnp.maximum(
                        jnp.linalg.norm(cam_params["W"]), 1e-8)))
    # Strip-padding rows past the frame bottom are dead on arrival: they
    # must not trace (nor count as traced rays).
    in_frame = to_flat(jnp.broadcast_to((gy < jnp.uint32(full_h))[None, :, :],
                                        (spl, height, width)))
    radiance, _, rays_traced = trace_paths(
        scene, rays, to_flat(rng), max_depth=max_depth,
        chunk_size=chunk_size, pixel_spread=pixel_spread,
        active0=in_frame, impl=impl)
    return radiance.reshape(height, width, spl, 3).sum(axis=2), rays_traced


# Rays per sample-major strip launch: bounds the live wavefront state (a
# full 1080p frame x 16 samples would otherwise be a 33M-ray state, ~4 GB
# of device memory per column set).
_SPL_TILE_RAYS = 4 * 1024 * 1024

IMPLS = ("auto", "xla", "spl")


def _merge_launch(film, rad_sum, samples_per_launch):
    """Merge one launch's radiance SUM into the film: progressive-mean
    accumulation plus ONE per-launch variance-tracker estimate — the
    single statistics convention of every launch path (a checkpoint
    written by one resumes correctly on another)."""
    from ..core.film import Film
    prev_n = film.subframe.astype(jnp.float32)
    new_n = jnp.float32(samples_per_launch)
    accum = (film.accum * prev_n + rad_sum) / (prev_n + new_n)
    sq, launches = film.sq, film.launches
    if sq is not None:
        est = rad_sum / new_n
        tl = 1.0 / (launches.astype(jnp.float32) + 1.0)
        sq = sq + (est * est - sq) * tl
        launches = launches + 1
    return Film(accum=accum, subframe=film.subframe + samples_per_launch,
                sq=sq, launches=launches)


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "samples_per_launch",
                                    "max_depth", "chunk_size", "full_width",
                                    "full_height", "impl"))
def render_accumulate(scene: DeviceScene, cam_params, film, width: int,
                      height: int, samples_per_launch: int = 1,
                      max_depth: int = 4,
                      chunk_size: Optional[int] = 65536,
                      y0=0, full_width=None, full_height=None,
                      impl: str = "auto"):
    """Progressive render step: adds `samples_per_launch` samples to the film.

    The full launchSubframe + accumulation-lerp pipeline
    (`optixPathTracer.cu:306-319`) as one XLA executable. Returns
    (film, rays_traced) — the ray count feeds the Mrays/s benchmark.

    impl: "auto" runs the XLA wavefront with the traversal that
    `intersect.traversal` picks (the fused brute-force kernel on a GPU);
    "xla" keeps every intersection in plain XLA (the reference the kernels
    are measured against); "spl" traces sample-major strips
    (render_sample_group). All three consume identical RNG streams.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    trace_impl = "xla" if impl == "xla" else "auto"
    if impl == "spl":
        # Sample-major launches: trace all spl samples of a row-strip as
        # one pixel-grouped wavefront (render_sample_group), strip by
        # strip so the live wavefront stays ~_SPL_TILE_RAYS. Same RNG
        # streams and estimator as the per-sample loop below.
        rows = min(height, max(1, _SPL_TILE_RAYS
                               // max(width * samples_per_launch, 1)))
        n_strips = -(-height // rows)
        h_pad = n_strips * rows

        def strip(i, carry):
            rad, cnt = carry
            r, c = render_sample_group(
                scene, cam_params, width, rows, film.subframe,
                samples_per_launch, max_depth=max_depth,
                chunk_size=chunk_size, y0=y0 + i * rows,
                full_width=full_width if full_width is not None else width,
                full_height=(full_height if full_height is not None
                             else height),
                impl=trace_impl)
            return (jax.lax.dynamic_update_slice(rad, r, (i * rows, 0, 0)),
                    cnt + c)

        rad_sum, count = jax.lax.fori_loop(
            0, n_strips, strip,
            (jnp.zeros((h_pad, width, 3), jnp.float32),
             jnp.zeros((), jnp.float32)))
        return (_merge_launch(film, rad_sum[:height], samples_per_launch),
                count)

    def body(i, carry):
        rad_sum, count = carry
        radiance, rays_traced = render_sample(
            scene, cam_params, width, height, film.subframe + i,
            max_depth=max_depth, chunk_size=chunk_size, y0=y0,
            full_width=full_width, full_height=full_height,
            impl=trace_impl)
        return rad_sum + radiance, count + rays_traced

    rad_sum, count = jax.lax.fori_loop(
        0, samples_per_launch,
        body, (jnp.zeros_like(film.accum), jnp.zeros((), jnp.float32)))
    return _merge_launch(film, rad_sum, samples_per_launch), count


@functools.partial(jax.jit, static_argnames=("width", "height", "chunk_size"))
def render_aovs(scene: DeviceScene, cam_params, width: int, height: int,
                chunk_size: Optional[int] = None):
    """Primary-hit AOV layers for the denoiser: albedo + shading normal.

    The guide layers the reference feeds `optixDenoiserInvoke`
    (`OptixDenoiserGuideLayer` albedo/normal; produced by dedicated AOV
    passes in `SDK/optixDenoiser`). One centered, unjittered camera ray per
    pixel. Returns dict(albedo [H,W,3], normal [H,W,3]).
    """
    rays, _ = generate_rays(cam_params, width, height, jitter=False)
    n = width * height
    rays = jax.tree.map(lambda a: a.reshape((n,) + a.shape[2:]), rays)
    hits = scene_closest(scene, rays, chunk_size=chunk_size)
    m = mats.gather(scene.materials, hits.mat_id)
    albedo = jnp.where(hits.valid[:, None], m["base_color"], 1.0)
    if scene.has_textures:
        from ..accel.geometry import shading_frame
        from ..shade.texture import sample_bilinear
        is_tri = hits.prim_id < scene.num_triangles
        frame = shading_frame(scene.geom,
                              jnp.minimum(jnp.maximum(hits.prim_id, 0),
                                          scene.num_triangles - 1), hits.uv)
        rgba = sample_bilinear(scene.textures, scene.tex_size,
                               jnp.where(is_tri, m["base_tex"], -1),
                               frame["uv"])
        albedo = albedo * rgba[..., :3]
    normal = hits.normal
    if scene.geom.smooth and not scene.has_instances:
        from ..accel.geometry import shading_frame
        is_tri = hits.prim_id < scene.num_triangles
        frame = shading_frame(scene.geom,
                              jnp.minimum(jnp.maximum(hits.prim_id, 0),
                                          scene.num_triangles - 1),
                              hits.uv)
        normal = jnp.where(is_tri[:, None], frame["shading_normal"], normal)
    normal = jnp.where(hits.valid[:, None], normal, -rays.direction)
    # Primary-hit emission: noise-free direct-emitter radiance (matches the
    # engine's depth-0 emission term exactly — throughput 1, prev_specular
    # 1). The denoiser subtracts it before filtering and adds it back, so
    # the predicted kernels never have to preserve an emitter's hard edge.
    emission = jnp.where(hits.valid[:, None], m["emission"], 0.0)
    return {"albedo": albedo.reshape(height, width, 3),
            "normal": normal.reshape(height, width, 3),
            "emission": emission.reshape(height, width, 3)}
