"""Scene-level intersection: triangles + custom primitives, merged.

The dispatch role of the reference's two-level traversal + SBT: a scene's GAS
set (triangle meshes and custom-primitive AABB inputs,
`SDK/optixWhitted/optixWhitted.cpp:381-430`) resolves to one closest hit. Ids
stay disjoint: custom prim i reports prim_id = num_triangles + i.
"""
from __future__ import annotations

from typing import Optional

import jax

from ..accel import bruteforce as bf
from ..accel import primitives as prim_mod
from ..accel import traverse as trav
from ..core.rays import Hits, Rays
from ..scene.device_scene import DeviceScene


def traversal(scene: DeviceScene, impl: str = "auto",
              platform: Optional[str] = None) -> str:
    """The one place that decides how a scene's triangles are traversed.

    Returns "instances" (the IAS loop of accel/tlas.py), "bvh" (the
    threaded BVH of accel/traverse.py, for meshes past the brute-force
    limit) or a brute-force implementation from `bf.choose_impl`:
    "pallas" (the fused GPU kernel), "xla" or "pallas_interpret".
    `impl` forces the brute-force implementation ("xla" = the plain XLA
    reference everywhere); `platform` defaults to JAX's default backend.
    """
    if scene.has_instances:
        return "instances"
    if scene.has_bvh and scene.num_triangles > bf.BRUTE_FORCE_MAX_TRIS:
        return "bvh"
    return bf.choose_impl(scene.num_triangles, impl, platform)


def _flat_call(fn, rays: Rays):
    """Run a flat-[N]-only intersector over rays of any batch shape."""
    batch_shape = rays.batch_shape
    n = 1
    for s in batch_shape:
        n *= s
    flat = jax.tree.map(
        lambda a: a.reshape((n,) + a.shape[len(batch_shape):]), rays)
    out = fn(flat)
    return jax.tree.map(
        lambda a: a.reshape(batch_shape + a.shape[1:]), out)


def _merge_motion_closest(scene: DeviceScene, hits: Hits, rays: Rays,
                          times):
    """Fold time-sampled motion-triangle hits into the static result.

    Motion prim ids live past triangles AND custom prims; material ids come
    from the motion mesh's own table (`optixSimpleMotionBlur` motion GAS in
    the standard launch)."""
    import jax.numpy as jnp
    from ..accel import motion as motion_mod

    if times is None:
        times = jnp.zeros(rays.tmin.shape, jnp.float32)
    mh = motion_mod.intersect_motion_triangles(scene.motion_geom, rays,
                                               times)
    mat = scene.motion_tri_mat[jnp.maximum(mh.prim_id, 0)]
    mh = mh.replace(mat_id=jnp.where(mh.valid, mat, -1))
    return prim_mod.merge_hits(
        hits, mh, prim_offset=scene.num_triangles + scene.prims.num)


def _motion_any(scene: DeviceScene, rays: Rays, times):
    import jax.numpy as jnp
    from ..accel import motion as motion_mod

    tt = (times if times is not None
          else jnp.zeros(rays.tmin.shape, jnp.float32))
    return motion_mod.intersect_motion_triangles(scene.motion_geom, rays,
                                                 tt).valid


def scene_closest(scene: DeviceScene, rays: Rays,
                  chunk_size: Optional[int] = None, times=None,
                  impl: str = "auto") -> Hits:
    """Closest hit over the scene's triangles, custom prims and motion
    triangles. `impl` forces the brute-force implementation (see
    `traversal`)."""
    how = traversal(scene, impl)
    if how == "instances":
        from ..accel import tlas
        hits = _flat_call(
            lambda r: tlas.intersect_instances(
                scene.geom, scene.instances, r, tri_mat=scene.tri_mat,
                chunk_size=chunk_size, impl=impl), rays)
    elif how == "bvh":
        # Chunked: fixed-size chunks bound the lock-step while_loop's live
        # state and the slowest ray's hold on the rest of the wavefront.
        hits = _flat_call(
            lambda r: bf._chunked(
                lambda c: trav.traverse(scene.bvh, scene.geom,
                                        scene.tri_mat, c),
                r, chunk_size), rays)
    else:
        hits = bf.intersect_closest(scene.geom, rays, tri_mat=scene.tri_mat,
                                    chunk_size=chunk_size, impl=how)
    if scene.prims.num:
        ph = prim_mod.intersect_prims_closest(scene.prims, rays)
        hits = prim_mod.merge_hits(hits, ph,
                                   prim_offset=scene.num_triangles)
    if scene.has_motion:
        hits = _merge_motion_closest(scene, hits, rays, times)
    return hits


def scene_any(scene: DeviceScene, rays: Rays,
              chunk_size: Optional[int] = None, times=None,
              impl: str = "auto"):
    """Occlusion (terminate-on-first-hit) over the whole scene → bool."""
    if scene.has_cutouts:
        # has_omm is only set at build time when the scene qualifies (no
        # instances; prim/motion materials cutout-free — device_scene.py).
        if scene.has_omm:
            return _scene_any_alpha_omm(scene, rays, chunk_size,
                                        times=times, impl=impl)
        return _scene_any_alpha(scene, rays, chunk_size, impl=impl)
    how = traversal(scene, impl)
    if how == "instances":
        from ..accel import tlas
        occ = _flat_call(
            lambda r: tlas.intersect_instances_any(
                scene.geom, scene.instances, r, chunk_size=chunk_size,
                impl=impl),
            rays)
    elif how == "bvh":
        occ = _flat_call(
            lambda r: bf._chunked(
                lambda c: trav.traverse(scene.bvh, scene.geom, None, c,
                                        any_hit=True),
                r, chunk_size), rays)
    else:
        occ = bf.intersect_any(scene.geom, rays, chunk_size=chunk_size,
                               impl=how)
    if scene.prims.num:
        occ = occ | prim_mod.intersect_prims_any(scene.prims, rays)
    if scene.has_motion:
        occ = occ | _motion_any(scene, rays, times)
    return occ


def _eval_hole(scene: DeviceScene, m, uv, tex_ok=True):
    """Alpha-mask hole test for gathered material rows `m` at texture
    coordinates `uv` — the anyhit `optixIgnoreIntersection` decision
    (`optixCutouts.cu:295,337`). tex_ok=False disables the CUT_TEXTURE
    branch (callers whose uv is not a real texture coordinate)."""
    import jax.numpy as jnp
    from ..shade.materials import CUT_CHECKER, CUT_CIRCLE, CUT_TEXTURE
    from ..shade.texture import sample_bilinear

    fu = uv * m["checker_scale"][..., None]
    cell = fu - jnp.floor(fu) - 0.5
    checker_hole = jnp.mod(jnp.floor(fu[..., 0])
                           + jnp.floor(fu[..., 1]), 2.0) < 1.0
    circle_hole = (cell[..., 0] ** 2 + cell[..., 1] ** 2) < 0.25 ** 2
    if scene.has_textures and tex_ok is not False:
        tid = m["base_tex"]
        if tex_ok is not True:
            tid = jnp.where(tex_ok, tid, -1)
        rgba = sample_bilinear(scene.textures, scene.tex_size, tid, uv)
        tex_hole = rgba[..., 3] < m["alpha_cutoff"]
    else:
        tex_hole = jnp.zeros_like(checker_hole)
    cut_kind = m["cutout"]
    hole = jnp.where(cut_kind == CUT_CHECKER, checker_hole,
                     jnp.where(cut_kind == CUT_CIRCLE, circle_hole,
                               jnp.where(cut_kind == CUT_TEXTURE,
                                         tex_hole, False)))
    return (m["alpha_mode"] == 1) & hole


def cutout_hole_mask(scene: DeviceScene, hits: Hits):
    """True where a hit lands in an alpha-mask hole — the anyhit
    `optixIgnoreIntersection` decision (`optixCutouts.cu:295,337`)."""
    import jax.numpy as jnp
    from ..accel.geometry import shading_frame
    from ..shade import materials as mats

    m = mats.gather(scene.materials, hits.mat_id)
    is_tri = hits.prim_id < scene.num_triangles
    frame = shading_frame(scene.geom,
                          jnp.minimum(jnp.maximum(hits.prim_id, 0),
                                      scene.num_triangles - 1), hits.uv)
    uv = jnp.where(is_tri[..., None], frame["uv"], hits.uv)
    return hits.valid & _eval_hole(scene, m, uv, tex_ok=is_tri)


def _scene_any_alpha_omm(scene: DeviceScene, rays: Rays, chunk_size,
                         max_steps: int = 64, times=None,
                         impl: str = "auto"):
    """Occlusion with opacity micromaps wired into the anyhit path.

    The traversal-skips-anyhit behavior of `optixOpacityMicromap.cpp:29-30`
    (build input `optix_host.h:731`), restructured for a wavefront:

    1. Triangles CERTAIN to occlude (summary OPAQUE + all non-cutout
       geometry) answer with one first-hit-exit any-hit query — no alpha
       loop, exactly as the driver never calls the anyhit program for
       opaque micro-triangles. Solid splits past the brute-force limit
       traverse their own BVH (scene.omm_solid_bvh); custom prims and motion
       triangles (cutout-free by the build-time gate) fold in here too.
    2. Summary-TRANSPARENT triangles are in no occlusion set at all —
       they can never block light, so rays pass them for free.
    3. Only summary-UNKNOWN triangles run the re-entry loop, and each hit
       first consults its micro-triangle state (micro_index of the hit
       barycentric): micro OPAQUE → occluded, micro TRANSPARENT →
       pass-through, micro UNKNOWN → evaluate the mask (the anyhit
       program, `optixCutouts.cu:295,337`).

    Rays already blocked by step 1 skip the loop (they start `done`).
    """
    import jax
    import jax.numpy as jnp
    from ..accel.geometry import shading_frame
    from ..accel.micromap import OPAQUE, TRANSPARENT, micro_index
    from ..shade import materials as mats

    if scene.omm_solid_bvh.num_nodes:
        occ0 = _flat_call(
            lambda r: bf._chunked(
                lambda c: trav.traverse(scene.omm_solid_bvh,
                                        scene.omm_solid_geom, None, c,
                                        any_hit=True),
                r, chunk_size), rays)
    elif scene.omm_solid_geom.num_triangles:
        occ0 = bf.intersect_any(scene.omm_solid_geom, rays,
                                chunk_size=chunk_size, impl=impl)
    else:
        occ0 = jnp.zeros(rays.tmin.shape, bool)
    if scene.prims.num:
        occ0 = occ0 | prim_mod.intersect_prims_any(scene.prims, rays)
    if scene.has_motion:
        occ0 = occ0 | _motion_any(scene, rays, times)
    if not scene.omm_unknown_geom.num_triangles:
        return occ0

    geom = scene.omm_unknown_geom
    # Per-unknown-triangle rows, gathered once per call (T rows, not N).
    micro = scene.omm_micro[scene.omm_unknown_ids].astype(jnp.int32)
    mat_unknown = scene.tri_mat[scene.omm_unknown_ids]     # [T]

    def body(state):
        k, cur, occluded, done = state
        hits = bf.intersect_closest(geom, cur, chunk_size=chunk_size,
                                    impl=impl)
        pid = jnp.maximum(hits.prim_id, 0)
        mid = micro_index(hits.uv[..., 0], hits.uv[..., 1], scene.omm_level)
        st = micro[pid, mid]
        m = mats.gather(scene.materials, mat_unknown[pid])
        uv = shading_frame(geom, pid, hits.uv)["uv"]
        hole = jnp.where(st == TRANSPARENT, True,
                         jnp.where(st == OPAQUE, False,
                                   _eval_hole(scene, m, uv)))
        solid = hits.valid & ~hole
        occluded = occluded | (solid & ~done)
        done = done | solid | ~hits.valid
        new_tmin = hits.t + 1e-2
        cur = Rays(origin=cur.origin, direction=cur.direction,
                   tmin=jnp.where(done, cur.tmin, new_tmin),
                   tmax=cur.tmax)
        return k + 1, cur, occluded, done

    def cond(state):
        k, _, _, done = state
        return (k < max_steps) & jnp.any(~done)

    zeros = jnp.zeros(rays.tmin.shape, bool)
    k, _, occluded, done = jax.lax.while_loop(
        cond, body, (jnp.int32(0), rays, zeros, occ0))
    # Backstop: unresolved rays after max_steps count as blocked.
    return occ0 | occluded | ~done


def _scene_any_alpha(scene: DeviceScene, rays: Rays, chunk_size,
                     max_steps: int = 64, impl: str = "auto"):
    """Occlusion with alpha-mask pass-through: re-enter past masked
    surfaces until every ray is resolved (the reference's anyhit program
    re-enters unboundedly, `optixCutouts.cu:295,337`).

    A `lax.while_loop` exits as soon as all rays are done, so typical
    scenes pay for the 1-3 surfaces they actually cross; `max_steps` is
    only the infinite-loop backstop (a ray threading more than 64 masked
    surfaces is conservatively declared blocked, and the bound is covered
    by a test at tests/test_intersect.py)."""
    import jax
    import jax.numpy as jnp

    def body(state):
        k, cur, occluded, done = state
        hits = scene_closest(scene, cur, chunk_size=chunk_size, impl=impl)
        hole = cutout_hole_mask(scene, hits)
        solid = hits.valid & ~hole
        occluded = occluded | (solid & ~done)
        done = done | solid | ~hits.valid
        # step past the masked surface
        new_tmin = hits.t + 1e-2
        cur = Rays(origin=cur.origin, direction=cur.direction,
                   tmin=jnp.where(done, cur.tmin, new_tmin),
                   tmax=cur.tmax)
        return k + 1, cur, occluded, done

    def cond(state):
        k, _, _, done = state
        return (k < max_steps) & jnp.any(~done)

    zeros = jnp.zeros(rays.tmin.shape, bool)
    k, _, occluded, done = jax.lax.while_loop(
        cond, body, (jnp.int32(0), rays, zeros, zeros))
    # Backstop: unresolved rays after max_steps count as blocked.
    return occluded | ~done
