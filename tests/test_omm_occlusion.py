"""Opacity micromaps wired into the occlusion path.

The reference's micromaps let traversal skip anyhit invocations for
certain micro-triangles (`optixOpacityMicromap.cpp:29-30`, build input
`optix_host.h:731`). Here: `_scene_any_alpha_omm` answers solid occlusion
with one first-hit-exit query, drops never-blocking triangles, and walks
the anyhit re-entry loop only over UNKNOWN-summary triangles with
per-micro-triangle short-circuits. These tests pin (a) the micro-index
inverse, (b) exact parity with the plain alpha loop, (c) the split's
structure.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from optix_raytracer_tpu.accel import micromap as mm
from optix_raytracer_tpu.core.rays import Rays
from optix_raytracer_tpu.wavefront import intersect as ix


def _shadow_rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform([50, 50, 50], [500, 500, 500], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                tmin=jnp.full((n,), 1e-2, jnp.float32),
                tmax=jnp.full((n,), 1e4, jnp.float32))


class TestMicroIndex:
    def test_inverts_enumeration(self):
        for level in (1, 2, 3):
            tris = mm._micro_corners(level)
            cents = tris.mean(axis=1)
            idx = np.asarray(mm.micro_index(jnp.asarray(cents[:, 0]),
                                            jnp.asarray(cents[:, 1]), level))
            np.testing.assert_array_equal(idx, np.arange(len(tris)))

    def test_random_points_contained(self):
        rng = np.random.default_rng(0)
        level = 3
        tris = mm._micro_corners(level)
        uv = rng.uniform(0, 1, (256, 2)).astype(np.float32)
        keep = uv.sum(axis=1) < 0.99
        uv = uv[keep]
        idx = np.asarray(mm.micro_index(jnp.asarray(uv[:, 0]),
                                        jnp.asarray(uv[:, 1]), level))
        c = tris[idx]
        e1 = c[:, 1] - c[:, 0]
        e2 = c[:, 2] - c[:, 0]
        d = uv - c[:, 0]
        det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        a = (d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]) / det
        b = (e1[:, 0] * d[:, 1] - e1[:, 1] * d[:, 0]) / det
        assert (a >= -1e-4).all() and (b >= -1e-4).all()
        assert (a + b <= 1 + 1e-4).all()


class TestConservativeClassification:
    def test_straddling_micro_tris_are_unknown(self):
        # checker scale 3 on a unit-uv triangle at level 2 (micro side 1/4):
        # cell edges at 1/3 cross micro-tris, which must then be UNKNOWN
        corner_uv = np.array([[[0, 0], [1, 0], [0, 1]]], np.float32)
        st, su = mm.build_opacity_micromap(corner_uv, mm.checker_mask(3.0),
                                           level=2)
        assert su[0] == mm.UNKNOWN_OPAQUE
        assert (st[0] == mm.UNKNOWN_OPAQUE).any()

    def test_aligned_checker_fully_certain(self):
        # checker scale 4 at level 3 (micro side 1/8): every micro-tri lies
        # inside one cell -> no UNKNOWN states anywhere
        corner_uv = np.array([[[0, 0], [1, 0], [0, 1]],
                              [[1, 0], [1, 1], [0, 1]]], np.float32)
        st, su = mm.build_opacity_micromap(corner_uv, mm.checker_mask(4.0),
                                           level=3)
        assert (st != mm.UNKNOWN_OPAQUE).all()
        assert (st == mm.OPAQUE).any() and (st == mm.TRANSPARENT).any()


@pytest.fixture(scope="module")
def cutout_scene():
    from optix_raytracer_tpu.apps.cutouts import cutout_cornell
    return cutout_cornell()


class TestOmmOcclusion:
    def test_scene_split_structure(self, cutout_scene):
        s = cutout_scene
        assert s.has_omm
        total = (s.omm_solid_geom.num_triangles
                 + s.omm_unknown_geom.num_triangles
                 + int((np.asarray(s.omm_summary) == mm.TRANSPARENT).sum()))
        assert total == s.num_triangles
        # the 12 non-cutout Cornell tris are certain occluders
        assert s.omm_solid_geom.num_triangles >= 12

    def test_parity_with_alpha_loop(self, cutout_scene):
        rays = _shadow_rays(2048)
        fast = np.asarray(ix._scene_any_alpha_omm(cutout_scene, rays, None))
        slow = np.asarray(ix._scene_any_alpha(cutout_scene, rays, None))
        # the micro states were built from the same masks the loop
        # evaluates, and the cutout checker (scale 4, level 3) aligns with
        # the micro lattice, so the two paths must agree exactly
        np.testing.assert_array_equal(fast, slow)
        # sanity: rays both occluded and unoccluded exist
        assert 0.0 < fast.mean() < 1.0

    def test_scene_any_dispatches_to_omm(self, cutout_scene):
        rays = _shadow_rays(512, seed=7)
        via_scene = np.asarray(ix.scene_any(cutout_scene, rays, None))
        direct = np.asarray(ix._scene_any_alpha_omm(cutout_scene, rays,
                                                    None))
        np.testing.assert_array_equal(via_scene, direct)

    def test_omm_disable_falls_back(self):
        from optix_raytracer_tpu.apps import cutouts as capp
        from optix_raytracer_tpu.scene import builtins
        from optix_raytracer_tpu.scene.device_scene import make_device_scene
        from optix_raytracer_tpu.shade import materials as mat
        from optix_raytracer_tpu.shade.lights import ParallelogramLight

        verts, idx, tri_mat = builtins.quads_to_triangles(
            builtins._CORNELL_QUADS)
        materials = [dict(m) for m in builtins.CORNELL_MATERIALS]
        materials.append({"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8),
                          "alpha_mode": mat.ALPHA_MASK,
                          "cutout": mat.CUT_CHECKER, "checker_scale": 4.0})
        tri_mat = np.asarray(tri_mat)
        tri_mat[20:30] = 4
        uvs = np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                      (len(verts) // 4, 1))
        light = ParallelogramLight.make(
            builtins.CORNELL_LIGHT_CORNER, builtins.CORNELL_LIGHT_V1,
            builtins.CORNELL_LIGHT_V2, builtins.CORNELL_LIGHT_EMISSION)
        s_off = make_device_scene(verts, idx, tri_mat, materials, uvs=uvs,
                                  area_light=light, opacity_micromaps=False)
        assert not s_off.has_omm
        rays = _shadow_rays(512, seed=9)
        occ_off = np.asarray(ix.scene_any(s_off, rays, None))
        s_on = make_device_scene(verts, idx, tri_mat, materials, uvs=uvs,
                                 area_light=light)
        occ_on = np.asarray(ix.scene_any(s_on, rays, None))
        np.testing.assert_array_equal(occ_on, occ_off)

    def test_fully_opaque_alpha_material_short_circuits(self):
        """An alpha-masked material whose mask never holes must land every
        triangle in the solid set — occlusion then needs no loop at all."""
        from optix_raytracer_tpu.scene.device_scene import make_device_scene
        from optix_raytracer_tpu.shade import materials as mat
        verts = np.array([[-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]],
                         np.float32)
        idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        # circle cutout with scale 0.2: the quad's uv*scale stays in
        # [0, 0.2]^2, >= 0.3 away from the cell-center hole circle
        # (radius 0.25 around 0.5) -> never a hole
        mats = [{"kind": mat.DIFFUSE, "base_color": (0.5, 0.5, 0.5),
                 "alpha_mode": mat.ALPHA_MASK, "cutout": mat.CUT_CIRCLE,
                 "checker_scale": 0.2}]
        s = make_device_scene(verts, idx, np.zeros(2, np.int32), mats,
                              uvs=uvs)
        assert s.has_omm
        assert s.omm_solid_geom.num_triangles == 2
        assert s.omm_unknown_geom.num_triangles == 0


def _cutout_grid_scene(nx=40, ny=30, prim=False, motion=False,
                       prim_cutout=False):
    """A cluster-eligible cutout scene: an nx x ny grid of quads in the
    y=300 plane, each quad one checker cell (scale 1 with per-quad uv
    offsets -> every triangle is CERTAIN opaque or transparent), plus a
    solid floor. Optionally a sphere prim and a moving triangle."""
    from optix_raytracer_tpu.accel.primitives import SPHERE, make_prims
    from optix_raytracer_tpu.scene.device_scene import make_device_scene
    from optix_raytracer_tpu.shade import materials as mat
    from optix_raytracer_tpu.shade.lights import ParallelogramLight

    verts, idx, uvs, tri_mat = [], [], [], []
    sx, sz = 500.0 / nx, 500.0 / ny
    for j in range(ny):
        for i in range(nx):
            b = len(verts)
            x0, z0 = i * sx, j * sz
            verts += [[x0, 300, z0], [x0 + sx, 300, z0],
                      [x0 + sx, 300, z0 + sz], [x0, 300, z0 + sz]]
            uvs += [[i, j], [i + 1, j], [i + 1, j + 1], [i, j + 1]]
            idx += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
            tri_mat += [1, 1]
    # solid floor (no cutout)
    b = len(verts)
    verts += [[0, 0, 0], [500, 0, 0], [500, 0, 500], [0, 0, 500]]
    uvs += [[0, 0], [1, 0], [1, 1], [0, 1]]
    idx += [[b, b + 2, b + 1], [b, b + 3, b + 2]]
    tri_mat += [0, 0]
    materials = [
        {"kind": mat.DIFFUSE, "base_color": (0.7, 0.7, 0.7)},
        {"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8),
         "alpha_mode": mat.ALPHA_MASK, "cutout": mat.CUT_CHECKER,
         "checker_scale": 1.0},
    ]
    prims = None
    if prim or prim_cutout:
        materials.append({"kind": mat.DIFFUSE, "base_color": (0.6, 0.6, 0.6),
                          **({"alpha_mode": mat.ALPHA_MASK,
                              "cutout": mat.CUT_CHECKER,
                              "checker_scale": 2.0} if prim_cutout else {})})
        prims = make_prims([{"kind": SPHERE, "center": (250, 150, 250),
                             "radius": 60.0,
                             "mat_id": len(materials) - 1}])
    mo = None
    if motion:
        mo = {"verts0": np.array([[100, 100, 100], [200, 100, 100],
                                  [150, 200, 100]], np.float32),
              "verts1": np.array([[120, 100, 100], [220, 100, 100],
                                  [170, 200, 100]], np.float32),
              "indices": np.array([[0, 1, 2]], np.int32), "tri_mat": 0}
    light = ParallelogramLight.make((150, 640, 150), (200, 0, 0),
                                    (0, 0, 200), (15.0, 15.0, 15.0))
    return make_device_scene(
        np.asarray(verts, np.float32), np.asarray(idx, np.int32),
        np.asarray(tri_mat, np.int32), materials,
        uvs=np.asarray(uvs, np.float32), area_light=light,
        prims=prims, motion=mo)


class TestOmmGeneralized:
    """OMM occlusion on meshes past the brute-force limit and on scenes
    with custom prims / motion (the reference applies micromaps to
    every anyhit lookup on any GAS, `optixOpacityMicromap.cpp:29-30`)."""

    def test_large_scene_builds_solid_bvh(self):
        s = _cutout_grid_scene()
        assert s.has_omm
        # 2400 grid tris, half opaque (checker) + 2 floor tris
        assert s.omm_solid_geom.num_triangles > 512
        assert s.omm_solid_bvh.num_nodes > 0
        # every grid triangle is certain: one checker cell per quad
        assert s.omm_unknown_geom.num_triangles == 0
        assert s.omm_all_certain

    def test_solid_bvh_anyhit_matches_bruteforce(self):
        from optix_raytracer_tpu.accel import bruteforce as bf
        from optix_raytracer_tpu.wavefront.intersect import scene_any
        s = _cutout_grid_scene()
        rays = _shadow_rays(1024, seed=3)
        # all-certain scene: scene_any is exactly the solid-split query
        occ_bvh = np.asarray(scene_any(s, rays))
        occ_bf = np.asarray(bf.intersect_any(s.omm_solid_geom, rays))
        assert occ_bf.any() and not occ_bf.all()
        np.testing.assert_array_equal(occ_bvh, occ_bf)

    def test_scene_any_parity_with_prims_and_motion(self):
        s = _cutout_grid_scene(prim=True, motion=True)
        assert s.has_omm
        rays = _shadow_rays(2048, seed=5)
        fast = np.asarray(ix.scene_any(s, rays, None))
        slow = np.asarray(ix._scene_any_alpha(s, rays, None))
        np.testing.assert_array_equal(fast, slow)
        assert 0.0 < fast.mean() < 1.0

    def test_prim_cutout_material_disables_omm(self):
        s = _cutout_grid_scene(prim_cutout=True)
        # a cutout material on a custom prim cannot take the OMM fast
        # path (its anyhit loop is mask-driven); the build-time gate
        # must fall back to the plain alpha loop
        assert not s.has_omm

    def test_radiance_engine_parity_omm_on_off(self):
        """The radiance-ray cutout pass-through consults micromap states;
        with states derived from the same masks the render must be
        bit-identical to the mask-evaluating path."""
        import jax.numpy as jnp
        from optix_raytracer_tpu.apps.cutouts import cutout_cornell
        from optix_raytracer_tpu.core.film import Film
        from optix_raytracer_tpu.scene import builtins
        from optix_raytracer_tpu.wavefront.engine import render_accumulate

        s_on = cutout_cornell()
        assert s_on.has_omm and not s_on.omm_all_certain
        from optix_raytracer_tpu.accel.geometry import TriangleGeometry
        s_off = s_on.replace(
            omm_micro=jnp.zeros((0, 1), jnp.uint8),
            omm_summary=jnp.zeros((0,), jnp.uint8),
            omm_unknown_ids=jnp.zeros((0,), jnp.int32))
        assert not s_off.has_omm
        w = h = 64
        cam = builtins.cornell_camera(w, h).params()
        imgs = []
        for s in (s_on, s_off):
            film = Film.create(h, w)
            film, _ = render_accumulate(s, cam, film, w, h,
                                        samples_per_launch=2, max_depth=3,
                                        chunk_size=None)
            imgs.append(np.asarray(film.accum))
        np.testing.assert_array_equal(imgs[0], imgs[1])

    def test_radiance_all_certain_shortcut_parity(self):
        """omm_all_certain scenes skip mask evaluation entirely in the
        radiance loop; the summary-driven pass-through must agree with
        the full mask path."""
        import jax.numpy as jnp
        from optix_raytracer_tpu.core.film import Film
        from optix_raytracer_tpu.scene import builtins
        from optix_raytracer_tpu.wavefront.engine import render_accumulate

        s_on = _cutout_grid_scene()
        assert s_on.omm_all_certain
        s_off = s_on.replace(
            omm_micro=jnp.zeros((0, 1), jnp.uint8),
            omm_summary=jnp.zeros((0,), jnp.uint8),
            omm_unknown_ids=jnp.zeros((0,), jnp.int32))
        w = h = 48
        from optix_raytracer_tpu.core.camera import Camera
        cam = Camera(eye=(250.0, 150.0, -400.0),
                     lookat=(250.0, 150.0, 250.0), up=(0.0, 1.0, 0.0),
                     fov_y=60.0, aspect=1.0).params()
        imgs = []
        for s in (s_on, s_off):
            film = Film.create(h, w)
            film, _ = render_accumulate(s, cam, film, w, h,
                                        samples_per_launch=2, max_depth=3,
                                        chunk_size=None)
            imgs.append(np.asarray(film.accum))
        np.testing.assert_array_equal(imgs[0], imgs[1])
