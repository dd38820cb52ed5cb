"""Acceptance tests for the Cornell path tracer: statistical agreement with an
independent numpy oracle integrator (the RMSE gate of SURVEY.md §4), plus
determinism / physical sanity checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optix_raytracer_tpu.core import film as film_mod
from optix_raytracer_tpu.scene.builtins import cornell_box, cornell_camera
from optix_raytracer_tpu.wavefront.engine import render_accumulate, render_sample

from oracle_pt import render_oracle, scene_to_numpy


@pytest.fixture(scope="module")
def scene():
    return cornell_box()


def jax_render_cam(scene, cam, w, h, samples, depth=3):
    film = film_mod.Film.create(h, w)
    film, _ = render_accumulate(scene, cam, film, w, h, samples_per_launch=samples,
                             max_depth=depth, chunk_size=None)
    return np.asarray(film.accum)


def jax_render(scene, w, h, samples, depth=3):
    return jax_render_cam(scene, cornell_camera(w, h).params(),
                          w, h, samples, depth)


class TestCornellAgainstOracle:
    def test_matches_numpy_oracle(self, scene):
        w = h = 32
        samples = 160
        depth = 3
        img_jax = jax_render(scene, w, h, samples, depth)
        cam = {k: np.asarray(v) for k, v in cornell_camera(w, h).params().items()}
        img_ora = render_oracle(scene_to_numpy(scene), cam, w, h,
                                samples=samples, max_depth=depth, seed=3)
        # Agreement in expectation: the two renders are independent MC
        # estimates of the same integral. Tolerance ≈ few × noise sigma.
        diff = np.abs(img_jax - img_ora)
        assert diff.mean() < 0.03, f"mean abs diff {diff.mean():.4f}"
        # Overall energy within 5%
        assert abs(img_jax.mean() - img_ora.mean()) / img_ora.mean() < 0.05


class TestPhysicalSanity:
    def test_deterministic_given_subframe(self, scene):
        a = jax_render(scene, 24, 24, 4)
        b = jax_render(scene, 24, 24, 4)
        np.testing.assert_array_equal(a, b)

    def test_finite_nonnegative(self, scene):
        img = jax_render(scene, 32, 32, 8)
        assert np.isfinite(img).all()
        assert (img >= 0).all()

    def test_color_bleeding_sides(self, scene):
        """Left half of the frame (red wall side) must be red-tinted and the
        right half green-tinted — the classic Cornell color bleed."""
        img = jax_render(scene, 48, 48, 32)
        left = img[:, :16]
        right = img[:, -16:]
        assert left[..., 0].mean() > left[..., 1].mean()
        assert right[..., 1].mean() > right[..., 0].mean()

    def test_light_brightest(self, scene):
        img = jax_render(scene, 48, 48, 8)
        # The lamp region (top middle) should contain the max radiance.
        ys, xs = np.unravel_index(np.argmax(img.sum(-1)), img.shape[:2])
        assert ys < 12, f"brightest pixel at row {ys}, expected lamp at top"

    def test_more_samples_less_noise(self, scene):
        w = h = 24
        img_lo = jax_render(scene, w, h, 4)
        img_hi = jax_render(scene, w, h, 64)
        ref = render_oracle(scene_to_numpy(scene),
                            {k: np.asarray(v) for k, v in
                             cornell_camera(w, h).params().items()},
                            w, h, samples=256, max_depth=3, seed=11)
        err_lo = np.abs(img_lo - ref).mean()
        err_hi = np.abs(img_hi - ref).mean()
        assert err_hi < err_lo

    def test_subframe_progression(self, scene):
        """render_accumulate must use distinct RNG per subframe: accumulating
        2×8 samples ≈ 16 samples, not 2× the same 8."""
        w = h = 16
        cam = cornell_camera(w, h).params()
        film = film_mod.Film.create(h, w)
        film, _ = render_accumulate(scene, cam, film, w, h, samples_per_launch=8,
                                 max_depth=3, chunk_size=None)
        first8 = np.asarray(film.accum)
        film, _ = render_accumulate(scene, cam, film, w, h, samples_per_launch=8,
                                 max_depth=3, chunk_size=None)
        second = np.asarray(film.accum)
        assert int(film.subframe) == 16
        assert not np.array_equal(first8, second)


class TestSampleMajor:
    """Sample-major wavefronts (render_sample_group / impl='spl') must be
    a pure re-bucketing of the sequential per-sample loop: identical RNG
    streams seed(pixel, subframe+s), identical estimator, so the summed
    film matches to float-summation order. Exercises the strip tiling
    (h doesn't divide the strip rows) and the no-sort bounce loop."""

    def _scene(self):
        from optix_raytracer_tpu.scene.builtins import trefoil_mesh
        from optix_raytracer_tpu.scene.device_scene import make_device_scene
        from optix_raytracer_tpu.shade.lights import ParallelogramLight

        verts, idx, normals = trefoil_mesh(40, 12)
        light = ParallelogramLight.make((-2.0, 6.0, -2.0), (4.0, 0, 0),
                                        (0, 0, 4.0), (12.0, 11.0, 10.0))
        return make_device_scene(
            verts, idx, np.zeros(len(idx), np.int32),
            [{"kind": 0, "base_color": (0.7, 0.6, 0.5)}],
            normals=normals, area_light=light)

    def test_spl_major_matches_sequential(self, monkeypatch):
        from optix_raytracer_tpu.scene.builtins import knot_camera
        from optix_raytracer_tpu.wavefront import engine

        scene = self._scene()
        w, h = 32, 21            # 21 rows: strips of 8 -> 3 strips, 3 pad rows
        monkeypatch.setattr(engine, "_SPL_TILE_RAYS", 32 * 8 * 8)
        cam = knot_camera(w, h).params()
        film = film_mod.Film.create(h, w)
        f_seq, r_seq = render_accumulate(scene, cam, film, w, h,
                                         samples_per_launch=8, max_depth=3,
                                         chunk_size=None, impl="xla")
        f_spl, r_spl = render_accumulate(scene, cam, film, w, h,
                                         samples_per_launch=8, max_depth=3,
                                         chunk_size=None, impl="spl")
        a, b = np.asarray(f_seq.accum), np.asarray(f_spl.accum)
        assert a.max() > 0.0
        # identical RNG streams + estimator; float-summation order over
        # the spl axis differs (jnp.sum tree-reduce vs sequential adds)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
        assert float(r_seq) == float(r_spl)
        assert int(f_seq.subframe) == int(f_spl.subframe)

    def test_unknown_impl_raises(self):
        from optix_raytracer_tpu.scene.builtins import knot_camera
        scene = self._scene()
        with pytest.raises(ValueError):
            render_accumulate(scene, knot_camera(8, 8).params(),
                              film_mod.Film.create(8, 8), 8, 8, impl="fused")

    def test_render_sample_group_sums_samples(self):
        """render_sample_group's radiance SUM equals the sum of the
        per-sample render_sample calls it batches."""
        from optix_raytracer_tpu.scene.builtins import knot_camera
        from optix_raytracer_tpu.wavefront.engine import render_sample_group

        scene = self._scene()
        w, h, spl = 24, 16, 8
        cam = knot_camera(w, h).params()
        rad_g, rays_g = jax.jit(
            render_sample_group, static_argnums=(2, 3, 5, 6, 7))(
                scene, cam, w, h, 3, spl, 3, None)
        rad_s = 0.0
        rays_s = 0.0
        for s in range(spl):
            r, c = render_sample(scene, cam, w, h, 3 + s, max_depth=3,
                                 chunk_size=None)
            rad_s = rad_s + r
            rays_s = rays_s + c
        np.testing.assert_allclose(np.asarray(rad_g), np.asarray(rad_s),
                                   rtol=2e-4, atol=2e-5)
        assert float(rays_g) == float(rays_s)


class TestMeshAgainstOracle:
    """End-to-end mesh-scene expectation gate (round-2 verdict weak #5:
    the oracle must exercise the large-mesh path, not just Cornell). A
    960-triangle flat-shaded knot is past the brute-force limit, so
    make_device_scene builds its BVH and every bounce and shadow query
    traverses it; radiance agreement validates the BVH path on a real mesh
    against an independent integrator."""

    @pytest.mark.slow  # heavy parity sweep (default run keeps a cheap cousin)
    def test_knot_matches_numpy_oracle(self):
        from optix_raytracer_tpu.scene.builtins import knot_camera, trefoil_mesh
        from optix_raytracer_tpu.scene.device_scene import make_device_scene
        from optix_raytracer_tpu.shade.lights import ParallelogramLight

        w, h = 24, 16
        samples, depth = 160, 3
        verts, idx, _ = trefoil_mesh(40, 12)   # 960 tris, flat-shaded
        light = ParallelogramLight.make((-2.0, 6.0, -2.0), (4.0, 0, 0),
                                        (0, 0, 4.0), (12.0, 11.0, 10.0))
        scene = make_device_scene(
            verts, idx, np.zeros(len(idx), np.int32),
            [{"kind": 0, "base_color": (0.7, 0.6, 0.5)}],
            area_light=light)
        assert scene.has_bvh        # really the BVH traversal
        img_jax = jax_render_cam(scene, knot_camera(w, h).params(),
                                 w, h, samples, depth)
        cam = {k: np.asarray(v)
               for k, v in knot_camera(w, h).params().items()}
        img_ora = render_oracle(scene_to_numpy(scene), cam, w, h,
                                samples=samples, max_depth=depth, seed=7)
        diff = np.abs(img_jax - img_ora)
        assert diff.mean() < 0.03, f"mean abs diff {diff.mean():.4f}"
        lit = img_ora.mean() > 1e-4
        assert lit, "oracle scene must actually be lit"
        assert abs(img_jax.mean() - img_ora.mean()) / img_ora.mean() < 0.05

    def test_knot_bvh_small_matches_numpy_oracle(self):
        """The cheap cousin of the sweep above: the 960-triangle knot built
        with make_device_scene's defaults (so it gets a BVH and no other
        structure), rendered through render_accumulate at 16x12."""
        from optix_raytracer_tpu.scene.builtins import knot_camera, trefoil_mesh
        from optix_raytracer_tpu.scene.device_scene import make_device_scene
        from optix_raytracer_tpu.shade.lights import ParallelogramLight
        from optix_raytracer_tpu.wavefront.intersect import traversal

        w, h = 16, 12
        samples, depth = 64, 2
        verts, idx, _ = trefoil_mesh(40, 12)
        light = ParallelogramLight.make((-2.0, 6.0, -2.0), (4.0, 0, 0),
                                        (0, 0, 4.0), (12.0, 11.0, 10.0))
        scene = make_device_scene(
            verts, idx, np.zeros(len(idx), np.int32),
            [{"kind": 0, "base_color": (0.7, 0.6, 0.5)}],
            area_light=light)
        assert traversal(scene, platform="gpu") == "bvh"
        img_jax = jax_render_cam(scene, knot_camera(w, h).params(),
                                 w, h, samples, depth)
        cam = {k: np.asarray(v)
               for k, v in knot_camera(w, h).params().items()}
        img_ora = render_oracle(scene_to_numpy(scene), cam, w, h,
                                samples=samples, max_depth=depth, seed=7)
        assert img_ora.mean() > 1e-4, "oracle scene must actually be lit"
        assert np.isfinite(img_jax).all() and (img_jax >= 0).all()
        # independent Monte-Carlo estimates at 64 spp: compare means
        assert abs(img_jax.mean() - img_ora.mean()) / img_ora.mean() < 0.08
        assert np.abs(img_jax - img_ora).mean() < 0.05
