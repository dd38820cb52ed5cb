"""Fused brute-force kernels (accel/pallas_bf.py) vs the XLA intersector.

The kernels run in Pallas interpret mode here, the same kernel code the
GPU compiles through Triton. They must agree exactly on hit ids and
material ids, and to f32 tolerance on t/uv/normal: the kernel evaluates
the same unit-triangle transform with scalar FMAs instead of a HIGHEST
matmul, so distances differ in the last bits only.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from optix_raytracer_tpu.accel import bruteforce as bf
from optix_raytracer_tpu.accel import pallas_bf
from optix_raytracer_tpu.accel.geometry import build_triangle_geometry
from optix_raytracer_tpu.core.rays import Rays

from test_intersect import random_mesh


def _random_rays(rng, n, tmin=1e-3, tmax=50.0):
    origins = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return Rays.make(jnp.asarray(origins), jnp.asarray(dirs),
                     tmin=tmin, tmax=tmax)


def _aimed_rays(rng, geom, n):
    """Rays from outside the mesh aimed at random triangle centroids, so a
    large share of them hit."""
    v0, e1, e2 = (np.asarray(a) for a in (geom.v0, geom.e1, geom.e2))
    k = rng.integers(0, v0.shape[0], n)
    target = v0[k] + (e1[k] + e2[k]) / 3.0
    origin = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays.make(jnp.asarray(origin), jnp.asarray(d.astype(np.float32)),
                     tmin=1e-3, tmax=50.0)


def _assert_closest_equal(out, ref, t_rtol=1e-5, uv_atol=1e-4):
    np.testing.assert_array_equal(out.prim_id, ref.prim_id)
    np.testing.assert_array_equal(out.mat_id, ref.mat_id)
    hit = np.asarray(ref.valid)
    np.testing.assert_allclose(np.asarray(out.t)[hit],
                               np.asarray(ref.t)[hit], rtol=t_rtol)
    np.testing.assert_allclose(np.asarray(out.uv)[hit],
                               np.asarray(ref.uv)[hit], atol=uv_atol)
    np.testing.assert_allclose(np.asarray(out.normal)[hit],
                               np.asarray(ref.normal)[hit], atol=1e-5)
    miss = ~hit
    np.testing.assert_array_equal(np.asarray(out.t)[miss],
                                  np.asarray(ref.t)[miss])


@pytest.fixture(scope="module")
def mesh_and_rays():
    rng = np.random.default_rng(7)
    verts, idx = random_mesh(rng, 40)
    geom = build_triangle_geometry(verts, idx)
    tri_mat = jnp.asarray(rng.integers(0, 5, 40), jnp.int32)
    n_rays = 1500  # not a multiple of the 128-ray block → exercises padding
    return geom, tri_mat, _random_rays(rng, n_rays)


class TestPallasClosest:
    def test_matches_xla_path(self, mesh_and_rays):
        geom, tri_mat, rays = mesh_and_rays
        ref = bf.intersect_closest(geom, rays, tri_mat=tri_mat, impl="xla",
                                   chunk_size=None)
        out = bf.intersect_closest(geom, rays, tri_mat=tri_mat,
                                   impl="pallas_interpret")
        _assert_closest_equal(out, ref)

    def test_miss_semantics(self, mesh_and_rays):
        geom, tri_mat, rays = mesh_and_rays
        out = bf.intersect_closest(geom, rays, tri_mat=tri_mat,
                                   impl="pallas_interpret")
        miss = ~np.asarray(out.valid)
        assert miss.any()
        np.testing.assert_array_equal(np.asarray(out.mat_id)[miss], -1)
        np.testing.assert_array_equal(np.asarray(out.prim_id)[miss], -1)
        np.testing.assert_allclose(np.asarray(out.t)[miss],
                                   np.asarray(rays.tmax)[miss])
        np.testing.assert_array_equal(np.asarray(out.normal)[miss], 0.0)


class TestPallasAnyHit:
    def test_matches_xla_path(self, mesh_and_rays):
        geom, _, rays = mesh_and_rays
        ref = bf.intersect_any(geom, rays, impl="xla", chunk_size=None)
        out = bf.intersect_any(geom, rays, impl="pallas_interpret")
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


@pytest.mark.parametrize("num_tris", [1, 32, 100, 512])
@pytest.mark.parametrize("n_rays", [1, 300])
class TestKernelParity:
    """Triangle counts from one triangle to the brute-force limit, ray
    counts below one block and not a multiple of it.

    Aimed rays include grazing hits, where t = -o'z / d'z divides the
    last-bit difference between the kernel's scalar FMAs and the HIGHEST
    matmul by a small |d'z|: t agrees to 2e-4 relative, uv to 5e-4."""

    def _case(self, num_tris, n_rays):
        rng = np.random.default_rng(num_tris * 1000 + n_rays)
        verts, idx = random_mesh(rng, num_tris)
        geom = build_triangle_geometry(verts, idx)
        tri_mat = jnp.asarray(rng.integers(0, 7, num_tris), jnp.int32)
        return geom, tri_mat, _aimed_rays(rng, geom, n_rays)

    def test_closest(self, num_tris, n_rays):
        geom, tri_mat, rays = self._case(num_tris, n_rays)
        ref = bf.intersect_closest(geom, rays, tri_mat=tri_mat, impl="xla",
                                   chunk_size=None)
        out = bf.intersect_closest(geom, rays, tri_mat=tri_mat,
                                   impl="pallas_interpret")
        _assert_closest_equal(out, ref, t_rtol=2e-4, uv_atol=5e-4)

    def test_any(self, num_tris, n_rays):
        geom, _, rays = self._case(num_tris, n_rays)
        ref = bf.intersect_any(geom, rays, impl="xla", chunk_size=None)
        out = bf.intersect_any(geom, rays, impl="pallas_interpret")
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


class TestKernelEdgeCases:
    @pytest.mark.parametrize("block_rays,num_warps", [(32, 1), (64, 2),
                                                      (256, 8)])
    def test_block_shapes(self, mesh_and_rays, block_rays, num_warps):
        geom, tri_mat, rays = mesh_and_rays
        ref = pallas_bf.closest_hit(geom.tri_consts, tri_mat, rays,
                                    interpret=True)
        out = pallas_bf.closest_hit(geom.tri_consts, tri_mat, rays,
                                    block_rays=block_rays,
                                    num_warps=num_warps, interpret=True)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(out[k]),
                                          np.asarray(ref[k]))
        occ_ref = pallas_bf.any_hit(geom.tri_consts, rays, interpret=True)
        occ = pallas_bf.any_hit(geom.tri_consts, rays,
                                block_rays=block_rays, num_warps=num_warps,
                                interpret=True)
        np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ_ref))

    def test_all_miss(self):
        verts = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
        geom = build_triangle_geometry(verts, np.array([[0, 1, 2]]))
        rays = Rays.make(jnp.tile(jnp.array([0.0, 0.0, 1.0]), (200, 1)),
                         jnp.tile(jnp.array([0.0, 0.0, 1.0]), (200, 1)),
                         tmax=7.0)
        out = bf.intersect_closest(geom, rays, impl="pallas_interpret")
        assert not np.asarray(out.valid).any()
        np.testing.assert_array_equal(np.asarray(out.prim_id), -1)
        np.testing.assert_array_equal(np.asarray(out.mat_id), -1)
        np.testing.assert_allclose(np.asarray(out.t), 7.0)
        np.testing.assert_array_equal(np.asarray(out.uv), 0.0)
        assert not np.asarray(
            bf.intersect_any(geom, rays, impl="pallas_interpret")).any()

    @pytest.mark.parametrize("tmin,tmax,expect_hit", [
        (1e-3, 50.0, True),     # plane at t=5 inside the window
        (1e-3, 4.9, False),     # window ends before the plane
        (5.1, 50.0, False),     # window starts past the plane
    ])
    def test_ray_window(self, tmin, tmax, expect_hit):
        verts = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
        geom = build_triangle_geometry(verts, np.array([[0, 1, 2]]))
        rays = Rays.make(jnp.tile(jnp.array([0.0, 0.0, 5.0]), (130, 1)),
                         jnp.tile(jnp.array([0.0, 0.0, -1.0]), (130, 1)),
                         tmin=tmin, tmax=tmax)
        out = bf.intersect_closest(geom, rays, impl="pallas_interpret")
        ref = bf.intersect_closest(geom, rays, impl="xla")
        assert bool(np.asarray(out.valid).all()) is expect_hit
        _assert_closest_equal(out, ref)
        occ = bf.intersect_any(geom, rays, impl="pallas_interpret")
        assert bool(np.asarray(occ).all()) is expect_hit

    def test_empty_window_rays_never_hit(self, mesh_and_rays):
        """tmax <= tmin marks a dead lane: no hit, t stays tmax, and a
        block made only of dead lanes skips the triangle loop."""
        geom, tri_mat, rays = mesh_and_rays
        n = rays.tmin.shape[0]
        dead = np.zeros(n, bool)
        dead[:256] = True                  # two whole dead blocks
        dead[300::3] = True                # scattered dead lanes
        rays = rays.replace(tmax=jnp.where(jnp.asarray(dead), 0.0,
                                           rays.tmax))
        out = bf.intersect_closest(geom, rays, tri_mat=tri_mat,
                                   impl="pallas_interpret")
        assert not np.asarray(out.valid)[dead].any()
        ref = bf.intersect_closest(geom, rays, tri_mat=tri_mat, impl="xla")
        _assert_closest_equal(out, ref)
        occ = bf.intersect_any(geom, rays, impl="pallas_interpret")
        assert not np.asarray(occ)[dead].any()

    def test_degenerate_triangles_never_hit(self):
        rng = np.random.default_rng(3)
        verts, idx = random_mesh(rng, 20)
        # collapse every other triangle: zero-area, collinear, point
        verts = verts.copy()
        for t in range(0, 20, 2):
            a, b, c = idx[t]
            verts[b] = verts[a]
            if t % 4 == 0:
                verts[c] = verts[a]
        geom = build_triangle_geometry(verts, idx)
        rays = _aimed_rays(rng, geom, 400)
        ref = bf.intersect_closest(geom, rays, impl="xla")
        out = bf.intersect_closest(geom, rays, impl="pallas_interpret")
        _assert_closest_equal(out, ref, t_rtol=2e-4, uv_atol=5e-4)
        hit_ids = np.asarray(out.prim_id)[np.asarray(out.valid)]
        assert not np.isin(hit_ids, np.arange(0, 20, 2)).any()
        np.testing.assert_array_equal(
            np.asarray(bf.intersect_any(geom, rays,
                                        impl="pallas_interpret")),
            np.asarray(bf.intersect_any(geom, rays, impl="xla")))

    def test_tri_mat_is_emitted(self, mesh_and_rays):
        geom, tri_mat, rays = mesh_and_rays
        out = bf.intersect_closest(geom, rays, tri_mat=tri_mat,
                                   impl="pallas_interpret")
        hit = np.asarray(out.valid)
        np.testing.assert_array_equal(
            np.asarray(out.mat_id)[hit],
            np.asarray(tri_mat)[np.asarray(out.prim_id)[hit]])

    def test_no_tri_mat_means_material_zero(self, mesh_and_rays):
        geom, _, rays = mesh_and_rays
        out = bf.intersect_closest(geom, rays, impl="pallas_interpret")
        hit = np.asarray(out.valid)
        assert hit.any()
        np.testing.assert_array_equal(np.asarray(out.mat_id)[hit], 0)

    def test_anyhit_block_fully_occluded(self):
        """Every ray of the block hits the first triangle: the any-hit
        loop stops early and still reports all rays occluded."""
        verts = np.concatenate([
            np.array([[-5, -5, 0], [5, -5, 0], [0, 5, 0]], np.float32),
            np.random.default_rng(1).uniform(2, 3, (30, 3)).astype(
                np.float32)])
        idx = np.concatenate([[[0, 1, 2]],
                              np.arange(3, 33).reshape(10, 3)])
        geom = build_triangle_geometry(verts, idx)
        rays = Rays.make(jnp.tile(jnp.array([0.0, 0.0, 1.0]), (256, 1)),
                         jnp.tile(jnp.array([0.0, 0.0, -1.0]), (256, 1)),
                         tmax=5.0)
        occ = bf.intersect_any(geom, rays, impl="pallas_interpret")
        assert np.asarray(occ).all()

    def test_batched_ray_shape(self, mesh_and_rays):
        geom, tri_mat, rays = mesh_and_rays
        r2 = Rays.make(rays.origin[:1200].reshape(30, 40, 3),
                       rays.direction[:1200].reshape(30, 40, 3),
                       tmin=1e-3, tmax=50.0)
        out = bf.intersect_closest(geom, r2, tri_mat=tri_mat,
                                   impl="pallas_interpret")
        assert out.t.shape == (30, 40)
        assert out.normal.shape == (30, 40, 3)
        flat = bf.intersect_closest(geom, r2.replace(
            origin=r2.origin.reshape(-1, 3),
            direction=r2.direction.reshape(-1, 3),
            tmin=r2.tmin.reshape(-1), tmax=r2.tmax.reshape(-1)),
            tri_mat=tri_mat, impl="xla")
        np.testing.assert_array_equal(np.asarray(out.prim_id).reshape(-1),
                                      np.asarray(flat.prim_id))


class TestChooseImpl:
    @pytest.mark.parametrize("platform,num_tris,expected", [
        ("gpu", 1, "pallas"),
        ("gpu", 32, "pallas"),
        ("gpu", bf.BRUTE_FORCE_MAX_TRIS, "pallas"),
        ("gpu", bf.BRUTE_FORCE_MAX_TRIS + 1, "xla"),
        ("gpu", 0, "xla"),
        ("cpu", 32, "xla"),
        ("cpu", bf.BRUTE_FORCE_MAX_TRIS, "xla"),
        ("cpu", 1, "xla"),
    ])
    def test_auto(self, platform, num_tris, expected):
        assert bf.choose_impl(num_tris, "auto", platform) == expected

    @pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_interpret"])
    def test_explicit_choice_wins(self, impl):
        assert bf.choose_impl(32, impl, "gpu") == impl
        assert bf.choose_impl(32, impl, "cpu") == impl

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError):
            bf.choose_impl(32, "fused", "gpu")

    def test_default_platform_is_cpu_here(self):
        # the suite runs on the CPU backend: auto never takes the kernel
        assert bf.choose_impl(32) == "xla"
