"""Mipmapped texturing + normal / metallic-roughness / emissive maps.

Covers the reference's full material texture set (`MaterialData.h:62-103`:
base color, normal, metallic-roughness, emissive samplers used in
`whitted.cu:160-260`) plus trilinear mip selection via ray cones.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from optix_raytracer_tpu.core import film as film_mod
from optix_raytracer_tpu.core.camera import Camera
from optix_raytracer_tpu.scene.device_scene import (make_device_scene,
                                                    pack_textures)
from optix_raytracer_tpu.shade import materials as mat
from optix_raytracer_tpu.shade.lights import ParallelogramLight
from optix_raytracer_tpu.shade.texture import sample_bilinear, sample_trilinear
from optix_raytracer_tpu.wavefront.engine import render_accumulate


def checker_image(n=64, a=0.0, b=1.0):
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    c = ((yy + xx) % 2).astype(np.float32)
    img = np.where(c[..., None] > 0, b, a).repeat(3, axis=-1)
    return img.astype(np.float32)


class TestMipAtlas:
    def test_chain_sizes_and_offsets(self):
        img = np.random.default_rng(0).uniform(0, 1, (32, 48, 3))
        tex, size, mips = pack_textures([img])
        mips = np.asarray(mips)
        np.testing.assert_array_equal(np.asarray(size)[0], (32, 48))
        np.testing.assert_array_equal(mips[0, 0], (0, 0, 32, 48))
        assert tuple(mips[0, 1][2:]) == (16, 24)
        assert tuple(mips[0, 2][2:]) == (8, 12)
        # chain ends at 1x1; beyond it h == 0
        hs = mips[0, :, 2]
        assert hs[hs > 0][-1] == 1

    def test_downsample_is_box_average(self):
        img = np.arange(16, dtype=np.float32).reshape(4, 4)[..., None]
        img = img.repeat(3, axis=-1)
        tex, size, mips = pack_textures([img])
        tex = np.asarray(tex)
        y, x, h, w = np.asarray(mips)[0, 1]
        lvl1 = tex[0, y:y + h, x:x + w, 0]
        want = np.array([[2.5, 4.5], [10.5, 12.5]], np.float32)
        np.testing.assert_allclose(lvl1, want)

    def test_mean_preserved_to_top_level(self):
        img = np.random.default_rng(1).uniform(0, 1, (16, 16, 3))
        tex, size, mips = pack_textures([img])
        tex = np.asarray(tex)
        y, x, h, w = np.asarray(mips)[0, 4]   # 1x1 level
        assert (h, w) == (1, 1)
        np.testing.assert_allclose(tex[0, y, x, :3], img.mean(axis=(0, 1)),
                                   rtol=1e-5)


class TestTrilinear:
    def test_lod0_matches_bilinear(self):
        img = np.random.default_rng(2).uniform(0, 1, (16, 16, 3))
        tex, size, mips = pack_textures([img])
        uv = jnp.asarray(np.random.default_rng(3).uniform(0, 1, (50, 2)),
                         jnp.float32)
        tid = jnp.zeros((50,), jnp.int32)
        a = sample_bilinear(tex, size, tid, uv)
        b = sample_trilinear(tex, mips, tid, uv, texel_scale=None)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    def test_huge_footprint_converges_to_mean(self):
        img = checker_image(64)
        tex, size, mips = pack_textures([img])
        uv = jnp.asarray([[0.3, 0.7]], jnp.float32)
        big = sample_trilinear(tex, mips, jnp.zeros((1,), jnp.int32), uv,
                               texel_scale=jnp.asarray([1e6], jnp.float32))
        np.testing.assert_allclose(np.asarray(big)[0, :3], 0.5, atol=1e-3)

    def test_lod_monotone_blur(self):
        img = checker_image(64)
        tex, size, mips = pack_textures([img])
        tid = jnp.zeros((1,), jnp.int32)
        uv = jnp.asarray([[0.25 + 1 / 128.0, 0.25]], jnp.float32)
        vals = []
        for scale in (0.0, 4.0 / 64, 16.0 / 64, 1.0):
            v = sample_trilinear(tex, mips, tid, uv,
                                 texel_scale=jnp.asarray([scale]))
            vals.append(float(np.asarray(v)[0, 0]))
        dev = [abs(v - 0.5) for v in vals]
        assert dev[0] >= dev[1] >= dev[2] >= dev[3] - 1e-6

    def test_missing_texture_is_white(self):
        img = checker_image(8)
        tex, size, mips = pack_textures([img])
        out = sample_trilinear(tex, mips, jnp.asarray([-1], jnp.int32),
                               jnp.asarray([[0.5, 0.5]], jnp.float32),
                               texel_scale=jnp.asarray([0.1]))
        np.testing.assert_array_equal(np.asarray(out), 1.0)


def quad_scene(material, textures):
    verts = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                     np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    light = ParallelogramLight.make((-0.5, 3.0, -0.5), (1, 0, 0), (0, 0, 1),
                                    (20.0, 20.0, 20.0))
    return make_device_scene(verts, idx, np.zeros(2, np.int32), [material],
                             uvs=uvs, textures=textures, area_light=light)


def render(scene, w=32, h=32, spl=96, depth=2):
    cam = Camera(eye=(0, 2.0, 0.001), lookat=(0, 0, 0), up=(0, 0, 1),
                 fov_y=40.0, aspect=1.0).params()
    film = film_mod.Film.create(h, w)
    film, _ = render_accumulate(scene, cam, film, w, h,
                                samples_per_launch=spl, max_depth=depth,
                                chunk_size=None)
    return np.asarray(film.accum)


class TestEngineMaps:
    def test_identity_normal_map_is_noop(self):
        flat_nm = np.full((8, 8, 3), (0.5, 0.5, 1.0), np.float32)
        base = {"kind": mat.DIFFUSE, "base_color": (0.6, 0.6, 0.6)}
        img_plain = render(quad_scene(dict(base), [flat_nm]))
        img_nm = render(quad_scene(dict(base, normal_tex=0), [flat_nm]))
        np.testing.assert_allclose(img_nm, img_plain, atol=1e-5)

    def test_tilted_normal_map_changes_shading(self):
        tilt = np.full((8, 8, 3), (0.9, 0.5, 0.6), np.float32)  # lean +T
        base = {"kind": mat.DIFFUSE, "base_color": (0.6, 0.6, 0.6)}
        img_plain = render(quad_scene(dict(base), [tilt]))
        img_nm = render(quad_scene(dict(base, normal_tex=0), [tilt]))
        # overhead light: tilting normals away reduces received radiance
        assert img_nm.mean() < img_plain.mean() * 0.95

    def test_mr_map_modulates_roughness_metallic(self):
        # rough=1, metal=0 in the map → PBR material becomes fully rough
        # dielectric; vs the factor-only material (metallic 1, rough 0.1)
        mr = np.zeros((4, 4, 3), np.float32)
        mr[..., 1] = 1.0   # G = roughness
        mr[..., 2] = 0.0   # B = metallic
        m0 = {"kind": mat.PBR, "base_color": (0.8, 0.2, 0.2),
              "metallic": 1.0, "roughness": 0.1}
        img_factor = render(quad_scene(dict(m0), [mr]))
        img_mapped = render(quad_scene(dict(m0, mr_tex=0), [mr]))
        assert not np.allclose(img_factor, img_mapped, atol=5e-3)

    def test_emissive_map(self):
        em = np.zeros((8, 8, 3), np.float32)
        em[:4] = (1.0, 1.0, 1.0)    # half the quad emits
        m0 = {"kind": mat.DIFFUSE, "base_color": (0.1, 0.1, 0.1),
              "emission": (2.0, 2.0, 2.0), "emissive_tex": 0}
        img = render(quad_scene(m0, [em]), spl=32, depth=1)
        lum = img.mean(axis=-1)
        half_a = lum[:16].mean()
        half_b = lum[16:].mean()
        bright, dark = max(half_a, half_b), min(half_a, half_b)
        assert bright > 1.0 and dark < 0.5 * bright

    def test_gltf_material_texture_wiring(self):
        from optix_raytracer_tpu.scene.gltf import GltfMaterial
        from optix_raytracer_tpu.scene.scene import Scene
        g = GltfMaterial(normal_texture=2, mr_texture=1, emissive_texture=3)
        assert g.normal_texture == 2 and g.mr_texture == 1
        # Scene.load wiring is exercised via the dict keys used above
        s = Scene()
        i = s.add_material({"kind": mat.PBR, "normal_tex": 2, "mr_tex": 1,
                            "emissive_tex": 3})
        scene = s.finalize()
        assert int(scene.materials.normal_tex[i]) == 2
        assert int(scene.materials.mr_tex[i]) == 1
        assert int(scene.materials.emissive_tex[i]) == 3


class TestBundles:
    """16-channel material bundles: one sliced gather per level must
    reproduce the per-map trilinear fetches (pack_bundles +
    sample_bundle vs sample_trilinear on the same images)."""

    def test_bundle_matches_per_map(self):
        from optix_raytracer_tpu.scene.device_scene import (pack_bundles,
                                                            pack_textures)
        from optix_raytracer_tpu.shade.texture import sample_bundle
        rng = np.random.default_rng(3)
        base = rng.uniform(0, 1, (32, 32, 4)).astype(np.float32)
        nmap = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
        mr = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
        em = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
        mats_l = [{"kind": mat.DIFFUSE, "base_tex": 0, "normal_tex": 1,
                   "mr_tex": 2, "emissive_tex": 3}]
        tex, size, mips = pack_textures([base, nmap, mr, em])
        bundles, bmip, mat_bundle, _bq, _qb = pack_bundles([base, nmap, mr, em],
                                                 mats_l)
        assert mat_bundle[0] == 0 and bundles.shape[-1] == 16
        n = 4096
        uv = jnp.asarray(rng.uniform(-1, 2, (n, 2)).astype(np.float32))
        scale = jnp.asarray(rng.uniform(0, 0.3, n).astype(np.float32))
        bid = jnp.zeros((n,), jnp.int32)
        b16 = sample_bundle(bundles, bmip, bid, uv, texel_scale=scale)
        for ch, img_i, cols in ((slice(0, 4), 0, slice(0, 4)),
                                (slice(4, 7), 1, slice(0, 3)),
                                (slice(7, 10), 3, slice(0, 3))):
            ref = sample_trilinear(tex, mips, jnp.full((n,), img_i,
                                                       jnp.int32),
                                   uv, texel_scale=scale)
            np.testing.assert_allclose(np.asarray(b16[:, ch]),
                                       np.asarray(ref[:, cols]), atol=1e-5)
        ref_mr = sample_trilinear(tex, mips, jnp.full((n,), 2, jnp.int32),
                                  uv, texel_scale=scale)
        np.testing.assert_allclose(np.asarray(b16[:, 10]),
                                   np.asarray(ref_mr[:, 1]), atol=1e-5)
        np.testing.assert_allclose(np.asarray(b16[:, 11]),
                                   np.asarray(ref_mr[:, 2]), atol=1e-5)

    def test_mixed_resolution_and_missing_maps(self):
        from optix_raytracer_tpu.scene.device_scene import pack_bundles
        from optix_raytracer_tpu.shade.texture import sample_bundle
        rng = np.random.default_rng(4)
        base = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
        nmap = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
        mats_l = [{"kind": mat.DIFFUSE, "base_tex": 0, "normal_tex": 1},
                  {"kind": mat.DIFFUSE},                 # untextured
                  {"kind": mat.DIFFUSE, "base_tex": 0, "normal_tex": 1}]
        bundles, bmip, mat_bundle, _bq, _qb = pack_bundles([base, nmap], mats_l)
        assert mat_bundle[1] == -1
        assert mat_bundle[0] == mat_bundle[2] == 0     # dedup by tex tuple
        n = 256
        uv = jnp.asarray(rng.uniform(0, 1, (n, 2)).astype(np.float32))
        b16 = sample_bundle(bundles, bmip, jnp.zeros((n,), jnp.int32), uv)
        # missing emissive/mr come back neutral 1.0
        np.testing.assert_allclose(np.asarray(b16[:, 7:12]), 1.0)
        # untextured id -1 -> all-neutral
        b_neutral = sample_bundle(bundles, bmip,
                                  jnp.full((n,), -1, jnp.int32), uv)
        np.testing.assert_allclose(np.asarray(b_neutral[:, 0:4]), 1.0)
        np.testing.assert_allclose(
            np.asarray(b_neutral[:, 4:7]),
            np.broadcast_to([0.5, 0.5, 1.0], (n, 3)))

    def test_wrap_border_continuity(self):
        # fetch exactly at the wrap seam: u just below 1 vs just above 0
        from optix_raytracer_tpu.scene.device_scene import pack_bundles
        from optix_raytracer_tpu.shade.texture import sample_bundle
        rng = np.random.default_rng(5)
        img = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
        bundles, bmip, mb, _bq, _qb = pack_bundles([img], [{"base_tex": 0}])
        uv_a = jnp.asarray([[0.9999999, 0.5]], jnp.float32)
        uv_b = jnp.asarray([[1.0000001 - 1.0, 0.5]], jnp.float32)
        a = sample_bundle(bundles, bmip, jnp.zeros((1,), jnp.int32), uv_a)
        b = sample_bundle(bundles, bmip, jnp.zeros((1,), jnp.int32), uv_b)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


class TestQuadRows:
    """The quad-row bundle atlas (one [128] row per texel carrying the
    2x2x16 bilinear footprint) must reproduce the slice-gather fetch
    bit-for-bit — same taps, same weights, different memory layout."""

    def test_quad_fetch_matches_slice_fetch(self):
        from optix_raytracer_tpu.scene.device_scene import pack_bundles
        from optix_raytracer_tpu.shade.texture import sample_bundle

        rng = np.random.default_rng(3)
        base = rng.uniform(0, 1, (16, 24, 3)).astype(np.float32)
        nmap = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
        mats_l = [{"base_tex": 0, "normal_tex": 1}]
        bundles, bmip, mb, quads, qbase = pack_bundles([base, nmap], mats_l)
        uv = jnp.asarray(rng.uniform(-2, 2, (500, 2)), jnp.float32)
        bid = jnp.zeros((500,), jnp.int32)
        scale = jnp.asarray(rng.uniform(0, 8, (500,)), jnp.float32)
        a = sample_bundle(bundles, bmip, bid, uv, texel_scale=scale)
        b = sample_bundle(bundles, bmip, bid, uv, texel_scale=scale,
                          quads=quads, quad_base=qbase)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-6)
