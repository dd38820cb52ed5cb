"""Engine-level two-level traversal (IAS over shared GAS).

Verifies the verdict item: instanced scenes render identically to the
transform-baked path, sbt offsets remap materials, and per-frame instance
matrix updates are functional replaces with no geometry rebuild
(`Scene.cpp:1134-1213` buildInstanceAccel; `optixDynamicGeometry.cpp` IAS
update).
"""
import numpy as np
import jax.numpy as jnp

from optix_raytracer_tpu.accel import tlas
from optix_raytracer_tpu.accel import bruteforce as bf
from optix_raytracer_tpu.accel.geometry import build_triangle_geometry
from optix_raytracer_tpu.core import film as film_mod
from optix_raytracer_tpu.core.camera import Camera
from optix_raytracer_tpu.core.rays import Rays
from optix_raytracer_tpu.scene.scene import Scene
from optix_raytracer_tpu.shade import materials as mat
from optix_raytracer_tpu.shade.lights import ParallelogramLight
from optix_raytracer_tpu.wavefront.engine import render_accumulate


def cube(size=1.0):
    s = size / 2.0
    v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                  for z in (-s, s)], np.float32)
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],   # x faces
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],   # y faces
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],   # z faces
    ], np.int32)
    return v, f


def translate(x, y, z):
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = (x, y, z)
    return t


def scale_rot(s, deg):
    a = np.radians(deg)
    t = np.eye(4, dtype=np.float32)
    t[0, 0] = np.cos(a) * s
    t[0, 2] = np.sin(a) * s
    t[2, 0] = -np.sin(a) * s
    t[2, 2] = np.cos(a) * s
    t[1, 1] = s
    return t


MATERIALS = [
    {"kind": mat.DIFFUSE, "base_color": (0.8, 0.3, 0.2)},
    {"kind": mat.DIFFUSE, "base_color": (0.2, 0.4, 0.8)},
]
LIGHT = ParallelogramLight.make((-1, 4, -1), (2, 0, 0), (0, 0, 2),
                                (12.0, 12.0, 12.0))
XFORMS = [translate(-1.2, 0.0, 0.0) @ scale_rot(1.0, 25.0),
          translate(1.0, 0.4, -0.5) @ scale_rot(0.7, -40.0)]


def instanced_scene():
    s = Scene()
    for m in MATERIALS:
        s.add_material(m)
    v, f = cube()
    mi = s.add_mesh(v, f, material=0)
    s.add_instance(mi, XFORMS[0])
    s.add_instance(mi, XFORMS[1], sbt_offset=1)
    return s.finalize(area_light=LIGHT)


def baked_scene():
    s = Scene()
    for m in MATERIALS:
        s.add_material(m)
    v, f = cube()
    s.add_mesh(v, f, material=0, transform=XFORMS[0])
    s.add_mesh(v, f, material=1, transform=XFORMS[1])
    return s.finalize(area_light=LIGHT)


def camera(w, h):
    return Camera(eye=(0.0, 2.5, 6.0), lookat=(0.0, 0.2, 0.0),
                  up=(0, 1, 0), fov_y=35.0, aspect=w / h).params()


def render(scene, w=64, h=48, spl=24):
    film = film_mod.Film.create(h, w)
    film, _ = render_accumulate(scene, camera(w, h), film, w, h,
                                samples_per_launch=spl, max_depth=3,
                                chunk_size=None)
    return np.asarray(film.accum)


class TestIntersection:
    def test_matches_baked_geometry(self):
        inst = instanced_scene()
        baked = baked_scene()
        assert inst.has_instances and not baked.has_instances
        rng = np.random.default_rng(0)
        o = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
        o[:, 2] += 5.0
        d = rng.normal(size=(500, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = Rays.make(jnp.asarray(o), jnp.asarray(d), tmin=1e-3,
                         tmax=100.0)
        hi = tlas.intersect_instances(inst.geom, inst.instances, rays,
                                      tri_mat=inst.tri_mat)
        hb = bf.intersect_closest(baked.geom, rays, tri_mat=baked.tri_mat,
                                  chunk_size=None)
        np.testing.assert_array_equal(np.asarray(hi.valid),
                                      np.asarray(hb.valid))
        hit = np.asarray(hb.valid)
        np.testing.assert_allclose(np.asarray(hi.t)[hit],
                                   np.asarray(hb.t)[hit], rtol=2e-4)
        # sbt offset maps instance 1 (base material 0) to material 1
        np.testing.assert_array_equal(np.asarray(hi.mat_id)[hit],
                                      np.asarray(hb.mat_id)[hit])
        # world-space normals agree
        np.testing.assert_allclose(np.asarray(hi.normal)[hit],
                                   np.asarray(hb.normal)[hit], atol=2e-4)
        occ_i = tlas.intersect_instances_any(inst.geom, inst.instances, rays)
        occ_b = bf.intersect_any(baked.geom, rays, chunk_size=None)
        np.testing.assert_array_equal(np.asarray(occ_i), np.asarray(occ_b))

    def test_instance_ids(self):
        inst = instanced_scene()
        # rays aimed at each cube's center from the front
        targets = np.array([XFORMS[0][:3, 3], XFORMS[1][:3, 3]], np.float32)
        o = np.tile(np.array([[0.0, 0.3, 6.0]], np.float32), (2, 1))
        d = targets - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = Rays.make(jnp.asarray(o), jnp.asarray(d), tmin=1e-3,
                         tmax=100.0)
        h = tlas.intersect_instances(inst.geom, inst.instances, rays,
                                     tri_mat=inst.tri_mat)
        np.testing.assert_array_equal(np.asarray(h.inst_id), [0, 1])


class TestEngine:
    def test_render_matches_baked(self):
        img_i = render(instanced_scene())
        img_b = render(baked_scene())
        rmse = float(np.sqrt(np.mean((img_i - img_b) ** 2)))
        assert rmse < 2e-3, f"instanced vs baked render differ: rmse={rmse}"

    def test_ias_matrix_update_without_rebuild(self):
        scene = instanced_scene()
        moved_x = [translate(-1.2, 1.0, 0.0) @ scale_rot(1.0, 25.0),
                   XFORMS[1]]
        new_table = tlas.make_instances(
            moved_x, sbt_offsets=np.asarray([0, 1], np.int32),
            prim_ranges=scene.instances.prim_ranges)
        moved = scene.replace(instances=new_table)  # no geometry rebuild
        img0 = render(scene, spl=8)
        img1 = render(moved, spl=8)
        assert float(np.abs(img0 - img1).mean()) > 1e-4
        # and the moved render equals a from-scratch instanced build
        s = Scene()
        for m in MATERIALS:
            s.add_material(m)
        v, f = cube()
        mi = s.add_mesh(v, f, material=0)
        s.add_instance(mi, moved_x[0])
        s.add_instance(mi, moved_x[1], sbt_offset=1)
        img2 = render(s.finalize(area_light=LIGHT), spl=8)
        np.testing.assert_allclose(img1, img2, atol=1e-5)


class TestSmoothNormalsShading:
    """Interpolated vertex normals drive shading everywhere — plain
    scenes AND instanced hits (per-hit instance normal transform, the
    optix_device.h:728-868 transform-stack role)."""

    QUAD_V = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                      np.float32)
    QUAD_I = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    MAT = [{"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8)}]
    # light directly overhead in +z (quad normal direction)
    LIGHT_Z = ParallelogramLight.make((-0.25, -0.25, 5.0), (0.5, 0, 0),
                                      (0, 0.5, 0), (40.0, 40.0, 40.0))

    def _render(self, scene, n=None):
        from optix_raytracer_tpu.scene.device_scene import make_device_scene
        cam = Camera(eye=(0, 0, 4), lookat=(0, 0, 0), up=(0, 1, 0),
                     fov_y=30.0, aspect=1.0)
        film = film_mod.Film.create(24, 24)
        film, _ = render_accumulate(scene, cam.params(), film, 24, 24,
                                    samples_per_launch=64, max_depth=1,
                                    chunk_size=None)
        return np.asarray(film.accum)

    def test_tilted_vertex_normals_change_radiance(self):
        from optix_raytracer_tpu.scene.device_scene import make_device_scene
        tilt = np.array([np.sin(np.radians(45)), 0.0,
                         np.cos(np.radians(45))], np.float32)
        normals_t = np.tile(tilt, (4, 1))
        s_flat = make_device_scene(self.QUAD_V, self.QUAD_I,
                                   np.zeros(2, np.int32), self.MAT,
                                   area_light=self.LIGHT_Z)
        s_tilt = make_device_scene(self.QUAD_V, self.QUAD_I,
                                   np.zeros(2, np.int32), self.MAT,
                                   area_light=self.LIGHT_Z,
                                   normals=normals_t)
        img_f = self._render(s_flat)
        img_t = self._render(s_tilt)
        c = np.s_[8:16, 8:16]
        ratio = img_t[c].mean() / img_f[c].mean()
        # NEE weight scales with n·wi: cos(45°)
        np.testing.assert_allclose(ratio, np.cos(np.radians(45)), rtol=0.05)

    def test_instanced_smooth_matches_baked(self):
        from optix_raytracer_tpu.scene.device_scene import make_device_scene
        # bumpy normals varying per vertex
        normals = np.array([[0.3, 0.1, 0.95], [-0.2, 0.2, 0.95],
                            [0.1, -0.3, 0.94], [-0.1, -0.1, 0.98]],
                           np.float32)
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        rot = scale_rot(1.0, 30.0)
        # baked: rotate verts + normals on the host
        vb = (self.QUAD_V @ rot[:3, :3].T).astype(np.float32)
        # row-vector form of w = (R^-1)^T n  is  n_row @ R^-1
        nb = (normals @ np.linalg.inv(rot[:3, :3])).astype(np.float32)
        nb /= np.linalg.norm(nb, axis=1, keepdims=True)
        s_baked = make_device_scene(vb, self.QUAD_I, np.zeros(2, np.int32),
                                    self.MAT, area_light=self.LIGHT_Z,
                                    normals=nb)
        # instanced: object-space quad + one rotated instance
        table = tlas.make_instances([rot], num_prims=2)
        s_inst = make_device_scene(self.QUAD_V, self.QUAD_I,
                                   np.zeros(2, np.int32), self.MAT,
                                   area_light=self.LIGHT_Z, normals=normals,
                                   instances=table)
        img_b = self._render(s_baked)
        img_i = self._render(s_inst)
        c = np.s_[6:18, 6:18]
        hit = (img_b[c].mean(-1) > 1e-4) & (img_i[c].mean(-1) > 1e-4)
        assert hit.sum() > 40
        np.testing.assert_allclose(img_i[c][hit].mean(),
                                   img_b[c][hit].mean(), rtol=0.02)
        rel = np.abs(img_i[c][hit] - img_b[c][hit]) / (img_b[c][hit] + 1e-4)
        # identical RNG streams: only edge pixels may flip hit/miss
        assert np.quantile(rel, 0.9) < 0.1, np.quantile(rel, 0.9)


class TestInstancedTraversal:
    """Instanced scenes traverse through the IAS loop with brute force per
    instance; no BVH is built over the object-space concatenation."""

    def test_large_instanced_mesh_builds_no_bvh(self):
        from optix_raytracer_tpu.scene.device_scene import make_device_scene
        from optix_raytracer_tpu.scene.builtins import trefoil_mesh
        from optix_raytracer_tpu.wavefront.intersect import traversal
        verts, idx, _ = trefoil_mesh(40, 16)          # 1280 tris > 512
        table = tlas.make_instances([translate(0, 0, 0)],
                                    prim_ranges=[(0, len(idx))])
        scene = make_device_scene(verts, idx, np.zeros(len(idx), np.int32),
                                  MATERIALS, instances=table)
        assert not scene.has_bvh
        assert traversal(scene, platform="gpu") == "instances"
        assert traversal(scene, platform="cpu") == "instances"

    def test_kernel_impl_matches_xla(self):
        v, i = cube()
        geom = build_triangle_geometry(v, i)
        tri_mat = jnp.arange(geom.num_triangles, dtype=jnp.int32) % 3
        table = tlas.make_instances(
            [translate(-2.0, 0, 0), translate(2.0, 0.5, 0)
             @ scale_rot(0.7, 30.0)],
            sbt_offsets=np.asarray([0, 1], np.int32),
            prim_ranges=[(0, geom.num_triangles)] * 2)
        rng = np.random.default_rng(9)
        o = np.tile(np.float32([0.0, 0.0, -8.0]), (300, 1))
        target = rng.uniform([-3.5, -1.5, -1.0], [3.5, 2.0, 1.0], (300, 3))
        d = (target - o).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = Rays.make(jnp.asarray(o), jnp.asarray(d), tmin=1e-3,
                         tmax=100.0)
        ref = tlas.intersect_instances(geom, table, rays, tri_mat=tri_mat,
                                       impl="xla")
        out = tlas.intersect_instances(geom, table, rays, tri_mat=tri_mat,
                                       impl="pallas_interpret")
        for k in ("prim_id", "inst_id", "mat_id"):
            np.testing.assert_array_equal(np.asarray(getattr(out, k)),
                                          np.asarray(getattr(ref, k)))
        hit = np.asarray(ref.valid)
        assert hit.any()
        np.testing.assert_allclose(np.asarray(out.t)[hit],
                                   np.asarray(ref.t)[hit], rtol=1e-5)
        np.testing.assert_array_equal(
            np.asarray(tlas.intersect_instances_any(
                geom, table, rays, impl="pallas_interpret")),
            np.asarray(tlas.intersect_instances_any(geom, table, rays,
                                                    impl="xla")))
