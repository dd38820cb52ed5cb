"""The traversal choice (wavefront/intersect.py `traversal`) per scene and
platform, and the acceleration structures make_device_scene builds for it.
The platform is an argument, so every branch is checked on the CPU."""
import numpy as np
import pytest

from optix_raytracer_tpu.accel import bruteforce as bf
from optix_raytracer_tpu.scene.builtins import cornell_box, trefoil_mesh
from optix_raytracer_tpu.scene.device_scene import DeviceScene, make_device_scene
from optix_raytracer_tpu.wavefront.intersect import traversal

MATS = [{"kind": 0, "base_color": (0.7, 0.6, 0.5)}]


def _mesh_scene(rings, segs):
    verts, idx, normals = trefoil_mesh(rings, segs)
    return make_device_scene(verts, idx, np.zeros(len(idx), np.int32), MATS,
                             normals=normals)


@pytest.fixture(scope="module")
def knot25k():
    """The knot configuration of the benchmark: 25,200 triangles."""
    return _mesh_scene(200, 63)


@pytest.fixture(scope="module")
def cornell():
    return cornell_box()


@pytest.mark.parametrize("platform,expected", [
    ("gpu", "pallas"), ("cpu", "xla")])
def test_cornell_brute_force_by_platform(cornell, platform, expected):
    assert cornell.num_triangles <= bf.BRUTE_FORCE_MAX_TRIS
    assert not cornell.has_bvh
    assert traversal(cornell, platform=platform) == expected


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_xla_impl_forces_plain_brute_force(cornell, platform):
    assert traversal(cornell, impl="xla", platform=platform) == "xla"


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_knot_takes_bvh_on_every_platform(knot25k, platform):
    assert traversal(knot25k, platform=platform) == "bvh"
    assert traversal(knot25k, impl="xla", platform=platform) == "bvh"


def test_knot_defaults_build_bvh_only(knot25k):
    assert knot25k.num_triangles == 25200
    assert knot25k.has_bvh
    # a threaded BVH over M triangles has 2M - 1 nodes
    assert knot25k.bvh.num_nodes == 2 * knot25k.num_triangles - 1
    assert not hasattr(knot25k, "clusters")
    assert not hasattr(DeviceScene, "has_clusters")


@pytest.mark.parametrize("rings,segs,expect_bvh", [
    (16, 16, False),      # 512 triangles: at the limit, brute force
    (17, 16, True),       # 544 triangles: past it
])
def test_bvh_threshold(rings, segs, expect_bvh):
    s = _mesh_scene(rings, segs)
    assert (s.num_triangles > bf.BRUTE_FORCE_MAX_TRIS) == expect_bvh
    assert s.has_bvh == expect_bvh
    assert traversal(s, platform="gpu") == ("bvh" if expect_bvh
                                            else "pallas")


def test_prebuilt_bvh_is_used(knot25k):
    verts, idx, normals = trefoil_mesh(200, 63)
    s = make_device_scene(verts, idx, np.zeros(len(idx), np.int32), MATS,
                          normals=normals, bvh=knot25k.bvh)
    assert s.bvh is knot25k.bvh
