"""The fused brute-force kernels compiled for the card (Triton route)
against the XLA reference. These need an NVIDIA GPU and skip elsewhere;
the same kernel code runs in interpret mode in test_pallas_intersect.py."""
import jax.numpy as jnp
import numpy as np
import pytest

from optix_raytracer_tpu.accel import bruteforce as bf
from optix_raytracer_tpu.accel.geometry import build_triangle_geometry
from optix_raytracer_tpu.core.rays import Rays

from test_intersect import random_mesh

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("num_tris", [1, 32, 512])
def test_compiled_kernel_matches_xla(gpu, num_tris):
    rng = np.random.default_rng(num_tris)
    verts, idx = random_mesh(rng, num_tris)
    geom = build_triangle_geometry(verts, idx)
    tri_mat = jnp.asarray(rng.integers(0, 5, num_tris), jnp.int32)
    n = 100_003
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays.make(jnp.asarray(o), jnp.asarray(d), tmin=1e-3, tmax=50.0)
    assert bf.choose_impl(num_tris) == "pallas"
    out = bf.intersect_closest(geom, rays, tri_mat=tri_mat, impl="pallas")
    ref = bf.intersect_closest(geom, rays, tri_mat=tri_mat, impl="xla")
    mismatch = np.asarray(out.prim_id) != np.asarray(ref.prim_id)
    assert mismatch.mean() <= 1e-4
    same = ~mismatch & np.asarray(ref.valid)
    np.testing.assert_allclose(np.asarray(out.t)[same],
                               np.asarray(ref.t)[same], atol=1e-4)
    occ = bf.intersect_any(geom, rays, impl="pallas")
    occ_ref = bf.intersect_any(geom, rays, impl="xla")
    assert (np.asarray(occ) != np.asarray(occ_ref)).mean() <= 1e-4
