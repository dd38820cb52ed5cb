"""Interleaved row distribution + sharded texture memory."""
import jax
import numpy as np
import pytest

from optix_raytracer_tpu.core import film as film_mod
from optix_raytracer_tpu.multichip import memory, tiles
from optix_raytracer_tpu.scene.builtins import cornell_box, cornell_camera
from optix_raytracer_tpu.wavefront.engine import render_accumulate


@pytest.fixture(scope="module")
def scene():
    return cornell_box()


class TestInterleaved:
    def test_matches_single_chip_after_deinterleave(self, scene):
        w = h = 32
        cam = cornell_camera(w, h).params()
        ref, _ = render_accumulate(scene, cam, film_mod.Film.create(h, w),
                                   w, h, samples_per_launch=2, max_depth=2,
                                   chunk_size=None)
        mesh = tiles.make_mesh(n_rows=8, n_samples=1,
                               devices=jax.devices()[:8])
        film = tiles.shard_film(film_mod.Film.create(h, w), mesh)
        film = tiles.render_accumulate_interleaved(
            scene, cam, film, mesh, w, h, samples_per_launch=2, max_depth=2)
        out = tiles.deinterleave_rows(np.asarray(film.accum), 8)
        np.testing.assert_allclose(out, np.asarray(ref.accum),
                                   rtol=1e-5, atol=1e-5)

    def test_deinterleave_permutation(self):
        acc = np.arange(8 * 2 * 1 * 1).reshape(8 * 2, 1, 1).astype(np.float32)
        # shard r holds rows [r, r+8] of the global image at local 0,1
        out = tiles.deinterleave_rows(acc, 8)
        # global row g = shard g%8, local g//8 → out[g] = acc[(g%8)*2 + g//8]
        for g in range(16):
            assert out[g, 0, 0] == acc[(g % 8) * 2 + g // 8, 0, 0]


class TestShardedTextures:
    def test_sharded_textures_render_matches(self, tmp_path):
        from test_scene_gltf import make_cube_gltf
        from optix_raytracer_tpu.scene.scene import Scene
        from optix_raytracer_tpu.shade.lights import AMBIENT, DIRECTIONAL
        path = make_cube_gltf(str(tmp_path / "cube.gltf"))
        host = Scene.load(path)
        lights = [{"kind": DIRECTIONAL, "direction": (-0.4, -0.7, -0.6),
                   "color": (0.9, 0.9, 0.9)},
                  {"kind": AMBIENT, "color": (0.25, 0.25, 0.25)}]
        ds = host.finalize(lights=lights)
        cam = host.default_camera(32, 32).params()
        from optix_raytracer_tpu.wavefront.whitted import render_whitted_sample
        ref = np.asarray(render_whitted_sample(ds, cam, 32, 32, 0,
                                               max_depth=2))
        mesh = tiles.make_mesh(n_rows=8, n_samples=1,
                               devices=jax.devices()[:8])
        ds_sharded = memory.shard_scene_textures(ds, mesh)
        out = np.asarray(render_whitted_sample(ds_sharded, cam, 32, 32, 0,
                                               max_depth=2))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


class TestPlacementPolicy:
    """optixNVLink placement policy (`optixNVLink.cpp:1524-1569,1698-1712`):
    one texture replica per island, spread over its members, chosen by
    a size heuristic; measured per-chip HBM saving."""

    def _mesh(self):
        from optix_raytracer_tpu.multichip import multislice as ms
        return ms.make_multislice_mesh(2, 2, 2, devices=jax.devices()[:8])

    def test_plan_modes(self):
        mesh = self._mesh()
        small = memory.plan_texture_placement(1 << 10, mesh,
                                              budget_bytes=1 << 20)
        assert small["mode"] == "replicate" and small["replicas"] == 8
        big = memory.plan_texture_placement(3 << 20, mesh,
                                            budget_bytes=1 << 20)
        assert big["mode"] == "shard_island"
        assert big["replicas"] == 2            # one copy per slice (island)
        assert big["per_chip_bytes"] <= (3 << 20) // 4 + 1
        huge = memory.plan_texture_placement(16 << 20, mesh,
                                             budget_bytes=1 << 20)
        assert huge["mode"] == "shard_global" and huge["replicas"] == 1

    def test_hbm_drop_and_render_match(self, tmp_path):
        from test_scene_gltf import make_cube_gltf
        from optix_raytracer_tpu.scene.scene import Scene
        from optix_raytracer_tpu.shade.lights import AMBIENT, DIRECTIONAL
        from optix_raytracer_tpu.wavefront.whitted import (
            render_whitted_sample)
        path = make_cube_gltf(str(tmp_path / "cube.gltf"))
        host = Scene.load(path)
        lights = [{"kind": DIRECTIONAL, "direction": (-0.4, -0.7, -0.6),
                   "color": (0.9, 0.9, 0.9)},
                  {"kind": AMBIENT, "color": (0.25, 0.25, 0.25)}]
        ds = host.finalize(lights=lights)
        cam = host.default_camera(32, 32).params()
        ref = np.asarray(render_whitted_sample(ds, cam, 32, 32, 0,
                                               max_depth=2))
        mesh = self._mesh()
        rep_scene, rep_report = memory.place_scene_textures(
            ds, mesh, budget_bytes=1 << 40)
        assert rep_report["mode"] == "replicate"
        rep_bytes = memory.per_chip_texture_bytes(rep_scene)

        sh_scene, sh_report = memory.place_scene_textures(
            ds, mesh, budget_bytes=1)
        assert sh_report["mode"].startswith("shard")
        sh_bytes = memory.per_chip_texture_bytes(sh_scene)
        # per-chip texture memory must actually drop (island size 4 when
        # every dim divides; >= 2x even with partial divisibility)
        assert sh_bytes <= rep_bytes // 2, (sh_bytes, rep_bytes)

        out = np.asarray(render_whitted_sample(sh_scene, cam, 32, 32, 0,
                                               max_depth=2))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


class TestMultiSlice:
    """Multi-host (DCN) mesh: (slice, rows, samples) — row bands across
    slices, sample pmean intra-slice, no rendering collective on the DCN
    axis. Must equal the single-chip accumulate exactly."""

    def test_multislice_matches_single_chip(self):
        import jax
        import numpy as np
        import jax.numpy as jnp
        from optix_raytracer_tpu.core import film as film_mod
        from optix_raytracer_tpu.multichip import multislice as ms
        from optix_raytracer_tpu.scene.builtins import (cornell_box,
                                                        cornell_camera)
        from optix_raytracer_tpu.wavefront.engine import render_accumulate

        w, h = 16, 32
        scene = cornell_box()
        cam = cornell_camera(w, h).params()

        mesh = ms.make_multislice_mesh(2, 2, 2,
                                       devices=jax.devices()[:8])
        film = ms.shard_film(film_mod.Film.create(h, w), mesh)
        film = ms.render_accumulate_multislice(
            scene, cam, film, mesh, w, h, samples_per_launch=1, max_depth=2)
        assert int(film.subframe) == 2

        ref = film_mod.Film.create(h, w)
        for _ in range(2):
            ref, _ = render_accumulate(scene, cam, ref, w, h,
                                       samples_per_launch=1, max_depth=2,
                                       chunk_size=None)
        np.testing.assert_allclose(np.asarray(film.accum),
                                   np.asarray(ref.accum), atol=2e-5)


class TestDistributedBringup:
    """multichip/distributed.py: env detection + single-process no-op +
    pod_mesh construction (the jax.distributed wrapper; real multi-host
    needs a pod, but the config plumbing and the mesh invariant are
    testable here)."""

    def test_detect_config_empty_is_single_process(self, monkeypatch):
        from optix_raytracer_tpu.multichip import distributed as dist
        for v in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                  "JAX_PROCESS_ID", "SLURM_NTASKS", "SLURM_PROCID",
                  "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
                  "COORDINATOR_ADDRESS"):
            monkeypatch.delenv(v, raising=False)
        assert dist.detect_config() == (None, 1, 0)

    def test_detect_config_env(self, monkeypatch):
        from optix_raytracer_tpu.multichip import distributed as dist
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.2:1234")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
        monkeypatch.setenv("JAX_PROCESS_ID", "2")
        assert dist.detect_config() == ("10.0.0.2:1234", 4, 2)
        # explicit args override env
        assert dist.detect_config("h:1", 8, 7) == ("h:1", 8, 7)

    def test_detect_config_slurm(self, monkeypatch):
        from optix_raytracer_tpu.multichip import distributed as dist
        for v in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                  "JAX_PROCESS_ID"):
            monkeypatch.delenv(v, raising=False)
        monkeypatch.setenv("COORDINATOR_ADDRESS", "head:999")
        monkeypatch.setenv("SLURM_NTASKS", "16")
        monkeypatch.setenv("SLURM_PROCID", "5")
        assert dist.detect_config() == ("head:999", 16, 5)

    def test_single_process_initialize_noop_and_pod_mesh(self, monkeypatch):
        from optix_raytracer_tpu.multichip import distributed as dist
        import jax
        for v in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                  "JAX_PROCESS_ID", "SLURM_NTASKS", "SLURM_PROCID",
                  "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
                  "COORDINATOR_ADDRESS"):
            monkeypatch.delenv(v, raising=False)
        dist.shutdown()
        info = dist.initialize()
        assert not info.initialized          # no-op path
        assert info.num_processes == 1 and info.process_id == 0
        assert not info.is_multi_host
        assert len(info.global_devices) == len(jax.devices())
        # 8 virtual CPU chips -> 1 slice x 4 rows x 2 samples
        mesh = dist.pod_mesh(rows_per_slice=4, samples_per_slice=2)
        assert mesh.shape == {"slice": 1, "rows": 4, "samples": 2}
        mesh2 = dist.pod_mesh()              # default: all chips as rows
        assert mesh2.shape == {"slice": 1, "rows": 8, "samples": 1}
        dist.shutdown()
