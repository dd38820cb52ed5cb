"""The main path needs only JAX and numpy: the path tracer app must import,
render and write its PNG with `flax` and `PIL` unimportable; packages off
the main path stay lazy and name themselves when missing. Also the compile
cache location, with and without JAX_COMPILATION_CACHE_DIR."""
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked for this test")
            return None

    sys.meta_path.insert(0, Block())
""")


def _run_blocked(blocked, body, tmp_path):
    code = (f"BLOCKED = {tuple(blocked)!r}\n" + _BLOCKER
            + textwrap.dedent(body))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_pathtracer_runs_without_flax_and_pil(tmp_path):
    r = _run_blocked(("flax", "PIL"), """
        import sys
        from optix_raytracer_tpu.apps import pathtracer
        pathtracer.main(["--dim", "16x8", "--samples", "2",
                         "--launch-samples", "2", "--depth", "2",
                         "--file", "out.png"])
        from optix_raytracer_tpu.io.image import load_image
        img = load_image("out.png")
        assert img.shape[:2] == (8, 16), img.shape
        assert "flax" not in sys.modules and "PIL" not in sys.modules
        print("RENDERED", img.mean())
    """, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "RENDERED" in r.stdout


def test_core_modules_import_without_flax(tmp_path):
    r = _run_blocked(("flax", "PIL"), """
        import optix_raytracer_tpu.core, optix_raytracer_tpu.accel
        import optix_raytracer_tpu.scene.device_scene
        import optix_raytracer_tpu.wavefront.engine
        import optix_raytracer_tpu.multichip.tiles
        print("IMPORTED")
    """, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "IMPORTED" in r.stdout


@pytest.mark.parametrize("blocked,body", [
    ("zstandard", """
        import numpy as np
        from optix_raytracer_tpu.io import ktx2
        ktx2.write_ktx2("t.ktx2", np.zeros((4, 4, 4), np.uint8),
                        supercompression="ZSTD")
    """),
    ("orbax", """
        from optix_raytracer_tpu.core import checkpoint, film
        checkpoint.save_checkpoint_orbax("ckpt", film.Film.create(2, 2))
    """),
    ("matplotlib", """
        from optix_raytracer_tpu.apps import viewer
        viewer.run_interactive(None, "out.png")
    """),
    ("PIL", """
        from optix_raytracer_tpu.scene import gltf
        gltf._decode_image({}, [], ".", {"uri": "x.png"})
    """),
])
def test_lazy_optional_packages_name_themselves(tmp_path, blocked, body):
    """Each optional package is imported only where it is used, and its
    absence fails there with an error naming it."""
    r = _run_blocked((blocked,), "import optix_raytracer_tpu.apps\n"
                     + textwrap.dedent(body),
                     tmp_path)
    assert r.returncode != 0
    assert "ImportError" in r.stderr and blocked in r.stderr


class TestCompileCache:
    def test_env_set_is_used_and_nothing_else_is_set(self, monkeypatch,
                                                     tmp_path):
        import jax
        from optix_raytracer_tpu.core import compile_cache as cc
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        monkeypatch.setenv(cc.ENV, str(tmp_path / "from_env"))
        assert cc.compile_cache_dir() == str(tmp_path / "from_env")
        assert cc.enable_compile_cache() == str(tmp_path / "from_env")
        assert calls == []

    def test_env_unset_uses_checkout_dir(self, monkeypatch):
        import jax
        from optix_raytracer_tpu.core import compile_cache as cc
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        monkeypatch.delenv(cc.ENV, raising=False)
        expect = os.path.join(ROOT, ".jax_cache")
        assert cc.CHECKOUT_CACHE_DIR == expect
        assert cc.compile_cache_dir() == expect
        assert cc.enable_compile_cache() == expect
        assert calls == [("jax_compilation_cache_dir", expect)]
        assert os.path.isdir(expect)

    def test_cache_dir_is_gitignored(self):
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()

    def test_device_context_defaults_to_the_cache_dir(self, monkeypatch,
                                                      tmp_path):
        import jax
        from optix_raytracer_tpu.api.context import DeviceContext
        from optix_raytracer_tpu.core import compile_cache as cc
        monkeypatch.setattr(jax.config, "update", lambda *a: None)
        monkeypatch.setenv(cc.ENV, str(tmp_path / "ctx"))
        assert DeviceContext().get_cache_location() == str(tmp_path / "ctx")
        monkeypatch.delenv(cc.ENV)
        assert DeviceContext().get_cache_location() == cc.CHECKOUT_CACHE_DIR


def test_abortable_compile_refuses_the_accelerator():
    from optix_raytracer_tpu.api.module import AbortableCompile
    with pytest.raises(ValueError):
        AbortableCompile("jax.numpy", "sin", [((4,), "float32")],
                         backend="gpu")
