"""chip_smoke.py on the CPU: it must refuse to run without a GPU (and when
the package is not next to it), and its phases must pass at tiny sizes
with the kernels in interpret mode."""
import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(script, cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_exits_nonzero_without_gpu():
    r = _run(SCRIPT, ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_without_gpu_four_cards():
    r = _run(SCRIPT, ROOT, "--cards", "4")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_exits_nonzero_alone(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, alone)
    r = _run(str(alone), str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_phase_device_refuses_cpu(smoke):
    with pytest.raises(SystemExit):
        smoke.phase_device()


def test_device_info_names_the_backend(smoke):
    info = smoke.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


def test_phase_kernels_interpret(smoke):
    res = smoke.phase_kernels(width=16, height=8, n_bounce=200,
                              impl="pallas_interpret", timed=False)
    assert [(r["kernel"], r["mesh"]) for r in res] == [
        ("closest_hit", "cornell32"), ("any_hit", "cornell32"),
        ("closest_hit", "mesh512"), ("any_hit", "mesh512")]
    assert all(r["ok"] and r["rays"] == 16 * 8 + 200 for r in res)
    assert res[2]["tris"] == 512


def test_compare_closest_counts_ties_and_mismatches(smoke):
    from optix_raytracer_tpu.core.rays import Hits
    import jax.numpy as jnp

    def hits(t, prim):
        t = jnp.asarray(t, jnp.float32)
        prim = jnp.asarray(prim, jnp.int32)
        return Hits(t=t, prim_id=prim, inst_id=jnp.where(prim >= 0, 0, -1),
                    mat_id=jnp.where(prim >= 0, 0, -1),
                    uv=jnp.zeros(t.shape + (2,)),
                    normal=jnp.zeros(t.shape + (3,)))

    ref = hits([1.0, 2.0, 3.0, 9.0], [0, 1, 2, -1])
    same = smoke.compare_closest(ref, ref, extent=10.0)
    assert same["ok"] and same["mismatch"] == 0 and same["max_dt"] == 0
    # prim 5 at the same t as prim 1 is a tie; a hit where the reference
    # misses is a mismatch
    out = hits([1.0, 2.0, 3.0, 4.0], [0, 5, 2, 7])
    res = smoke.compare_closest(out, ref, extent=10.0)
    assert res["ties"] == 1 and res["mismatch"] == 1 and not res["ok"]
    far = hits([1.0, 2.5, 3.0, 9.0], [0, 5, 2, -1])
    assert smoke.compare_closest(far, ref, extent=10.0)["mismatch"] == 1


def test_compare_any(smoke):
    a = np.array([True, False, True])
    assert smoke.compare_any(a, a)["ok"]
    assert not smoke.compare_any(a, ~a)["ok"]


def test_render_launches_tiny(smoke):
    from optix_raytracer_tpu.scene.builtins import cornell_box, cornell_camera
    res = smoke.render_launches(cornell_box(),
                                cornell_camera(16, 8).params(), 16, 8, 2, 2,
                                "cornell-tiny")
    assert res["subframe"] == 6 and res["finite"] and res["nonnegative"]
    assert res["launches_timed"] == 2


def test_phase_golden(smoke):
    res = smoke.phase_golden()
    assert res["rmse_xla"] < smoke.GOLDEN_RMSE_TOL


def test_phase_knot_hits_small(smoke):
    from optix_raytracer_tpu.scene.builtins import knot_scene
    scene = knot_scene(40, 12)
    res = smoke.phase_knot_hits(scene, width=32, height=16, n_rays=256)
    assert res["ok"] and res["rays"] == 256 and res["hits"] > 0


def test_phase_cards_on_four_cpu_devices(smoke):
    """The four-card phase on four virtual CPU devices (conftest forces the
    host platform's device count), at a tiny frame."""
    assert len(jax.devices()) >= 4
    res = smoke.phase_cards(width=16, height=8, spp_per_card=1, n_cards=4)
    assert [r["scene"] for r in res] == ["cornell", "knot"]
    for r in res:
        assert r["mesh"] == {"rows": 2, "samples": 2}
        assert r["pixels_past_tol"] <= smoke.CARDS_BAD_FRAC
        assert r["subframe"] == 2
