"""Smoke test of the path tracer on one GPU: the quickest proof that the
system still starts, compiles and renders correctly on the card.

    python chip_smoke.py              # one GPU: phases (a)-(d)
    python chip_smoke.py --cards 4    # four GPUs: phase (e) only

Phases:
  (a) device   - JAX's default platform must be "gpu"; no CPU fallback.
  (b) kernels  - every hand-written kernel (accel/pallas_bf.py, compiled
                 through Triton) against the XLA brute-force reference on
                 ~2.6M rays: the 1080p primary wavefront plus seeded random
                 bounce rays, on the Cornell box (32 triangles) and a
                 512-triangle knot.
  (c) cornell  - render_accumulate at 1920x1088, 16 samples per launch,
                 depth 4, through the kernel and again through plain XLA
                 (the end-to-end comparison); then the 32x32 golden image.
  (d) knot     - the 25,200-triangle trefoil knot (BVH traversal) through
                 render_accumulate at 1920x1088, 16 spp, depth 3; then its
                 BVH closest hits against XLA brute force on 65,536 of its
                 primary rays.
  (e) 4 cards  - tiles.render_accumulate_sharded of Cornell and the knot at
                 1080p on a (rows=2, samples=2) mesh, against the one-card
                 render_accumulate in the same process.

Every phase raises on failure, so the script exits non-zero; the last line
of standard output is one JSON object with "ok" and the device, printed
only when every phase passed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "optix_raytracer_tpu"

FULL_W, FULL_H = 1920, 1088
SPP = 16

# Kernel vs XLA reference. Both evaluate the same f32 unit-triangle
# transform, the kernel with scalar FMAs and XLA with a HIGHEST matmul, so
# rounding differs in the last bits relative to the scene's coordinates
# (not to t): |t_kernel - t_ref| <= T_TOL_REL * scene extent. A last-bit
# difference can also move a hit across a triangle edge, or pick the other
# of two triangles at the same t (an exact tie). The unit-triangle test is
# not watertight, so a ray through an edge shared by two triangles can miss
# both in one float path and hit a farther triangle; the BVH's slab tests
# round on their own too. At most MISMATCH_FRAC of the rays may disagree
# on hit/miss or on the triangle.
T_TOL_REL = 1e-5
MISMATCH_FRAC = 1e-4
# The golden Cornell image (tests/golden, rendered on the CPU): identical
# RNG streams, but FMA contraction and summation order differ on the GPU,
# which can send a few paths another way. The repo's golden test gate.
GOLDEN_RMSE_TOL = 3e-3
# Four cards vs one: same RNG streams; the sharded path keeps a running
# mean per card and averages over the samples axis, the one-card path sums
# and divides, and each compiles its own program. Pixels may differ by
# float rounding, and a path whose rounding flips a decision (a hit at an
# edge, Russian roulette at its threshold) changes its pixel's sample.
CARDS_ABS_TOL = 1e-3           # per-pixel difference counted as rounding
CARDS_BAD_FRAC = 1e-3          # share of pixels allowed past it


def _log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """`name, power.limit` of every visible card, as nvidia-smi says."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    return out


def device_info() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def phase_device(cards: int = 1) -> dict:
    """(a) The accelerator: a GPU backend with at least `cards` devices."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{info['platform']!r}); not running on the CPU")
    if info["count"] < cards:
        raise SystemExit(f"chip_smoke: {cards} GPUs needed, "
                         f"{info['count']} visible")
    _log(f"[device] {info}")
    return info


# --------------------------------------------------------------------- rays

def primary_rays(cam_params, width, height):
    """The unjittered primary wavefront, flat [width*height]."""
    import jax
    from optix_raytracer_tpu.core.camera import generate_rays
    rays, _ = generate_rays(cam_params, width, height, jitter=False)
    n = width * height
    return jax.tree.map(lambda a: a.reshape((n,) + a.shape[2:]), rays)


def bounce_rays(geom, n, seed):
    """Seeded random rays from inside the mesh's bounds in uniform
    directions; a quarter are dead lanes (empty window), as in a bounce
    wavefront, and the shadow variant gets finite windows."""
    import jax.numpy as jnp
    import numpy as np
    from optix_raytracer_tpu.core.rays import Rays
    rng = np.random.default_rng(seed)
    v = np.asarray(geom.vertices)
    lo, hi = v.min(axis=0), v.max(axis=0)
    o = lo + (hi - lo) * rng.uniform(0.05, 0.95, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    extent = float(np.linalg.norm(hi - lo))
    tmax = np.where(rng.uniform(size=n) < 0.25, 0.0, 1e16)
    shadow_tmax = np.where(tmax > 0, rng.uniform(0, extent, n), 0.0)
    mk = lambda a: jnp.asarray(a, jnp.float32)   # noqa: E731
    radiance = Rays(origin=mk(o), direction=mk(d),
                    tmin=jnp.full((n,), 1e-2, jnp.float32), tmax=mk(tmax))
    return radiance, radiance.replace(tmax=mk(shadow_tmax))


def concat_rays(a, b):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(lambda x, y: jnp.concatenate([x, y]), a, b)


def scene_extent(geom) -> float:
    import numpy as np
    v = np.asarray(geom.vertices)
    return float(np.linalg.norm(v.max(axis=0) - v.min(axis=0)))


# ------------------------------------------------------------- comparisons

def compare_closest(out, ref, extent: float) -> dict:
    """Hit-by-hit agreement of two closest-hit results (see T_TOL_REL)."""
    import numpy as np
    ov, rv = np.asarray(out.valid), np.asarray(ref.valid)
    ot, rt = np.asarray(out.t), np.asarray(ref.t)
    op, rp = np.asarray(out.prim_id), np.asarray(ref.prim_id)
    tol = T_TOL_REL * extent
    both = ov & rv
    dt = np.abs(ot - rt)
    tie = both & (op != rp) & (dt <= tol)
    hit_miss = ov != rv
    wrong_prim = both & (op != rp) & ~tie
    mismatch = hit_miss | wrong_prim
    same = both & (op == rp)
    mat_ok = bool(np.array_equal(np.asarray(out.mat_id)[same],
                                 np.asarray(ref.mat_id)[same]))
    res = {"rays": int(ov.size), "hits": int(rv.sum()),
           "mismatch": int(mismatch.sum()), "hit_miss": int(hit_miss.sum()),
           "wrong_prim": int(wrong_prim.sum()), "ties": int(tie.sum()),
           "max_dt": float(dt[same].max()) if same.any() else 0.0,
           "t_tol": tol, "mat_ok": mat_ok}
    res["ok"] = bool(res["mismatch"] <= MISMATCH_FRAC * res["rays"]
                     and res["max_dt"] <= tol and mat_ok)
    return res


def compare_any(out, ref) -> dict:
    import numpy as np
    out, ref = np.asarray(out), np.asarray(ref)
    mismatch = int((out != ref).sum())
    return {"rays": int(out.size), "occluded": int(ref.sum()),
            "mismatch": mismatch,
            "ok": bool(mismatch <= MISMATCH_FRAC * out.size)}


def _time(fn, reps=5) -> float:
    """Mean seconds per call after one warm-up call."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn()
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / reps


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"chip_smoke: {what}")


# ------------------------------------------------------------------ phases

def phase_kernels(width=FULL_W, height=FULL_H, n_bounce=1 << 19,
                  impl="pallas", timed=True) -> list:
    """(b) Each kept kernel against the XLA reference at real widths.
    impl="pallas_interpret" runs the same check on the CPU."""
    from optix_raytracer_tpu.accel import bruteforce as bf
    from optix_raytracer_tpu.scene.builtins import (
        cornell_box, cornell_camera, knot_camera, trefoil_mesh)
    from optix_raytracer_tpu.scene.device_scene import make_device_scene
    import numpy as np

    verts, idx, normals = trefoil_mesh(16, 16)
    mesh512 = make_device_scene(verts, idx, np.zeros(len(idx), np.int32),
                                [{"kind": 0}], normals=normals)
    cases = [("cornell32", cornell_box(), cornell_camera(width, height)),
             ("mesh512", mesh512, knot_camera(width, height))]
    results = []
    for seed, (name, scene, cam) in enumerate(cases):
        geom, tm = scene.geom, scene.tri_mat
        _check(bf.choose_impl(geom.num_triangles, impl) == impl,
               f"{name}: {impl} not chosen")
        extent = scene_extent(geom)
        radiance, shadow = bounce_rays(geom, n_bounce, seed)
        prim = primary_rays(cam.params(), width, height)
        rays = concat_rays(prim, radiance)
        # primary rays as shadow rays toward a point half the scene away
        shadow = concat_rays(prim.replace(
            tmax=np.full(prim.tmax.shape, 0.5 * extent, np.float32)), shadow)

        def closest(i, r=rays):
            return bf.intersect_closest(geom, r, tri_mat=tm, impl=i,
                                        chunk_size=65536)

        def anyhit(i, r=shadow):
            return bf.intersect_any(geom, r, impl=i, chunk_size=65536)

        res = {"kernel": "closest_hit", "mesh": name,
               "tris": geom.num_triangles,
               **compare_closest(closest(impl), closest("xla"), extent)}
        res_any = {"kernel": "any_hit", "mesh": name,
                   "tris": geom.num_triangles,
                   **compare_any(anyhit(impl), anyhit("xla"))}
        if timed:
            res["kernel_ms"] = 1e3 * _time(lambda: closest(impl))
            res["xla_ms"] = 1e3 * _time(lambda: closest("xla"))
            res_any["kernel_ms"] = 1e3 * _time(lambda: anyhit(impl))
            res_any["xla_ms"] = 1e3 * _time(lambda: anyhit("xla"))
        for r in (res, res_any):
            _log(f"[kernels] {json.dumps(r)} tolerance: mismatch <= "
                 f"{MISMATCH_FRAC:g} of rays, |dt| <= {T_TOL_REL:g} x "
                 f"extent {extent:.4g}")
            _check(r["ok"], f"{r['kernel']} on {name} outside tolerance")
            results.append(r)
    return results


def render_launches(scene, cam_params, width, height, spp, depth, label,
                    launches=2, chunk_size=65536, impl="auto") -> dict:
    """Compile render_accumulate, warm up with one launch, then time
    `launches` launches; checks the film and returns the numbers.
    impl="xla" forces the plain XLA brute force (no kernel)."""
    import jax
    import numpy as np
    from optix_raytracer_tpu.core.film import Film
    from optix_raytracer_tpu.wavefront.engine import render_accumulate

    film = Film.create(height, width)
    t0 = time.perf_counter()
    step = render_accumulate.lower(
        scene, cam_params, film, width, height, samples_per_launch=spp,
        max_depth=depth, chunk_size=chunk_size, impl=impl).compile()
    compile_s = time.perf_counter() - t0
    _log(f"[{label}] compile_s {compile_s:.3f}")
    _log(f"[{label}] memory_analysis {step.memory_analysis()}")
    film, _ = step(scene, cam_params, film)
    jax.block_until_ready(film.accum)
    rays = 0.0
    t0 = time.perf_counter()
    for _ in range(launches):
        film, n = step(scene, cam_params, film)
        rays += float(n)
    jax.block_until_ready(film.accum)
    dt = time.perf_counter() - t0
    accum = np.asarray(film.accum)
    stats = jax.devices()[0].memory_stats() or {}
    res = {"impl": impl, "width": width, "height": height,
           "spp_per_launch": spp, "depth": depth, "launches_timed": launches,
           "compile_s": compile_s, "launch_s": dt / launches,
           "rays_per_s_informational": rays / dt,
           "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
           "finite": bool(np.isfinite(accum).all()),
           "nonnegative": bool((accum >= 0).all()),
           "mean": float(accum.mean()), "max": float(accum.max()),
           "subframe": int(film.subframe)}
    _log(f"[{label}] {json.dumps(res)}")
    _check(accum.shape == (height, width, 3), f"{label}: film shape")
    _check(res["finite"] and res["nonnegative"],
           f"{label}: film not finite and non-negative")
    _check(res["max"] > 0.0, f"{label}: film is black")
    _check(res["subframe"] == (launches + 1) * spp, f"{label}: subframe")
    return res


def phase_golden() -> dict:
    """(c, second part) The 32x32 64-spp depth-3 Cornell render against
    tests/golden/cornell_32x32_64spp.npz."""
    import numpy as np
    from optix_raytracer_tpu.core.film import Film
    from optix_raytracer_tpu.scene.builtins import cornell_box, cornell_camera
    from optix_raytracer_tpu.wavefront.engine import render_accumulate

    with np.load(os.path.join(HERE, "tests", "golden",
                              "cornell_32x32_64spp.npz")) as z:
        golden = z["image"]
    scene, cam = cornell_box(), cornell_camera(32, 32).params()
    res = {}
    for impl in ("auto", "xla"):
        film, _ = render_accumulate(scene, cam, Film.create(32, 32), 32, 32,
                                    samples_per_launch=64, max_depth=3,
                                    chunk_size=None, impl=impl)
        img = np.asarray(film.accum)
        res[f"rmse_{impl}"] = float(np.sqrt(np.mean((img - golden) ** 2)))
    res["tolerance"] = GOLDEN_RMSE_TOL
    _log(f"[golden] {json.dumps(res)} (auto = the kernel path on a GPU)")
    for impl in ("auto", "xla"):
        _check(res[f"rmse_{impl}"] < GOLDEN_RMSE_TOL,
               f"golden RMSE ({impl}) {res[f'rmse_{impl}']}")
    return res


def knot_scene():
    """The 25,200-triangle trefoil knot (trefoil_mesh(200, 63)) on a
    2-triangle floor under an area light, built by make_device_scene with
    its defaults."""
    from optix_raytracer_tpu.scene.builtins import knot_scene as build
    return build(200, 63)


def phase_knot_hits(scene, width=FULL_W, height=FULL_H, n_rays=65536,
                    seed=5) -> dict:
    """(d, second part) BVH closest hits on n_rays of the knot's primary
    rays against XLA brute force over every triangle."""
    import jax
    import numpy as np
    from optix_raytracer_tpu.accel import bruteforce as bf
    from optix_raytracer_tpu.scene.builtins import knot_camera
    from optix_raytracer_tpu.wavefront.intersect import scene_closest, traversal

    _check(traversal(scene) == "bvh", "knot does not take the BVH")
    prim = primary_rays(knot_camera(width, height).params(), width, height)
    pick = np.sort(np.random.default_rng(seed).choice(
        prim.tmin.shape[0], n_rays, replace=False))
    rays = jax.tree.map(lambda a: a[pick], prim)
    hits = scene_closest(scene, rays, chunk_size=65536)
    ref = bf.intersect_closest(scene.geom, rays, tri_mat=scene.tri_mat,
                               chunk_size=2048, impl="xla")
    res = compare_closest(hits, ref, scene_extent(scene.geom))
    _log(f"[knot-hits] {json.dumps(res)} tolerance: prim_id equal except "
         f"exact ties, mismatch <= {MISMATCH_FRAC:g} of rays, |dt| <= "
         f"{T_TOL_REL:g} x extent")
    _check(res["hits"] > 0, "no knot primary ray hit")
    _check(res["ok"], "BVH closest hits outside tolerance")
    return res


def phase_cards(width=FULL_W, height=FULL_H, spp_per_card=2,
                n_cards=4) -> list:
    """(e) One frame on a (rows=2, samples=n_cards/2) mesh against the
    one-card render of the same samples."""
    import jax
    import numpy as np
    from optix_raytracer_tpu.core.film import Film
    from optix_raytracer_tpu.multichip import tiles
    from optix_raytracer_tpu.scene.builtins import cornell_box, cornell_camera
    from optix_raytracer_tpu.scene.builtins import knot_camera
    from optix_raytracer_tpu.wavefront.engine import render_accumulate

    devices = jax.devices()[:n_cards]
    n_samples = 2 if n_cards % 2 == 0 else 1
    mesh = tiles.make_mesh(n_rows=n_cards // n_samples, n_samples=n_samples,
                           devices=devices)
    results = []
    for label, scene, cam, depth in (
            ("cornell", cornell_box(), cornell_camera(width, height), 4),
            ("knot", knot_scene(), knot_camera(width, height), 3)):
        cam = cam.params()
        t0 = time.perf_counter()
        film = tiles.render_accumulate_sharded(
            scene, cam, tiles.shard_film(Film.create(height, width), mesh),
            mesh, width, height, samples_per_launch=spp_per_card,
            max_depth=depth)
        sharded = np.asarray(film.accum)
        t_sharded = time.perf_counter() - t0
        with jax.default_device(devices[0]):
            t0 = time.perf_counter()
            one, _ = render_accumulate(
                scene, cam, Film.create(height, width), width, height,
                samples_per_launch=spp_per_card * n_samples,
                max_depth=depth)
            single = np.asarray(one.accum)
            t_single = time.perf_counter() - t0
        diff = np.abs(sharded - single)
        bad = float((diff.max(axis=-1) > CARDS_ABS_TOL).mean())
        res = {"scene": label, "mesh": dict(mesh.shape),
               "spp": spp_per_card * n_samples, "depth": depth,
               "max_abs_diff": float(diff.max()),
               "mean_abs_diff": float(diff.mean()),
               "bit_identical": bool((diff == 0).all()),
               "pixels_past_tol": bad, "abs_tol": CARDS_ABS_TOL,
               "bad_frac_tol": CARDS_BAD_FRAC,
               "first_call_s_sharded": t_sharded,
               "first_call_s_single": t_single,
               "subframe": int(film.subframe)}
        _log(f"[cards] {json.dumps(res)}")
        _check(np.isfinite(sharded).all(), f"{label}: sharded not finite")
        _check(int(film.subframe) == int(one.subframe), "subframe")
        _check(bad <= CARDS_BAD_FRAC,
               f"{label}: {bad:.2e} of pixels differ by > {CARDS_ABS_TOL}")
        results.append(res)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4),
                   help="4: run only the four-card phase (e)")
    args = p.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, PACKAGE)):
        print(f"chip_smoke: no {PACKAGE}/ next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from optix_raytracer_tpu.core.compile_cache import enable_compile_cache

    info = phase_device(args.cards)
    _log(card_line())
    _log(f"[cache] {enable_compile_cache()}")
    t_start = time.perf_counter()
    if args.cards == 4:
        phase_cards()
    else:
        from optix_raytracer_tpu.scene.builtins import (
            cornell_box, cornell_camera, knot_camera)
        phase_kernels()
        cornell_cam = cornell_camera(FULL_W, FULL_H).params()
        kern = render_launches(cornell_box(), cornell_cam, FULL_W, FULL_H,
                               SPP, 4, "cornell")
        # The same launches with the plain XLA brute force: the kernel's
        # end-to-end time against what XLA makes of the reference.
        plain = render_launches(cornell_box(), cornell_cam, FULL_W, FULL_H,
                                SPP, 4, "cornell-xla", impl="xla")
        _log(f"[cornell] end to end, informational: kernel path "
             f"{kern['launch_s']:.4f} s/launch, plain XLA "
             f"{plain['launch_s']:.4f} s/launch")
        phase_golden()
        t0 = time.perf_counter()
        knot = knot_scene()
        _log(f"[knot] build_s {time.perf_counter() - t0:.3f} triangles "
             f"{knot.num_triangles} bvh_nodes {int(knot.bvh.num_nodes)}")
        render_launches(knot, knot_camera(FULL_W, FULL_H).params(),
                        FULL_W, FULL_H, SPP, 3, "knot")
        phase_knot_hits(knot)
    _log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
