"""Benchmark: Cornell-box path trace at 1080p — Mrays/sec/chip — plus the
large-mesh traversal metrics (25k/500k-triangle knot, BVH) in extra.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extra}.
Baseline = the driver-set north-star target of 200 Mrays/sec/chip
(BASELINE.json; the reference publishes no numbers — BASELINE.md).

Ray accounting is honest: the engine counts rays actually traced (closest-hit
queries for live lanes + NEE shadow rays), not pixels × depth.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WIDTH, HEIGHT = 1920, 1088   # 1080p rounded up to a multiple of 8 rows
SAMPLES = 16               # matches the reference default (optixPathTracer.cpp:929)
MAX_DEPTH = 4
CHUNK = None                 # let XLA see the whole wavefront
BASELINE_MRAYS = 200.0


def _knot_primary(segments, sides, w=1920, h=1088):
    """A trefoil knot built with make_device_scene's defaults (a BVH past
    the brute-force limit) and its unjittered 1080p primary wavefront."""
    import numpy as np
    import jax
    from optix_raytracer_tpu.core.camera import generate_rays
    from optix_raytracer_tpu.scene.builtins import knot_camera, trefoil_mesh
    from optix_raytracer_tpu.scene.device_scene import make_device_scene

    verts, idx, normals = trefoil_mesh(segments, sides)
    scene = make_device_scene(verts, idx, np.zeros(len(idx), np.int32),
                              [{"kind": 0, "base_color": (0.7, 0.6, 0.5)}],
                              normals=normals)
    rays, _ = generate_rays(knot_camera(w, h).params(), w, h,
                            rng_state=None, jitter=False)
    flat = jax.tree.map(lambda a: a.reshape((w * h,) + a.shape[2:]), rays)
    return scene, flat


def _rate(fn, n_rays, reps=3):
    """Mrays/s of fn() after one warm-up call, synced with
    block_until_ready."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.time()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return round(reps * n_rays / (time.time() - t0) / 1e6, 1)


def bench_large_mesh():
    """25k-triangle trefoil knot at 1080p through the scene-level queries
    (BVH traversal): primary closest-hit, any-hit on the same rays, and
    the NEE-style shadow wavefront from the primary hits."""
    import jax
    import jax.numpy as jnp
    from optix_raytracer_tpu.core.rays import Rays
    from optix_raytracer_tpu.wavefront.intersect import scene_any, scene_closest

    scene, flat = _knot_primary(200, 63)
    n = flat.tmin.shape[0]
    closest = jax.jit(lambda r: scene_closest(scene, r, chunk_size=65536))
    anyhit = jax.jit(lambda r: scene_any(scene, r, chunk_size=65536))
    out = {"knot25k_closest_mrays": _rate(lambda: closest(flat), n),
           "knot25k_anyhit_mrays": _rate(lambda: anyhit(flat), n)}

    hits = closest(flat)
    p = flat.origin + flat.direction * hits.t[:, None] * 0.999
    d = jnp.asarray([0.0, 8.0, 0.0]) - p
    dist = jnp.linalg.norm(d, axis=1, keepdims=True)
    # Lanes whose primaries missed get an empty window (the engine's NEE
    # mask does the same); the rate counts only the live shadow rays.
    sh = Rays(origin=p, direction=d / dist,
              tmin=jnp.full((n,), 1e-3, jnp.float32),
              tmax=jnp.where(hits.valid, dist[:, 0] * 0.999, 0.0))
    n_live = float(jnp.sum(hits.valid.astype(jnp.float32)))
    out["knot25k_shadow_mrays"] = _rate(lambda: anyhit(sh), n_live)
    out["knot25k_tris"] = int(scene.num_triangles)
    return out


def bench_stream_mesh():
    """500k-triangle dense knot at 1080p: primary closest-hit through the
    BVH (host SAH build counts as set-up, not in the rate)."""
    import jax
    from optix_raytracer_tpu.wavefront.intersect import scene_closest

    scene, flat = _knot_primary(1000, 250)
    closest = jax.jit(lambda r: scene_closest(scene, r, chunk_size=65536))
    return {"knot500k_closest_mrays": _rate(lambda: closest(flat),
                                            flat.tmin.shape[0]),
            "knot500k_tris": int(scene.num_triangles)}


def _launch_rate(scene, cam, w=None, h=None, spl=None, depth=None,
                 launches=2, **kw):
    """Mrays/s of `launches` render_accumulate launches after a warm-up
    launch (compile included in the warm-up)."""
    import jax
    from optix_raytracer_tpu.core import film as film_mod
    from optix_raytracer_tpu.wavefront.engine import render_accumulate

    w, h = w or WIDTH, h or HEIGHT
    args = dict(samples_per_launch=spl or SAMPLES,
                max_depth=depth or MAX_DEPTH, **kw)
    film, _ = render_accumulate(scene, cam, film_mod.Film.create(h, w), w,
                                h, **args)
    jax.block_until_ready(film.accum)
    rays = 0.0
    t0 = time.time()
    for _ in range(launches):
        film, n = render_accumulate(scene, cam, film, w, h, **args)
        rays += float(n)
    jax.block_until_ready(film.accum)
    return round(rays / (time.time() - t0) / 1e6, 1)


def bench_whitted_prims():
    """Whitted-class scene — floor mesh + sphere/shell/parallelogram/
    capsule custom prims with a glass shell — path-traced through
    render_accumulate."""
    import numpy as np
    from optix_raytracer_tpu.accel import primitives as prim
    from optix_raytracer_tpu.core.camera import Camera
    from optix_raytracer_tpu.scene.device_scene import make_device_scene
    from optix_raytracer_tpu.shade import materials as mat
    from optix_raytracer_tpu.shade.lights import ParallelogramLight

    S = 4.0
    verts = np.array([[-S, 0, -S], [S, 0, -S], [S, 0, S], [-S, 0, S]],
                     np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    prims = prim.make_prims([
        {"kind": prim.SPHERE, "center": (-1.2, 0.7, 0.0), "radius": 0.7,
         "mat_id": 1},
        {"kind": prim.SPHERE_SHELL, "center": (0.6, 0.8, 0.5),
         "radius_inner": 0.4, "radius_outer": 0.6, "mat_id": 3},
        {"kind": prim.PARALLELOGRAM, "anchor": (-0.5, 1.8, -1.0),
         "v1": (1.5, 0.0, 0.0), "v2": (0.0, 0.0, 1.2), "mat_id": 2},
        {"kind": prim.CAPSULE, "p0": (1.2, 0.3, -1.2),
         "p1": (2.0, 1.2, -0.8), "radius": 0.25, "mat_id": 2},
    ])
    mats = [
        {"kind": mat.DIFFUSE, "base_color": (0.75, 0.75, 0.75)},
        {"kind": mat.DIFFUSE, "base_color": (0.8, 0.3, 0.2)},
        {"kind": mat.DIFFUSE, "base_color": (0.2, 0.4, 0.8)},
        {"kind": mat.GLASS, "base_color": (0.95, 0.95, 0.95), "ior": 1.5},
    ]
    light = ParallelogramLight.make((-1.0, 3.5, -1.0), (2.0, 0, 0),
                                    (0, 0, 2.0), (10.0, 10.0, 10.0))
    scene = make_device_scene(verts, idx, np.zeros(2, np.int32), mats,
                              prims=prims, area_light=light)
    cam = Camera(eye=(0, 1.6, -5.5), lookat=(0, 0.8, 0), up=(0, 1, 0),
                 fov_y=40.0, aspect=WIDTH / HEIGHT).params()
    return _launch_rate(scene, cam)


def bench_textured():
    """Texture-heavy scene at 1080p: base-color + normal + metallic-
    roughness + emissive maps with trilinear ray-cone mip selection
    through the XLA wavefront (texture fetches are gathers — SURVEY hard
    part #4; this pins the number)."""
    import numpy as np
    from optix_raytracer_tpu.core.camera import Camera
    from optix_raytracer_tpu.scene.device_scene import make_device_scene
    from optix_raytracer_tpu.shade import materials as mat
    from optix_raytracer_tpu.shade.lights import ParallelogramLight

    rng = np.random.default_rng(7)
    tex_base = rng.uniform(0.1, 0.9, (256, 256, 3)).astype(np.float32)
    nm = rng.normal(0, 0.2, (128, 128, 3)).astype(np.float32)
    nm[..., 2] = 1.0
    nm /= np.linalg.norm(nm, axis=-1, keepdims=True)
    tex_norm = (nm * 0.5 + 0.5).astype(np.float32)
    tex_mr = rng.uniform(0, 1, (128, 128, 3)).astype(np.float32)
    tex_em = rng.uniform(0, 0.2, (64, 64, 3)).astype(np.float32)

    S = 3.0
    verts = np.array([[-S, 0, -S], [S, 0, -S], [S, 0, S], [-S, 0, S],
                      [-1.0, 0.0, -0.5], [1.0, 0.0, -0.5],
                      [1.0, 1.6, -0.5], [-1.0, 1.6, -0.5]], np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], np.int32)
    uvs = np.array([[0, 0], [4, 0], [4, 4], [0, 4],
                    [0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    mats = [{"kind": mat.PBR, "base_color": (1, 1, 1), "base_tex": 0,
             "normal_tex": 1, "mr_tex": 2, "emissive_tex": 3,
             "emission": (1.0, 1.0, 1.0), "metallic": 1.0,
             "roughness": 1.0}]
    light = ParallelogramLight.make((-1.0, 3.0, -1.0), (2, 0, 0),
                                    (0, 0, 2), (8.0, 8.0, 8.0))
    scene = make_device_scene(verts, idx, np.zeros(4, np.int32), mats,
                              uvs=uvs,
                              textures=[tex_base, tex_norm, tex_mr, tex_em],
                              area_light=light)
    cam = Camera(eye=(0, 1.5, -4.5), lookat=(0, 0.6, 0), up=(0, 1, 0),
                 fov_y=40.0, aspect=WIDTH / HEIGHT).params()

    return {"textured_mrays": _launch_rate(scene, cam, spl=4, depth=3)}


def bench_knot_pathtrace():
    """Full path trace of the 25k-tri knot through the engine (depth 3,
    BVH traversal): the end-to-end large-mesh number, incoherent bounces
    included. Also times the sample-major launch (impl="spl": the 16
    samples of a row strip traced as one pixel-grouped wavefront, same
    estimator and RNG streams); the headline is the better of the two."""
    from optix_raytracer_tpu.scene.builtins import knot_camera

    scene, _ = _knot_primary(200, 63, 8, 8)
    cam = knot_camera(WIDTH, HEIGHT).params()
    seq = _launch_rate(scene, cam, spl=1, depth=3)
    spl16 = _launch_rate(scene, cam, spl=16, depth=3, impl="spl")
    return {"knot25k_pathtrace_mrays": max(seq, spl16),
            "knot25k_pathtrace_seq_mrays": seq,
            "knot25k_pathtrace_spl16_mrays": spl16}


def bench_instanced_cornell():
    """Cornell as an IAS (walls instance + two shared-box instances):
    the two-level traversal path of `Scene.cpp:1134-1213`."""
    from optix_raytracer_tpu.scene.builtins import (cornell_box_instanced,
                                                    cornell_camera)
    return _launch_rate(cornell_box_instanced(),
                        cornell_camera(WIDTH, HEIGHT).params())


def bench_pbr_cornell():
    """Cornell with a rough-metal GGX wall material (the PBR lanes of the
    bounce loop)."""
    from optix_raytracer_tpu.scene.builtins import (
        CORNELL_LIGHT_CORNER, CORNELL_LIGHT_V1, CORNELL_LIGHT_V2,
        CORNELL_LIGHT_EMISSION, CORNELL_MATERIALS, _CORNELL_QUADS,
        cornell_camera, quads_to_triangles)
    from optix_raytracer_tpu.scene.device_scene import make_device_scene
    from optix_raytracer_tpu.shade import materials as mat
    from optix_raytracer_tpu.shade.lights import ParallelogramLight

    verts, idx, tri_mat = quads_to_triangles(_CORNELL_QUADS)
    mats = [dict(m) for m in CORNELL_MATERIALS]
    mats[0] = {"kind": mat.PBR, "base_color": (0.8, 0.6, 0.3),
               "metallic": 0.8, "roughness": 0.35}
    light = ParallelogramLight.make(
        CORNELL_LIGHT_CORNER, CORNELL_LIGHT_V1, CORNELL_LIGHT_V2,
        CORNELL_LIGHT_EMISSION)
    scene = make_device_scene(verts, idx, tri_mat, mats, area_light=light)
    return _launch_rate(scene, cornell_camera(WIDTH, HEIGHT).params())


def bench_cutouts():
    """Occlusion on a cutout-heavy scene (the Cornell cutouts boxes),
    2M-shadow-ray wavefront: opacity-micromap path (one first-hit-exit
    query over certain-opaque geometry + re-entry only through UNKNOWN
    triangles) vs the plain alpha re-entry loop — the measured anyhit
    speedup the micromap integration buys (`optixOpacityMicromap.cpp:29-30`,
    `optix_host.h:731`)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from optix_raytracer_tpu.apps.cutouts import cutout_cornell
    from optix_raytracer_tpu.core.rays import Rays
    from optix_raytracer_tpu.wavefront import intersect as ix

    scene = cutout_cornell()
    n = 1 << 21
    rng = np.random.default_rng(3)
    o = rng.uniform([50, 50, 50], [500, 500, 500], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                tmin=jnp.full((n,), 1e-2, jnp.float32),
                tmax=jnp.full((n,), 1e4, jnp.float32))

    def time_it(fn):
        return _rate(lambda: fn(rays), n)

    out = {
        "cutout_anyhit_mrays": time_it(
            jax.jit(lambda r: ix._scene_any_alpha_omm(scene, r, None))),
        "cutout_anyhit_noomm_mrays": time_it(
            jax.jit(lambda r: ix._scene_any_alpha(scene, r, None))),
    }

    # Certain-alpha scene: alpha-MASK materials whose masks never hole
    # (the common case for real alpha textures). The micromap classifies
    # every triangle OPAQUE, so occlusion collapses to ONE first-hit-exit
    # query with no anyhit loop — the reference's headline win
    # (`optixOpacityMicromap.cpp:29-30`: traversal skips the anyhit
    # program for certain micro-triangles).
    from optix_raytracer_tpu.scene import builtins
    from optix_raytracer_tpu.scene.device_scene import make_device_scene
    from optix_raytracer_tpu.shade import materials as mat
    from optix_raytracer_tpu.shade.lights import ParallelogramLight

    verts, idx, tri_mat = builtins.quads_to_triangles(
        builtins._CORNELL_QUADS)
    mats2 = [dict(m) for m in builtins.CORNELL_MATERIALS]
    # circle cutout at scale 0.2: uv*scale stays inside [0,0.2]^2, far
    # from the hole circle around each cell center -> never a hole
    mats2.append({"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8),
                  "alpha_mode": mat.ALPHA_MASK, "cutout": mat.CUT_CIRCLE,
                  "checker_scale": 0.2})
    tm2 = np.asarray(tri_mat).copy()
    tm2[10:30] = 4        # both blocks alpha-masked but certainly opaque
    uvs = np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                  (len(verts) // 4, 1))
    light = ParallelogramLight.make(
        builtins.CORNELL_LIGHT_CORNER, builtins.CORNELL_LIGHT_V1,
        builtins.CORNELL_LIGHT_V2, builtins.CORNELL_LIGHT_EMISSION)
    s2 = make_device_scene(verts, idx, tm2, mats2, uvs=uvs,
                           area_light=light)
    assert s2.omm_unknown_geom.num_triangles == 0
    out["opaque_alpha_anyhit_mrays"] = time_it(
        jax.jit(lambda r: ix._scene_any_alpha_omm(s2, r, None)))
    out["opaque_alpha_anyhit_noomm_mrays"] = time_it(
        jax.jit(lambda r: ix._scene_any_alpha(s2, r, None)))

    # OMM past the brute-force limit: a 2402-tri cutout grid whose
    # certain-solid split (~1200 tris) traverses its own BVH for the
    # one-shot occlusion query, vs the plain alpha re-entry loop over the
    # same scene. The reference applies micromaps on any GAS
    # (`optixOpacityMicromap.cpp:29-30`).
    from optix_raytracer_tpu.apps.cutouts import cutout_grid
    s3 = cutout_grid()
    assert s3.has_omm and s3.omm_solid_bvh.num_nodes > 0
    o3 = rng.uniform([50, 50, 50], [450, 250, 450], (n, 3)).astype(
        np.float32)
    d3 = rng.normal(size=(n, 3)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=1, keepdims=True)
    rays3 = Rays(origin=jnp.asarray(o3), direction=jnp.asarray(d3),
                 tmin=jnp.full((n,), 1e-2, jnp.float32),
                 tmax=jnp.full((n,), 1e4, jnp.float32))

    def time_it3(fn):
        return _rate(lambda: fn(rays3), n)

    out["cutout_bvh_anyhit_mrays"] = time_it3(
        jax.jit(lambda r: ix.scene_any(s3, r, None)))
    out["cutout_bvh_noomm_mrays"] = time_it3(
        jax.jit(lambda r: ix._scene_any_alpha(s3, r, None)))
    return out


# Every metric the bench can produce, pre-filled to -1 ("not measured"):
# a harness kill at ANY point leaves the last-printed line with every key
# present, so the record distinguishes "skipped/killed" from "zero".
_EXPECTED_EXTRAS = [
    "knot25k_closest_mrays", "knot25k_anyhit_mrays", "knot25k_shadow_mrays",
    "knot25k_tris",
    "knot25k_pathtrace_mrays", "knot25k_pathtrace_seq_mrays",
    "knot25k_pathtrace_spl16_mrays",
    "textured_mrays", "cornell_pbr_ggx_mrays",
    "cornell_instanced_mrays", "whitted_prims_mrays",
    "knot500k_closest_mrays", "knot500k_tris",
    "cutout_anyhit_mrays", "cutout_anyhit_noomm_mrays",
    "opaque_alpha_anyhit_mrays", "opaque_alpha_anyhit_noomm_mrays",
    "cutout_bvh_anyhit_mrays", "cutout_bvh_noomm_mrays",
]


def _recorded_rmse():
    """Gate results from tools/run_rmse_gate.py's committed record (the
    oracle comparison is hours of numpy — run out-of-band, recorded here
    so the bench extras carry it). Returns {extra_key: value} with the
    headline point plus every recorded multi-point gate)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "RMSE.json")
    out = {"cornell_rmse_vs_oracle": -1.0}
    try:
        with open(path) as f:
            rec = json.load(f)
        out["cornell_rmse_vs_oracle"] = rec.get("cornell_rmse_vs_oracle",
                                                -1.0)
        for label, pt in rec.get("points", {}).items():
            out[f"cornell_rmse_{label}"] = pt.get("cornell_rmse_vs_oracle",
                                                  -1.0)
    except Exception:
        pass
    return out


def main():
    # The ONE JSON line contract is "last line wins": a progressively
    # enriched record is re-printed after the headline and after every
    # sub-bench, so a harness kill at any point still leaves a complete,
    # parsable record of everything measured so far (round-3 failure mode:
    # one print at the very end, killed before reaching it -> parsed=null).
    record = {
        "metric": "cornell_pathtrace_1080p", "value": -1.0,
        "unit": "Mrays/s/chip", "vs_baseline": -1.0,
        "extra": {k: -1.0 for k in _EXPECTED_EXTRAS},
    }
    record["extra"].update(_recorded_rmse())
    record["extra"]["note"] = "headline pending (killed during warmup?)"
    bench_s = {}
    record["extra"]["bench_seconds"] = bench_s

    def emit():
        print(json.dumps(record), flush=True)

    emit()
    import jax
    from optix_raytracer_tpu.core.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    record["extra"]["device"] = {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())}

    # Wall-clock budget over the WHOLE bench (headline included): once
    # spent, remaining sub-benches are skipped (-1) instead of risking
    # the record. The progressive emit-after-every-sub-bench contract
    # makes a harness kill harmless (last printed line is complete).
    budget_s = float(os.environ.get("ORT_BENCH_BUDGET_S", "1300"))
    bench_t0 = time.time()

    from optix_raytracer_tpu.core import film as film_mod
    from optix_raytracer_tpu.scene.builtins import cornell_box, cornell_camera
    from optix_raytracer_tpu.wavefront.engine import render_accumulate

    scene = cornell_box()
    cam = cornell_camera(WIDTH, HEIGHT).params()
    film = film_mod.Film.create(HEIGHT, WIDTH)

    def run(film):
        return render_accumulate(scene, cam, film, WIDTH, HEIGHT,
                                 samples_per_launch=SAMPLES,
                                 max_depth=MAX_DEPTH, chunk_size=CHUNK)

    # Warmup / compile
    t0 = time.time()
    film_w, rays_w = run(film)
    jax.block_until_ready(film_w.accum)
    compile_s = time.time() - t0

    # Timed runs (progressive launches, like the reference's frame loop)
    n_iters = 2
    t0 = time.time()
    f = film_w
    for _ in range(n_iters):
        f, rays = run(f)
    jax.block_until_ready(f.accum)
    dt = time.time() - t0
    total_rays = float(rays) * n_iters

    mrays = total_rays / dt / 1e6
    record["value"] = round(mrays, 2)
    record["vs_baseline"] = round(mrays / BASELINE_MRAYS, 4)
    record["extra"].update(
        msamples_per_s=round(WIDTH * HEIGHT * SAMPLES * n_iters / dt / 1e6,
                             2),
        rays_per_launch=float(rays),
        samples_per_launch=SAMPLES,
        max_depth=MAX_DEPTH,
        resolution=f"{WIDTH}x{HEIGHT}",
        compile_plus_first_launch_s=round(compile_s, 1),
        timed_s=round(dt, 3),
    )
    record["extra"]["note"] = "headline measured; sub-benches pending"
    emit()                      # the headline is now on record, whatever
    #                             happens to the sub-benches below

    skipped = []

    def timed(name, fn):
        # A sub-bench failure (e.g. a kernel lowering regression) must not
        # zero the whole bench record: report -1 for the failed metric and
        # keep going.
        default = {} if name in ("large_mesh", "stream") else -1.0
        if time.time() - bench_t0 > budget_s:
            print(f"# bench '{name}' SKIPPED: {budget_s:.0f}s budget spent",
                  flush=True)
            skipped.append(name)
            bench_s[name] = 0.0
            return default
        t = time.time()
        try:
            r = fn()
        except Exception as e:
            import traceback
            print(f"# bench '{name}' FAILED: {e!r}", flush=True)
            traceback.print_exc()
            r = default
        bench_s[name] = round(time.time() - t, 1)
        return r

    def absorb(name, fn, key=None):
        r = timed(name, fn)
        if isinstance(r, dict):
            record["extra"].update(r)
        elif key is not None:
            record["extra"][key] = r
        record["extra"]["note"] = f"through sub-bench '{name}'"
        emit()

    # Value-ordered: the round-2/3 verdict targets (knot traversal numbers,
    # OMM cutout speedup, textured) land first so a budget/harness cut
    # costs the least.
    absorb("large_mesh", bench_large_mesh)
    absorb("knot_pt", bench_knot_pathtrace)
    absorb("cutouts", bench_cutouts)
    absorb("textured", bench_textured)
    absorb("pbr", bench_pbr_cornell, key="cornell_pbr_ggx_mrays")
    absorb("instanced", bench_instanced_cornell,
           key="cornell_instanced_mrays")
    absorb("whitted", bench_whitted_prims, key="whitted_prims_mrays")
    absorb("stream", bench_stream_mesh)
    record["extra"]["note"] = ("complete" if not skipped else
                               f"skipped: {', '.join(skipped)}")
    emit()


if __name__ == "__main__":
    main()
