"""Train the kernel-prediction denoiser on this framework's own renders.

The reference ships pretrained denoiser weights inside the driver
(`optixDenoiserCreate`, model kinds at `optix_types.h:1609-1635`). We
cannot ship NVIDIA's weights, so we train our own: random Cornell-variant
scenes rendered by the path tracer — low-spp noisy input + AOV guide
layers vs high-spp target — through the KPCNN (denoise/kpcnn.py), saved to
optix_raytracer_tpu/denoise/weights/kpcnn.npz.

Usage:
  python tools/train_denoiser.py --scenes 96 --steps 4000
  python tools/train_denoiser.py --render-only   # just build the dataset
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

RES = 256          # rendered scene resolution
PATCH = 128
DATA = "/tmp/denoiser_data"


def random_scene(rng: np.random.Generator):
    """A randomized Cornell-style room: recolored walls, 1-3 random boxes
    (some metal/rough-PBR), random ceiling light."""
    from optix_raytracer_tpu.scene.builtins import quads_to_triangles
    from optix_raytracer_tpu.scene.device_scene import make_device_scene
    from optix_raytracer_tpu.shade import materials as mat
    from optix_raytracer_tpu.shade.lights import ParallelogramLight

    def color():
        c = rng.uniform(0.05, 0.9, 3)
        if rng.random() < 0.5:          # mostly-neutral surfaces too
            c[:] = rng.uniform(0.2, 0.9)
        return tuple(float(x) for x in c)

    mats = []

    def add_mat():
        i = len(mats)
        if rng.random() < 0.25:
            mats.append({"kind": mat.PBR, "base_color": color(),
                         "metallic": float(rng.uniform(0.0, 1.0)),
                         "roughness": float(rng.uniform(0.1, 0.9))})
        else:
            mats.append({"kind": mat.DIFFUSE, "base_color": color()})
        return i

    quads = []
    S = 556.0
    m_floor, m_ceil, m_back = add_mat(), add_mat(), add_mat()
    m_left, m_right = add_mat(), add_mat()
    quads.append(([(S, 0, 0), (0, 0, 0), (0, 0, S), (S, 0, S)], m_floor))
    quads.append(([(S, S, 0), (S, S, S), (0, S, S), (0, S, 0)], m_ceil))
    quads.append(([(S, 0, S), (0, 0, S), (0, S, S), (S, S, S)], m_back))
    quads.append(([(0, 0, S), (0, 0, 0), (0, S, 0), (0, S, S)], m_right))
    quads.append(([(S, 0, 0), (S, 0, S), (S, S, S), (S, S, 0)], m_left))

    n_boxes = int(rng.integers(1, 4))
    for b in range(3):          # always 3 box slots → fixed triangle count
        if b >= n_boxes:
            # degenerate (zero-area) quads: never hit, keep shapes static
            # so every scene reuses one compiled render executable
            for _ in range(5):
                quads.append(([(0.0, 0.0, 0.0)] * 4, 0))
            continue
        m = add_mat()
        w, d, h = rng.uniform(60, 200, 3)
        cx = rng.uniform(w / 2 + 10, S - w / 2 - 10)
        cz = rng.uniform(d / 2 + 10, S - d / 2 - 10)
        ang = rng.uniform(0, np.pi / 2)
        ca, sa = np.cos(ang), np.sin(ang)
        corners = []
        for dx, dz in ((-w / 2, -d / 2), (w / 2, -d / 2), (w / 2, d / 2),
                       (-w / 2, d / 2)):
            corners.append((cx + dx * ca - dz * sa, h,
                            cz + dx * sa + dz * ca))
        quads.append((corners, m))                       # top
        for i in range(4):
            a, b = corners[i], corners[(i + 1) % 4]
            quads.append(([(a[0], 0, a[2]), (a[0], h, a[2]),
                           (b[0], h, b[2]), (b[0], 0, b[2])], m))

    # light quad just below the ceiling
    lw, ld = rng.uniform(80, 200, 2)
    lx = rng.uniform(lw / 2 + 20, S - lw / 2 - 20)
    lz = rng.uniform(ld / 2 + 20, S - ld / 2 - 20)
    emission = tuple(float(x) for x in rng.uniform(8.0, 30.0, 3))
    m_light = len(mats)
    mats.append({"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8),
                 "emission": emission})
    corner = (lx + lw / 2, 548.6, lz - ld / 2)
    v1, v2 = (-lw, 0.0, 0.0), (0.0, 0.0, ld)
    quads.append(([corner,
                   (corner[0] + v1[0], corner[1], corner[2]),
                   (corner[0] + v1[0], corner[1], corner[2] + v2[2]),
                   (corner[0], corner[1], corner[2] + v2[2])], m_light))

    while len(mats) < 9:        # fixed material-table shape (no recompiles)
        mats.append({"kind": mat.DIFFUSE, "base_color": (0.5, 0.5, 0.5)})

    verts, idx, tri_mat = quads_to_triangles(quads)
    light = ParallelogramLight.make(corner, v1, v2, emission)
    return make_device_scene(verts, idx, tri_mat, mats, area_light=light)


def random_camera_obj(rng: np.random.Generator, w, h):
    from optix_raytracer_tpu.core.camera import Camera
    eye = (278 + rng.uniform(-120, 120), 273 + rng.uniform(-120, 120),
           -900 + rng.uniform(-100, 300))
    lookat = (278 + rng.uniform(-80, 80), 273 + rng.uniform(-80, 80), 330)
    return Camera(eye=eye, lookat=lookat, up=(0, 1, 0),
                  fov_y=float(rng.uniform(28, 45)), aspect=w / h)


def random_camera(rng: np.random.Generator, w, h):
    return random_camera_obj(rng, w, h).params()


def render_dataset(n_scenes: int, seed: int = 0,
                   noisy_spp=(1, 2, 4, 8, 16, 32, 64),
                   clean_spp: int = 1024):
    """noisy_spp spans 1..64: the net must ALSO see near-clean inputs or
    it never learns the near-identity regime and imposes its bias floor
    (~5e-3 log-MSE) on inputs cleaner than its training distribution —
    measured on the canonical Cornell, where 4 spp is already cleaner
    than any 8 spp scene in the original 1-8 spp dataset."""
    import jax
    import jax.numpy as jnp
    from optix_raytracer_tpu.core.film import Film
    from optix_raytracer_tpu.wavefront.engine import (render_accumulate,
                                                      render_aovs)

    os.makedirs(DATA, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_scenes):
        path = os.path.join(DATA, f"scene_{i:04d}.npz")
        # Draw BEFORE the exists-check: skipping must still consume the
        # stream, or later scenes silently replay earlier geometry (a
        # fresh run extending an existing dataset would otherwise
        # duplicate scene 0.. as scene N..).
        t0 = time.time()
        scene = random_scene(rng)
        cam = random_camera(rng, RES, RES)
        spp = int(rng.choice(noisy_spp))
        if os.path.exists(path):
            continue

        film = Film.create(RES, RES)
        film, _ = render_accumulate(scene, cam, film, RES, RES,
                                    samples_per_launch=spp, max_depth=4)
        noisy = np.asarray(film.accum)
        film = Film.create(RES, RES)
        # split the clean render into launches to bound kernel runtime
        for _ in range(clean_spp // 64):
            film, _ = render_accumulate(scene, cam, film, RES, RES,
                                        samples_per_launch=64, max_depth=4)
        clean = np.asarray(film.accum)
        aovs = render_aovs(scene, cam, RES, RES)
        np.savez_compressed(
            path, noisy=noisy.astype(np.float16),
            clean=clean.astype(np.float16), spp=spp,
            albedo=np.asarray(aovs["albedo"], np.float16),
            normal=np.asarray(aovs["normal"], np.float16),
            emission=np.asarray(aovs["emission"], np.float16))
        print(f"[{i+1}/{n_scenes}] spp={spp} {time.time()-t0:.1f}s",
              flush=True)


def add_temporal_history(n_scenes: int, seed: int = 0,
                         old_spp_until: int = 120, prev_spp: int = 128):
    """Add a temporal 'history' layer to each dataset file: render the
    SAME scene from a slightly moved camera (the previous frame), compute
    optical flow previous->current against the noisy current frame
    (matching inference conditions), and store the flow-warped previous
    render. Replays the generator RNG stream like upgrade_emission_aovs."""
    import jax.numpy as jnp
    from optix_raytracer_tpu.core.camera import Camera
    from optix_raytracer_tpu.core.film import Film
    from optix_raytracer_tpu.denoise.atrous import warp_by_flow
    from optix_raytracer_tpu.denoise.flow import optical_flow
    from optix_raytracer_tpu.wavefront.engine import render_accumulate

    rng = np.random.default_rng(seed)
    for i in range(n_scenes):
        scene = random_scene(rng)
        cam_obj = random_camera_obj(rng, RES, RES)
        spp_pop = ((1, 2, 4, 8) if i < old_spp_until
                   else (1, 2, 4, 8, 16, 32, 64))
        rng.choice(spp_pop)
        path = os.path.join(DATA, f"scene_{i:04d}.npz")
        if not os.path.exists(path):
            continue
        d = dict(np.load(path))
        if "history" in d:
            continue
        t0 = time.time()
        # deterministic small camera move (not from the replay stream!)
        js = np.random.default_rng(10_000 + i)
        eye = np.asarray(cam_obj.eye, np.float32)
        lookat = np.asarray(cam_obj.lookat, np.float32)
        offset = js.normal(size=3).astype(np.float32)
        offset /= max(np.linalg.norm(offset), 1e-6)
        step = 0.02 * float(np.linalg.norm(lookat - eye))
        prev_cam = Camera(eye=tuple(eye + step * offset),
                          lookat=tuple(lookat), up=(0, 1, 0),
                          fov_y=cam_obj.fov_y, aspect=cam_obj.aspect)
        film = Film.create(RES, RES)
        film, _ = render_accumulate(scene, prev_cam.params(), film, RES,
                                    RES, samples_per_launch=prev_spp,
                                    max_depth=4)
        prev = np.asarray(film.accum, np.float32)
        noisy = np.asarray(d["noisy"], np.float32)
        fl = optical_flow(jnp.asarray(prev), jnp.asarray(noisy))
        hist = np.asarray(warp_by_flow(jnp.asarray(prev), fl), np.float32)
        d["history"] = hist.astype(np.float16)
        np.savez_compressed(path, **d)
        if (i + 1) % 24 == 0:
            print(f"history {i+1}/{n_scenes} ({time.time()-t0:.1f}s/scene)",
                  flush=True)


def upgrade_emission_aovs(n_scenes: int, seed: int = 0,
                          old_spp_until: int = 120):
    """Add the emission AOV to dataset files that predate it, by replaying
    the scene/camera RNG stream (same seed, same draw order) and running
    one AOV pass per scene — no re-render of noisy/clean needed.

    The spp draw must replay with each scene's ORIGINAL population:
    rng.choice over a non-power-of-two population can consume extra
    words (bounded-integer rejection), so eras matter. Scenes before
    `old_spp_until` were rendered with the 4-way tuple."""
    from optix_raytracer_tpu.wavefront.engine import render_aovs

    rng = np.random.default_rng(seed)
    for i in range(n_scenes):
        scene = random_scene(rng)
        cam = random_camera(rng, RES, RES)
        spp_pop = ((1, 2, 4, 8) if i < old_spp_until
                   else (1, 2, 4, 8, 16, 32, 64))
        spp = int(rng.choice(spp_pop))  # consume the spp draw
        path = os.path.join(DATA, f"scene_{i:04d}.npz")
        if not os.path.exists(path):
            continue
        d = dict(np.load(path))
        assert int(d["spp"]) == spp, (i, int(d["spp"]), spp)
        if "emission" in d:
            continue
        aovs = render_aovs(scene, cam, RES, RES)
        d["emission"] = np.asarray(aovs["emission"], np.float16)
        # sanity: the replayed scene must be the recorded one
        alb_err = float(np.mean(np.abs(
            np.asarray(aovs["albedo"], np.float32)
            - np.asarray(d["albedo"], np.float32))))
        assert alb_err < 2e-3, (i, alb_err)
        np.savez_compressed(path, **d)
        if (i + 1) % 24 == 0:
            print(f"upgraded {i+1}/{n_scenes}", flush=True)


def load_dataset():
    files = sorted(os.path.join(DATA, f) for f in os.listdir(DATA)
                   if f.endswith(".npz"))
    out = []
    for f in files:
        d = np.load(f)
        keys = ("noisy", "clean", "albedo", "normal", "emission")
        out.append({k: np.asarray(d[k], np.float32)
                    for k in keys if k in d})
    return out


def train(steps: int = 4000, batch: int = 8, lr: float = 1e-3,
          seed: int = 0, val_frac: float = 0.1, upscale: bool = False,
          temporal: bool = False, alpha_out: bool = False):
    """upscale=True trains the UPSCALE2X weights: the input is the noisy
    image box-downsampled 2x then bilinear-lifted back (simulating a
    half-res render), guides stay full-res; saved to kpcnn_up2x.npz."""
    import jax
    import jax.numpy as jnp
    import optax
    from optix_raytracer_tpu.denoise import kpcnn

    def degrade(noisy):
        # [N, H, W, 3] -> box 2x down -> bilinear 2x up
        n, h, w, c = noisy.shape
        lr_ = noisy.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))
        return kpcnn.upsample2x_bilinear(lr_)

    data = load_dataset()
    assert data, "no dataset — run with --render-only first"
    n_val = max(1, int(len(data) * val_frac))
    val, trainset = data[:n_val], data[n_val:]
    print(f"dataset: {len(trainset)} train / {n_val} val scenes")

    rng = np.random.default_rng(seed)
    params = kpcnn.init_params(jax.random.PRNGKey(seed),
                               cin=13 if temporal else 10,
                               out_alpha=alpha_out and temporal)
    if alpha_out and temporal and kpcnn.has_temporal_weights():
        # Warm start the predicted-alpha net from the trained temporal
        # net: every layer copies; the new blend-logit output channel
        # starts at zero weights with bias -2 (alpha ~= 0.12), so step 0
        # is close to the trained temporal filter.
        base = kpcnn.load_params(kpcnn.TEMPORAL_WEIGHTS_PATH)
        for k, v in base.items():
            v = np.asarray(v)
            if k == "out_w":
                w = np.zeros_like(np.asarray(params[k]))
                w[..., :v.shape[-1]] = v
                params[k] = jnp.asarray(w)
            elif k == "out_b":
                b = np.full(params[k].shape, -2.0, np.float32)
                b[:v.shape[0]] = v
                params[k] = jnp.asarray(b)
            else:
                params[k] = jnp.asarray(v)
        print("warm-started alpha net from", kpcnn.TEMPORAL_WEIGHTS_PATH)
    elif temporal and kpcnn.has_weights():
        # Warm start from the trained spatial net: copy every layer and
        # zero-pad in0_w's 3 new history channels. At step 0 the temporal
        # net then EQUALS the spatial net, so training can only improve on
        # it by actually using history (a cold start plateaus slightly
        # worse than spatial).
        spatial = kpcnn.load_params()
        for k, v in spatial.items():
            if k == "in0_w":
                w = np.zeros_like(np.asarray(params[k]))
                w[:, :, :10, :] = np.asarray(v)
                params[k] = jnp.asarray(w)
            else:
                params[k] = jnp.asarray(v)
        print("warm-started temporal net from", kpcnn.WEIGHTS_PATH)
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.02)
    opt = optax.adam(sched)
    opt_state = opt.init(params)

    def tonemap(x):
        return jnp.log1p(jnp.maximum(x, 0.0))

    def loss_fn(params, noisy, albedo, normal, emission, history, clean):
        if upscale:
            noisy = degrade(noisy)
        out = kpcnn.denoise_kp(params, noisy, albedo, normal,
                               emission=emission,
                               history=history if temporal else None)
        lt = jnp.abs(tonemap(out) - tonemap(clean))
        gy = jnp.abs(jnp.diff(tonemap(out), axis=1)
                     - jnp.diff(tonemap(clean), axis=1))
        gx = jnp.abs(jnp.diff(tonemap(out), axis=2)
                     - jnp.diff(tonemap(clean), axis=2))
        return jnp.mean(lt) + 0.5 * (jnp.mean(gx) + jnp.mean(gy))

    @jax.jit
    def step(params, opt_state, noisy, albedo, normal, emission, history,
             clean):
        loss, grads = jax.value_and_grad(loss_fn)(params, noisy, albedo,
                                                  normal, emission, history,
                                                  clean)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    def sample_batch(ds):
        ns, als, nms, ems, hs, cls_ = [], [], [], [], [], []
        for _ in range(batch):
            s = ds[rng.integers(len(ds))]
            y = rng.integers(0, RES - PATCH + 1)
            x = rng.integers(0, RES - PATCH + 1)
            sl = np.s_[y:y + PATCH, x:x + PATCH]
            ns.append(s["noisy"][sl])
            als.append(s["albedo"][sl])
            nms.append(s["normal"][sl])
            ems.append(s.get("emission", np.zeros_like(s["noisy"]))[sl])
            hs.append(s.get("history", np.zeros_like(s["noisy"]))[sl])
            cls_.append(s["clean"][sl])
        return (jnp.asarray(np.stack(ns)), jnp.asarray(np.stack(als)),
                jnp.asarray(np.stack(nms)), jnp.asarray(np.stack(ems)),
                jnp.asarray(np.stack(hs)), jnp.asarray(np.stack(cls_)))

    @jax.jit
    def val_mse(params, noisy, albedo, normal, emission, history, clean):
        if upscale:
            noisy = degrade(noisy)
        out = kpcnn.denoise_kp(params, noisy, albedo, normal,
                               emission=emission,
                               history=history if temporal else None)
        return (jnp.mean((tonemap(out) - tonemap(clean)) ** 2),
                jnp.mean((tonemap(noisy) - tonemap(clean)) ** 2))

    t0 = time.time()
    for i in range(steps):
        b = sample_batch(trainset)
        params, opt_state, loss = step(params, opt_state, *b)
        if (i + 1) % 200 == 0:
            vm, nm = 0.0, 0.0
            for s in val:
                em = s.get("emission", np.zeros_like(s["noisy"]))
                hi = s.get("history", np.zeros_like(s["noisy"]))
                a, b_ = val_mse(params, jnp.asarray(s["noisy"][None]),
                                jnp.asarray(s["albedo"][None]),
                                jnp.asarray(s["normal"][None]),
                                jnp.asarray(em[None]),
                                jnp.asarray(hi[None]),
                                jnp.asarray(s["clean"][None]))
                vm += float(a); nm += float(b_)
            print(f"step {i+1}: loss={float(loss):.4f} "
                  f"val_mse={vm/len(val):.5f} noisy_mse={nm/len(val):.5f} "
                  f"({time.time()-t0:.0f}s)", flush=True)

    path = (kpcnn.UPSCALE_WEIGHTS_PATH if upscale
            else kpcnn.TEMPORAL_WEIGHTS_PATH if temporal
            else kpcnn.WEIGHTS_PATH)
    kpcnn.save_params(params, path)
    print("saved", path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=96)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--clean-spp", type=int, default=1024)
    ap.add_argument("--render-only", action="store_true")
    ap.add_argument("--train-only", action="store_true")
    ap.add_argument("--upgrade-emission", action="store_true",
                    help="replay the RNG stream to add emission AOVs to "
                         "dataset files that predate them")
    ap.add_argument("--upscale", action="store_true",
                    help="train the 2x-upscale weights (kpcnn_up2x.npz)")
    ap.add_argument("--temporal", action="store_true",
                    help="train the temporal weights (kpcnn_temporal.npz; "
                         "needs --add-history first)")
    ap.add_argument("--alpha-out", action="store_true",
                    help="temporal net with a PREDICTED history-blend "
                         "output channel (temporal-KPCN style)")
    ap.add_argument("--add-history", action="store_true",
                    help="render+warp previous frames into the dataset")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.upgrade_emission:
        upgrade_emission_aovs(args.scenes, seed=args.seed)
    if args.add_history:
        add_temporal_history(args.scenes, seed=args.seed)
        return
    if not args.train_only and not args.upgrade_emission:
        render_dataset(args.scenes, seed=args.seed,
                       clean_spp=args.clean_spp)
    if not args.render_only:
        train(steps=args.steps, seed=args.seed, upscale=args.upscale,
              temporal=args.temporal, alpha_out=args.alpha_out)


if __name__ == "__main__":
    main()
