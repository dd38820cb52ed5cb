"""Resumable, jax-free oracle render pair for the RMSE gate.

The gate's cost driver is the numpy oracle (hours of single-core work per
point — `tools/run_rmse_gate.py`). This runner produces the cached oracle
pair WITHOUT importing jax, so the hours-long render needs numpy alone and
never opens (or waits for) an accelerator. The scene is pre-dumped to
a plain .npz by a one-shot jax process (see --dump-scene), after which the
render loop touches numpy only.

Progress is checkpointed: every --chunk samples, the running mean lands in
the oracle cache under the *achieved* spp (atomic rename), and stale lower-
spp snapshots of the same stream are dropped. A kill at any point leaves
the largest finished snapshot usable — a Monte-Carlo mean over s samples
is a valid oracle at spp=s, and chunked rendering with one persistent
Generator per stream reproduces the monolithic render bit-exactly
(oracle_pt.render_oracle's rng parameter). Streams alternate chunks so
both seeds stay balanced at any cutoff.

Usage:
    python tools/oracle_runner.py --dump-scene /tmp/oracle_scene.npz
    python tools/oracle_runner.py --scene /tmp/oracle_scene.npz \
        --dim 256 --spp 1024 --max-depth 4 --seeds 11 12
"""
from __future__ import annotations

import argparse
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import numpy as np  # noqa: E402

from oracle_pt import render_oracle  # noqa: E402  (numpy-only module)


def dump_scene(path: str, dim: int):
    """One-shot jax step: DeviceScene -> plain npz (run this separately)."""
    from optix_raytracer_tpu.scene.builtins import cornell_box, cornell_camera
    from oracle_pt import scene_to_numpy

    sc = scene_to_numpy(cornell_box())
    cam = {k: np.asarray(v)
           for k, v in cornell_camera(dim, dim).params().items()}
    light = sc.pop("light")
    np.savez(path, **sc, **{f"light_{k}": v for k, v in light.items()},
             **{f"cam_{k}": v for k, v in cam.items()})
    print(f"# scene dumped to {path}")


def load_scene(path: str):
    z = np.load(path)
    scene = {k: z[k] for k in ("v0", "e1", "e2", "normal",
                               "mat_albedo", "mat_emission")}
    scene["light"] = {k[len("light_"):]: (float(z[k]) if z[k].ndim == 0
                                          else z[k])
                      for k in z.files if k.startswith("light_")}
    cam = {k[len("cam_"):]: z[k] for k in z.files if k.startswith("cam_")}
    return scene, cam


def _snap_path(cache, dim, spp, depth, seed):
    return os.path.join(
        cache, f"cornell_d{dim}x{dim}_spp{spp}_depth{depth}_seed{seed}.npz")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="/tmp/oracle_scene_256.npz")
    p.add_argument("--dump-scene", default=None, metavar="PATH")
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--spp", type=int, default=1024)
    p.add_argument("--max-depth", type=int, default=4)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--seeds", type=int, nargs="+", default=[11, 12])
    p.add_argument("--cache",
                   default=os.environ.get("ORT_ORACLE_CACHE",
                                          "/tmp/ort_oracle_cache"))
    args = p.parse_args()
    if args.dump_scene:
        dump_scene(args.dump_scene, args.dim)
        return
    os.makedirs(args.cache, exist_ok=True)
    scene, cam = load_scene(args.scene)
    dim, depth = args.dim, args.max_depth

    streams = [{"seed": s, "rng": np.random.default_rng(s),
                "sum": np.zeros((dim, dim, 3)), "done": 0}
               for s in args.seeds]
    t0 = time.time()
    while any(st["done"] < args.spp for st in streams):
        for st in streams:
            if st["done"] >= args.spp:
                continue
            n = min(args.chunk, args.spp - st["done"])
            img = render_oracle(scene, cam, dim, dim, samples=n,
                                max_depth=depth, rng=st["rng"])
            st["sum"] += img * n
            prev = st["done"]
            st["done"] += n
            path = _snap_path(args.cache, dim, st["done"], depth, st["seed"])
            tmp = path + ".tmp.npz"
            np.savez_compressed(tmp, img=st["sum"] / st["done"])
            os.replace(tmp, path)
            old = _snap_path(args.cache, dim, prev, depth, st["seed"])
            if prev and os.path.exists(old):
                os.remove(old)
            el = time.time() - t0
            total = sum(x["done"] for x in streams)
            rate = el / total
            left = sum(args.spp - x["done"] for x in streams)
            print(f"# seed {st['seed']}: {st['done']}/{args.spp} spp  "
                  f"({rate:.2f} s/spp, eta {left * rate / 60:.0f} min)",
                  flush=True)
    print(f"# done in {(time.time() - t0) / 60:.1f} min")


if __name__ == "__main__":
    main()
