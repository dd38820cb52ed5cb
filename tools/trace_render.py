"""Trace render_accumulate launches and reduce the trace to device metrics.

    python tools/trace_render.py --scene cornell --dim 1920x1088 --spp 16
    python tools/trace_render.py --scene knot --dim 1920x1088 --spp 2

Compiles one launch, runs one warm-up launch, then traces `--launches`
launches with `jax.profiler` into `--out` (default chiprun_out/trace). The
reduction reads the `.xplane.pb` the profiler writes: over the device planes
(`/device:GPU:*`), the window is first start to last end of any device
event, busy time is the union of the events' intervals, and the idle share
is 1 - busy / window. It prints the window, the idle share, the number of
device events and the top operations by summed device time, and ends with
one JSON line of the same numbers.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_events(xplane_path: str, plane_prefix: str = "/device:GPU"):
    """[(line, name, start_ns, dur_ns)] of every event on the device
    planes."""
    from jax.profiler import ProfileData
    data = ProfileData.from_file(xplane_path)
    out = []
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            # "XLA Modules"/"Steps" lines span whole programs; the per-stream
            # lines hold the kernels themselves.
            if line.name in ("XLA Modules", "Steps", "XLA TraceMe"):
                continue
            for ev in line.events:
                out.append((line.name, ev.name, ev.start_ns,
                            ev.duration_ns))
    return out


def reduce_events(events, top: int = 25) -> dict:
    """Window, busy time (union of intervals), idle share, and the top ops
    of each trace line (a line may repeat another's time: XLA's op line
    and the stream lines that run the op's kernels)."""
    if not events:
        return {"events": 0}
    spans = sorted((s, s + d) for _, _, s, d in events)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    per_op = collections.defaultdict(collections.Counter)
    count = collections.Counter()
    for line, name, _, d in events:
        per_op[line][name] += d
        count[line, name] += 1
    lines = {}
    for line, ops in per_op.items():
        total = sum(ops.values())
        lines[line] = {"ms": total / 1e6, "top": [
            {"op": n, "ms": d / 1e6, "share": d / total,
             "calls": count[line, n]} for n, d in ops.most_common(top)]}
    return {"events": len(events), "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "lines": lines}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scene", choices=("cornell", "knot"), default="cornell")
    p.add_argument("--dim", default="1920x1088")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--depth", type=int, default=None,
                   help="default: 4 for cornell, 3 for the knot")
    p.add_argument("--launches", type=int, default=1)
    p.add_argument("--impl", default="auto")
    p.add_argument("--out", default="chiprun_out/trace")
    p.add_argument("--plane", default="/device:GPU",
                   help="device plane prefix (/host:CPU to rehearse on CPU)")
    args = p.parse_args(argv)

    import jax
    from optix_raytracer_tpu.core.compile_cache import enable_compile_cache
    from optix_raytracer_tpu.core.film import Film
    from optix_raytracer_tpu.scene import builtins
    from optix_raytracer_tpu.wavefront.engine import render_accumulate

    enable_compile_cache()
    w, h = (int(x) for x in args.dim.split("x"))
    if args.scene == "cornell":
        scene, cam = builtins.cornell_box(), builtins.cornell_camera(w, h)
    else:
        scene, cam = builtins.knot_scene(200, 63), builtins.knot_camera(w, h)
    depth = args.depth or (4 if args.scene == "cornell" else 3)
    cam = cam.params()
    film = Film.create(h, w)
    step = render_accumulate.lower(
        scene, cam, film, w, h, samples_per_launch=args.spp, max_depth=depth,
        chunk_size=65536, impl=args.impl).compile()
    film, _ = step(scene, cam, film)
    jax.block_until_ready(film.accum)

    out_dir = os.path.join(args.out, f"{args.scene}_{args.impl}")
    t0 = time.perf_counter()
    with jax.profiler.trace(out_dir):
        for _ in range(args.launches):
            film, _ = step(scene, cam, film)
        jax.block_until_ready(film.accum)
    wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(out_dir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    res = reduce_events(device_events(path, args.plane))
    res.update(scene=args.scene, impl=args.impl, dim=args.dim, spp=args.spp,
               depth=depth, launches=args.launches, traced_wall_s=wall,
               device=jax.devices()[0].device_kind)
    for line, agg in res.get("lines", {}).items():
        print(f"== {line}: {agg['ms']:.3f} ms")
        for row in agg["top"]:
            print(f"{row['ms']:12.3f} ms {row['share']:7.2%} "
                  f"{row['calls']:7d}  {row['op'][:100]}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
