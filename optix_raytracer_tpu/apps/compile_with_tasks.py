"""optixCompileWithTasks equivalent: parallel module compilation on a pool.

Reference: `SDK/optixCompileWithTasks/` — `optixModuleCreateWithTasks`
splits one module's compile into tasks executed by a thread pool
(`lib/CompileWithTasks.h:53-117` ThreadPool/OptixTaskExecutePool), and the
sample reports the wall-clock win over serial compilation.

Mapping (`api/module.py` compile_with_tasks): XLA's C++ compile
releases the GIL, so AOT `jit(...).lower().compile()` jobs genuinely
overlap on a ThreadPoolExecutor. The jobs here are the whitted pipeline's
raygen at several film sizes — distinct static shapes, so each is a real
compile (no cache collapsing).
"""
from __future__ import annotations

import argparse
import time

import jax

from ..api.module import compile_with_tasks
from ..scene.builtins import whitted_scene, whitted_camera
from ..wavefront.whitted import render_whitted_sample


def make_jobs(n_jobs, base=48):
    """n_jobs whitted-raygen compiles at distinct film sizes."""
    scene = whitted_scene()
    jobs = []
    for i in range(n_jobs):
        w = h = base + 16 * i     # distinct static shape per job
        cam = whitted_camera(w, h).params()

        def entry(cam, w=w, h=h):
            return render_whitted_sample(scene, cam, w, h, 0, max_depth=2)

        jobs.append((entry, (cam,)))
    return jobs


def run(n_jobs=4, workers=4, compare_serial=False, base=48):
    jobs = make_jobs(n_jobs, base=base)
    results = {}
    if compare_serial:
        jax.clear_caches()
        t0 = time.time()
        for fn, fargs in jobs:
            jax.jit(fn).lower(*fargs).compile()
        results["serial_s"] = time.time() - t0
        jax.clear_caches()
    t0 = time.time()
    compiled = compile_with_tasks(jobs, max_workers=workers)
    results["pool_s"] = time.time() - t0
    results["compiled"] = len(compiled)
    return results, compiled


def main(argv=None):
    p = argparse.ArgumentParser(
        description="thread-pool module compilation (optixCompileWithTasks)")
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--serial", action="store_true",
                   help="also time serial compilation for comparison")
    args = p.parse_args(argv)
    res, compiled = run(args.jobs, args.workers, compare_serial=args.serial)
    if "serial_s" in res:
        print(f"serial: {res['serial_s']:.2f}s")
    print(f"pool({args.workers} workers): {res['pool_s']:.2f}s "
          f"for {res['compiled']} modules")
    if "serial_s" in res and res["pool_s"] > 0:
        import os
        ncpu = os.cpu_count() or 1
        print(f"speedup: {res['serial_s'] / res['pool_s']:.2f}x "
              f"({ncpu} host cores; the pool only wins with >1)")
    # Executables are real: run one to prove the pipeline is live.
    out = compiled[0](make_jobs(1)[0][1][0])
    print(f"module 0 executes: output {tuple(out.shape)}")


if __name__ == "__main__":
    main()
