"""Module: a compiled set of device programs + async/abortable compilation.

Maps the reference's module machinery:
- `optixModuleCreate` (PTX → module, `optix_host.h:332`): a Module holds
  named jittable entry points ("__raygen__x", "__closesthit__y", ...) plus
  compile options. "Compilation" = AOT `jax.jit(...).lower().compile()`.
- `OptixModuleCompileBoundValueEntry` specialization (`optix_types.h:1969`,
  `optixBoundValues` sample): `bound_values` are baked into the entry points
  as closure constants before tracing — XLA constant-folds them exactly like
  the reference bakes launch params at compile time.
- `optixModuleCreateWithTasks` + thread pool (`lib/CompileWithTasks.h:53-117`):
  `compile_with_tasks` fans module compilations out to a thread pool (XLA
  compilation releases the GIL).
- the `optixModuleCreateAbort` sample (out-of-process compile that the parent
  can kill, `optixModuleCreateAbort.cpp:30,786`): `AbortableCompile` runs the
  compile in a separate process with `.abort()`.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import jax


class Module:
    """A named bundle of device programs (the PTX-module analogue)."""

    def __init__(self, entry_points: Dict[str, Callable],
                 bound_values: Optional[dict] = None,
                 opt_level: int = 3, debug: bool = False,
                 context=None, name: str = "module"):
        self.name = name
        self.opt_level = opt_level
        self.debug = debug
        self._context = context
        self.bound_values = dict(bound_values or {})
        self.entry_points = {
            k: (functools.partial(fn, **self.bound_values)
                if self.bound_values else fn)
            for k, fn in entry_points.items()
        }
        if context is not None:
            context.log(4, "COMPILE",
                        f"module {name}: {sorted(entry_points)}")

    def get(self, entry: str) -> Callable:
        if entry not in self.entry_points:
            raise KeyError(
                f"no entry point {entry!r} in module {self.name!r}; "
                f"have {sorted(self.entry_points)}")
        return self.entry_points[entry]

    def compile_entry(self, entry: str, *example_args):
        """AOT-compile one entry point (lower + compile now, not at first
        call) and return the compiled executable."""
        fn = self.get(entry)
        return jax.jit(fn).lower(*example_args).compile()


#: Built-in intersector families — `OptixPrimitiveType` names the driver's
#: builtin IS modules cover (`optix_types.h` curve/sphere primitive types).
BUILTIN_IS_KINDS = ("sphere", "round_linear", "round_quadratic_bspline",
                    "round_cubic_bspline", "round_catmullrom", "round_bezier",
                    "flat_quadratic")


def builtin_is_module(kind: str, context=None) -> Module:
    """`optixBuiltinISModuleGet` (`optix_host.h:409`): a Module holding the
    named built-in intersection programs.

    The returned Module has two entry points —
    ``__intersection__<kind>`` (prims, rays) → closest Hits and
    ``__intersection_any__<kind>`` (prims, rays) → occluded bool — plus a
    ``make_primitives`` helper that converts the family's natural inputs
    (sphere centers/radii, curve strand control points + widths) into the
    primitive table the intersectors consume, mirroring how the reference
    pairs the builtin module with a curve/sphere GAS build
    (`optixCurves.cpp:380-412,489`, `optixSphere`).
    """
    from ..accel import curves as _curves
    from ..accel import primitives as _prim

    kind = kind.lower()

    def _spheres(centers, radii, mat_id: int = 0):
        return _prim.make_prims(
            [{"kind": _prim.SPHERE, "center": tuple(map(float, c)),
              "radius": float(r), "mat_id": mat_id}
             for c, r in zip(centers, radii)])

    builders = {
        "sphere": _spheres,
        "round_linear": lambda control, widths, mat_id=0: _prim.make_prims(
            _curves.strand_to_capsules(control, widths, mat_id=mat_id)),
        "round_quadratic_bspline":
            lambda control, widths, mat_id=0: _prim.make_prims(
                _curves.strand_to_swept_quads(control, widths,
                                              mat_id=mat_id)),
        "round_cubic_bspline":
            lambda control, widths, mat_id=0: _prim.make_prims(
                _curves.strand_to_swept_cubics(
                    control, widths, kind=_curves.CUBIC_BSPLINE,
                    mat_id=mat_id)),
        "round_catmullrom":
            lambda control, widths, mat_id=0: _prim.make_prims(
                _curves.strand_to_swept_cubics(
                    control, widths, kind=_curves.CATMULL_ROM,
                    mat_id=mat_id)),
        "round_bezier":
            lambda control, widths, mat_id=0: _prim.make_prims(
                _curves.strand_to_swept_cubics(
                    control, widths, kind=_curves.BEZIER, mat_id=mat_id)),
        "flat_quadratic": lambda control, widths, mat_id=0: _prim.make_prims(
            _curves.strand_to_ribbons(control, widths, mat_id=mat_id)),
    }
    if kind not in builders:
        raise ValueError(f"no builtin IS module {kind!r}; "
                         f"have {sorted(builders)}")
    mod = Module({f"__intersection__{kind}": _prim.intersect_prims_closest,
                  f"__intersection_any__{kind}": _prim.intersect_prims_any},
                 context=context, name=f"builtin_is_{kind}")
    mod.make_primitives = builders[kind]
    return mod


def compile_with_tasks(jobs, max_workers: int = 4):
    """Parallel module/entry compilation — `optixModuleCreateWithTasks` +
    `OptixTaskExecutePool` behavior (`lib/CompileWithTasks.h`).

    jobs: list of (fn, example_args tuple). Returns the compiled executables
    in order. XLA's C++ compile releases the GIL, so threads genuinely
    overlap.
    """
    def compile_one(job):
        fn, args = job
        return jax.jit(fn).lower(*args).compile()

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(compile_one, jobs))


class AbortableCompile:
    """Out-of-process compilation that can be killed mid-flight.

    The `optixModuleCreateAbort` sample spawns a child process to compile and
    kills it on demand so a hung compile can't wedge the render loop
    (`optixModuleCreateAbort.cpp:29-31`). Here the child process runs the AOT
    compile and writes the serialized executable status; `.abort()` kills it.
    The result is a bool (compile finished) — the parent then compiles from
    its (warm, process-local) cache or proceeds with the old pipeline, which
    is exactly the reference's hot-swap flow (`:446,586-599`).

    The child always runs on the CPU backend: a second JAX process on the
    accelerator would reserve most of the card's memory and fail (or starve
    the parent), so `backend` other than "cpu" is refused.
    """

    def __init__(self, module_path: str, entry: str, example_shapes,
                 backend: str = "cpu"):
        """module_path/entry name an importable function (what the reference
        serializes to the child's CLI, `optixModuleCreateAbort.cpp:786-835`);
        example_shapes: list of (shape tuple, dtype str) for its args."""
        import multiprocessing as mp
        import os
        if backend != "cpu":
            raise ValueError(
                f"AbortableCompile compiles in a child process on the CPU "
                f"only; backend={backend!r} would open the accelerator "
                f"from a second process")
        self._ctx = mp.get_context("spawn")
        self._proc = self._ctx.Process(
            target=_abortable_worker,
            args=(module_path, entry, example_shapes, backend), daemon=True)
        # The child must see JAX_PLATFORMS=cpu from interpreter startup
        # (before _abortable_worker runs), so it never opens the card the
        # parent holds. Set around start(): spawn snapshots the environment
        # at exec time.
        saved = {"JAX_PLATFORMS": os.environ.pop("JAX_PLATFORMS", None)}
        os.environ["JAX_PLATFORMS"] = backend
        try:
            self._proc.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def poll(self) -> Optional[bool]:
        """None while running; True once the child finished successfully."""
        if self._proc.is_alive():
            return None
        return self._proc.exitcode == 0

    def wait(self, timeout=None) -> bool:
        self._proc.join(timeout)
        return self._proc.exitcode == 0

    def abort(self):
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join()


def _abortable_worker(module_path, entry, example_shapes, backend):
    import importlib
    import os

    os.environ["JAX_PLATFORMS"] = backend
    import jax as _jax
    import jax.numpy as _jnp
    _jax.config.update("jax_platforms", backend)
    mod = importlib.import_module(module_path)
    fn = getattr(mod, entry)
    args = [_jnp.zeros(shape, dtype) for shape, dtype in example_shapes]
    _jax.jit(fn).lower(*args).compile()
