"""DeviceContext: logging, validation mode, compile cache, device properties.

The `optixDeviceContextCreate` surface (`include/optix_host.h:98-228`):
- the severity-tagged log callback (`optix_host.h:118-134`) becomes a Python
  callback fed by the framework's logger;
- the compiled-module **disk cache** with its `OPTIX_CACHE_PATH` env
  override (`optix_host.h:136-228`) maps onto the XLA persistent
  compilation cache and `JAX_COMPILATION_CACHE_DIR` (same role: skip
  recompiles across runs; core/compile_cache.py);
- validation mode (`OPTIX_DEVICE_CONTEXT_VALIDATION_MODE_ALL`, used in the
  reference's debug builds, `optixPathTracer.cpp:566-569`) enables
  jax_debug_nans + NaN/range checks in launches.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import jax

from ..core.compile_cache import compile_cache_dir


class LogLevel:
    """Severity levels of the OptiX log callback (optix_host.h:118-134)."""
    DISABLE = 0
    FATAL = 1
    ERROR = 2
    WARNING = 3
    PRINT = 4


class DeviceContext:
    def __init__(self, log_callback: Optional[Callable] = None,
                 log_level: int = LogLevel.WARNING,
                 validation_mode: bool = False,
                 cache_enabled: bool = True,
                 cache_location: Optional[str] = None,
                 debug_nans: bool = False):
        self._log_cb = log_callback
        self._log_level = log_level
        self.validation_mode = validation_mode
        self._cache_enabled = cache_enabled
        self._cache_location = cache_location or compile_cache_dir()
        if self._cache_enabled:
            try:
                os.makedirs(self._cache_location, exist_ok=True)
                jax.config.update("jax_compilation_cache_dir",
                                  self._cache_location)
                self.log(LogLevel.PRINT, "CACHE",
                         f"compilation cache at {self._cache_location}")
            except Exception as e:  # cache is best-effort, like the reference
                self.log(LogLevel.WARNING, "CACHE", f"cache disabled: {e}")
        if validation_mode:
            # Structured per-launch exception counters (see
            # wavefront/exceptions.py) are the default surface —
            # the exception-program role of `optix_device.h:1263-1432`.
            # jax_debug_nans is the opt-in crash-on-first-NaN variant
            # (it fires before the counters can be collected).
            if debug_nans:
                jax.config.update("jax_debug_nans", True)
            self.log(LogLevel.PRINT, "VALIDATION", "validation mode ALL")

    # --- properties (optixDeviceContextGetProperty) ---
    @property
    def device(self):
        return jax.devices()[0]

    def get_property(self, name: str):
        dev = self.device
        props = {
            "platform": dev.platform,
            "device_kind": getattr(dev, "device_kind", "unknown"),
            "num_devices": len(jax.devices()),
            "rtcore_version": 0,            # traversal runs in software
            "limit_max_trace_depth": 31,
            "limit_max_instance_id": 1 << 28,
        }
        return props[name]

    # --- logging (optixDeviceContextSetLogCallback) ---
    def set_log_callback(self, callback, level: int):
        self._log_cb = callback
        self._log_level = level

    def log(self, level: int, tag: str, message: str):
        if self._log_cb is not None and level <= self._log_level:
            self._log_cb(level, tag, message)

    # --- cache controls (optixDeviceContextSetCache*) ---
    def set_cache_enabled(self, enabled: bool):
        self._cache_enabled = enabled
        if enabled:
            jax.config.update("jax_compilation_cache_dir",
                              self._cache_location)
        else:
            jax.config.update("jax_compilation_cache_dir", None)

    def set_cache_location(self, path: str):
        self._cache_location = path
        if self._cache_enabled:
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)

    def get_cache_location(self) -> str:
        return self._cache_location

    def destroy(self):
        pass


class StageTimers:
    """Per-frame stage timing + overlay text: the `sutil::displayStats` /
    `displayFPS` role (`SDK/sutil/sutil.h:117-121`) plus `jax.profiler`
    hooks for deep traces.

    Usage: `with timers.stage("render"): ...`; `timers.report()` returns the
    state/render/display text the reference overlays each frame
    (`optixPathTracer.cpp:1030-1041`).
    """

    def __init__(self):
        self.totals = {}
        self.last = {}
        self.frames = 0
        self._ticks = []          # recent frame_done timestamps → FPS

    class _Stage:
        def __init__(self, timers, name):
            self.timers = timers
            self.name = name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            self.timers.totals[self.name] = (
                self.timers.totals.get(self.name, 0.0) + dt)
            self.timers.last[self.name] = dt
            return False

    def stage(self, name: str):
        return self._Stage(self, name)

    def frame_done(self):
        self.frames += 1
        self._ticks.append(time.perf_counter())
        if len(self._ticks) > 16:
            self._ticks.pop(0)

    def fps(self) -> float:
        """Frames per second over the recent window (`displayFPS`,
        `sutil/sutil.h:117`)."""
        if len(self._ticks) < 2:
            return 0.0
        span = self._ticks[-1] - self._ticks[0]
        return (len(self._ticks) - 1) / span if span > 0 else 0.0

    def overlay(self) -> str:
        """One-line live overlay: FPS + this frame's stage times — the
        on-screen `displayStats` text (`optixPathTracer.cpp:1030-1041`)."""
        parts = [f"{self.fps():.1f} fps"]
        parts += [f"{k} {1e3 * v:.1f}ms" for k, v in self.last.items()]
        return " | ".join(parts)

    def report(self) -> str:
        if not self.frames:
            return "no frames"
        parts = [f"{k}: {1000 * v / self.frames:8.2f} ms"
                 for k, v in self.totals.items()]
        fps = self.frames / max(sum(self.totals.values()), 1e-9)
        return " | ".join(parts) + f" | {fps:6.1f} fps"

    @staticmethod
    def profiler_trace(path: str):
        """Structured deep trace (the NVTX/jax.profiler analogue)."""
        return jax.profiler.trace(path)
