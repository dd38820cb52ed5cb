"""ProgramGroup / Pipeline / ShaderBindingTable / launch.

The reference's launch ritual (`optixProgramGroupCreate` →
`optixPipelineCreate` → SBT record packing → `optixLaunch`,
`include/optix_host.h:440-528`) with these meanings:

- A ProgramGroup binds entry points from a Module (RG/MS/CH/AH/EX/callables,
  kinds at `optix_types.h:2072-2094`).
- The ShaderBindingTable's hitgroup records carry the per-geometry material
  data; record order defines the SBT index exactly like
  `sbtOffset + geometryIndex * rayTypeCount + rayType` (`Scene.cpp:1154`).
- Pipeline "linking" builds ONE jitted launch function: the megakernel the
  driver assembles from PTX becomes an XLA executable; stack-size
  configuration (`optix_stack_size.h`) degenerates to `max_trace_depth`,
  which is the bounce-loop bound.
- `pipeline.launch(sbt, width, height, ...)` = `optixLaunch`.

Pipelines select one of the framework integrators ("pathtrace", "whitted",
"raycast") — the set of device-program semantics the shared `SDK/cuda/`
library provides — parameterized by the SBT's materials, the launch params'
camera/lights, and the GAS handles.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import jax.numpy as jnp

from ..accel.primitives import CustomPrims
from .context import LogLevel
from ..core import film as film_mod
from ..scene.device_scene import DeviceScene, make_device_scene
from ..shade.lights import LightTable, ParallelogramLight
from ..shade.materials import make_material_table
from ..wavefront.engine import render_accumulate
from ..wavefront.whitted import render_whitted_sample
from .accel import TraversableHandle


class ProgramGroupKind(enum.Enum):
    RAYGEN = "raygen"
    MISS = "miss"
    HITGROUP = "hitgroup"
    EXCEPTION = "exception"
    CALLABLES = "callables"


@dataclasses.dataclass
class ProgramGroup:
    kind: ProgramGroupKind
    entry: str = ""                 # e.g. "__raygen__pinhole"
    module: object = None           # api.module.Module or None (builtin)

    @property
    def stack_size(self):
        """Parity with optixProgramGroupGetStackSize: state lives in the
        bounce-loop carry, so the 'stack' is one path-state struct."""
        return {"cssRG": 0, "cssMS": 0, "cssCH": 0, "dssDC": 0}


@dataclasses.dataclass
class SbtRecord:
    """One SBT record: header (program group) + data payload
    (`sutil/Record.h:36-46`)."""
    program_group: ProgramGroup
    data: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ShaderBindingTable:
    """Raygen/miss/hitgroup/callable records (`optix_types.h:2293-2331`)."""
    raygen_record: Optional[SbtRecord] = None
    miss_records: Sequence[SbtRecord] = ()
    hitgroup_records: Sequence[SbtRecord] = ()
    callable_records: Sequence[SbtRecord] = ()

    def material_table(self):
        """Hitgroup record data → MaterialTable (record order = SBT index)."""
        return make_material_table([r.data for r in self.hitgroup_records]
                                   or [{}])

    def miss_color(self):
        if self.miss_records:
            return self.miss_records[0].data.get("color", (0.0, 0.0, 0.0))
        return (0.0, 0.0, 0.0)


class Pipeline:
    def __init__(self, context=None, program_groups: Sequence[ProgramGroup] = (),
                 integrator: str = "pathtrace", max_trace_depth: int = 4,
                 samples_per_launch: int = 1):
        self.context = context
        self.program_groups = list(program_groups)
        self.integrator = integrator
        self.max_trace_depth = max_trace_depth
        self.samples_per_launch = samples_per_launch
        if context is not None:
            context.log(4, "PIPELINE",
                        f"linked {integrator} pipeline, depth "
                        f"{max_trace_depth}")

    def set_stack_size(self, *_args, **_kw):
        """optixPipelineSetStackSize parity: a no-op — the loop carry is the
        stack and its size is static."""

    def _assemble_scene(self, sbt: ShaderBindingTable,
                        handle: TraversableHandle,
                        tri_sbt_index=None, lights=(),
                        area_light: Optional[ParallelogramLight] = None,
                        textures=()) -> DeviceScene:
        import numpy as np
        geom_v = (np.zeros((3, 3), np.float32) if handle.geom is None
                  else handle.geom.vertices)
        geom_i = (np.zeros((1, 3), np.int32) if handle.geom is None
                  else handle.geom.indices)
        n_tris = 1 if handle.geom is None else handle.geom.num_triangles
        tri_mat = (jnp.zeros(n_tris, jnp.int32) if tri_sbt_index is None
                   else jnp.asarray(tri_sbt_index, jnp.int32))
        scene = make_device_scene(
            geom_v, geom_i, tri_mat, sbt.material_table(),
            area_light=area_light, lights=lights,
            prims=handle.prims if handle.prims is not None
            else CustomPrims.empty(),
            miss_color=sbt.miss_color(), textures=textures,
            bvh=handle.bvh)
        return scene

    def launch(self, sbt: ShaderBindingTable, handle: TraversableHandle,
               cam_params, width: int, height: int, film=None,
               tri_sbt_index=None, lights=(), area_light=None, textures=()):
        """The optixLaunch: run `samples_per_launch` progressive samples.

        Returns (film, rays_traced). `film=None` starts a fresh accumulation
        buffer (subframe 0).
        """
        scene = self._assemble_scene(sbt, handle, tri_sbt_index, lights,
                                     area_light, textures)
        if film is None:
            film = film_mod.Film.create(height, width)
        film_before = film
        if self.integrator == "pathtrace":
            film, rays = render_accumulate(
                scene, cam_params, film, width, height,
                samples_per_launch=self.samples_per_launch,
                max_depth=self.max_trace_depth)
        elif self.integrator == "whitted":
            rays = jnp.zeros(())
            for _ in range(self.samples_per_launch):
                radiance = render_whitted_sample(
                    scene, cam_params, width, height, film.subframe,
                    max_depth=self.max_trace_depth)
                film = film.accumulate(radiance)
        else:
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if self.context is not None and self.context.validation_mode:
            self._check_launch(cam_params, film_before, film, width, height)
        return film, rays

    last_exceptions = None

    def _check_launch(self, cam_params, film_before, film, width, height):
        """Validation-mode exception surface: per-launch error counters
        through the context log callback (the exception-program role,
        `optix_device.h:1263-1432`; enabled like validation mode ALL,
        `optixPathTracer.cpp:566-569`)."""
        from ..wavefront.exceptions import (format_exceptions,
                                            launch_diagnostics)
        diag = {k: int(v) for k, v in launch_diagnostics(
            cam_params, film_before, film, width, height).items()}
        self.last_exceptions = diag
        msg = format_exceptions(diag)
        if msg:
            self.context.log(LogLevel.ERROR, "EXCEPTION", msg)
