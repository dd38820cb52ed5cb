"""OptiX-shaped compatibility surface.

Python classes named and shaped after the reference's host API
(`include/optix_host.h`) so reference-style applications port 1:1, mapped to
their meanings in this framework:

| OptiX                                  | here                              |
|----------------------------------------|-----------------------------------|
| optixInit / optixDeviceContextCreate   | DeviceContext (logging, cache,    |
|   + disk cache env vars                |   validation; XLA compile cache)  |
| optixModuleCreate (PTX/OptiX-IR)       | Module — a named set of shade/    |
|   optixModuleCreateWithTasks           |   callable functions; async       |
|   optixModuleCreateAbort sample        |   compile via futures; abortable  |
|                                        |   out-of-process compile          |
| optixProgramGroupCreate                | ProgramGroup(kind, entries)       |
| optixPipelineCreate (+stack sizes)     | Pipeline — one compiled launch fn |
| OptixShaderBindingTable                | ShaderBindingTable — records bind |
|                                        |   geometry ranges to materials &  |
|                                        |   shade programs                  |
| optixAccelBuild / Compact / Relocate   | accel.build_gas / (no-op) / free  |
| optixLaunch                            | pipeline.launch(params, w, h)     |
| optixDenoiserCreate/Setup/Invoke       | api.denoiser.Denoiser             |
| optixDirectCall / ContinuationCall     | CallableTable (lax.switch)        |
| OptixModuleCompileBoundValueEntry      | bound_values= closure constants   |
"""
from .context import DeviceContext, LogLevel  # noqa: F401
from .module import (Module, compile_with_tasks,  # noqa: F401
                     AbortableCompile, builtin_is_module, BUILTIN_IS_KINDS)
from .pipeline import (ProgramGroup, ProgramGroupKind, Pipeline,  # noqa: F401
                       ShaderBindingTable, SbtRecord)
from .accel import build_gas, build_custom_gas, build_ias, refit_gas  # noqa: F401
from .callables import CallableTable  # noqa: F401
