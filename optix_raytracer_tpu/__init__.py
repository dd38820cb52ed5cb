"""optix_raytracer_tpu — a GPU ray-tracing framework in JAX.

A from-scratch rebuild (JAX / XLA / Pallas / shard_map) of the capabilities of the
OptiX 8 SDK sample suite + the author's `imgui_test` renderer
(reference: awegsche/OptiX_Raytracer). The OptiX megakernel launch
(raygen / intersection / closest-hit / miss programs wired through a shader binding
table — reference `include/optix_host.h:521`) becomes a wavefront loop of XLA
programs plus a fused brute-force intersection kernel (Pallas, Triton route);
`optixAccelBuild` (reference `include/optix_host.h:562`) becomes a host SAH or
on-device LBVH builder; multi-GPU tile distribution (reference
`SDK/sutil/WorkDistribution.h:50-81`) becomes mesh-sharded tiles with XLA
collectives. The package name is historical: the framework was first written
for another accelerator.

Layering (bottom-up; see SURVEY.md §7):
  core/       vector math, rays, AABBs, transforms, RNG, cameras, film
  accel/      brute-force intersector + GPU kernel, Morton codes, BVH build, traversal, TLAS
  wavefront/  the execution engine: raygen → trace → shade → accumulate loop
  shade/      materials (diffuse/PBR-GGX/glass/phong/checker), lights, sampling
  scene/      host-side scene container, GLTF loader, built-in scenes
  multichip/  device-mesh tile sharding + framebuffer collectives
  denoise/    small conv denoiser (OptiX denoiser equivalent)
  io/         image read/write (PNG/PPM/EXR-as-npz)
  api/        OptiX-shaped compatibility surface (DeviceContext, Pipeline, SBT, launch)
  apps/       the sample suite re-created as runnable apps + acceptance tests
"""

__version__ = "0.1.0"
