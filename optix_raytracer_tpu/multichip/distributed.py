"""Multi-host process-group bring-up: `jax.distributed` made turnkey.

The reference has no multi-node story (single process; NVLink P2P only,
`optixNVLink.cpp:1617-1712`). The multi-host equivalent is JAX's
distributed runtime: one process per host, a coordinator address, and a global device
view after `jax.distributed.initialize`. This module wraps the bring-up so
apps and the multislice renderer (multichip/multislice.py) can go
multi-host with one call:

    from optix_raytracer_tpu.multichip import distributed as dist
    info = dist.initialize()              # env-driven; no-op single host
    mesh = dist.pod_mesh(rows_per_slice=4)

Environment autodetection (in priority order):
- explicit kwargs
- JAX-standard vars (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
  JAX_PROCESS_ID) and the common launcher vars (SLURM_*, OMPI_COMM_WORLD_*).
- cluster metadata that jax.distributed detects itself when everything
  is left unset.

Single-process (no coordinator configured anywhere) is an explicit no-op:
local == global devices, process_id 0 — the same code path runs unchanged
on one host, which is how the CPU-mesh tests and the driver dry-run
exercise it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import jax

from .multislice import (ROWS_AXIS, SAMPLES_AXIS, SLICE_AXIS,
                         make_multislice_mesh)


@dataclass
class ProcessInfo:
    """What bring-up resolved to."""
    initialized: bool          # True when jax.distributed was initialized
    process_id: int
    num_processes: int
    coordinator: Optional[str]
    local_devices: tuple
    global_devices: tuple

    @property
    def is_multi_host(self) -> bool:
        return self.num_processes > 1


def _env(*names):
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def detect_config(coordinator_address=None, num_processes=None,
                  process_id=None):
    """Resolve (coordinator, num_processes, process_id) from args + env.
    Returns (None, 1, 0) when nothing is configured (single process)."""
    coordinator = coordinator_address or _env(
        "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else _env(
        "JAX_NUM_PROCESSES", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
    pid = process_id if process_id is not None else _env(
        "JAX_PROCESS_ID", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
    if coordinator is None and nproc is None and pid is None:
        return None, 1, 0
    return (coordinator,
            int(nproc) if nproc is not None else 1,
            int(pid) if pid is not None else 0)


_INFO: Optional[ProcessInfo] = None


def initialize(coordinator_address=None, num_processes=None,
               process_id=None) -> ProcessInfo:
    """Bring up the process group (idempotent).

    Multi-process when a coordinator/num_processes is configured: calls
    `jax.distributed.initialize` BEFORE any backend use (caller's
    responsibility to invoke early), after which `jax.devices()` is the
    global view and `jax.local_devices()` this host's chips. Single
    process otherwise: pure no-op.
    """
    global _INFO
    if _INFO is not None:
        return _INFO
    coordinator, nproc, pid = detect_config(coordinator_address,
                                            num_processes, process_id)
    did_init = False
    if nproc > 1 or coordinator is not None:
        kwargs = {}
        if coordinator is not None:
            kwargs["coordinator_address"] = coordinator
        if nproc > 1:
            kwargs["num_processes"] = nproc
            kwargs["process_id"] = pid
        jax.distributed.initialize(**kwargs)
        did_init = True
    _INFO = ProcessInfo(
        initialized=did_init,
        process_id=jax.process_index(),
        num_processes=jax.process_count(),
        coordinator=coordinator,
        local_devices=tuple(jax.local_devices()),
        global_devices=tuple(jax.devices()),
    )
    return _INFO


def shutdown():
    """Tear down (test support). Safe to call when never initialized."""
    global _INFO
    if _INFO is not None and _INFO.initialized:
        jax.distributed.shutdown()
    _INFO = None


def pod_mesh(rows_per_slice: Optional[int] = None,
             samples_per_slice: int = 1, devices=None):
    """(slice, rows, samples) mesh with one slice PER PROCESS (host), so
    the multislice invariant — no render-time collective crosses hosts —
    holds by construction: each process's local chips form its slice.

    rows_per_slice defaults to local_chips // samples_per_slice."""
    info = initialize()
    devices = list(devices if devices is not None else info.global_devices)
    n_slices = max(info.num_processes, 1)
    per_slice = len(devices) // n_slices
    if rows_per_slice is None:
        rows_per_slice = per_slice // samples_per_slice
    assert rows_per_slice * samples_per_slice == per_slice, (
        f"rows({rows_per_slice}) x samples({samples_per_slice}) != "
        f"chips per slice ({per_slice})")
    return make_multislice_mesh(n_slices, rows_per_slice,
                                samples_per_slice, devices=devices)
