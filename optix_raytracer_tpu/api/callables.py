"""Callable program tables: `optixDirectCall` / `optixContinuationCall`.

The reference registers direct/continuation-callable program groups and
dispatches them by SBT index at run time (`optixCallablePrograms.cu:123,138`,
group setup `optixCallablePrograms.cpp:434-444`). Under XLA the exact same
shape is `jax.lax.switch` over a static function table: the "SBT callable
index" is a traced int32, every callable is traced once, and dispatch is
branchless per lane: every lane evaluates the selected branch's program
where the reference pays a divergent indirect call.
"""
from __future__ import annotations

from typing import Callable, Sequence

import jax


class CallableTable:
    def __init__(self, callables: Sequence[Callable] = ()):
        self._fns = list(callables)

    def add(self, fn: Callable) -> int:
        """Register a callable; returns its SBT index."""
        self._fns.append(fn)
        return len(self._fns) - 1

    def __len__(self):
        return len(self._fns)

    def direct_call(self, index, *args):
        """`optixDirectCall<Ret>(sbt_index, args...)`: branchless dispatch of
        `index` (traced int, any batch shape via vmap outside) over the
        table."""
        if not self._fns:
            raise ValueError("empty callable table")
        return jax.lax.switch(index, self._fns, *args)

    # Continuation callables have identical dispatch semantics here — the
    # distinction in the reference is a stack/scheduling detail of the driver
    # (optix_device.h:1484), which XLA's inlining makes moot.
    continuation_call = direct_call
