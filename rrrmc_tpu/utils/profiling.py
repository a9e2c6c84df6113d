"""Tracing / profiling instrumentation.

The reference's observability story is wall-clock timing inside its driver
loops (runtest, /root/reference/src/RRRMC.jl:733-760); on an accelerator
almost all time is spent inside XLA programs and kernels dispatched
asynchronously, so there are three layers:

1. ``trace(logdir)`` — the JAX profiler (TensorBoard "XProf" format):
   per-HLO and per-kernel device timelines next to the host plane
   (dispatch, transfer, compile spans). Kernels carry stable names
   (e.g. ``lattice_sweep``) so a trace reduction can find them.
2. ``annotate(name)`` — names a region of host code so its dispatches group
   under one span in the trace viewer (jax.profiler.TraceAnnotation).
3. ``dispatch_counters`` — a host-side registry of per-label dispatch
   counts and (opt-in, synchronizing) wall times. Synchronization is
   ``jax.block_until_ready`` on the output.

None of them costs anything unless used; nothing here runs inside jit.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import jax

__all__ = ["trace", "annotate", "DispatchCounters", "dispatch_counters"]


@contextlib.contextmanager
def trace(logdir: str, *, host_only: bool = False):
    """Capture a jax.profiler trace into ``logdir`` (TensorBoard format).

    View with ``tensorboard --logdir=<logdir>`` (Profile tab) or xprof.
    host_only=True records host spans only (compiles, dispatches,
    transfers, `annotate()` regions)."""
    opts = jax.profiler.ProfileOptions()
    if host_only:
        opts.device_tracer_level = 0
    jax.profiler.start_trace(logdir, profiler_options=opts)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named host-span context manager; nests inside `trace()` captures."""
    return jax.profiler.TraceAnnotation(name)


@dataclass
class _Stat:
    count: int = 0
    wall_s: float = 0.0
    synced: int = 0


@dataclass
class DispatchCounters:
    """Per-label dispatch counters with optional synchronized timing.

    >>> pc = DispatchCounters()
    >>> with pc.measure("sweep_chunk", out := sweeper(sigma, E, ...)):
    ...     pass            # or: out = pc.timed("sweep_chunk", fn, *args)
    >>> pc.summary()
    {"sweep_chunk": {"count": 3, "wall_s": 1.2, ...}}

    `timed(label, fn, *a, sync_out=True, **kw)` is the main entry: it calls
    fn, optionally syncs on the output (true end-to-end latency — use only
    when measuring, it defeats async pipelining), and accumulates. `tick`
    counts without timing."""

    stats: Dict[str, _Stat] = field(
        default_factory=lambda: defaultdict(_Stat))

    def tick(self, label: str, n: int = 1) -> None:
        self.stats[label].count += n

    def timed(self, label: str, fn, *args, sync_out: bool = True, **kw):
        t0 = time.time()
        out = fn(*args, **kw)
        if sync_out:
            jax.block_until_ready(out)
        s = self.stats[label]
        s.count += 1
        s.wall_s += time.time() - t0
        s.synced += int(sync_out)
        return out

    @contextlib.contextmanager
    def measure(self, label: str, *, sync_value=None):
        """Times the with-block; if sync_value is given, syncs on it at
        exit so the measurement covers device completion."""
        t0 = time.time()
        yield
        if sync_value is not None:
            jax.block_until_ready(sync_value)
        s = self.stats[label]
        s.count += 1
        s.wall_s += time.time() - t0
        s.synced += int(sync_value is not None)

    def summary(self) -> Dict[str, Dict]:
        return {k: {"count": v.count, "wall_s": v.wall_s,
                    "synced": v.synced,
                    "mean_s": (v.wall_s / v.count if v.count else 0.0)}
                for k, v in sorted(self.stats.items())}

    def reset(self) -> None:
        self.stats.clear()


#: process-global default registry (samplers are pure; instrumentation that
#: wants per-path dispatch counts hooks in at the driver level)
dispatch_counters = DispatchCounters()
