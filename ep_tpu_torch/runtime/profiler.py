"""Profiling hooks.

Counterpart of ``ep_tpu/runtime/profiler.py``:
  * ``trace`` — a context manager around ``torch.profiler`` (the host and,
    where there is one, the card), enabled by ``--profile_dir``: it writes a
    Chrome trace, ``trace.json``, into that directory;
  * ``span`` — the port's named ranges (``ep::step``, ``ep::backward``,
    ``ep::attn_half``, ...). Under a profiler session, whichever opened it
    (``trace``, the benchmark's traced stretch, ``chip_smoke.py``), a span
    is a ``record_function`` range: the trace holds its name, start, end and
    enclosing range on the device trace's clock, beside the kernels it
    launched. With no session running it is one shared no-op context, at
    the cost of one check of the profiler's flag.
The JAX package's ``compiled_cost`` reads XLA's cost model, which eager
PyTorch does not have; its ``ThroughputMeter`` has no counterpart here.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` (an ``ep::`` name) while a profiler
    session runs; else the shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    if not profile_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
