"""Profiling hooks.

Counterpart of ``ep_tpu/runtime/profiler.py``:
  * ``trace`` — a context manager around ``torch.profiler`` (the host and,
    where there is one, the card), enabled by ``--profile_dir``: it writes a
    Chrome trace, ``trace.json``, into that directory;
  * ``ThroughputMeter`` — an images-per-second meter on the host clock.
The JAX package's ``compiled_cost`` reads XLA's cost model, which eager
PyTorch does not have.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


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


class ThroughputMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._images = 0

    def update(self, n_images: int):
        self._images += n_images

    @property
    def images_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._images / dt if dt > 0 else 0.0
