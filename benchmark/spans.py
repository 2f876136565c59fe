"""The program's own spans over a traced stretch: the ``ep::`` ranges that
``ep_tpu_torch/runtime/profiler.py::span`` opens under the profiler
(``ep::step`` and its phases, the blocks' halves, the head).

    python3 -m benchmark.spans --workload <cell> --seed <n>

runs a cell's traced stretch as ``run.py`` does (after set-up and warm-up,
without the window and the correctness check) and prints one JSON line:
the split below, beside ``devtrace.Summary``'s ``bwd_opt_ms`` and
``idle_share`` of the same trace.

- Device attribution: a device operation belongs to the innermost ``ep::``
  span open on the thread that launched it; where that thread has none open
  (autograd's device thread in the backward), to the innermost ``ep::``
  span open on the window's main thread at the launch's time stamp. A
  forward recomputed in the backward opens its own spans on autograd's
  thread and keeps its kernels.
- Host self time: each main-thread span's duration less its child ``ep::``
  spans on that thread.
- Idle: each stretch of the window in which the device ran nothing, split
  by exact overlap across the innermost main-thread ``ep::`` span open
  during it (None: outside every span).

``devtrace.Summary`` is left as it is: the ``bench::`` attribution that the
benchmark's per-layer metrics read does not see these spans.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from bisect import bisect_left, bisect_right
from collections import defaultdict

import torch

from . import check, devtrace, manifest, run

PREFIX = "ep::"
# the spans that split what the benchmark's ``bwd_opt_ms`` holds
OUTSIDE_FORWARD = ("ep::step", "ep::loss", "ep::backward", "ep::grad_reduce",
                   "ep::metrics", "ep::optimizer")


class Spans:
    """The ``ep::`` attribution of the traced stretch that ``summary`` read
    from ``events``: device, host self and idle seconds by span name, and
    each span's calls (opened in the window, on any thread)."""

    def __init__(self, events: list, summary: devtrace.Summary):
        self.summary = s = summary
        xs = [e for e in events if e.get("ph") == "X"]
        ranges, launches = defaultdict(list), {}
        for e in xs:
            cat = e.get("cat")
            if cat == "user_annotation" and e["name"].startswith(PREFIX):
                ts = float(e["ts"])
                ranges[e["tid"]].append((ts, ts + float(e["dur"]), e["name"]))
            if cat in devtrace.LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = (e["tid"], e["ts"])
        for v in ranges.values():
            v.sort(key=lambda r: (r[0], -r[1]))
        main = ranges.get(s.main_tid, [])

        self.calls = defaultdict(int)
        for v in ranges.values():
            for t, _, name in v:
                if s.lo <= t <= s.hi:
                    self.calls[name] += 1

        device = [e for e in xs if e.get("cat") in devtrace.DEVICE_CATS]
        by_tid = defaultdict(list)
        for e in device:
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is not None and s.lo <= launch[1] <= s.hi:
                by_tid[launch[0]].append((launch[1], e["dur"] / 1e6))
        self.device_s = defaultdict(float)
        for tid, pts in by_tid.items():
            pts.sort()
            at = [t for t, _ in pts]
            own = devtrace.innermost(ranges.get(tid, []), at)
            waiting = devtrace.innermost(main, at)
            for (_, d), a, b in zip(pts, own, waiting):
                self.device_s[a or b] += d

        self.host_s = defaultdict(float)
        own_us = [e - t for t, e, _ in main]
        stack = []
        for i, (t, e, _) in enumerate(main):
            while stack and main[stack[-1]][1] <= t:
                stack.pop()
            if stack:
                own_us[stack[-1]] -= e - t
            stack.append(i)
        for (t, _, name), us in zip(main, own_us):
            if s.lo <= t <= s.hi:
                self.host_s[name] += us / 1e6

        busy = devtrace.union(devtrace.clip(
            [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in device], s.lo, s.hi))
        edges = [s.lo] + [x for b in busy for x in b] + [s.hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        cuts = sorted({x for t, e, _ in main for x in (t, e)
                       if s.lo < x < s.hi})
        pieces = []
        for a, b in gaps:
            inner = cuts[bisect_right(cuts, a):bisect_left(cuts, b)]
            pts = [a] + inner + [b]
            pieces += [((x + y) / 2, y - x) for x, y in zip(pts, pts[1:])]
        pieces.sort()
        self.idle_s = defaultdict(float)
        for (_, length), name in zip(
                pieces, devtrace.innermost(main, [m for m, _ in pieces])):
            self.idle_s[name] += length / 1e6

    def _per_step_ms(self, table: dict, name) -> float:
        return 1e3 * table.get(name, 0.0) / max(self.summary.steps, 1)

    def device_ms(self, name) -> float | None:
        """Device ms a step attributed to span ``name``; None without
        device records or without the span."""
        if self.summary.busy_s <= 0 or not self.calls.get(name):
            return None
        return self._per_step_ms(self.device_s, name)

    def idle_ms(self, name) -> float | None:
        """Device idle ms a step while the main thread's innermost span is
        ``name``; None without device records or without the span."""
        if self.summary.busy_s <= 0 or not self.calls.get(name):
            return None
        return self._per_step_ms(self.idle_s, name)

    def host_ms(self, name) -> float | None:
        """Host self ms a step of the main thread's span ``name``."""
        if not self.calls.get(name):
            return None
        return self._per_step_ms(self.host_s, name)

    def metrics(self) -> dict:
        """The five readings of the ``backward and optimizer`` layer."""
        return {"bwd_ms": self.device_ms("ep::backward"),
                "opt_ms": self.device_ms("ep::optimizer"),
                "opt_host_ms": self.host_ms("ep::optimizer"),
                "bwd_idle_ms": self.idle_ms("ep::backward"),
                "opt_idle_ms": self.idle_ms("ep::optimizer")}

    def report(self) -> dict:
        """The metrics beside the checks that the split is whole: the spans
        outside the forward against ``bwd_opt_ms``, the device time outside
        every span, and the idle parts against the window's idle time."""
        s, steps = self.summary, max(self.summary.steps, 1)
        total = sum(self.device_s.values())
        out = {"metrics": self.metrics(),
               "calls_per_step": {k: v / steps for k, v in self.calls.items()},
               "host_self_ms": {k: self._per_step_ms(self.host_s, k)
                                for k in self.host_s}}
        if s.busy_s > 0:
            out.update(
                device_ms={str(k): self._per_step_ms(self.device_s, k)
                           for k in self.device_s},
                split_ms=sum(self._per_step_ms(self.device_s, k)
                             for k in OUTSIDE_FORWARD),
                bwd_opt_ms=s.outside_forward_ms(),
                outside_spans_pct=100.0 * self.device_s.get(None, 0.0) / total,
                idle_ms={str(k): self._per_step_ms(self.idle_s, k)
                         for k in self.idle_s},
                window_idle_ms=1e3 * (s.window_s - s.busy_s) / steps,
                idle_share=100.0 * (1.0 - s.busy_s / s.window_s))
        return out


def traced_events(train: run.Trainer, n: int, sync) -> list:
    """The events of ``run.traced_stretch``'s profiled stretch."""
    from torch.profiler import ProfilerActivity, profile, record_function
    train.prog.install_ranges()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        train()
        sync()
        with record_function(devtrace.WINDOW):
            for _ in range(n):
                with record_function(devtrace.STEP):
                    train()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return devtrace.load(path)
    finally:
        os.remove(path)


def measure(cell: manifest.Cell, seed: int, device: str = "cuda") -> dict:
    """Set-up and warm-up as ``run.run``, then its host and traced
    stretches; the report of the traced one."""
    from .program import Program
    from .weights import draw_batches, draw_weights
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, traffic = cell.config, cell.traffic
    W = draw_weights(cfg, traffic["image_size"], seed, device,
                     frozen_encoder=traffic["step"] != "finetune")
    images, labels = draw_batches(cfg, traffic, seed, device)
    train = run.Trainer(Program(cfg, traffic, W, device), images, labels,
                        cfg["optimizer"]["schedule"]["start_step"])
    del W
    for _ in range(check.CHECK_STEPS + run.WARMUP_STEPS):
        train()
    host_ms = run.host_stretch(train, traffic["host_steps"], sync)
    events = traced_events(train, traffic["trace_steps"], sync)
    summary = devtrace.Summary(events)
    steps = [e["dur"] / 1e3 for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") == devtrace.STEP
             and summary.lo <= e["ts"] <= summary.hi]
    return {"workload": cell.name, "seed": seed, "steps": summary.steps,
            "host_ms": sum(host_ms) / len(host_ms),
            "traced_step_host_ms": sum(steps) / max(len(steps), 1),
            **Spans(events, summary).report()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    a = p.parse_args(argv)
    for var, sub in run.CACHES.items():
        os.environ[var] = str(manifest.ROOT / ".bench_cache" / sub)
    if not torch.cuda.is_available():
        run.log("no CUDA device")
        return 2
    out = measure(manifest.cell(a.workload), a.seed)
    out["card"] = run.power_limit()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
