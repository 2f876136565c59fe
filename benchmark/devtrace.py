"""Arithmetic over a profiler trace (Chrome trace JSON, as
``torch.profiler`` exports it).

- Device intervals: kernels, copies and sets on the card; their union is the
  time the device was busy, so overlap between streams counts once.
- Attribution: every device operation belongs to the innermost ``bench::``
  range open on the host thread that launched it, found through the
  launch's correlation id. A kernel launched by the autograd engine's thread
  belongs to a range only where that thread opened one (a forward recomputed
  in the backward does).
- Idle gaps: the stretches of the window in which the device ran nothing,
  named by the innermost host operation open on the window's thread in the
  middle of each.
"""
from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
PREFIX = "bench::"
WINDOW = "bench::window"
STEP = "bench::step"


def load(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def union(intervals) -> list:
    """Merged (start, end) pairs of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def innermost(ranges: list, points: list) -> list:
    """For each point (sorted), the innermost of ``ranges`` (start, end,
    name), sorted by start and properly nested, that contains it, or None."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


class Summary:
    """What the per-layer metrics read from one traced stretch of steps."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X"]
        windows = [e for e in xs if e.get("cat") == "user_annotation"
                   and e.get("name") == WINDOW]
        if len(windows) != 1:
            raise ValueError(f"{len(windows)} {WINDOW} ranges in the trace")
        w = windows[0]
        self.lo, self.hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.window_s = (self.hi - self.lo) / 1e6
        self.main_tid = w["tid"]
        self.steps = sum(1 for e in xs if e.get("cat") == "user_annotation"
                         and e.get("name") == STEP
                         and self.lo <= e["ts"] <= self.hi)

        ranges = defaultdict(list)
        host = defaultdict(list)
        launches = {}
        for e in xs:
            cat = e.get("cat")
            if cat == "user_annotation" and e["name"].startswith(PREFIX):
                ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
            if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = (e["tid"], e["ts"])
            if cat in HOST_CATS and e["tid"] == self.main_tid:
                host[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        for v in ranges.values():
            v.sort(key=lambda r: (r[0], -r[1]))

        device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        # a device operation counts where its launch lies inside the window
        by_tid = defaultdict(list)
        for k, e in enumerate(device):
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is not None and self.lo <= launch[1] <= self.hi:
                by_tid[launch[0]].append((launch[1], k))
        self.by_label = defaultdict(float)  # label -> device seconds
        self.by_name = defaultdict(float)  # operation name -> device seconds
        self.counted = []
        for tid, pts in by_tid.items():
            pts.sort()
            labels = innermost(ranges.get(tid, []), [t for t, _ in pts])
            for (_, k), label in zip(pts, labels):
                e = device[k]
                self.by_label[label] += e["dur"] / 1e6
                self.by_name[e["name"]] += e["dur"] / 1e6
                self.counted.append(k)
        self.calls = defaultdict(int)  # range name -> ranges opened in window
        for v in ranges.values():
            for s, _, name in v:
                if self.lo <= s <= self.hi:
                    self.calls[name] += 1

        busy = union(clip([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in device], self.lo, self.hi))
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
        if busy:
            gaps = [(self.lo, busy[0][0])] + gaps + [(busy[-1][1], self.hi)]
        else:
            gaps = [(self.lo, self.hi)]
        gaps = [g for g in gaps if g[1] > g[0]]
        mids = sorted(((s + e) / 2, e - s) for s, e in gaps)
        hr = sorted(host[self.main_tid], key=lambda r: (r[0], -r[1]))
        names = innermost(hr, [m for m, _ in mids])
        self.idle_by_host = defaultdict(float)
        for (_, length), name in zip(mids, names):
            self.idle_by_host[name or "no host operation"] += length / 1e6

    def per_step_ms(self, label) -> float:
        return 1e3 * self.by_label.get(label, 0.0) / max(self.steps, 1)

    def outside_forward_ms(self) -> float:
        """Device ms per step launched in no range of the model's forward:
        the backward, the loss, the metrics and the optimizer."""
        inside = sum(v for k, v in self.by_label.items()
                     if k in ("bench::forward", "bench::attn_half",
                              "bench::mlp_half", "bench::head"))
        total = sum(self.by_label.values())
        return 1e3 * (total - inside) / max(self.steps, 1)

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:200], v] for k, v in top],
                "idle_gaps": [[k[:200], v] for k, v in gaps]}
