"""One run of a benchmark cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up draws the weights and a pool of batches from the seed on the card,
builds the port's training step as its driver does, and drives the step's
first ``check.CHECK_STEPS`` steps (read for the correctness check) and
``WARMUP_STEPS`` more. The window then dispatches steps back to back, one
trainer in a closed loop, with a CUDA event after each and one sync at its
end. With ``--trace 1`` the window is followed by ``host_steps`` steps each
after a sync (the host's dispatch time) and ``trace_steps`` steps under the
profiler, with ranges around the calls into each layer; the result then
carries the per-layer metrics instead of the end-to-end ones. Last, the
program is freed and the reference follows the checked steps.

The last line of standard output is the result (one JSON object); the last
lines of standard error are the compared numbers beside their limits.
"""
from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import torch  # noqa: E402

from . import check, devtrace, imports, manifest  # noqa: E402
from .peaks import peaks  # noqa: E402
from .weights import draw_batches, draw_weights  # noqa: E402

WARMUP_STEPS = 2
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def process_age() -> float:
    """Seconds since this process started, from the kernel's start time; since
    this module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - T0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Marks:
    """A mark after each step: a CUDA event on the card, the host clock on
    the CPU (where only the tests run)."""

    def __init__(self, cuda: bool):
        self.cuda, self.marks = cuda, []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def p90(values: list) -> float:
    """The 90th percentile over all values (``statistics.quantiles``,
    inclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=10, method="inclusive")[8]


class Trainer:
    """The program's step driven over the pool of batches, by global step."""

    def __init__(self, prog, images, labels, first_step: int):
        self.prog, self.images, self.labels = prog, images, labels
        self.first = first_step
        self.next = first_step

    def __call__(self):
        j = (self.next - self.first) % len(self.images)
        m = self.prog.step(self.next, self.images[j], self.labels[j])
        self.next += 1
        return m


def measure_window(train: Trainer, seconds: float, sync, cuda: bool) -> dict:
    marks, losses = Marks(cuda), []
    sync()
    t0 = time.perf_counter()
    marks.mark()
    deadline = t0 + seconds
    while True:
        losses.append(train()["loss"])
        marks.mark()
        if time.perf_counter() >= deadline:
            break
    sync()
    wall = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return dict(steps=len(losses), wall=wall, failed=failed,
                intervals=marks.intervals_ms())


def host_stretch(train: Trainer, n: int, sync) -> list:
    """Host ms for ``train_step`` to return, each step after a sync."""
    out = []
    for _ in range(n):
        sync()
        t = time.perf_counter()
        train()
        out.append((time.perf_counter() - t) * 1e3)
    sync()
    return out


def traced_stretch(train: Trainer, n: int, sync) -> devtrace.Summary:
    from torch.profiler import ProfilerActivity, profile, record_function
    train.prog.install_ranges()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        train()  # under the profiler, outside the window: its start-up
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
        return devtrace.Summary(devtrace.load(path))
    finally:
        os.remove(path)


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", fault: str | None = None) -> dict:
    """One run; returns the result object (the line the run prints)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, traffic = cell.config, cell.traffic
    ft = traffic["step"] == "finetune"
    from .program import Program
    log(f"set-up: imports done at {process_age():.2f} s")
    if cuda:
        from ep_tpu_torch.ops._build import build
        _, build_s, compiled = build()
        if compiled:
            print(json.dumps({"compiled_kernels": True, "build_s": build_s}),
                  flush=True)
        log(f"set-up: kernel library at {process_age():.2f} s")
    W = draw_weights(cfg, traffic["image_size"], seed, device,
                     frozen_encoder=not ft)
    images, labels = draw_batches(cfg, traffic, seed, device)
    sync()
    log(f"set-up: weights and batches at {process_age():.2f} s")
    prog = Program(cfg, traffic, W, device)
    del W
    sync()
    log(f"set-up: the program at {process_age():.2f} s")
    first = cfg["optimizer"]["schedule"]["start_step"]
    train = Trainer(prog, images, labels, first)
    with prog.fault(fault):
        readings = check.program_readings(prog, images, labels, first)
        train.next = first + check.CHECK_STEPS
        log(f"set-up: checked steps read at {process_age():.2f} s")
        for _ in range(WARMUP_STEPS):
            train()
        sync()
        setup_s = process_age()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        win = measure_window(train, seconds, sync, cuda)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        host_ms, summary = [], None
        if trace:
            host_ms = host_stretch(train, traffic["host_steps"], sync)
            summary = traced_stretch(train, traffic["trace_steps"], sync)
    del prog, train, images, labels
    if cuda:
        torch.cuda.empty_cache()
    img_s = win["steps"] * traffic["batch"] / win["wall"]
    log(f"window: {win['steps']} steps of {traffic['batch']} images in "
        f"{win['wall']:.3f} s; set-up {setup_s:.2f} s")

    t_ref = time.perf_counter()
    ref = check.reference_readings(cfg, traffic, seed, device)
    gaps = check.gaps(readings, ref)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s; worst grad leaf "
        f"{gaps['worst_grad_leaf']}, worst update leaf "
        f"{gaps['worst_update_leaf']}, {len(gaps['skipped_leaves'])} leaves "
        "left out of the change")
    correct, checks = check.judge(gaps, cell.limits)
    correct = correct and win["failed"] == 0  # no step of the window lost

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": win["steps"],
           "failed": win["failed"]}
    if not trace:
        values = {"img_s": img_s, "step_ms_p90": p90(win["intervals"]),
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        reading = SimpleNamespace(
            summary=summary, host_ms=host_ms, img_s=img_s, cfg=cfg,
            traffic=traffic, card=peaks(kind))
        metrics = {}
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    out.update(metrics=metrics, device=dev)
    if trace:
        out["breakdown"] = summary.breakdown()
    out["checks"] = checks
    return out


def power_limit() -> str:
    import subprocess
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return p.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(manifest.ROOT / ".bench_cache" / sub)
    cell = manifest.cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{a.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
            "available")
        return 2
    out = run(cell, a.seed, a.seconds, bool(a.trace))
    checks = out.pop("checks")
    out["card"] = power_limit()  # the name and the power limit
    out["checks"] = checks
    bad = imports.forbidden()
    if bad:
        log(f"modules loaded that a run may not load: {bad}")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
