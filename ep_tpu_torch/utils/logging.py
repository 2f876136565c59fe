"""Metric logging and the four observability sinks.

Counterpart of ``ep_tpu/utils/logging.py`` (the reference's util/misc.py:
22-182, 374-412 and main_linprobe.py:186-196,719-757), line for line:

  1. ``training_log.txt`` — epoch CSV lines in the exact reference format, so
     ``tools/plot_lr*.py`` and ``search_linprobe.py`` read it unchanged.
  2. TensorBoard (tensorboardX, when installed) with the epoch_1000x x-axis
     calibration.
  3. Optional wandb, gated on WANDB_ENTITY/WANDB_PROJECT env vars.
  4. Rank-0-only timestamped stdout.

:func:`is_main_process` is true in one process and on rank 0 of a
``torch.distributed`` group. The train step's metrics are already global
(reduced over the mesh's data axis inside the step, ``train/steps.py``), so
the host-side meters need no barrier or all_reduce. The engine hands the
meters Python numbers, read one step late from the device.
"""
from __future__ import annotations

import builtins
import datetime
import os
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch


def is_main_process() -> bool:
    return (not torch.distributed.is_available()
            or not torch.distributed.is_initialized()
            or torch.distributed.get_rank() == 0)


_ORIG_PRINT = None


def setup_for_distributed(is_master: bool) -> None:
    """Rank-0-only print with a timestamp prefix (util/misc.py:168-182).
    Idempotent: repeated setup (LR-search trials re-enter main) must not
    stack prefixes."""
    global _ORIG_PRINT
    if _ORIG_PRINT is None:
        _ORIG_PRINT = builtins.print
    builtin_print = _ORIG_PRINT

    def print_(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            now = datetime.datetime.now().time()
            builtin_print(f"[{now}] ", end="")
            builtin_print(*args, **kwargs)

    builtins.print = print_


class SmoothedValue:
    """Track a series of values: windowed median/avg + global average."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(np.asarray(self.deque))) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(np.asarray(self.deque))) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if v is None:
                continue
            if hasattr(v, "item"):
                v = float(v.item()) if np.ndim(v) == 0 else float(np.asarray(v))
            assert isinstance(v, (float, int)), (k, type(v))
            self.meters[k].update(v)

    def update_n(self, n: int, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v), n=n)

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def __getattr__(self, attr):
        meters = self.__dict__.get("meters")
        if meters is not None and attr in meters:
            return meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def stats(self) -> dict:
        return {k: m.global_avg for k, m in self.meters.items()}

    def log_every(self, iterable, print_freq: int, header: str = "",
                  length: Optional[int] = None) -> Iterable:
        i = 0
        length = length if length is not None else len(iterable)
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        space_fmt = ":" + str(len(str(length))) + "d"
        log_msg = self.delimiter.join([
            header, "[{0" + space_fmt + "}/{1}]", "eta: {eta}", "{meters}",
            "time: {time}", "data: {data}",
        ])
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == length - 1:
                eta = iter_time.global_avg * (length - i)
                print(log_msg.format(
                    i, length, eta=str(datetime.timedelta(seconds=int(eta))),
                    meters=str(self), time=str(iter_time), data=str(data_time)))
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        print("{} Total time: {} ({:.4f} s / it)".format(
            header, str(datetime.timedelta(seconds=int(total_time))),
            total_time / max(length, 1)))


class TrainingLogFile:
    """Writer for ``training_log.txt`` in the reference's exact format
    (main_linprobe.py:186-196,574-578,719-722,752-757)."""

    def __init__(self, output_dir: str):
        self.path = os.path.join(output_dir, "training_log.txt")
        self.enabled = bool(output_dir) and is_main_process()

    def write_header(self, cfg) -> None:
        if not self.enabled:
            return
        Path(os.path.dirname(self.path) or ".").mkdir(parents=True, exist_ok=True)
        with open(self.path, "w") as f:
            f.write("Training Log\n")
            f.write(f"Model: {cfg.model}\n")
            f.write(f"Model Details: {cfg.finetune}\n")
            f.write(f"Dataset: {cfg.dataset_name}\n")
            f.write(f"Representation: {cfg.cls_features}\n")
            f.write(f"Batch size per GPU: {cfg.batch_size}\n")
            f.write(f"Base learning rate: {cfg.blr}\n")

    def write_setup(self, eff_batch_size: int, n_parameters: int) -> None:
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(f"Effective batch size: {eff_batch_size}\n")
            f.write(f"Trainable Parameters: {n_parameters:,}\n")
            f.write("Epoch, Train Loss, Train Acc1, Val Loss, Val Acc1, Val Acc5\n")

    def write_epoch(self, epoch: int, train_stats: dict, test_stats: dict) -> None:
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(
                f"{epoch}, {train_stats['loss']:.4f}, {train_stats['acc1']:.2f}, "
                f"{test_stats['loss']:.4f}, {test_stats['acc1']:.2f}, "
                f"{test_stats['acc5']:.2f}\n"
            )

    def write_line(self, msg: str) -> None:
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(msg + "\n")

    def write_final(self, max_accuracy: float, test_stats: dict,
                    total_time_str: str) -> None:
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write("\nFinal Results:\n")
            f.write(f"Max Accuracy: {max_accuracy:.2f}%\n")
            f.write(f"Final Val Acc1: {test_stats['acc1']:.2f}%\n")
            f.write(f"Final Val Acc5: {test_stats['acc5']:.2f}%\n")
            f.write(f"Total Training Time: {total_time_str}\n")


def make_tb_writer(output_dir: str):
    """TensorBoard writer (sink 2); returns None when unavailable/disabled."""
    if not output_dir or not is_main_process():
        return None
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(log_dir=output_dir)
    except Exception:
        return None


def maybe_setup_wandb(logdir: str, cfg=None, job_type: str = "linprobe_v1",
                      run_name_suffix: str = ""):
    """Optional wandb init, gated on WANDB_ENTITY/WANDB_PROJECT
    (util/misc.py:374-412). Returns the run or None."""
    entity = os.environ.get("WANDB_ENTITY")
    project = os.environ.get("WANDB_PROJECT")
    if entity is None or project is None:
        print(f"wandb_entity={entity} wandb_project={project}")
        print("Not initializing WANDB")
        return None
    try:
        import wandb
    except ImportError:
        print("wandb not installed; skipping")
        return None
    origin = Path(logdir).name
    # run-name dedup via the wandb API (util/misc.py:386-395): if a run
    # already carries this display name, suffix with the group's run count;
    # an API failure (offline mode) degrades to the plain name.
    name = origin
    try:
        api = wandb.Api()
        path = f"{entity}/{project}"
        name_runs = list(api.runs(path, filters={"display_name": origin}))
        if name_runs:
            group_runs = list(api.runs(path, filters={"group": origin}))
            name = f"{origin}_{len(group_runs)}"
    except Exception as err:
        print(f"wandb name-dedup skipped: {err}")
    if run_name_suffix:
        name = f"{name}_{run_name_suffix}"
    run = wandb.init(
        entity=entity, project=project,
        config=(vars(cfg) if hasattr(cfg, "__dict__") else
                (cfg.__dataclass_fields__ and
                 {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}) if cfg else None),
        name=name, dir=logdir, group=origin, job_type=job_type,
        resume="never", sync_tensorboard=True,
    )
    print("WANDB run", run.id, name, origin)
    return run
