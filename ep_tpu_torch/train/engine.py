"""Host-side train/eval/extract/kNN loops (engine_finetune.py rebuilt).

Counterpart of ``ep_tpu/train/engine.py``: the loops feed batches to the
steps of ``train/steps.py``, meter their metrics and implement the
reference's protocol details: the per-iteration LR (inside the step), the
loss-finiteness abort (engine_finetune.py:68-70), batch-size-weighted eval
meters (:150-153) and the temperature-weighted kNN classifier (:216-257).

Over several ranks the train step's metrics are already global
(``train/steps.py``). ``evaluate`` all-reduces its sums over the mesh's data
axis when the val loader is sharded (``--dist_eval``); without it every rank
evaluates the whole val set, as in the JAX loaders. ``extract_features``
gathers every rank's rows of a sharded loader in rank order, so every rank
holds the whole split; the JAX function reads a global array with
``device_get``, which JAX refuses across processes.

A batch arrives from the loader as NHWC float32 numpy. It is cast to bf16 on
the host when the model computes in bf16 (half the bytes to copy) and, with
``--pin_mem``, copied from pinned memory without blocking the host. Metrics
stay on the device and are read one step late, so the host never waits for
the step it has just launched.
"""
from __future__ import annotations

import math
import sys
from typing import Dict

import numpy as np
import torch

from ep_tpu_torch.parallel.mesh import DATA_AXIS
from ep_tpu_torch.parallel.metrics import (all_gather_rows,
                                           collective_device, psum)
from ep_tpu_torch.runtime.profiler import span
from ep_tpu_torch.utils.logging import MetricLogger, SmoothedValue


def _host_cast(images: np.ndarray, cfg) -> torch.Tensor:
    """The batch as a host tensor, in bf16 when the model computes in bf16."""
    t = torch.from_numpy(np.ascontiguousarray(images))
    if t.dtype != torch.uint8 and cfg is not None and \
            cfg.amp in ("bfloat16", "float16"):
        t = t.to(torch.bfloat16)
    return t


def to_device(array: np.ndarray, device: torch.device, pin: bool,
              cfg=None) -> torch.Tensor:
    """Copy one host array to ``device`` (images through :func:`_host_cast`
    when ``cfg`` is given); pinned and non-blocking with ``pin`` on a card."""
    t = _host_cast(array, cfg) if cfg is not None else torch.from_numpy(
        np.ascontiguousarray(array))
    if device.type == "cuda":
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)
    return t.to(device)


def _waited(loader):
    """The loader's batches, each ``next`` in an ``ep::data_wait`` span."""
    batches = iter(loader)
    while True:
        with span("ep::data_wait"):
            batch = next(batches, None)
        if batch is None:
            return
        yield batch


def train_one_epoch(train_step, step: int, loader, device, epoch: int, cfg,
                    log_writer=None) -> tuple[int, Dict[str, float]]:
    """One epoch from global step ``step``; returns (the global step after
    it, the averaged train stats)."""
    metric_logger = MetricLogger(delimiter="  ")
    metric_logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    header = f"Epoch: [{epoch}]"
    print_freq = 20
    length = len(loader)
    pin = bool(cfg.pin_mem)

    # Metrics are read with a one-step lag so the host never blocks the
    # device on the current step's results; the NaN abort therefore fires
    # one step late, which changes nothing observable.
    pending = None  # (it, metrics) from the previous step

    def drain(entry):
        it_prev, m = entry
        loss_value = float(m["loss"])
        if not math.isfinite(loss_value):
            print(f"Loss is {loss_value}, stopping training")
            sys.exit(1)
        metric_logger.update(
            loss=loss_value,
            acc1=float(m["acc1"]),
            acc5=float(m["acc5"]),
            lr=float(m["lr"]),
            grad_norm=float(m["grad_norm"]),
        )
        if log_writer is not None and (it_prev + 1) % cfg.accum_iter == 0:
            # epoch_1000x x-axis calibration (engine_finetune.py:92-98)
            epoch_1000x = int((it_prev / length + epoch) * 1000)
            log_writer.add_scalar("loss", loss_value, epoch_1000x)
            log_writer.add_scalar("lr", float(m["lr"]), epoch_1000x)

    for it, (images, labels, _valid) in enumerate(
            metric_logger.log_every(_waited(loader), print_freq, header,
                                    length=length)):
        with span("ep::h2d"):
            images = to_device(images, device, pin, cfg)
            labels = to_device(labels, device, pin).long()
        metrics = train_step(step, images, labels)
        step += 1
        if pending is not None:
            drain(pending)
        pending = (it, metrics)

    if pending is not None:
        drain(pending)

    print("Averaged stats:", metric_logger)
    return step, metric_logger.stats()


def evaluate(eval_step, loader, device, cfg=None,
             return_targets_and_preds: bool = False) -> Dict[str, float]:
    metric_logger = MetricLogger(delimiter="  ")
    header = "Test:"
    sums = {"loss_sum": 0.0, "acc1_sum": 0.0, "acc5_sum": 0.0, "count": 0.0}
    targets, preds = [], []
    pin = bool(cfg is not None and cfg.pin_mem)

    # one-batch-lag read, like train_one_epoch: log_every's periodic prints
    # show meters one batch behind (the final stats below are exact)
    pending = None

    def drain(entry):
        batch_sums, batch_preds, host_labels, host_valid = entry
        if return_targets_and_preds:
            keep = host_valid > 0
            targets.append(host_labels[keep])
            preds.append(batch_preds.cpu().numpy()[keep])
        for k in sums:
            sums[k] += float(batch_sums[k])
        n = max(float(batch_sums["count"]), 1.0)
        metric_logger.update_n(
            int(n),
            loss=float(batch_sums["loss_sum"]) / n,
            acc1=float(batch_sums["acc1_sum"]) / n,
            acc5=float(batch_sums["acc5_sum"]) / n,
        )

    for images, labels, valid in metric_logger.log_every(
            iter(loader), 10, header, length=len(loader)):
        host_labels, host_valid = labels, valid
        batch_sums, batch_preds = eval_step(
            to_device(images, device, pin, cfg),
            to_device(labels, device, pin).long(),
            to_device(valid, device, pin))
        if pending is not None:
            drain(pending)
        pending = (batch_sums, batch_preds, host_labels, host_valid)
    if pending is not None:
        drain(pending)
    if _sharded(loader):
        # --dist_eval: each rank evaluated its shard; the sums are global
        total = psum(torch.tensor([sums[k] for k in sums], dtype=torch.float64,
                                  device=collective_device()), DATA_AXIS)
        sums = dict(zip(sums, total.tolist()))

    count = max(sums["count"], 1.0)
    stats = {
        "loss": sums["loss_sum"] / count,
        "acc1": sums["acc1_sum"] / count,
        "acc5": sums["acc5_sum"] / count,
    }
    print("* Acc@1 {:.3f} Acc@5 {:.3f} loss {:.3f}".format(
        stats["acc1"], stats["acc5"], stats["loss"]))
    if return_targets_and_preds:
        stats["targets"] = np.concatenate(targets) if targets else np.array([])
        stats["preds"] = np.concatenate(preds) if preds else np.array([])
    return stats


def _sharded(loader) -> bool:
    """Whether ``loader`` yields only this rank's share of its split."""
    return getattr(loader, "num_processes", 1) > 1


def gather_labels(labels: np.ndarray, valid: np.ndarray):
    """(labels, valid) of a batch's rows on every rank of the data axis, in
    rank order (numpy, ``labels``' dtype; ``valid`` as 0 or 1)."""
    both = all_gather_rows(torch.from_numpy(np.stack(
        [labels.astype(np.int64), (valid > 0).astype(np.int64)], axis=1)),
        DATA_AXIS).cpu().numpy()
    return both[:, 0].astype(labels.dtype), both[:, 1]


def extract_features(extract_step, loader, device, cfg=None):
    """Pooled descriptors + targets over a loader (engine_finetune.py:168-213),
    the padded rows of the last batch dropped by ``valid``; each batch's
    features are read after the next batch is launched. A loader sharded
    over the data axis has each batch's rows of every rank gathered in rank
    order (valid rows only), so every rank returns the whole split."""
    feats, targets = [], []
    pending = None
    pin = bool(cfg is not None and cfg.pin_mem)
    gather = _sharded(loader)

    def drain(entry):
        f, labels, valid = entry
        if gather:
            f = all_gather_rows(f, DATA_AXIS)
            labels, valid = gather_labels(labels, valid)
        keep = valid > 0
        feats.append(f.float().cpu().numpy()[keep])
        targets.append(labels[keep])

    for images, labels, valid in iter(loader):
        f = extract_step(to_device(images, device, pin, cfg))
        if pending is not None:
            drain(pending)
        pending = (f, labels, valid)
    if pending is not None:
        drain(pending)
    return np.concatenate(feats), np.concatenate(targets)


def knn_classifier(train_features, train_labels, test_features, test_labels,
                   k: int, T: float, num_classes: int = 1000,
                   num_chunks: int = 500, device=None):
    """Temperature-weighted cosine kNN (engine_finetune.py:216-257)."""
    return knn_classifier_multi(
        train_features, train_labels, test_features, test_labels, [k], T,
        num_classes, num_chunks, device)[k]


def knn_classifier_multi(train_features, train_labels, test_features,
                         test_labels, ks, T: float, num_classes: int = 1000,
                         num_chunks: int = 500, device=None):
    """kNN for several k values from one device pass.

    Returns {} when ks is empty. The device computes the top-max(k) neighbour
    list once, in chunks of test rows ((chunk, N_train) similarities); the
    temperature-weighted vote for each k runs on the host over that list:
    the k-NN vote reads only the first k columns of the max(k)-sorted list.
    ``device`` is where the similarities run (None: the CPU)."""
    if not ks:
        return {}
    device = torch.device(device or "cpu")
    tr_feats = torch.as_tensor(np.asarray(train_features)).to(device)
    tr_labels = torch.as_tensor(np.asarray(train_labels).astype(np.int64)
                                ).to(device)
    test_features = np.asarray(test_features)

    n_test = test_features.shape[0]
    imgs_per_chunk = min(max(256, n_test // num_chunks), n_test)
    k_max = min(max(ks), tr_feats.shape[0])

    dists, neigh = [], []
    with torch.no_grad():
        for s in range(0, n_test, imgs_per_chunk):
            feats = torch.as_tensor(test_features[s:s + imgs_per_chunk]
                                    ).to(device)
            sim = feats @ tr_feats.T  # (chunk, N_train)
            dist, idx = sim.topk(k_max, dim=1)
            dists.append(dist)
            neigh.append(tr_labels[idx])
    dists = torch.cat(dists).cpu().numpy()
    neigh = torch.cat(neigh).cpu().numpy()

    test_labels = np.asarray(test_labels)
    rows = np.arange(n_test)
    results = {}
    # one reused f32 vote buffer across the k sweep
    probs = np.zeros((n_test, num_classes), np.float32)
    for k in ks:
        kk = min(k, k_max)
        weights = np.exp(dists[:, :kk].astype(np.float32) / T)
        probs.fill(0.0)
        np.add.at(probs, (rows[:, None], neigh[:, :kk]), weights)
        pred5 = np.argsort(-probs, axis=1)[:, :5]
        top1 = (pred5[:, 0] == test_labels).sum() * 100.0 / n_test
        top5 = (pred5 == test_labels[:, None]).any(axis=1).sum() \
            * 100.0 / n_test
        results[k] = (top1, top5)
    return results
