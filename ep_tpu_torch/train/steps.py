"""Train and eval steps.

Counterpart of ``ep_tpu/train/steps.py``: the model's forward (a frozen
backbone is never differentiated; under ``--finetuning`` it trains with the
head), the backward, the LARS update with the per-iteration warmup-cosine LR,
and the same metrics. PyTorch runs
eagerly, so a step is a plain function over the module; metrics stay on the
device until the caller reads them.

With ``device_aug`` (``data/device_aug.py::DeviceAug``) the images arrive as
u8 staged batches: the train step crops, flips and normalizes them on their
device, its draws seeded by the global step; the eval and extract steps
normalize them.

Over several ranks (a registered mesh with a data axis above 1,
``parallel/mesh.py``) each rank's batch is its rows of the global batch, as
GSPMD shards the JAX step's: the BatchNorms of the head normalise with the
global batch's moments (``poolings/batchnorm.py``), the gradients are
averaged over the data axis in one all-reduce before the optimizer, and the
loss and top-k accuracies are averaged with them, so the step's metrics
are the global batch's, as the JAX step's are. The gradient is reduced at
every micro-step, also under ``accum_iter``: the step reports the global
gradient's norm at each, as the JAX step does. No ``DistributedDataParallel``
wraps the module: a frozen backbone has no gradient to reduce, and a
parameter that gets none (``return_attn``, a head's unused parameter) is
updated by the optimizer as optax updates it, from a zero gradient on every
rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch
import torch.nn as nn

from ep_tpu_torch.parallel.mesh import DATA_AXIS, current_mesh
from ep_tpu_torch.parallel.metrics import pmean
from ep_tpu_torch.runtime.profiler import span
from .lars import RawUpdateOptimizer


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None].long())[:, 0]


def topk_correct(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """float (B,) indicator that the label is within the top-k logits."""
    idx = logits.topk(min(k, logits.shape[-1]), dim=-1).indices
    return (idx == labels[:, None]).any(dim=1).float()


def global_grad_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """The norm of all the gradients laid end to end, in float32: a few
    multi-tensor launches on the card, whatever the number of leaves."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(grads), dtype=torch.float32)))


def pmean_grads(params, mesh) -> None:
    """Replace each parameter's gradient by its mean over the mesh's data
    axis, in one all-reduce of the gradients laid end to end. Every rank
    holds gradients for the same parameters (the same module and the same
    step), so the flat buffers line up."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = pmean(torch.cat([g.reshape(-1) for g in grads]), DATA_AXIS, mesh)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_train_step(model: nn.Module, optimizer: RawUpdateOptimizer,
                    lr_fn: Callable[[int], float], device_aug=None):
    """Returns train_step(step, images, labels) -> metrics.

    ``step`` is the global iteration index that drives the LR schedule: it
    counts micro-steps, as the JAX state's step does, and the caller carries
    it across a resume. The batch-norm running statistics and the optimizer's
    state advance in place; under ``accum_iter`` k the optimizer applies the
    mean of k micro-steps' gradients at the k-th, with that micro-step's
    LR (``optax.MultiSteps`` inside the JAX step). ``device_aug`` augments
    u8 images, keyed by ``step``, so a resumed run draws the same crops.
    The mesh registered when the step is made sets the ranks it reduces
    over. Under a profiler the step opens ``ep::step`` and, inside it in
    this order, ``ep::forward``, ``ep::loss``, ``ep::backward``,
    ``ep::grad_reduce`` (where a mesh reduces), ``ep::metrics`` for the
    gradient's norm, ``ep::optimizer`` and ``ep::metrics`` for the scores
    (``runtime/profiler.py::span``)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    mesh = current_mesh()
    reduce = mesh is not None and mesh.shape[DATA_AXIS] > 1

    def train_step(step: int, images: torch.Tensor,
                   labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        with span("ep::step"):
            model.train()
            with span("ep::forward"):
                if device_aug is not None:
                    images = device_aug.train_fn(step, images)
                logits = model(images)
            with span("ep::loss"):
                loss = cross_entropy(logits, labels).mean()
            with span("ep::backward"):
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
            if reduce:
                with span("ep::grad_reduce"):
                    pmean_grads(params, mesh)
            lr = lr_fn(step)
            with span("ep::metrics"):
                grad_norm = global_grad_norm(p.grad for p in params
                                             if p.grad is not None)
            with span("ep::optimizer"):
                optimizer.step(lr)
            with span("ep::metrics"):
                logits = logits.detach()
                scores = {"loss": loss.detach(),
                          "acc1": topk_correct(logits, labels, 1).mean() * 100.0,
                          "acc5": topk_correct(logits, labels, 5).mean() * 100.0}
                if reduce:
                    scores = dict(zip(scores, pmean(
                        torch.stack(list(scores.values())), DATA_AXIS, mesh)))
            return {**scores, "lr": torch.tensor(lr), "grad_norm": grad_norm}

    return train_step


def make_eval_step(model: nn.Module, device_aug=None):
    """eval_step(images, labels, valid) -> (summed metrics, predictions).

    ``valid`` masks padding rows of a padded final batch; sums are weighted
    so the caller can divide by the true sample count."""

    @torch.no_grad()
    def eval_step(images, labels, valid):
        model.eval()
        if device_aug is not None:
            images = device_aug.eval_fn(images)
        logits = model(images)
        valid = valid.float()
        loss = cross_entropy(logits, labels)
        c1 = topk_correct(logits, labels, 1)
        c5 = topk_correct(logits, labels, 5)
        return {
            "loss_sum": (loss * valid).sum(),
            "acc1_sum": (c1 * valid).sum() * 100.0,
            "acc5_sum": (c5 * valid).sum() * 100.0,
            "count": valid.sum(),
        }, logits.argmax(dim=-1)

    return eval_step


def make_extract_step(model: nn.Module, device_aug=None):
    """extract_step(images) -> the backbone's pooled descriptors, in eval
    mode and without autograd (``ep_tpu/train/steps.py::make_extract_step``,
    the features kNN evaluation reads)."""

    @torch.no_grad()
    def extract_step(images):
        model.eval()
        if device_aug is not None:
            images = device_aug.eval_fn(images)
        return model(images, return_backbone_features=True)[1]

    return extract_step
