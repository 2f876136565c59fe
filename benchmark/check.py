"""The comparison that decides ``correct``.

A run drives the program's first ``CHECK_STEPS`` training steps in its
set-up, through the window's own call, on batches that all differ, and
reads: each step's loss, each trained leaf's gradient after the first step
(as the optimizer got it), and the norm of each leaf's change after the
last. The configuration's reference (``references/``) follows the same
steps from the same weights and batches, and the gaps are:

- ``loss_gap``: the largest |program - reference| / |reference| over steps;
- ``grad_gap``: over the leaves, the largest |program's norm - reference's
  norm|, over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- ``update_gap``: the same for the norm of the change, leaving out leaves
  whose reference gradient is under a thousandth of the median leaf's
  (``NEGLIGIBLE``): those move under the optimizer by round-off alone;
- ``grad_dist``: over the leaves, the norm of the difference of the first
  gradients over the same denominator as ``grad_gap``. The three gaps above
  take means over the batch and norms, which rounding that is as likely up
  as down moves only a little; this one moves with every element, so that
  computing in the precision below the configuration's fails it.

Each gap has a limit per cell (``limits/<cell>.json``), set from the
readings of sound runs and of the control (``control.py``).
"""
from __future__ import annotations

import math
import statistics

import torch

from .manifest import reference
from .weights import draw_batches, draw_weights

NEGLIGIBLE = 1e-3
CHECK_STEPS = 3  # the steps the reference follows
GAPS = ("loss_gap", "grad_gap", "update_gap", "grad_dist")


def program_readings(prog, images, labels, first_step: int,
                     n: int = CHECK_STEPS) -> dict:
    """Drive ``prog.step`` through ``n`` steps on pool batches 0..n-1 and
    read the losses, the first step's gradients and the change."""
    start = {k: p.detach().clone() for k, p in prog.trained.items()}
    losses = []
    for j in range(n):
        m = prog.step(first_step + j, images[j], labels[j])
        losses.append(m["loss"])
        if j == 0:  # on the host, out of the window's memory
            grads = {prog.leaf[k]: p.grad.detach().float().cpu()
                     for k, p in prog.trained.items() if p.grad is not None}
    change = prog.leaf_norms({k: p.detach() - start[k]
                              for k, p in prog.trained.items()})
    return dict(losses=torch.stack(losses).tolist(), grads=grads, change=change)


def reference_readings(cfg: dict, traffic: dict, seed: int, device,
                       precision: str = "f32") -> dict:
    """The reference's readings of the same steps, from the seed."""
    ft = traffic["step"] == "finetune"
    W = draw_weights(cfg, traffic["image_size"], seed, device,
                     frozen_encoder=not ft)
    images, labels = draw_batches(cfg, traffic, seed, device)
    n = CHECK_STEPS
    images, labels = images[:n].clone(), labels[:n].clone()
    mod = reference(cfg)
    ref = mod.Reference(W, mod.dims(cfg, traffic["image_size"]),
                        cfg["optimizer"], ft, precision)
    del W
    first = cfg["optimizer"]["schedule"]["start_step"]
    losses = []
    for j in range(n):
        losses.append(ref.step(first + j, images[j], labels[j]))
        if j == 0:
            grads = ref.grads()
    return dict(losses=losses, grads=grads, change=ref.change_norms())


def worst(values: dict) -> tuple[float, str]:
    """(the largest value, its key); NaN where any value is NaN."""
    top, key = 0.0, ""
    for k, v in values.items():
        if math.isnan(v):
            return v, k
        if v >= top:
            top, key = v, k
    return top, key


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t)) for k, t in tensors.items()}


def gaps(prog: dict, ref: dict) -> dict:
    """The gaps of a run's readings against the reference's, with the leaf
    that set each, and the leaves left out of the change. A leaf the
    program lacks counts as zero."""
    ref_norms = norms(ref["grads"])
    med = statistics.median(ref_norms.values())
    den = {k: max(r, med, 1e-30) for k, r in ref_norms.items()}
    skip = {k for k, g in ref_norms.items() if g < NEGLIGIBLE * med}
    loss = [abs(p - r) / max(abs(r), 1e-30)
            for p, r in zip(prog["losses"], ref["losses"])]
    loss = math.nan if any(map(math.isnan, loss)) else max(loss)
    prog_norms = norms(prog["grads"])
    grad, grad_leaf = worst({k: abs(prog_norms.get(k, 0.0) - r) / den[k]
                             for k, r in ref_norms.items()})
    cmed = statistics.median(ref["change"].values())
    upd, upd_leaf = worst({k: abs(prog["change"].get(k, 0.0) - r)
                           / max(r, cmed, 1e-30)
                           for k, r in ref["change"].items() if k not in skip})
    zero = torch.zeros(())
    dist, dist_leaf = worst({
        k: float(torch.linalg.vector_norm(prog["grads"].get(k, zero) - g))
        / den[k] for k, g in ref["grads"].items()})
    return dict(loss_gap=loss, grad_gap=grad, update_gap=upd, grad_dist=dist,
                worst_grad_leaf=grad_leaf, worst_update_leaf=upd_leaf,
                worst_dist_leaf=dist_leaf, skipped_leaves=sorted(skip))


def judge(g: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, name -> {value, limit}); a gap whose limit is null is
    reported and not judged. A gap that is not finite fails."""
    checks, ok = {}, True
    for name in GAPS:
        v, lim = g[name], limits.get(name)
        checks[name] = {"value": v, "limit": lim}
        if lim is not None and not v <= lim:
            ok = False
    return ok, checks
