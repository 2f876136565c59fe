"""LARS, AdamW and SGD with the JAX package's semantics, as
``torch.optim.Optimizer``s that emit a raw update.

Counterpart of ``ep_tpu/train/lars.py``. Each optimizer's
:meth:`~RawUpdateOptimizer.raw_updates` returns the update before the
learning rate, and :meth:`~RawUpdateOptimizer.step` applies
``p += -lr(step) * u`` in float32: the train step's per-iteration
warmup-cosine LR. A parameter without a gradient is updated with a zero
gradient, as optax updates every leaf of the trainable tree: its momentum
decays, and weight decay (through the trust ratio for LARS) still applies.

LARS (``scaled_lars``): for parameters with ndim > 1,

    dp = grad + weight_decay * p
    q  = trust_coefficient * ||p|| / ||dp||   (1 where either norm is 0)
    dp = dp * q

parameters with ndim <= 1 get neither weight decay nor trust scaling (the
rule is by rank, not by name). Then heavy-ball momentum, mu = momentum*mu + dp.
On CUDA parameters LARS's :meth:`~RawUpdateOptimizer.step` is two kernel
launches over every leaf (``ops/lars.py``); on the CPU it is the loop below,
which :meth:`~RawUpdateOptimizer.raw_updates` keeps on either device as the
reference.

AdamW: ``optax.scale_by_adam(0.9, 0.999, 1e-8, mu_dtype)`` followed by
``optax.add_decayed_weights(weight_decay)`` on every parameter. SGD: the
gradient plus the decay, no momentum (``torch.optim.SGD`` at the reference's
graft site).

``mu_dtype=torch.bfloat16`` (``--mu_bf16``) stores the carried first moment
in bf16: this step's update still uses the f32 value, and only what is kept
for the next step is rounded.

``accum_iter=k`` (``--accum_iter``) is ``optax.MultiSteps``: each call of
:meth:`~RawUpdateOptimizer.step` folds this micro-step's gradients into a
running mean, and every k-th applies the update of that mean and resets it;
the calls in between leave the parameters and the optimizer's state as they
are. The count of micro-steps is kept in the optimizer's state, so it
survives a checkpoint.
"""
from __future__ import annotations

import torch

from ep_tpu_torch.ops import use_kernel
from ep_tpu_torch.ops.lars import lars_update


class RawUpdateOptimizer(torch.optim.Optimizer):
    """The shared loop: a zero gradient where there is none, the running mean
    of ``accum_iter`` micro-steps, and ``p += -lr * u``. A subclass computes
    ``u`` in :meth:`_update`."""

    def __init__(self, params, defaults: dict, mu_dtype: torch.dtype,
                 accum_iter: int):
        super().__init__(params, {**defaults, "mini_step": 0, "count": 0})
        self.mu_dtype = mu_dtype
        self.accum_iter = max(1, int(accum_iter))

    def _update(self, p, g, group, state) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def raw_updates(self, grads=None) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Advance the optimizer's state with ``grads`` (default: each
        parameter's ``.grad``, zeros where it has none); return
        (param, f32 update before the LR) for every parameter."""
        out = []
        for gi, group in enumerate(self.param_groups):
            group["count"] += 1
            for pi, p in enumerate(group["params"]):
                g = grads[gi][pi] if grads is not None else p.grad
                # a copy: the state kept from it must not alias the gradient
                g = torch.zeros_like(p, dtype=torch.float32) if g is None \
                    else g.to(torch.float32, copy=True)
                out.append((p, self._update(p, g, group, self.state[p])))
        return out

    @torch.no_grad()
    def step(self, lr: float) -> None:  # noqa: D401 - torch's name
        """Apply ``p += -lr * u`` (float32), or under ``accum_iter`` fold the
        gradients into their running mean and apply only at its k-th
        micro-step."""
        if self.accum_iter == 1:
            self._apply_updates(lr)
        else:
            n = self.param_groups[0]["mini_step"]
            means = []
            for group in self.param_groups:
                row = []
                for p in group["params"]:
                    st = self.state[p]
                    g = p.grad.float() if p.grad is not None else \
                        torch.zeros_like(p, dtype=torch.float32)
                    acc = st.get("acc_grad")
                    acc = g.clone() if acc is None else acc + (g - acc) / (n + 1)
                    st["acc_grad"] = acc
                    row.append(acc)
                means.append(row)
            if n + 1 < self.accum_iter:
                for group in self.param_groups:
                    group["mini_step"] = n + 1
                return
            self._apply_updates(lr, means)
            for group in self.param_groups:
                group["mini_step"] = 0
                for p in group["params"]:
                    self.state[p]["acc_grad"].zero_()

    def _apply_updates(self, lr: float, grads=None) -> None:
        """``p += -lr * u`` for every parameter, ``u`` from
        :meth:`raw_updates` of ``grads``."""
        for p, u in self.raw_updates(grads):
            p.copy_((p.float() + u * (-lr)).to(p.dtype))


class LARS(RawUpdateOptimizer):
    """On CUDA parameters :meth:`step` runs the whole update in the two
    kernels of ``ops/lars.py`` (the same arithmetic, each leaf's norms summed
    in another order); on CPU parameters the plain loop of :meth:`_update`."""

    _plan = None  # ops/lars.py::LarsPlan of the parameter list

    def __init__(self, params, weight_decay: float = 0.0, momentum: float = 0.9,
                 trust_coefficient: float = 0.001,
                 mu_dtype: torch.dtype = torch.float32, accum_iter: int = 1):
        super().__init__(params, dict(weight_decay=weight_decay,
                                      momentum=momentum,
                                      trust_coefficient=trust_coefficient),
                         mu_dtype, accum_iter)

    def _apply_updates(self, lr: float, grads=None) -> None:
        params = [p for group in self.param_groups for p in group["params"]]
        if not params or not use_kernel(*params):
            return super()._apply_updates(lr, grads)
        if grads is None:
            grads = [[p.grad for p in group["params"]]
                     for group in self.param_groups]
        hypers = []
        for group in self.param_groups:
            group["count"] += 1
            hypers += [(group["weight_decay"], group["trust_coefficient"],
                        group["momentum"])] * len(group["params"])
        mus, self._plan = lars_update(
            params, [g for row in grads for g in row],
            [self.state[p].get("mu") for p in params], hypers, self.mu_dtype,
            lr, self._plan)
        for p, mu in zip(params, mus):
            self.state[p]["mu"] = mu

    def _update(self, p, dp, group, state):
        wd, tc = group["weight_decay"], group["trust_coefficient"]
        if p.ndim > 1:
            p32 = p.float()
            dp = dp + wd * p32
            pn = torch.linalg.vector_norm(p32)
            un = torch.linalg.vector_norm(dp)
            q = torch.where((pn > 0) & (un > 0), tc * pn / un,
                            torch.ones_like(pn))
            dp = dp * q
        mu = state.get("mu")
        mu = dp if mu is None else group["momentum"] * mu.float() + dp
        state["mu"] = mu.to(self.mu_dtype)
        return mu


class AdamW(RawUpdateOptimizer):
    """``scale_by_adam`` then ``add_decayed_weights``; the bias corrections
    use the step count in float32, as optax does."""

    def __init__(self, params, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: torch.dtype = torch.float32, accum_iter: int = 1):
        super().__init__(params, dict(weight_decay=weight_decay, b1=b1, b2=b2,
                                      eps=eps), mu_dtype, accum_iter)

    def _update(self, p, g, group, state):
        b1, b2 = group["b1"], group["b2"]
        mu = state.get("mu")
        nu = state.get("nu")
        # b1 * mu in mu's storage dtype, b1 rounded to it: optax multiplies a
        # bf16 moment by a weakly typed Python float in bf16
        mu = (1 - b1) * g if mu is None else (
            (1 - b1) * g + (torch.tensor(b1, dtype=mu.dtype) * mu).float())
        nu = (1 - b2) * (g * g) if nu is None else (1 - b2) * (g * g) + b2 * nu
        count = torch.tensor(float(group["count"]), dtype=torch.float32)
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
        u = (mu / c1.to(mu.device)) / (torch.sqrt(nu / c2.to(nu.device))
                                       + group["eps"])
        state["mu"] = mu.to(self.mu_dtype)
        state["nu"] = nu
        return u + group["weight_decay"] * p.float()


class SGD(RawUpdateOptimizer):
    def __init__(self, params, weight_decay: float = 0.0,
                 mu_dtype: torch.dtype = torch.float32, accum_iter: int = 1):
        super().__init__(params, dict(weight_decay=weight_decay), mu_dtype,
                         accum_iter)

    def _update(self, p, g, group, state):
        return g + group["weight_decay"] * p.float()


def build_optimizer(name: str, params, weight_decay: float,
                    mu_dtype: torch.dtype = torch.float32,
                    accum_iter: int = 1) -> RawUpdateOptimizer:
    """lars | adamw | sgd over ``params``, each emitting a raw update to be
    scaled by -lr(step) (``ep_tpu/train/lars.py::build_optimizer``, with
    ``optax.MultiSteps`` for ``accum_iter`` > 1 as ``cli/linprobe.py`` wraps
    it). ``mu_dtype``: storage dtype of the momentum / first moment."""
    kw = dict(weight_decay=weight_decay, mu_dtype=mu_dtype,
              accum_iter=accum_iter)
    if name == "lars":
        return LARS(params, **kw)
    if name == "adamw":
        return AdamW(params, **kw)
    if name == "sgd":
        return SGD(params, **kw)
    raise ValueError(name)
