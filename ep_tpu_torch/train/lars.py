"""LARS with the reference's semantics, as a ``torch.optim.Optimizer``.

Counterpart of ``ep_tpu/train/lars.py::scaled_lars``. For parameters with
ndim > 1:

    dp = grad + weight_decay * p
    q  = trust_coefficient * ||p|| / ||dp||   (1 where either norm is 0)
    dp = dp * q

parameters with ndim <= 1 get neither weight decay nor trust scaling (the
rule is by rank, not by name). Then heavy-ball momentum, mu = momentum*mu + dp.
:meth:`LARS.raw_updates` returns that raw momentum buffer; :meth:`LARS.step`
applies ``p += -lr(step) * mu`` in float32, the train step's per-iteration
warmup-cosine LR. ``mu_dtype=torch.bfloat16`` (``--mu_bf16``) stores the
carried buffer in bf16: this step's update still uses the f32 momentum, and
only what is kept for the next step is rounded.
"""
from __future__ import annotations

import torch


class LARS(torch.optim.Optimizer):
    def __init__(self, params, weight_decay: float = 0.0, momentum: float = 0.9,
                 trust_coefficient: float = 0.001,
                 mu_dtype: torch.dtype = torch.float32):
        super().__init__(params, dict(weight_decay=weight_decay,
                                      momentum=momentum,
                                      trust_coefficient=trust_coefficient))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def raw_updates(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Advance the momentum buffers; return (param, f32 mu) per updated
        param."""
        out = []
        for group in self.param_groups:
            wd, tc = group["weight_decay"], group["trust_coefficient"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                dp = p.grad.float()
                if p.ndim > 1:
                    p32 = p.float()
                    dp = dp + wd * p32
                    pn = torch.linalg.vector_norm(p32)
                    un = torch.linalg.vector_norm(dp)
                    q = torch.where((pn > 0) & (un > 0), tc * pn / un,
                                    torch.ones_like(pn))
                    dp = dp * q
                state = self.state[p]
                mu = state.get("mu")
                mu = dp if mu is None else group["momentum"] * mu.float() + dp
                state["mu"] = mu.to(self.mu_dtype)
                out.append((p, mu))
        return out

    @torch.no_grad()
    def step(self, lr: float) -> None:  # noqa: D401 - torch's name
        """Apply ``p += -lr * mu`` (float32) with freshly advanced buffers."""
        for p, mu in self.raw_updates():
            p.copy_((p.float() + mu * (-lr)).to(p.dtype))
