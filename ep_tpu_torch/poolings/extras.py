"""Classical poolings that no ``--cls_features`` name reaches, kept for API
completeness as in the JAX package.

Counterpart of ``ep_tpu/poolings/extras.py``: log-sum-exp pooling with a
learned temperature, generalized-mean pooling with a learned exponent (both
0-d parameters, as there), generalized max pooling (a ridge-regularised
solve) and slot-attention pooling (a residual update in place of the GRU cell,
the max over the slots). Each takes (B, N, C) tokens.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Dense, LayerNorm, normal_


class LSEPool(nn.Module):
    """Log-sum-exp pooling with a learned temperature r."""

    def __init__(self, r_init: float = 10.0):
        super().__init__()
        self.r_init = r_init
        self.r = nn.Parameter(torch.tensor(r_init))

    def init_weights(self, generator: torch.Generator = None) -> None:
        with torch.no_grad():
            self.r.fill_(self.r_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xr = x.float() * self.r
        return (torch.logsumexp(xr, dim=1) - math.log(x.shape[1])) / self.r


class GeMPool(nn.Module):
    """Generalized-mean pooling with a learned exponent p."""

    def __init__(self, p_init: float = 3.0, eps: float = 1e-6):
        super().__init__()
        self.p_init, self.eps = p_init, eps
        self.p = nn.Parameter(torch.tensor(p_init))

    def init_weights(self, generator: torch.Generator = None) -> None:
        with torch.no_grad():
            self.p.fill_(self.p_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.float().clamp(min=self.eps)
        return (xc ** self.p).mean(dim=1) ** (1.0 / self.p)


class GeneralizedMaxPool(nn.Module):
    """Generalized max pooling: the weights that equalise each token's dot
    product with the pooled vector (ridge-regularised)."""

    def __init__(self, lam: float = 1e2):
        super().__init__()
        self.lam = lam

    def init_weights(self, generator: torch.Generator = None) -> None:
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        xf = x.float()
        A = torch.einsum("bnc,bmc->bnm", xf, xf) + self.lam * torch.eye(
            N, device=x.device)
        alpha = torch.linalg.solve(A, torch.ones(B, N, 1, device=x.device))
        return torch.einsum("bn,bnc->bc", alpha[..., 0], xf)


class SlotPooling(nn.Module):
    """Slot-attention pooling: ``iters`` slot updates (a residual update in
    place of the GRU cell, then a residual MLP), the max over the slots."""

    def __init__(self, dim: int, num_slots: int = 4, iters: int = 3,
                 eps: float = 1e-8, hidden_dim: int = 128,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        D, hidden = dim, max(dim, hidden_dim)
        self.num_slots, self.iters, self.eps = num_slots, iters, eps
        self.dtype = dtype
        self.slots_mu = nn.Parameter(torch.zeros(1, 1, D))
        self.norm_input = LayerNorm(D, 1e-6, dtype)
        self.to_k = Dense(D, D, dtype=dtype, fan_in=D)
        self.to_v = Dense(D, D, dtype=dtype, fan_in=D)
        self.norm_slots = LayerNorm(D, 1e-6, dtype)
        self.norm_pre_ff = LayerNorm(D, 1e-6, dtype)
        self.to_q = Dense(D, D, dtype=dtype, fan_in=D)
        self.mlp_fc1 = Dense(D, hidden, dtype=dtype, fan_in=D)
        self.mlp_fc2 = Dense(hidden, D, dtype=dtype, fan_in=hidden)
        self.update = Dense(2 * D, D, dtype=dtype, fan_in=2 * D)

    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.slots_mu, 1.0, generator)
        for m in (self.norm_input, self.to_k, self.to_v, self.norm_slots,
                  self.norm_pre_ff, self.to_q, self.mlp_fc1, self.mlp_fc2,
                  self.update):
            m.init_weights(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        slots = self.slots_mu.to(x.dtype).expand(B, self.num_slots, D)
        xin = self.norm_input(x)
        k, v = self.to_k(xin), self.to_v(xin)
        for _ in range(self.iters):
            q = self.to_q(self.norm_slots(slots))
            dots = torch.einsum("bid,bjd->bij", q.float(), k.float()) * D ** -0.5
            attn = torch.softmax(dots, dim=1) + self.eps
            attn = attn / attn.sum(dim=-1, keepdim=True)
            updates = torch.einsum("bjd,bij->bid", v.float(),
                                   attn.to(v.dtype).float()).to(v.dtype)
            slots = slots + self.update(torch.cat([slots, updates], dim=-1))
            h = self.mlp_fc2(F.relu(self.mlp_fc1(self.norm_pre_ff(slots))))
            slots = slots + h
        return slots.amax(dim=1)
