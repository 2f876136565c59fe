"""LARS over every trained leaf in two kernel launches.

No TPU kernel: the JAX package leaves optax's LARS to XLA, which fuses it.
The plain PyTorch loop (``train/lars.py::LARS._update``, leaf after leaf) is
some 15 small kernels a leaf, each done on the card before the host has
launched the next. On CUDA leaves :func:`lars_update` runs the whole update
in the two passes of ``csrc/lars.cu``: ``lars_norms`` (each chunk's partial
sums of p^2 and (g + wd*p)^2) and ``lars_apply`` (each leaf's trust ratio
from its partials, the momentum and ``p += -lr * mu``). CPU leaves keep the
plain loop, which is also what the kernels are held to on the card.

Every leaf is cut into chunks of ``CHUNK`` elements, leaf after leaf
(:func:`chunk_table`); the table and each leaf's constants (size, rank,
hyperparameters) go to the card once per parameter list (:class:`LarsPlan`).
The pointers change every step (``zero_grad(set_to_none=True)``), so each
step sends one row of five int64 a leaf (p, g, mu read, mu written, the
dtypes) from a fresh pinned tensor, without a synchronisation.
"""
from __future__ import annotations

import numpy as np
import torch

from . import LAUNCHES
from ._build import call, stream_ptr

CHUNK = 16384  # elements a block of either pass; a multiple of 4
# csrc/lars.cu::LarsLeaf
LEAF_DTYPE = np.dtype([("numel", "<i8"), ("first_chunk", "<i4"),
                       ("n_chunks", "<i4"), ("scaled", "<i4"),
                       ("weight_decay", "<f4"), ("trust", "<f4"),
                       ("momentum", "<f4")])
CODES = {torch.float32: 0, torch.bfloat16: 1}


def chunk_table(numels, chunk: int = CHUNK):
    """(leaf of each chunk, first chunk of each leaf, chunks of each leaf):
    leaf after leaf, each cut into ceil(numel / chunk) chunks (none for an
    empty leaf); chunk c of its leaf l covers elements
    [(c - first[l]) * chunk, min((c - first[l] + 1) * chunk, numel))."""
    leaf_of, first, count = [], [], []
    for leaf, n in enumerate(numels):
        k = -(-int(n) // chunk)
        first.append(len(leaf_of))
        count.append(k)
        leaf_of += [leaf] * k
    return leaf_of, first, count


class LarsPlan:
    """The tables of one parameter list on its card: the leaf of each chunk
    (int32, one a chunk) and each leaf's ``LEAF_DTYPE`` row, built once;
    ``key`` says which lists and hyperparameters they fit."""

    def __init__(self, params, hypers):
        self.key = plan_key(params, hypers)
        numels = [p.numel() for p in params]
        leaf_of, first, count = chunk_table(numels)
        rows = np.zeros(len(params), LEAF_DTYPE)
        rows["numel"], rows["first_chunk"], rows["n_chunks"] = (
            numels, first, count)
        rows["scaled"] = [p.ndim > 1 for p in params]
        for k, name in enumerate(("weight_decay", "trust", "momentum")):
            rows[name] = [h[k] for h in hypers]
        self.n_chunks = len(leaf_of)
        dev = params[0].device
        self.leaves = _to_card(torch.from_numpy(rows.view(np.uint8)), dev)
        self.chunk_leaf = _to_card(torch.tensor(leaf_of, dtype=torch.int32),
                                   dev)


def plan_key(params, hypers) -> tuple:
    return (tuple((p.numel(), p.ndim > 1) for p in params), tuple(hypers),
            params[0].device)


def _to_card(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on the card through a pinned copy, without a synchronisation:
    the pinned block is not reused before the copy has run."""
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _code(dtype: torch.dtype, name: str) -> int:
    if dtype not in CODES:
        raise TypeError(f"lars: {name} is {dtype}; the kernels take float32 "
                        "and bfloat16")
    return CODES[dtype]


def _dense(t: torch.Tensor, p: torch.Tensor, name: str) -> torch.Tensor:
    if t.shape != p.shape:
        raise ValueError(f"lars: {name} of {tuple(t.shape)} for a parameter "
                         f"of {tuple(p.shape)}")
    return t.contiguous()


def pointer_rows(params, grads, mus, mu_dtype: torch.dtype):
    """The per-step table, five int64 a leaf (``csrc/lars.cu::LarsPtrs``: p,
    g or 0, the momentum read or 0, the momentum written, and the dtypes
    p | g << 2 | mu read << 4 | mu written << 6, 0 for float32 and 1 for
    bfloat16); the momentum each leaf's step writes: the tensor of ``mus``
    where it has ``mu_dtype``, else a new one; and the tensors the rows
    point to, to be held until the kernels are launched (a contiguous copy
    freed before would go back to the allocator)."""
    mo_code = _code(mu_dtype, "mu_dtype")
    rows, mus_out, held = [], [], []
    for p, g, mu in zip(params, grads, mus):
        if not p.is_contiguous():
            raise ValueError("lars: the kernels need contiguous parameters")
        code = _code(p.dtype, "a parameter")
        gp = mp = 0
        if g is not None:
            g = _dense(g, p, "a gradient")
            gp, code = g.data_ptr(), code | _code(g.dtype, "a gradient") << 2
        if mu is not None:
            mu = _dense(mu, p, "a momentum")
            mp, code = mu.data_ptr(), code | _code(mu.dtype, "a momentum") << 4
        out = mu if mu is not None and mu.dtype == mu_dtype else torch.empty(
            p.shape, dtype=mu_dtype, device=p.device)
        mus_out.append(out)
        held += [g, mu]
        rows += [p.data_ptr(), gp, mp, out.data_ptr(), code | mo_code << 6]
    return rows, mus_out, held


def lars_update(params, grads, mus, hypers, mu_dtype: torch.dtype,
                lr: float, plan: LarsPlan | None = None):
    """One LARS step over CUDA leaves ``params``, in place: ``grads`` (None
    reads as zeros), the carried momentum ``mus`` (None reads as zeros, as
    optax's first step starts from zeros), ``hypers`` (weight decay, trust
    coefficient, momentum) a leaf, ``p += -lr * mu``. Returns each leaf's
    momentum after the step, in ``mu_dtype``, and the plan of the list
    (``plan`` where it fits)."""
    rows, mus_out, held = pointer_rows(params, grads, mus, mu_dtype)
    if plan is None or plan.key != plan_key(params, hypers):
        plan = LarsPlan(params, hypers)
    if plan.n_chunks:
        dev = params[0].device
        ptrs = _to_card(torch.tensor(rows, dtype=torch.int64, pin_memory=True),
                        dev)
        partials = torch.empty((plan.n_chunks, 2), dtype=torch.float32,
                               device=dev)
        tables = (plan.leaves.data_ptr(), ptrs.data_ptr(),
                  plan.chunk_leaf.data_ptr(), partials.data_ptr(),
                  plan.n_chunks, CHUNK)
        stream = stream_ptr(params[0])
        call("ep_lars_norms", *tables, stream)
        LAUNCHES["lars_norms"] += 1
        call("ep_lars_apply", *tables, -lr, stream)
        LAUNCHES["lars_apply"] += 1
        torch.autograd.graph.increment_version(list(params) + mus_out)
    del held
    return mus_out, plan
