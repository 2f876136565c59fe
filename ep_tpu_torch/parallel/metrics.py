"""Reductions over a mesh axis.

Counterpart of ``ep_tpu/parallel/metrics.py``. Under GSPMD a mean over the
sharded batch is already global; here each rank holds its own rows, so what
must be global is reduced explicitly over the ranks of a mesh axis
(``parallel/mesh.py``):

  * :func:`psum` / :func:`pmean` — ``all_reduce`` over the axis's group,
    differentiable (the backward sums the gradients over the same group, as
    SyncBatchNorm's does): BatchNorm's moments, the train step's gradients
    and metrics;
  * :func:`all_gather_rows` — every rank's rows in rank order (the cached
    extraction, kNN features); gloo has no ``all_gather`` of CUDA tensors, so
    under gloo the rows go through the host;
  * :func:`all_reduce_mean_host` — the mean of a host scalar over every
    process.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, current_mesh, process_count


def _axis(axis_name: str, mesh: Optional[Mesh]):
    """(the axis's size, its group) on ``mesh`` (default: the registered
    one); size 1 without a mesh in a single process."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        if process_count() > 1:
            raise RuntimeError(f"a reduction over {axis_name!r} with "
                               f"{process_count()} processes needs a "
                               "registered mesh (set_current_mesh)")
        return 1, None
    return mesh.shape[axis_name], mesh.group(axis_name)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def psum(x: torch.Tensor, axis_name: str = "data",
         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of the axis (``x`` itself at size 1)."""
    n, group = _axis(axis_name, mesh)
    return x if n == 1 else _AllReduceSum.apply(x, group)


def pmean(x: torch.Tensor, axis_name: str = "data",
          mesh: Optional[Mesh] = None) -> torch.Tensor:
    n, _ = _axis(axis_name, mesh)
    return x if n == 1 else psum(x, axis_name, mesh) / n


def all_gather_rows(x: torch.Tensor, axis_name: str = "data",
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order (``x``
    itself at size 1). Every rank passes the same shape. The rows travel
    where the backend takes them, and the result stays there: on the CPU
    under gloo, on this process's card under NCCL."""
    n, group = _axis(axis_name, mesh)
    if n == 1:
        return x
    if dist.get_backend(group) == "gloo":
        x = x.cpu()
    else:
        x = x.to(torch.device("cuda", torch.cuda.current_device()))
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: this
    process's card under NCCL, the CPU otherwise."""
    if process_count() > 1 and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_mean_host(x: float) -> float:
    """Mean of a host scalar across processes (util/misc.py:363-371)."""
    if process_count() == 1:
        return float(x)
    t = torch.tensor([float(x)], dtype=torch.float64,
                     device=collective_device())
    dist.all_reduce(t)
    return float(t.item()) / process_count()


def weighted_merge(stats_list: Dict[str, float]) -> Dict[str, float]:
    """Merge {metric: (sum, count)} dicts into global averages."""
    out = {}
    for k, (s, c) in stats_list.items():
        out[k] = s / max(c, 1)
    return out
