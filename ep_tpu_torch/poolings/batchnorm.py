"""BatchNorm over the feature axis with torch's own running-statistics rule.

Counterpart of ``ep_tpu/poolings/batchnorm.py::TorchBatchNorm``, which exists
to reproduce exactly this rule in flax: normalise with the biased batch
variance, fold the Bessel-corrected variance into the running average. Here
it is ``nn.BatchNorm1d`` itself, fed f32 and cast back to the compute dtype.
As there, the features are the last axis and the statistics reduce over all
the others, at any rank: the input is flattened to (-1, C) around
``BatchNorm1d``, so the Bessel count is the product of the reduced axes.

In training, when the registered mesh (``parallel/mesh.py``) has more than
one rank on its data axis, the statistics are those of the global batch, as
GSPMD computes them over the JAX package's sharded batch: the per-rank sums
are all-reduced in f32 (the mean first, then the squared deviations from
it), the biased variance normalises, and the Bessel-corrected variance over
the global count goes into the running average. The reduction is
differentiable (``parallel/metrics.py::psum``). ``SyncBatchNorm`` does not
fit: it normalises dimension 1 of a (N, C, ...) input, this class the last
axis. At one rank, and in eval mode, nothing changes.

``momentum`` keeps the JAX package's (flax) convention, the weight of the old
running value: flax's 0.9 is torch's 0.1.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ep_tpu_torch.parallel.mesh import DATA_AXIS, current_mesh
from ep_tpu_torch.parallel.metrics import psum


class TorchBatchNorm(nn.BatchNorm1d):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, affine: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=epsilon, momentum=1.0 - momentum,
                         affine=affine)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.float().reshape(-1, x.shape[-1])
        mesh = current_mesh()
        if self.training and mesh is not None and mesh.shape[DATA_AXIS] > 1:
            y = self._global_batch(x2, mesh)
        else:
            y = super().forward(x2)
        return y.reshape(x.shape).to(self.compute_dtype or x.dtype)

    def _global_batch(self, x2: torch.Tensor, mesh) -> torch.Tensor:
        C = x2.shape[1]
        sums = psum(torch.cat([x2.sum(0), x2.new_full((1,), x2.shape[0])]),
                    DATA_AXIS, mesh)
        n = sums[C]
        mean = sums[:C] / n
        d = x2 - mean
        var = psum(d.square().sum(0), DATA_AXIS, mesh) / n
        y = d * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.weight + self.bias
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(
                var.detach() * (n / (n - 1.0)), alpha=m)
            self.num_batches_tracked.add_(1)
        return y
