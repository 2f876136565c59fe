"""BatchNorm over the feature axis with torch's own running-statistics rule.

Counterpart of ``ep_tpu/poolings/batchnorm.py::TorchBatchNorm``, which exists
to reproduce exactly this rule in flax: normalise with the biased batch
variance, fold the Bessel-corrected variance into the running average. Here
it is ``nn.BatchNorm1d`` itself, fed f32 and cast back to the compute dtype.
As there, the features are the last axis and the statistics reduce over all
the others, at any rank: the input is flattened to (-1, C) around
``BatchNorm1d``, so the Bessel count is the product of the reduced axes.

``momentum`` keeps the JAX package's (flax) convention, the weight of the old
running value: flax's 0.9 is torch's 0.1.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class TorchBatchNorm(nn.BatchNorm1d):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, affine: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=epsilon, momentum=1.0 - momentum,
                         affine=affine)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x.float().reshape(-1, x.shape[-1]))
        return y.reshape(x.shape).to(self.compute_dtype or x.dtype)
