"""Tensor-parallel partition rule and the placement of the model's state.

Counterpart of ``ep_tpu/parallel/partition.py``. :func:`spec_for` is the
JAX package's Megatron-style rule (``_spec_for``) over the port's parameter
names: column-parallel qkv and fc1/w12 (their biases with them), row-parallel
proj and fc2/w3. Its answer is the dimension of the port's tensor that the
model axis would split; a flax kernel is (in, out) and an ``nn.Linear``
weight (out, in), so a column split is dimension 0 here and 1 there.

:func:`shard_state` on a data-only mesh replicates rank 0's parameters and
buffers on every rank. The sharded compute a model axis above 1 would need
is not ported (ROADMAP item 9b): no JAX driver calls ``shard_state`` either,
and on such a mesh every rank holds the whole model and computes the same
thing.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch.distributed as dist
import torch.nn as nn

from .mesh import MODEL_AXIS, Mesh, process_count


def spec_for(name: str, shape: Sequence[int], model_size: int) -> Optional[int]:
    """The dimension of the port's tensor ``name`` (of ``shape``) that the
    model axis splits, or None where the tensor is replicated."""

    def div(dim_idx: int) -> bool:
        return len(shape) > dim_idx and shape[dim_idx] % model_size == 0

    if "attn" in name and name.endswith("qkv.weight") and div(0):
        return 0  # column parallel
    if "attn" in name and name.endswith("proj.weight") and div(1):
        return 1  # row parallel (all-reduce after)
    if "mlp" in name and name.endswith(("fc1.weight", "w12.weight")) and div(0):
        return 0
    if "mlp" in name and name.endswith(("fc2.weight", "w3.weight")) and div(1):
        return 1
    if "attn" in name and name.endswith("qkv.bias") and div(0):
        return 0
    if "mlp" in name and name.endswith(("fc1.bias", "w12.bias")) and div(0):
        return 0
    return None


def replicate(model: nn.Module, src: int = 0) -> nn.Module:
    """Broadcast every parameter and buffer of ``model`` from rank ``src``
    to every rank (nothing to do in one process)."""
    if process_count() > 1:
        for t in itertools.chain(model.parameters(), model.buffers()):
            dist.broadcast(t.data, src)
    return model


def shard_state(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Place the model's state on the mesh: replicated on a data-only mesh
    (rank 0's parameters and buffers on every rank). A model axis above 1
    raises: its tensor-parallel placement is ROADMAP item 9b."""
    if mesh.shape[MODEL_AXIS] > 1:
        raise NotImplementedError(
            f"shard_state on a mesh with model axis {mesh.shape[MODEL_AXIS]}: "
            "tensor-parallel compute is not ported (ROADMAP item 9b); on "
            "such a mesh every rank holds the whole model")
    return replicate(model)
