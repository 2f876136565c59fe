"""Tensor-parallel partition rule and the placement of the model's state.

Counterpart of ``ep_tpu/parallel/partition.py``. :func:`spec_for` is the
JAX package's Megatron-style rule (``_spec_for``) over the port's parameter
names: column-parallel qkv and fc1/w12 (their biases with them), row-parallel
proj and fc2/w3. Its answer is the dimension of the port's tensor that the
model axis would split; a flax kernel is (in, out) and an ``nn.Linear``
weight (out, in), so a column split is dimension 0 here and 1 there.

:func:`shard_state` replicates rank 0's parameters and buffers on every rank
and, on a mesh whose model axis M is above 1, cuts every frozen ViT block
(the backbone's, MAE's encoder's, the ``dino`` mode's oracle's) over the
model group. Under GSPMD any split of the JAX rule computes the same thing;
here each rank computes on its own pieces (``models/vit.py``), so the port
cuts where local compute allows:

* attention by head group: rank r keeps the q, k and v rows of heads
  [r·H/M, (r+1)·H/M) of ``qkv`` (timm's [q | k | v] layout) and of its
  bias, and the matching columns of ``proj``. Where M does not divide H
  the attention half stays whole;
* SwiGLU by half: rank r keeps its 1/M of ``w1`` and its 1/M of ``w2`` out
  of ``w12`` = [w1 | w2], and the matching columns of ``w3``;
* GELU MLPs: a plain 1/M of ``fc1``'s hidden units and ``fc2``'s columns.

The biases of ``proj``, ``fc2`` and ``w3`` stay whole: they are added once,
after the sum over the model group. A piece is a copy, so the whole tensor's
storage is freed. Fine-tuning shards nothing, as the JAX rule applies its
split to ``state.frozen`` only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import MODEL_AXIS, Mesh, process_count
from .metrics import all_gather_rows


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


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """What a sharded module keeps on itself: the mesh whose model group
    holds the other pieces, this rank's heads (attention only), and how each
    sharded parameter was cut: ``(name, parts)`` with ``parts`` > 0 for rows
    cut in ``parts`` stacked blocks (3 for [q | k | v], 2 for [w1 | w2], 1
    for fc1), 0 for columns."""

    mesh: Mesh
    cuts: Tuple[Tuple[str, int], ...]
    heads: Optional[slice] = None


def take_piece(t: torch.Tensor, parts: int, model: int,
               index: int) -> torch.Tensor:
    """Rank ``index``'s piece of ``t`` (a copy with storage of its own):
    1/``model`` of each of ``parts`` stacked row blocks, or with ``parts``
    0 the ``index``-th 1/``model`` of the columns."""
    if parts:
        n = t.shape[0] // (parts * model)
        piece = t.reshape(parts, model, n, *t.shape[1:])[:, index]
        piece = piece.reshape(parts * n, *t.shape[1:])
    else:
        n = t.shape[1] // model
        piece = t[:, index * n:(index + 1) * n]
    return piece.contiguous().clone()


def join_pieces(piece: torch.Tensor, parts: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``piece`` over the model group
    (the inverse of :func:`take_piece`), contiguous, on ``piece``'s
    device."""
    m = mesh.shape[MODEL_AXIS]
    if parts:
        g = all_gather_rows(piece, MODEL_AXIS, mesh).to(piece.device)
        g = g.reshape(m, parts, -1, *piece.shape[1:]).transpose(0, 1)
        return g.reshape(-1, *piece.shape[1:]).contiguous()
    g = all_gather_rows(piece.t(), MODEL_AXIS, mesh).to(piece.device)
    return g.t().contiguous()


@contextlib.contextmanager
def whole_tensors(*modules: nn.Module):
    """Give each sharded module among ``modules`` its whole parameters for
    the duration, joined over the model group, and mark it unsharded; then
    put the pieces back, which frees the whole tensors."""
    saved = []
    try:
        for m in modules:
            tp = m.tp
            if tp is None:
                continue
            saved.append((m, tp, [(p, p.data) for p in
                                  (_param(m, n) for n, _ in tp.cuts)]))
            for (p, piece), (_, parts) in zip(saved[-1][2], tp.cuts):
                p.data = join_pieces(piece, parts, tp.mesh)
            m.tp = None
        yield
    finally:
        for m, tp, pieces in saved:
            for p, piece in pieces:
                p.data = piece
            m.tp = tp


def replicate(model: nn.Module, src: int = 0) -> nn.Module:
    """Broadcast every parameter and buffer of ``model`` from rank ``src``
    to every rank (nothing to do in one process)."""
    if process_count() > 1:
        for t in itertools.chain(model.parameters(), model.buffers()):
            dist.broadcast(t.data, src)
    return model


def _param(module: nn.Module, name: str) -> Optional[torch.Tensor]:
    """``module``'s parameter ``name`` (dotted), or None (a bias left out)."""
    owner, _, leaf = name.rpartition(".")
    return getattr(module.get_submodule(owner), leaf)


def _cut(module: nn.Module, prefix: str, cuts: Sequence[Tuple[str, int]],
         mesh: Mesh, heads: Optional[slice] = None) -> None:
    """Replace ``module``'s parameters named in ``cuts`` by this rank's
    pieces and record them on ``module.tp``, where :func:`spec_for` splits
    each of them along the cut's dimension; else leave the module whole."""
    m, r = mesh.shape[MODEL_AXIS], mesh.model_index
    cuts = tuple((n, parts) for n, parts in cuts
                 if _param(module, n) is not None)
    if any(spec_for(f"{prefix}.{n}", _param(module, n).shape, m)
           != (0 if parts else 1) for n, parts in cuts):
        return
    with torch.no_grad():
        for n, parts in cuts:
            p = _param(module, n)
            p.data = take_piece(p.data, parts, m, r)
    module.tp = TensorParallel(mesh, cuts, heads)


def shard_block(block: nn.Module, mesh: Mesh) -> None:
    """Cut one ``models/vit.py::Block`` over the mesh's model group in place:
    the attention half by head group where M divides its heads, the MLP half
    where M divides its hidden width (see the module's docstring). A block
    whose attention takes the kernels (``attn_impl="pallas"``) joins its
    pieces into whole tensors for each call (``Block.gather``)."""
    m = mesh.shape[MODEL_AXIS]
    attn, mlp = block.attn, block.mlp
    if attn.num_heads % m == 0:
        h = attn.num_heads // m
        r = mesh.model_index
        _cut(attn, "attn", (("qkv.weight", 3), ("qkv.bias", 3),
                            ("proj.weight", 0)), mesh,
             slice(r * h, (r + 1) * h))
    _cut(mlp, "mlp", (("w12.weight", 2), ("w12.bias", 2), ("w3.weight", 0))
         if hasattr(mlp, "w3") else
         (("fc1.weight", 1), ("fc1.bias", 1), ("fc2.weight", 0)), mesh)
    block.gather = attn.kernel and (attn.tp is not None
                                    or mlp.tp is not None)


def shard_state(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Place the model's state on the mesh: rank 0's parameters and buffers
    on every rank, then, where the model axis M is above 1, every frozen ViT
    block cut over the model group (:func:`shard_block`). Ranks with the
    same model index hold the same pieces.

    Load a checkpoint before calling this: a whole ``state_dict`` does not
    load into a sharded model. (The probe's ``checkpoint-*.pth`` holds the
    head only, which stays whole.) Build the model with the mesh registered
    (``set_current_mesh``), so that attention's ``"auto"`` reads the model
    axis as the JAX gate does."""
    from ep_tpu_torch.models.vit import Block  # models import this module
    from ep_tpu_torch.train.state import split_params
    replicate(model)
    if mesh.shape[MODEL_AXIS] == 1:
        return model
    frozen = split_params(model, getattr(model, "finetuning", False))[1]
    for name, block in model.named_modules():
        if isinstance(block, Block) and all(
                f"{name}.{n}" in frozen for n, _ in block.named_parameters()):
            shard_block(block, mesh)
    return model
