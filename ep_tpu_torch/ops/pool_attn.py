"""EP pooling: query bank x tokens -> per-query value slices, concatenated.

Counterpart of ``ep_tpu/ops/pool_attn_pallas.py::ep_pool_attend``:

    logits = q_scaled @ tokensᵀ        (B, Q, N), f32
    attn   = softmax_N(logits)          f32, cast to the value dtype
    out[q] = attn[q] @ v[:, q, :]       f32 sums, cast once -> (B, Q, cq)

On CUDA tensors the forward is kernel D (``csrc/ep_pool.cu``), one launch for
each group of at most 64 queries (:func:`query_groups`); on CPU tensors it is
:func:`ep_pool_attend_ref`. The backward is autograd through the plain
version on the same device, as the JAX package's ``_ep_bwd`` is the VJP of
``ep_pool_attend_xla``.

:func:`ep_pool_proj_attend` is the same pool with the value projection
``v = x @ Wᵀ`` inside (``pool_attn_pallas.py::ep_pool_proj_attend``): kernel G
(``csrc/ep_pool_proj.cu``) on CUDA tensors, so that neither v nor the
probabilities reach device memory, and :func:`ep_pool_proj_attend_ref` on CPU
tensors; the backward is autograd through the plain version, as ``_ep_proj_bwd``
is. W is in the ``nn.Linear`` layout, (Q*cq, C), like every weight of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES, MAX_SMEM, check, default_device, use_kernel
from ._build import call, query, stream_ptr


def block_mask(Q: int, cq: int, device=None) -> torch.Tensor:
    """(Q, Q*cq) block-diagonal selector: row q is 1 on its cq-slice. On
    ``device`` (None: the card, as every constructor of the port)."""
    return torch.block_diag(
        *[torch.ones(1, cq, device=default_device(device))] * Q)


def ep_pool_attend_ref(q_scaled: torch.Tensor, tokens: torch.Tensor,
                       v: torch.Tensor, return_attn: bool = False):
    """Plain version (``ep_pool_attend_xla``): the masked-full form, one
    (B,Q,N)@(B,N,Q*cq) product and a block-diagonal mask-reduce. Every output
    element equals one element of the full product. With ``return_attn``
    also the f32 probabilities (B, Q, N), which no kernel computes."""
    B, N, Q, cq = v.shape
    logits = torch.einsum("qc,bnc->bqn", q_scaled.float(), tokens.float())
    attn = torch.softmax(logits, dim=-1)
    full = torch.einsum("bqn,bnm->bqm", attn.to(v.dtype).float(),
                        v.reshape(B, N, Q * cq).float())
    out = (full * block_mask(Q, cq, v.device)).sum(dim=1)
    out = out.reshape(B, Q, cq).to(v.dtype)
    return (out, attn) if return_attn else out


def _check_pool_inputs(q_scaled, tokens) -> None:
    N, C = tokens.shape[1:]
    check(q_scaled, "q_scaled", (q_scaled.shape[0], C), torch.bfloat16)
    # tokens may be the patch-token view x[:, 1:]: rows contiguous, images apart
    check(tokens[0], "tokens[0]", (N, C), torch.bfloat16)
    if tokens.stride(0) % 8:
        raise ValueError("tokens: images must start 16-byte aligned")


# Kernel D's tiling (csrc/ep_pool.cu): an image's tokens in tiles of 64
# (wgmma's M), a cluster of blocks an image, `tiles` consecutive tiles a
# block; the query bank padded to 8, 16, 32 or 64 rows (wgmma's N); a ring of
# EP_POOL_STAGES TMA slots a block.
EP_POOL_TILE = 64
EP_POOL_STAGES = 2
EP_POOL_MAX_CLUSTER = 16
EP_POOL_QUERY_ROWS = (8, 16, 32, 64)


def ep_pool_smem_bytes(Q: int, QC: int, cluster: int, tiles: int) -> int:
    """Shared memory of one block of kernel D (``csrc/ep_pool.cu::layout``):
    the ring, p (Q rows rounded up to 8 a tile; the last tile's 64 rows reach
    into what follows), the f32 logits, the partial sums of the Q*cq = QC
    columns, the cluster's maxima and sums, the barriers and the 1024-byte
    alignment."""
    qn = next(r for r in EP_POOL_QUERY_ROWS if r >= Q)
    tile, p_tile = EP_POOL_TILE * 128, -(-Q // 8) * 8 * 128
    p = EP_POOL_STAGES * (tile + qn * 128)
    logits = p + tiles * p_tile
    partial = logits + qn * (tiles * EP_POOL_TILE + 4) * 4
    bars = partial + -(-QC // 4) * 16 + 2 * cluster * qn * 4
    end = max(bars + EP_POOL_STAGES * 8, p + (tiles - 1) * p_tile + tile)
    return 1024 + end


def query_groups(Q: int) -> list[tuple[int, int]]:
    """(first, last + 1) of each group of queries that one launch of kernel D
    or G takes: 64 at a time (the N of their logits' wgmma), the rest in the
    last group. Each group is a softmax of its own over the tokens, so the
    groups are independent launches on their slices of the query bank, of
    v's or W's columns and of the output. A group of 64 starts its columns
    at a multiple of 64*cq, 16-byte aligned, and where Q*cq % 8 == 0 the last
    group's Q_g*cq % 8 == 0 too."""
    step = EP_POOL_QUERY_ROWS[-1]
    return [(q0, min(q0 + step, Q)) for q0 in range(0, Q, step)]


def _check_pool_widths(kernel: str, C: int, Q: int, QC: int) -> tuple[int, int]:
    """The widths kernels D and G take: rows of 16 bytes for TMA and, past 64
    queries, Q*cq columns (cq a whole number) split by :func:`query_groups`.
    Returns the largest group's (queries, columns), which sets the layout."""
    if C % 16 or QC % 8:
        raise NotImplementedError(
            f"{kernel} streams 16-byte rows by TMA: it needs C % 16 == 0 and "
            f"Q*cq % 8 == 0; got C={C}, Q*cq={QC}")
    if Q <= EP_POOL_QUERY_ROWS[-1]:
        return Q, QC
    if QC % Q:
        raise ValueError(f"{kernel}: Q*cq={QC} columns are not a whole number "
                         f"of columns for each of the {Q} queries")
    q = EP_POOL_QUERY_ROWS[-1]
    return q, q * (QC // Q)


def _cluster_split(n_tiles: int, max_cluster: int) -> tuple[int, int]:
    """(cluster size, tiles a block): one tile a block while the cluster
    stays within max_cluster, else the fewest tiles a block that keep it
    there. Every block has at least one tile."""
    tiles = -(-n_tiles // max_cluster)
    return -(-n_tiles // tiles), tiles


def ep_pool_tiling(N: int, C: int, Q: int, QC: int) -> tuple[int, int]:
    """(cluster size, tiles a block) of kernel D for N tokens of width C, Q
    queries and QC = Q*cq value columns: one tile a block and a cluster of
    ceil(N / 64) blocks up to 16 (N <= 1024), else the fewest tiles a block
    that keep the cluster within 16. Every block has at least one tile. Past
    64 queries every group of :func:`query_groups` is launched with this
    tiling. Raises NotImplementedError for a shape the kernel does not
    take."""
    Qg, QCg = _check_pool_widths("ep_pool", C, Q, QC)
    cluster, tiles = _cluster_split(-(-N // EP_POOL_TILE), EP_POOL_MAX_CLUSTER)
    smem = ep_pool_smem_bytes(Qg, QCg, cluster, tiles)
    if smem > MAX_SMEM:
        raise NotImplementedError(
            f"ep_pool keeps the logits and p of its {tiles} tiles of 64 tokens "
            f"a block in shared memory: N={N}, Q={Qg}, Q*cq={QCg} needs {smem} "
            f"bytes, more than {MAX_SMEM}")
    return cluster, tiles


def _ep_pool_kernel(q_scaled, tokens, v):
    B, N, C = tokens.shape
    Q, cq = v.shape[2], v.shape[3]
    _check_pool_inputs(q_scaled, tokens)
    check(v, "v", (B, N, Q, cq), torch.bfloat16)
    cluster, tiles = ep_pool_tiling(N, C, Q, Q * cq)
    out = torch.empty(B, Q, cq, device=v.device, dtype=v.dtype)
    for q0, q1 in query_groups(Q):
        call("ep_pool", q_scaled[q0].data_ptr(), tokens.data_ptr(),
             v[0, 0, q0].data_ptr(), out[0, q0].data_ptr(), B, N, C, q1 - q0,
             cq, tokens.stride(0), Q * cq, Q * cq, cluster, tiles,
             stream_ptr(v))
        LAUNCHES["ep_pool"] += 1
    return out


def _plain_backward(ref, ctx, g):
    """Gradients of the kernel's inputs by autograd through its plain version
    ``ref``, recomputed from the saved inputs."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        out = ref(*inputs)
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


class _EPPoolAttend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_scaled, tokens, v):
        ctx.save_for_backward(q_scaled, tokens, v)
        return _ep_pool_kernel(q_scaled, tokens, v)

    @staticmethod
    def backward(ctx, g):
        return _plain_backward(ep_pool_attend_ref, ctx, g)


def ep_pool_attend(q_scaled: torch.Tensor, tokens: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """q_scaled (Q, C) already multiplied by the scale; tokens (B, N, C);
    v (B, N, Q, cq) projected values. Returns (B, Q, cq)."""
    if not use_kernel(q_scaled, tokens, v):
        return ep_pool_attend_ref(q_scaled, tokens, v)
    return _EPPoolAttend.apply(q_scaled, tokens, v)


def ep_pool_proj_attend_ref(q_scaled: torch.Tensor, tokens: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """Plain version (``ep_pool_proj_attend_xla``): the projection in the
    tokens' dtype, then the plain pool."""
    B, N, _ = tokens.shape
    Q = q_scaled.shape[0]
    v = F.linear(tokens, w.to(tokens.dtype))
    return ep_pool_attend_ref(q_scaled, tokens, v.reshape(B, N, Q, -1))


# Kernel G's tiling (csrc/ep_pool_proj.cu): an image's tokens in panels of
# 128, a cluster of blocks an image, `panels` consecutive panels a block; W's
# Q*cq rows in tiles of 256; a ring of 3 TMA slots, each a 64-channel slice of
# the panel, of the tile's rows of W and of the query bank padded to
# EP_POOL_QUERY_ROWS.
EP_PROJ_PANEL = 128
EP_PROJ_ROWS = 256
EP_PROJ_STAGES = 3
EP_PROJ_MAX_CLUSTER = 16


def ep_pool_proj_smem_bytes(Q: int, QC: int, cluster: int) -> int:
    """Shared memory of one block of kernel G (``csrc/ep_pool_proj.cu::
    layout``): the ring, p of one panel (bf16, Q rows of 136), the 8 warps'
    per-query statistics, the partial sums of the QC columns, the cluster's
    maxima and sums, the global statistics, the barriers and the 1024-byte
    alignment. It does not depend on N: a block with several panels
    computes their logits again where it needs them."""
    qn = next(r for r in EP_POOL_QUERY_ROWS if r >= Q)
    p = EP_PROJ_STAGES * (EP_PROJ_PANEL + EP_PROJ_ROWS + qn) * 128
    wred = p + Q * (EP_PROJ_PANEL + 8) * 2
    partial = wred + 8 * qn * 4
    xmax = partial + -(-QC // 4) * 16
    bars = xmax + 2 * cluster * qn * 4 + 2 * qn * 4
    return 1024 + bars + 2 * EP_PROJ_STAGES * 8


def ep_pool_proj_tiling(N: int, C: int, Q: int, QC: int) -> tuple[int, int]:
    """(cluster size, panels a block) of kernel G for N tokens of width C, Q
    queries and QC = Q*cq value columns: one panel of 128 tokens a block and a
    cluster of ceil(N / 128) blocks up to 16 (N <= 2048), else the fewest
    panels a block that keep the cluster within 16. The widths are kernel
    D's (any cq, any Q, past 64 in the groups of :func:`query_groups`);
    raises NotImplementedError where they are not, or where the block's
    shared memory cannot hold the query bank and the columns."""
    Qg, QCg = _check_pool_widths("ep_pool_proj", C, Q, QC)
    cluster, panels = _cluster_split(-(-N // EP_PROJ_PANEL),
                                     EP_PROJ_MAX_CLUSTER)
    smem = ep_pool_proj_smem_bytes(Qg, QCg, cluster)
    if smem > MAX_SMEM:
        raise NotImplementedError(
            f"ep_pool_proj keeps its ring, p of a panel and the partial sums "
            f"of all Q*cq columns in shared memory: Q={Qg}, Q*cq={QCg} needs "
            f"{smem} bytes, more than {MAX_SMEM}")
    return cluster, panels


def _ep_pool_proj_kernel(q_scaled, tokens, w):
    B, N, C = tokens.shape
    Q, QC = q_scaled.shape[0], w.shape[0]
    if QC % Q:
        raise ValueError(f"w has {QC} rows, not a multiple of the {Q} queries")
    cq = QC // Q
    _check_pool_inputs(q_scaled, tokens)
    w = w.to(tokens.dtype)
    check(w, "w", (QC, C), torch.bfloat16)
    cluster, panels = ep_pool_proj_tiling(N, C, Q, QC)
    out = torch.empty(B, Q, cq, device=tokens.device, dtype=tokens.dtype)
    for q0, q1 in query_groups(Q):
        Qg = q1 - q0
        smem = ep_pool_proj_smem_bytes(Qg, Qg * cq, cluster)
        if query("ep_pool_proj_smem_bytes", Qg, Qg * cq, cluster) != smem:
            raise RuntimeError(
                "ep_pool_proj_smem_bytes is not the kernel's layout")
        call("ep_pool_proj", q_scaled[q0].data_ptr(), tokens.data_ptr(),
             w[q0 * cq].data_ptr(), out[0, q0].data_ptr(), B, N, C, Qg, cq,
             tokens.stride(0), QC, cluster, panels, stream_ptr(tokens))
        LAUNCHES["ep_pool_proj"] += 1
    return out


class _EPPoolProjAttend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_scaled, tokens, w):
        ctx.save_for_backward(q_scaled, tokens, w)
        return _ep_pool_proj_kernel(q_scaled, tokens, w)

    @staticmethod
    def backward(ctx, g):
        return _plain_backward(ep_pool_proj_attend_ref, ctx, g)


def ep_pool_proj_attend(q_scaled: torch.Tensor, tokens: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """q_scaled (Q, C) already multiplied by the scale; tokens (B, N, C); w
    (Q*cq, C), the value projection's weight (EP's v has no bias), in its own
    (master) dtype. Returns (B, Q, cq)."""
    if not use_kernel(q_scaled, tokens, w):
        return ep_pool_proj_attend_ref(q_scaled, tokens, w)
    return _EPPoolProjAttend.apply(q_scaled, tokens, w)
