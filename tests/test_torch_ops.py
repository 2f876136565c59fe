"""ep_tpu_torch ops (plain versions, CPU) against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs.

Tolerances: float32 at 1e-5, the parity bar of the existing suite. In
bfloat16 both sides round at the same points; the f32 sums differ in order,
which can move a value across one bf16 rounding boundary, so bf16 outputs
agree within two bf16 steps (2**-7 relative) of their magnitude.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ep_tpu.ops.attn_block_pallas import attn_supercell as jax_supercell
from ep_tpu.ops.attn_fused_pallas import attention_qkv_fused as jax_attn
from ep_tpu.ops.pool_attn_pallas import ep_pool_attend as jax_ep
from ep_tpu_torch.ops import (LAUNCHES, MAX_SMEM, check, reset_launches,
                              use_kernel)
from ep_tpu_torch.ops.attn_block import attn_supercell, attn_supercell_ref
from ep_tpu_torch.ops.attn_fused import attention_qkv_fused
from ep_tpu_torch.ops.pool_attn import (EP_POOL_MAX_CLUSTER, EP_POOL_TILE,
                                        EP_PROJ_MAX_CLUSTER, EP_PROJ_PANEL,
                                        ep_pool_attend, ep_pool_attend_ref,
                                        ep_pool_proj_smem_bytes,
                                        ep_pool_proj_tiling,
                                        ep_pool_smem_bytes, ep_pool_tiling,
                                        query_groups)

F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(out_t: torch.Tensor, out_j, dtype: str):
    a = out_t.float().numpy()
    b = np.asarray(jnp.asarray(out_j, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)
    else:
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_qkv_fused_matches_jax(dtype):
    B, T, H, Dh = 2, 5, 2, 32
    rng = np.random.default_rng(0)
    qkv_j, qkv_t = _pair(rng.standard_normal((B, T, 3 * H * Dh), np.float32),
                         dtype)
    scale = Dh ** -0.5
    out_j = jax_attn(qkv_j, H, scale, 1.0, True)
    out_t = attention_qkv_fused(qkv_t, H, scale, 1.0)
    assert out_t.dtype == DTYPES[dtype][1] and out_t.shape == (B, T, H * Dh)
    _close(out_t, out_j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_supercell_matches_jax(dtype):
    B, T, H, D = 2, 5, 2, 64
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, D), np.float32)
    w_qkv = rng.standard_normal((D, 3 * D), np.float32) * D ** -0.5
    b_qkv = rng.standard_normal(3 * D, np.float32) * 0.02
    gamma = 1 + 0.1 * rng.standard_normal(D, np.float32)
    beta = 0.1 * rng.standard_normal(D, np.float32)
    w_proj = rng.standard_normal((D, D), np.float32) * D ** -0.5
    b_proj = rng.standard_normal(D, np.float32) * 0.02
    scale = (D // H) ** -0.5
    x_j, x_t = _pair(x, dtype)
    out_j = jax_supercell(x_j, *map(jnp.asarray, (w_qkv, b_qkv, gamma, beta,
                                                  w_proj, b_proj)),
                          H, scale, 1.0, 1e-6, True)
    # the port keeps every weight in the nn.Linear (out, in) layout
    t = torch.from_numpy
    args = (x_t, t(w_qkv.T.copy()), t(b_qkv), t(gamma), t(beta),
            t(w_proj.T.copy()), t(b_proj), H, scale, 1.0, 1e-6)
    out_t = attn_supercell(*args)
    _close(out_t, out_j, dtype)
    torch.testing.assert_close(out_t, attn_supercell_ref(*args), rtol=0, atol=0)


def _ep_inputs(dtype, seed=2, B=3, N=37, C=64, Q=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, C), np.float32) * C ** -0.5
    x = rng.standard_normal((B, N, C), np.float32)
    v = rng.standard_normal((B, N, Q, C // Q), np.float32)
    return [_pair(a, dtype) for a in (q, x, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ep_pool_attend_matches_jax(dtype):
    (q_j, q_t), (x_j, x_t), (v_j, v_t) = _ep_inputs(dtype)
    out_j = jax_ep(q_j, x_j, v_j, True)
    out_t = ep_pool_attend(q_t, x_t, v_t)
    assert out_t.shape == v_t.shape[:1] + v_t.shape[2:]
    _close(out_t, out_j, dtype)


def test_ep_pool_attend_grad_matches_jax_vjp():
    (q_j, q_t), (x_j, x_t), (v_j, v_t) = _ep_inputs("float32", seed=3)
    g = np.random.default_rng(4).standard_normal(v_t.shape[:1] + v_t.shape[2:],
                                                 np.float32)
    _, vjp = jax.vjp(lambda q, x, v: jax_ep(q, x, v, True), q_j, x_j, v_j)
    grads_j = vjp(jnp.asarray(g))
    ins = [t.clone().requires_grad_(True) for t in (q_t, x_t, v_t)]
    ep_pool_attend(*ins).backward(torch.from_numpy(g))
    for t, gj in zip(ins, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_ep_pool_plain_is_the_masked_full_form():
    """The plain version's block-diagonal reduce equals the per-query
    contraction it stands for."""
    (_, q), (_, x), (_, v) = _ep_inputs("float32", seed=5)
    attn = torch.softmax(torch.einsum("qc,bnc->bqn", q, x), dim=-1)
    direct = torch.einsum("bqn,bnqc->bqc", attn, v)
    torch.testing.assert_close(ep_pool_attend_ref(q, x, v), direct,
                               rtol=F32_TOL, atol=F32_TOL)


# Kernel D's shapes: the ViT-B/16, ViT-L/16, ViT-L/14, ViT-H/14 and ViT-g/14
# patch grids at 224 px, ViT-B/16, ViT-L/14 and ViT-H/14 at 448 px (EP-32 at
# d_out 1: Q*cq = C), EP-64 and d_out 2, and small ragged N around a tile.
EP_POOL_SHAPES = [
    (196, 768, 32, 768), (196, 1024, 32, 1024), (256, 1024, 32, 1024),
    (256, 1280, 32, 1280), (256, 1408, 32, 1408), (784, 768, 32, 768),
    (1024, 1024, 32, 1024), (1024, 1280, 32, 1280), (196, 768, 64, 768),
    (196, 768, 32, 384), (1, 128, 4, 128), (37, 128, 4, 128),
    (63, 192, 12, 192), (64, 768, 32, 768), (65, 768, 32, 768),
    (129, 64, 8, 64), (1025, 1280, 32, 1280), (2048, 768, 32, 768),
    (4096, 1280, 32, 1280)]


@pytest.mark.parametrize("N, C, Q, QC", EP_POOL_SHAPES)
def test_ep_pool_tiling_takes_every_token_once(N, C, Q, QC):
    """Kernel D's blocks cover the image's tiles of 64 tokens once, each block
    at least one of them, in a cluster the card schedules (at most 16, past 8
    only with the non-portable size) and within a block's shared memory; up
    to N = 1024 a block takes one tile."""
    cluster, tiles = ep_pool_tiling(N, C, Q, QC)
    span = tiles * EP_POOL_TILE
    assert 1 <= cluster <= EP_POOL_MAX_CLUSTER and tiles >= 1
    assert (cluster - 1) * span < N <= cluster * span
    assert ep_pool_smem_bytes(Q, QC, cluster, tiles) <= MAX_SMEM
    if N <= EP_POOL_TILE * EP_POOL_MAX_CLUSTER:
        assert (cluster, tiles) == (-(-N // EP_POOL_TILE), 1)


@pytest.mark.parametrize("N, C, Q, QC, what", [
    (196, 768, 65, 780, r"Q\*cq % 8"), (196, 776, 8, 776, "C % 16"),
    (37, 128, 4, 12, r"Q\*cq % 8"), (16 * 64 * 48, 768, 32, 768, "bytes")])
def test_ep_pool_tiling_refuses_what_kernel_d_does_not_take(N, C, Q, QC, what):
    """65 queries are taken (in two groups), but not at 780 columns: 12 a
    query, and 780 % 8 != 0."""
    with pytest.raises(NotImplementedError, match=what):
        ep_pool_tiling(N, C, Q, QC)


# More than 64 queries at ViT-B's token width: 65 (cq 8; a last group of
# one), 96 (cq 8), 128 (cq 6), 768 (cq 1), and ViT-H's 1280 (cq 1).
MANY_QUERIES = [(196, 768, 65, 520), (196, 768, 96, 768), (196, 768, 128, 768),
                (196, 768, 768, 768), (256, 1280, 1280, 1280),
                (1024, 1280, 128, 1280)]


@pytest.mark.parametrize("N, C, Q, QC", MANY_QUERIES)
def test_pool_kernels_take_more_than_64_queries(N, C, Q, QC):
    """Past 64 queries kernels D and G run one launch a group of at most 64
    (the N of their logits' wgmma): every query in one group, each group's
    columns starting 16-byte aligned with a whole number of 16-byte rows
    (Q_g*cq % 8 == 0), and both tilings those of a full group of 64."""
    groups = query_groups(Q)
    assert [q for q0, q1 in groups for q in range(q0, q1)] == list(range(Q))
    assert all(1 <= q1 - q0 <= 64 for q0, q1 in groups)
    cq = QC // Q
    assert all((q0 * cq * 2) % 16 == 0 and ((q1 - q0) * cq) % 8 == 0
               for q0, q1 in groups)
    assert ep_pool_tiling(N, C, Q, QC) == ep_pool_tiling(N, C, 64, 64 * cq)
    assert (ep_pool_proj_tiling(N, C, Q, QC)
            == ep_pool_proj_tiling(N, C, 64, 64 * cq))


def test_query_groups():
    assert query_groups(1) == [(0, 1)]
    assert query_groups(64) == [(0, 64)]
    assert query_groups(65) == [(0, 64), (64, 65)]
    assert query_groups(96) == [(0, 64), (64, 96)]
    assert query_groups(768) == [(i, i + 64) for i in range(0, 768, 64)]


@pytest.mark.parametrize("tiling", ["ep_pool_tiling", "ep_pool_proj_tiling"])
def test_pool_kernels_refuse_columns_not_a_multiple_of_the_queries(tiling):
    """Past 64 queries the groups split the columns by query, so Q*cq must
    hold a whole number of columns for each query."""
    fn = dict(ep_pool_tiling=ep_pool_tiling,
              ep_pool_proj_tiling=ep_pool_proj_tiling)[tiling]
    with pytest.raises(ValueError, match="whole number"):
        fn(196, 768, 96, 776)


def test_ep_pool_smem_grows_with_tiles_and_queries():
    """The layout holds the ring, a tile's p and logits, the cluster's
    exchange and the partial sums: it grows with each of them."""
    base = ep_pool_smem_bytes(32, 768, 4, 1)
    assert ep_pool_smem_bytes(32, 768, 4, 2) > base
    assert ep_pool_smem_bytes(64, 768, 4, 1) > base
    assert ep_pool_smem_bytes(32, 1280, 4, 1) > base
    assert ep_pool_smem_bytes(32, 768, 16, 1) > base


@pytest.mark.parametrize("N", [1, 127, 128, 129, 196, 256, 1024, 2100])
def test_ep_pool_proj_tiling_takes_every_token_once(N):
    """Kernel G's blocks cover the image's panels of 128 tokens once, each
    block at least one of them, in a cluster the card schedules (at most 16);
    up to N = 2048 a block takes one panel, past it several."""
    cluster, panels = ep_pool_proj_tiling(N, 768, 32, 768)
    span = panels * EP_PROJ_PANEL
    assert 1 <= cluster <= EP_PROJ_MAX_CLUSTER and panels >= 1
    assert (cluster - 1) * span < N <= cluster * span
    if N <= EP_PROJ_PANEL * EP_PROJ_MAX_CLUSTER:
        assert (cluster, panels) == (-(-N // EP_PROJ_PANEL), 1)
    else:
        assert panels > 1


@pytest.mark.parametrize("N, C, Q, QC", EP_POOL_SHAPES)
def test_ep_pool_proj_takes_every_shape_kernel_d_takes(N, C, Q, QC):
    """Every shape kernel D takes, kernel G takes too (any cq), within a
    block's shared memory."""
    ep_pool_tiling(N, C, Q, QC)
    cluster, _ = ep_pool_proj_tiling(N, C, Q, QC)
    assert ep_pool_proj_smem_bytes(Q, QC, cluster) <= MAX_SMEM


@pytest.mark.parametrize("N, C, Q, QC, what", [
    (196, 768, 65, 780, r"Q\*cq % 8"), (196, 776, 8, 776, "C % 16"),
    (37, 128, 4, 12, r"Q\*cq % 8")])
def test_ep_pool_proj_refuses_the_widths_kernel_d_refuses(N, C, Q, QC, what):
    """The widths D refuses, G refuses with the same reason. (D's fourth
    refusal, a long image whose logits overflow D's shared memory, has no
    counterpart: G's shared memory does not grow with N, see the next
    test.)"""
    for tiling in (ep_pool_tiling, ep_pool_proj_tiling):
        with pytest.raises(NotImplementedError, match=what):
            tiling(N, C, Q, QC)


def test_ep_pool_proj_smem_grows_with_queries_and_columns_not_tokens():
    """G's layout holds the ring (its query slice grows with the padded
    bank), p of one panel, the partial sums of the columns and the cluster's
    exchange; a block with more panels recomputes their logits instead of
    keeping them, so N does not enter. It fits a block at every path's shape
    and at the long image kernel D refuses."""
    base = ep_pool_proj_smem_bytes(32, 768, 2)
    assert ep_pool_proj_smem_bytes(33, 768, 2) > base
    assert ep_pool_proj_smem_bytes(64, 768, 2) > ep_pool_proj_smem_bytes(33, 768, 2)
    assert ep_pool_proj_smem_bytes(32, 1280, 2) > base
    assert ep_pool_proj_smem_bytes(32, 768, 16) > base
    for N, C, QC in ((196, 768, 768), (256, 1280, 1280), (1024, 1280, 1280),
                     (196, 768, 384), (256, 1280, 640), (196, 1024, 1024),
                     (256, 1408, 1408), (16 * 64 * 48, 768, 768)):
        cluster, panels = ep_pool_proj_tiling(N, C, 32, QC)
        assert ep_pool_proj_smem_bytes(32, QC, cluster) <= MAX_SMEM
    with pytest.raises(NotImplementedError, match="bytes"):
        ep_pool_tiling(16 * 64 * 48, 768, 32, 768)
    assert ep_pool_proj_tiling(16 * 64 * 48, 768, 32, 768) == (16, 24)


def test_dispatch_by_device():
    cpu = torch.zeros(2)
    assert use_kernel(cpu, cpu) is False
    meta = torch.zeros(2, device="meta")
    with pytest.raises(ValueError):
        use_kernel(cpu, meta)


@pytest.mark.parametrize("bad, err", [
    (torch.zeros(4, 8, dtype=torch.float32), TypeError),
    (torch.zeros(4, 9, dtype=torch.bfloat16), ValueError),
    (torch.zeros(8, 4, dtype=torch.bfloat16).t(), ValueError),
    (torch.zeros(33, dtype=torch.bfloat16)[1:].view(4, 8), ValueError),
])
def test_kernel_input_checks(bad, err):
    with pytest.raises(err):
        check(bad, "t", (4, 8), torch.bfloat16)


@pytest.mark.parametrize("N, K, ln", [
    (2304, 768, True), (3072, 1024, True), (3840, 1280, True), (192, 64, True),
    (768, 768, False), (1024, 1024, False), (1280, 1280, False),
    (1408, 1408, False), (8, 64, False)])
def test_gemm_kernels_take_the_models_widths(N, K, ln):
    """What the wrappers of kernels A and C accept: every K that is a multiple
    of 64 (one 128-byte swizzle row of bf16) with N a multiple of 8; kernel A,
    whose statistics kernel holds a row in one warp's registers, up to
    K = 1280."""
    from ep_tpu_torch.ops.attn_block import _check_gemm
    _check_gemm("gemm", N, K, ln=ln)


@pytest.mark.parametrize("N, K, ln, what", [
    (2304, 800, True, "K % 64"), (2304, 32, False, "K % 64"),
    (2300, 768, False, "N % 8"), (4032, 1344, True, "K <= 1280"),
    (6144, 2048, True, "K <= 1280")])
def test_gemm_kernels_refuse_other_widths(N, K, ln, what):
    from ep_tpu_torch.ops.attn_block import _check_gemm
    with pytest.raises(NotImplementedError, match=what):
        _check_gemm("gemm", N, K, ln=ln)


@pytest.mark.parametrize("B, T, H, Dh", [
    (1, 1, 1, 64), (2, 63, 2, 80), (1, 65, 12, 64), (1, 129, 16, 80),
    (1, 257, 16, 80), (64, 785, 12, 64), (64, 1025, 16, 80), (1, 4097, 1, 64),
    (8, 789, 32, 128), (2, 201, 32, 128), (1, 1, 1, 128),
    (128, 729, 16, 72), (1, 1, 1, 72), (3, 65, 2, 72)])
def test_flash_takes_every_t_at_both_head_widths(B, T, H, Dh):
    """What kernel F's wrapper accepts after its redesign: every T >= 1 (the
    last key tile narrows to 16, 32 or 64 columns, query rows come in 64-row
    units) at head widths 64 and 80, the widths of its two-box tiles, 72
    (SigLIP2's: width 80's boxes, the rest columns zeroed) and 128 (DINOv3's:
    two 64-column boxes)."""
    from ep_tpu_torch.ops.flash_attn import flash_head_dim
    assert flash_head_dim((B, T, 3 * H * Dh), H, Dh ** -0.5, 1.5) == Dh


@pytest.mark.parametrize("shape, H, scale, temperature, err, what", [
    ((1, 65, 3 * 2 * 32), 2, 0.2, 1.0, NotImplementedError, "head width 32"),
    ((1, 65, 3 * 1 * 112), 1, 0.1, 1.0, NotImplementedError, "head width 112"),
    ((1, 65, 3 * 2 * 96), 2, 0.1, 1.0, NotImplementedError, "head width 96"),
    ((1, 65, 3 * 64 + 8), 1, 0.1, 1.0, ValueError, "3 x 1 heads"),
    ((1, 0, 3 * 64), 1, 0.1, 1.0, ValueError, "empty"),
    ((0, 9, 3 * 64), 1, 0.1, 1.0, ValueError, "empty"),
    ((1, 9, 3 * 64), 1, 0.125, -1.0, ValueError, "positive"),
    ((1, 9, 3 * 64), 1, 0.0, 1.0, ValueError, "positive")])
def test_flash_refuses_what_it_does_not_take(shape, H, scale, temperature, err,
                                             what):
    from ep_tpu_torch.ops.flash_attn import flash_head_dim
    with pytest.raises(err, match=what):
        flash_head_dim(shape, H, scale, temperature)


def test_supercell_is_forward_only():
    """The supercell differentiates on the CPU through the plain versions
    (kernels A, B and E are never launched there), and every input gets a
    finite gradient of its own dtype."""
    D, H = 64, 2
    rng = np.random.default_rng(5)
    ins = [torch.from_numpy(rng.standard_normal(s, np.float32))
           for s in ((1, 5, D), (3 * D, D), (3 * D,), (D,), (D,), (D, D), (D,))]
    ins[0] = ins[0].bfloat16()
    ins = [t.requires_grad_(True) for t in ins]
    reset_launches()
    out = attn_supercell(*ins, H, (D // H) ** -0.5)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and not any(LAUNCHES.values())
    for t in ins:
        assert t.grad is not None and t.grad.dtype == t.dtype
        assert t.grad.shape == t.shape and torch.isfinite(t.grad.float()).all()


def test_port_never_imports_jax():
    """Every ep_tpu_torch module imports without jax, flax or optax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ep_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ep_tpu_torch.__path__,"
        " 'ep_tpu_torch.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "bad = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]\n"
        "assert len(names) >= 15 and not bad, (names, bad)\n")
    subprocess.run([sys.executable, "-c", code], check=True)
