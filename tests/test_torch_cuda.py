"""ep_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped without a CUDA device. On a machine with one card
(and no jax), run them with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: both sides round to bf16 at the same points; the f32 sums run in
another order, which can move a value across one bf16 rounding boundary, so
|kernel - plain| <= 1e-2 + 1e-2*|plain| (about two bf16 steps at unit size).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dev, scale=1.0, dtype=torch.bfloat16, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a * scale).to(dev, dtype)


@pytest.mark.parametrize("B, T, H, Dh", [
    (2, 197, 12, 64), (3, 5, 2, 64), (1, 64, 1, 64), (2, 100, 3, 64),
    (1, 256, 2, 64), (2, 257, 16, 80), (3, 9, 8, 80), (1, 272, 2, 80)])
def test_attn_core(dev, B, T, H, Dh):
    from ep_tpu_torch.ops.attn_fused import (attention_qkv_fused,
                                             attention_qkv_fused_ref)
    qkv = _rand((B, T, 3 * H * Dh), dev)
    torch.testing.assert_close(attention_qkv_fused(qkv, H, Dh ** -0.5, 1.5),
                               attention_qkv_fused_ref(qkv, H, Dh ** -0.5, 1.5),
                               **TOL)


@pytest.mark.parametrize("B, T, H, Dh", [
    (2, 197, 12, 64), (3, 5, 2, 64), (1, 300, 1, 64), (2, 257, 16, 80),
    (3, 9, 8, 80), (1, 320, 2, 80)])
def test_attn_core_bwd(dev, B, T, H, Dh):
    """Kernel E against the plain backward, and through autograd. dq and dk
    sum T products of a bf16-rounded dL, so the absolute bound is taken at
    the output's largest magnitude."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.attn_fused import (attention_qkv_fused,
                                             attention_qkv_fused_bwd,
                                             attention_qkv_fused_bwd_ref)
    qkv = _rand((B, T, 3 * H * Dh), dev)
    g = _rand((B, T, H * Dh), dev, seed=1)
    ref = attention_qkv_fused_bwd_ref(qkv, g, H, Dh ** -0.5, 1.5)
    out = attention_qkv_fused_bwd(qkv, g, H, Dh ** -0.5, 1.5)
    scale = float(ref.float().abs().max())
    torch.testing.assert_close(out, ref, rtol=1e-2, atol=1e-2 * scale)
    if T > 272:  # past kernel B's register tile: E alone
        return
    reset_launches()
    x = qkv.clone().requires_grad_(True)
    attention_qkv_fused(x, H, Dh ** -0.5, 1.5).backward(g)
    assert LAUNCHES["attn_core_bwd"] == 1 and LAUNCHES["attn_core"] == 1
    torch.testing.assert_close(x.grad, out, rtol=0, atol=0)


@pytest.mark.parametrize("B, T, D", [(2, 197, 768), (3, 7, 192)])
def test_supercell_and_its_gemms(dev, B, T, D):
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.attn_block import attn_supercell, attn_supercell_ref
    x = _rand((B, T, D), dev, seed=1)
    args = (x, _rand((3 * D, D), dev, D ** -0.5, seed=2),
            _rand((3 * D,), dev, 0.02, torch.float32, seed=3),
            1 + _rand((D,), dev, 0.1, torch.float32, seed=4),
            _rand((D,), dev, 0.1, torch.float32, seed=5),
            _rand((D, D), dev, D ** -0.5, seed=6),
            _rand((D,), dev, 0.02, torch.float32, seed=7), D // 64, 0.125)
    reset_launches()
    out = attn_supercell(*args)
    assert dict(LAUNCHES) == {"ln_qkv_gemm": 1, "attn_core": 1,
                              "proj_residual_gemm": 1, "ep_pool": 0,
                              "attn_core_bwd": 0}
    torch.testing.assert_close(out, attn_supercell_ref(*args), **TOL)


@pytest.mark.parametrize("B, T, D, H", [(2, 197, 768, 12), (2, 257, 1280, 16)])
def test_supercell_gradients(dev, B, T, D, H):
    """The supercell's backward (A and B recomputed, E, plain products)
    against autograd of its plain version on the card; the weights are f32
    masters as in fine-tuning. Each gradient within 2e-2 of its largest
    magnitude: the products round to bf16 at the same points, in another
    summation order."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.attn_block import attn_supercell, attn_supercell_ref
    ins = [_rand((B, T, D), dev, seed=11),
           _rand((3 * D, D), dev, D ** -0.5, torch.float32, seed=12),
           _rand((3 * D,), dev, 0.02, torch.float32, seed=13),
           1 + _rand((D,), dev, 0.1, torch.float32, seed=14),
           _rand((D,), dev, 0.1, torch.float32, seed=15),
           _rand((D, D), dev, D ** -0.5, torch.float32, seed=16),
           _rand((D,), dev, 0.02, torch.float32, seed=17)]
    g = _rand((B, T, D), dev, seed=18)
    grads = []
    for fn in (attn_supercell, attn_supercell_ref):
        xs = [t.clone().requires_grad_(True) for t in ins]
        reset_launches()
        fn(*xs, H, (D // H) ** -0.5).backward(g)
        grads.append([t.grad for t in xs])
        if fn is attn_supercell:
            assert dict(LAUNCHES) == {"ln_qkv_gemm": 2, "attn_core": 2,
                                      "proj_residual_gemm": 1, "ep_pool": 0,
                                      "attn_core_bwd": 1}
    for a, b in zip(*grads):
        assert a.dtype == b.dtype
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.parametrize("B, N, C, Q", [(4, 196, 768, 32), (3, 37, 128, 4)])
def test_ep_pool_forward_and_grad(dev, B, N, C, Q):
    from ep_tpu_torch.ops.pool_attn import ep_pool_attend, ep_pool_attend_ref
    q = _rand((Q, C), dev, C ** -0.5, seed=8)
    x = _rand((B, N + 1, C), dev, seed=9)[:, 1:]
    v = _rand((B, N, Q, C // Q), dev, seed=10)
    outs, grads = [], []
    for fn in (ep_pool_attend, ep_pool_attend_ref):
        qg, vg = q.clone().requires_grad_(), v.clone().requires_grad_()
        out = fn(qg, x, vg)
        (out.float() ** 2).sum().backward()
        outs.append(out)
        grads.append((qg.grad, vg.grad))
    torch.testing.assert_close(outs[0], outs[1], **TOL)
    for a, b in zip(*grads):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a, b, rtol=1e-2, atol=1e-2 * scale)


def test_kernels_refuse_what_they_do_not_take(dev):
    from ep_tpu_torch.ops.attn_fused import attention_qkv_fused
    with pytest.raises(TypeError):
        attention_qkv_fused(_rand((1, 5, 3 * 64), dev, dtype=torch.float32), 1,
                            0.125)
    from ep_tpu_torch.ops.attn_fused import attention_qkv_fused_bwd
    with pytest.raises(NotImplementedError, match="head width"):
        attention_qkv_fused(_rand((1, 5, 3 * 64), dev), 2, 0.125)
    with pytest.raises(NotImplementedError, match="T=273"):
        attention_qkv_fused(_rand((1, 273, 3 * 80), dev), 1, 0.125)
    with pytest.raises(ValueError):
        attention_qkv_fused(_rand((1, 3 * 64, 5), dev).transpose(1, 2), 1, 0.125)
    with pytest.raises(NotImplementedError, match="head width 32"):
        attention_qkv_fused_bwd(_rand((1, 5, 3 * 64), dev),
                                _rand((1, 5, 64), dev), 2, 0.125)
    with pytest.raises(NotImplementedError, match="T=321"):
        attention_qkv_fused_bwd(_rand((1, 321, 3 * 80), dev),
                                _rand((1, 321, 80), dev), 1, 0.125)
