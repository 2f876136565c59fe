"""LayerScale and the residual (``ops/layerscale.py``) on the CPU.

The kernel runs only on the card (its bits against the chain are
tests/test_torch_cuda.py's); here the route's predicate over every input it
reads, the plain version against the chain a LayerScale block ran before it
and against the kernel's rounding points, that CPU tensors never launch,
and that a LayerScale block gives the bits and gradients it gave before.
"""
import itertools

import pytest
import torch

import ep_tpu_torch.models.vit as pvit
from ep_tpu_torch.models.vit import Block, ViTConfig, layer_norm
from ep_tpu_torch.ops import LAUNCHES, reset_launches
from ep_tpu_torch.ops.layerscale import (MAX_D, ls_residual, ls_residual_ref,
                                         takes_ls_kernel)

BF16, F32 = torch.bfloat16, torch.float32


class _On:
    """A CPU tensor that reports another device: what the predicate reads of
    a tensor on a card this host lacks."""

    def __init__(self, t: torch.Tensor, device: str):
        self._t, self.device = t, torch.device(device)

    def __getattr__(self, name):
        return getattr(self._t, name)


def _inputs(device="cuda", dtypes=(BF16, BF16), shape=(6, 16),
            gamma_dtype=F32, needs=()):
    x = torch.randn(shape).to(dtypes[0]).requires_grad_("x" in needs)
    y = torch.randn(shape).to(dtypes[1]).requires_grad_("y" in needs)
    gamma = torch.rand(shape[-1]).to(gamma_dtype).requires_grad_(
        "gamma" in needs)
    return [_On(t, device) for t in (x, y, gamma)]


ROUTE_INPUTS = list(itertools.product(
    ("cuda", "cpu"), ((BF16, BF16), (F32, F32), (BF16, F32), (F32, BF16)),
    (False, True), ((), ("x",), ("y",), ("gamma",))))


@pytest.mark.parametrize("device, dtypes, grad_mode, needs", ROUTE_INPUTS)
def test_route_predicate(device, dtypes, grad_mode, needs):
    """The kernel for CUDA bf16 x and y, where grad mode is off or none of
    x, y and gamma requires a gradient; every other combination keeps the
    chain."""
    x, y, gamma = _inputs(device, dtypes, needs=needs)
    want = (device == "cuda" and dtypes == (BF16, BF16)
            and not (grad_mode and needs))
    with torch.set_grad_enabled(grad_mode):
        assert takes_ls_kernel(x, y, gamma) is want


def _misaligned(shape):
    """A bf16 tensor of ``shape`` that starts 8 bytes past an aligned one."""
    n = torch.Size(shape).numel()
    return torch.randn(n + 4).to(BF16)[4:].view(shape)


SHAPE_CASES = {
    "rows of 16": (lambda x, y, g: (x, y, g), True),
    "3-d rows": (lambda x, y, g: (x.view(2, 3, 16), y.view(2, 3, 16), g),
                 True),
    "bf16 gamma": (lambda x, y, g: (x, y, g.to(BF16)), True),
    "D % 8": (lambda x, y, g: (x[:, :12].contiguous(), y[:, :12].contiguous(),
                               g[:12]), False),
    "other shapes": (lambda x, y, g: (x, y[:5], g), False),
    "y transposed": (lambda x, y, g: (x, y.view(16, 6).t(), g), False),
    "x transposed": (lambda x, y, g: (x.view(16, 6).t(), y, g), False),
    "x misaligned": (lambda x, y, g: (_misaligned(x.shape), y, g), False),
    "gamma of another width": (lambda x, y, g: (x, y, g[:8]), False),
    "gamma strided": (lambda x, y, g: (x, y, torch.rand(32)[::2]), False),
    "gamma f16": (lambda x, y, g: (x, y, g.half()), False),
    "wider than MAX_D": (lambda x, y, g: (
        torch.zeros(2, MAX_D + 8, dtype=BF16),
        torch.zeros(2, MAX_D + 8, dtype=BF16), torch.ones(MAX_D + 8)), False),
}


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_route_predicate_shapes(case):
    """Of bf16 card tensors without a gradient, the kernel takes one shape,
    contiguous and 16-byte aligned, rows of D % 8 == 0 (at most MAX_D), and
    a contiguous (D,) gamma in f32 or bf16."""
    make, want = SHAPE_CASES[case]
    x, y, gamma = (torch.randn(6, 16).to(BF16), torch.randn(6, 16).to(BF16),
                   torch.rand(16))
    args = [_On(t, "cuda") for t in make(x, y, gamma)]
    assert takes_ls_kernel(*args) is want


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("gamma_dtype", [F32, BF16])
def test_plain_version_is_the_old_chain(dtype, gamma_dtype):
    """``ls_residual_ref`` equals ``x + LayerScale(y)`` as the block computed
    it (the product in y's dtype, then the add) bit for bit; in bf16 also
    the kernel's rounding points: bf16(x + bf16(y * bf16(gamma))) in f32."""
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(7, 9, 48, generator=g) * 4).to(dtype)
    y = (torch.randn(7, 9, 48, generator=g) * 4).to(dtype)
    gamma = (torch.randn(48, generator=g) * 3).to(gamma_dtype)
    got = ls_residual_ref(x, y, gamma)
    old = x + y * gamma.to(y.dtype)
    assert got.dtype == dtype and torch.equal(got, old)
    if dtype == BF16:
        p = (y.float() * gamma.to(BF16).float()).to(BF16).float()
        assert torch.equal(got, (x.float() + p).to(BF16))


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_tensors_take_the_chain(grad):
    """``ls_residual`` on CPU tensors is the chain, with or without a
    gradient, and launches nothing; y is left as it was."""
    x, y = torch.randn(4, 3, 24).to(BF16), torch.randn(4, 3, 24).to(BF16)
    gamma = torch.rand(24, requires_grad=grad)
    y0 = y.clone()
    reset_launches()
    with torch.set_grad_enabled(grad):
        got = ls_residual(x, y, gamma)
    assert LAUNCHES["ls_residual"] == 0
    assert torch.equal(got, ls_residual_ref(x, y, gamma))
    assert torch.equal(y, y0) and got.requires_grad is grad


def _old_block(blk, x):
    """The block as it ran before the closing had its own pass: LayerScale
    as ``y * gamma.to(y.dtype)``, then ``x + y``, in each half."""
    y = blk.attn(layer_norm(x, blk.norm1), 1.0, None, False, None)
    x = x + y * blk.ls1.gamma.to(y.dtype)
    m = blk.mlp(layer_norm(x, blk.norm2))
    return x + m * blk.ls2.gamma.to(m.dtype)


@pytest.mark.parametrize("mlp_type", ["gelu", "swiglu"])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_layerscale_block_bits_and_gradients(mlp_type, dtype):
    """A DINOv2-style block (LayerScale at random gammas, GELU or SwiGLU) on
    the CPU: the output and every gradient (input, gammas, weights) equal
    the old chain's bit for bit; no launch."""
    torch.manual_seed(0)
    cfg = ViTConfig(embed_dim=64, depth=1, num_heads=4, init_values=1.0,
                    mlp_type=mlp_type, dtype=dtype)
    blk = Block(cfg)
    with torch.no_grad():
        blk.ls1.gamma.normal_(1.0, 0.3)
        blk.ls2.gamma.normal_(0.5, 0.3)
    x = torch.randn(2, 7, 64)
    outs, grads = [], []
    reset_launches()
    for run in (blk, lambda t: _old_block(blk, t)):
        blk.zero_grad()
        xi = x.clone().requires_grad_(True)
        out = run(xi)
        out.float().square().sum().backward()
        outs.append(out.detach())
        grads.append([xi.grad] + [p.grad for p in blk.parameters()])
    assert LAUNCHES["ls_residual"] == 0
    assert torch.equal(*outs)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_block_asks_the_route_with_the_branch_and_the_stream(monkeypatch):
    """Each half hands the predicate the residual stream, its branch before
    LayerScale and its own gamma; with the route taken, the block calls the
    kernel's entry (the chain on CPU tensors) and gives the same bits. A
    block without LayerScale never asks."""
    torch.manual_seed(1)
    blk = Block(ViTConfig(embed_dim=32, depth=1, num_heads=2,
                          init_values=0.5))
    x = torch.randn(2, 5, 32)
    asked, entered = [], []
    monkeypatch.setattr(pvit, "takes_ls_kernel",
                        lambda *a: asked.append(a) or True)
    monkeypatch.setattr(pvit, "ls_residual",
                        lambda *a: entered.append(a) or ls_residual(*a))
    with torch.no_grad():
        out = blk(x)
        _, _, branch = blk.capture(x)
        want = _old_block(blk, x)
    assert torch.equal(out, want)
    assert len(asked) == 4 and entered == asked
    (x0, y0, g0), (x1, y1, g1) = asked[:2]
    assert x0 is x and g0 is blk.ls1.gamma and g1 is blk.ls2.gamma
    assert torch.equal(y0, asked[2][1]) and torch.equal(asked[2][1], branch)
    assert torch.equal(x1, x + y0 * blk.ls1.gamma)
    asked.clear()
    plain = Block(ViTConfig(embed_dim=32, depth=1, num_heads=2))
    with torch.no_grad():
        plain(x)
    assert asked == []
