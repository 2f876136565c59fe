"""The MLP half's fc1 + GELU route (``ops/fc1_gelu.py``) on the CPU.

The epilogue route runs only on the card (its arithmetic is
tests/test_torch_cuda.py's); here the route's predicate over every input it
reads, and that a CPU model never takes it: the counter stays 0 and the MLP
is exactly ``fc2(gelu(fc1(x)))``, the route the JAX parity tests hold.
"""
import itertools

import pytest
import torch
import torch.nn.functional as F

import ep_tpu_torch.models.vit as pvit
from ep_tpu_torch.models.vit import Mlp, ViTConfig, VisionTransformer
from ep_tpu_torch.ops import LAUNCHES, reset_launches
from ep_tpu_torch.ops.fc1_gelu import takes_gelu_epilogue

ROUTE_INPUTS = list(itertools.product(
    ("cuda", "cpu"), (torch.bfloat16, torch.float32), ("gelu", "quick_gelu"),
    (False, True), (False, True)))


@pytest.mark.parametrize("device, dtype, act, cut, needs_grad", ROUTE_INPUTS)
def test_route_predicate(device, dtype, act, cut, needs_grad):
    """The epilogue on the card, in bf16, for GELU, in a whole block, where
    no gradient is needed; every other combination keeps the old route."""
    want = (device, dtype, act, cut, needs_grad) == (
        "cuda", torch.bfloat16, "gelu", False, False)
    assert takes_gelu_epilogue(torch.device(device), dtype, act, cut,
                               needs_grad) is want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_mlp_asks_the_route_what_it_reads(monkeypatch, dtype, act):
    """``Mlp`` hands the predicate the input's device, the compute dtype,
    the activation, whether it is cut and whether autograd needs the
    gradient: not under ``no_grad``, yes for an input or a weight that
    requires one."""
    asked = []
    monkeypatch.setattr(pvit, "takes_gelu_epilogue",
                        lambda *a: asked.append(a) or False)
    mlp = Mlp(16, 64, dtype, act=act)
    x = torch.randn(2, 3, 16)
    with torch.no_grad():
        mlp(x)
    mlp(x)  # the weights require gradients
    mlp.requires_grad_(False)
    mlp(x)
    mlp(x.requires_grad_())
    cpu = torch.device("cpu")
    assert asked == [(cpu, dtype, act, False, False),
                     (cpu, dtype, act, False, True),
                     (cpu, dtype, act, False, False),
                     (cpu, dtype, act, False, True)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grad", [False, True])
def test_cpu_mlp_keeps_the_plain_route(dtype, grad):
    """On the CPU the counter stays 0 and the MLP is fc2(gelu(fc1(x))) bit
    for bit, the tanh GELU in bf16 and the exact one in f32."""
    torch.manual_seed(0)
    mlp = Mlp(16, 64, dtype)
    mlp.requires_grad_(grad)
    x = torch.randn(2, 3, 16)
    approximate = "tanh" if dtype == torch.bfloat16 else "none"
    reset_launches()
    with torch.set_grad_enabled(grad):
        got = mlp(x)
    assert LAUNCHES["fc1_gelu_epilogue"] == 0
    with torch.no_grad():
        want = mlp.fc2(F.gelu(mlp.fc1(x), approximate=approximate))
    assert torch.equal(got.detach(), want)


def test_cpu_vit_forward_never_takes_the_epilogue():
    """A bf16 ViT's forward under ``no_grad`` on the CPU (a frozen encoder,
    as the probe runs it on the card) launches no epilogue."""
    torch.manual_seed(0)
    vit = VisionTransformer(ViTConfig(img_size=32, embed_dim=64, depth=2,
                                      num_heads=2))
    reset_launches()
    with torch.no_grad():
        vit(torch.randn(2, 32, 32, 3))
    assert LAUNCHES["fc1_gelu_epilogue"] == 0
