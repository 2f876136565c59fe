"""The pooling zoo in bfloat16, the four extras, abmilp's options and the two
attention helpers, against the JAX package on the CPU (the shapes of
``tests/test_torch_zoo_util.py``).

* bf16: every head and extra on the same bf16 tokens with the same f32
  parameters, the JAX side compiled without XLA's excess precision (so that
  each cast to bf16 it asks for is a rounding; ROADMAP §3's trap). Both sides
  round at the same points; the port's dense layers add the bias inside the
  product and round once where flax rounds the product and then the sum, and
  sums run in another order. So outputs agree within 2**-6 (two bf16 steps)
  of their largest magnitude; measured: eight heads equal bit for bit, the
  rest 1.0e-3 to 6.3e-3.
* The extras (LSE, GeM, generalized max, slot attention), which no
  ``--cls_features`` name reaches: float32 forward and every gradient at
  1e-5, their 0-d parameters kept 0-d.
* abmilp's options (``--abmilp_sa none/map``, ``relu``, depth 3,
  ``--abmilp_cond pe`` with ``--abmilp_content all`` and ``patch`` on [CLS] +
  patch tokens): float32 at 1e-5.
* ``pooled_mha`` and ``ops/attention.py::mha`` with ``return_probs``:
  float32 at 1e-5, and bf16 equal within one bf16 step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ep_tpu.ops.attention as jax_attention
import ep_tpu.poolings.common as jax_common
from test_torch_zoo_util import (D, EXTRAS, HEADS, N, as_np, close, load_port,
                                 tokens)
from ep_tpu.poolings.abmilp import ABMILPHead as FlaxABMILP
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.ops.attention import mha
from ep_tpu_torch.poolings.abmilp import ABMILPHead
from ep_tpu_torch.poolings.common import pooled_mha

TOL = 1e-5
BF16_BOUND = 2.0 ** -6
_NO_DTYPE = ("lse", "gem", "gmp")  # f32 throughout, no dtype argument


def _strict(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _build(name):
    if name in HEADS:
        fcls, pcls, kw, bn = HEADS[name]
    else:
        (fcls, pcls, kw), bn = EXTRAS[name], False

    def make(cls, dtype):
        return cls(**kw) if name in _NO_DTYPE else cls(**kw, dtype=dtype)
    return make, fcls, pcls, bn


@pytest.mark.parametrize("name", sorted(HEADS) + sorted(EXTRAS))
def test_bf16_forward_matches_flax(name):
    make, fcls, pcls, bn = _build(name)
    x = tokens(2, positive=name == "gem")
    v = as_np(make(fcls, jnp.float32).init(
        jax.random.key(2), jnp.asarray(x), **({"train": True} if bn else {})))
    fm = make(fcls, jnp.bfloat16)
    kwargs = {"train": False} if bn else {}
    xb = jnp.asarray(x, jnp.bfloat16)
    out_j = np.asarray(_strict(lambda v_, x_: fm.apply(v_, x_, **kwargs), v, xb),
                       np.float32)
    pm = load_port(make(pcls, torch.bfloat16), v).eval()
    out_t = pm(torch.from_numpy(x).bfloat16())
    if name not in _NO_DTYPE:
        assert out_t.dtype == torch.bfloat16
    d = np.abs(out_t.detach().float().numpy() - out_j).max()
    assert d <= BF16_BOUND * np.abs(out_j).max(), (d, np.abs(out_j).max())


@pytest.mark.parametrize("name", sorted(EXTRAS))
def test_extras_match_flax(name):
    make, fcls, pcls, _ = _build(name)
    x = tokens(3, positive=name == "gem")
    fm = make(fcls, jnp.float32)
    v = as_np(fm.init(jax.random.key(3), jnp.asarray(x)))
    pm = load_port(make(pcls, torch.float32), v)
    out_j = fm.apply(v, jnp.asarray(x))
    out_t = pm(torch.from_numpy(x))
    close(out_t.detach().numpy(), out_j, TOL, "forward")
    if name in ("lse", "gem"):  # r and p are 0-d, as in flax
        assert [p.ndim for p in pm.parameters()] == [0]
    if not v.get("params"):
        return
    w = np.random.default_rng(6).standard_normal(np.shape(out_j)).astype(
        np.float32)
    grad_j = jax.jit(jax.grad(lambda p: jnp.sum(
        fm.apply({"params": p}, jnp.asarray(x)) * w)))(v["params"])
    grads_j, _ = flax_to_torch({"params": as_np(grad_j)}, device="cpu")
    (out_t * torch.from_numpy(w)).sum().backward()
    floor = TOL * max(float(g.abs().max()) for g in grads_j.values())
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads_j[k].numpy(),
                                   rtol=TOL, atol=floor, err_msg=k)


@pytest.mark.parametrize("kw, cls_row", [
    (dict(self_attention_apply_to="none"), False),
    (dict(self_attention_apply_to="map", activation="relu"), False),
    (dict(depth=3), False),
    (dict(cond="pe"), True),  # [CLS] + patch tokens: the pe has a [CLS] row
    (dict(cond="pe", content="patch"), True),  # the first token dropped
])
def test_abmilp_options_match_flax(kw, cls_row):
    x = tokens(4, n=N + cls_row)
    fm = FlaxABMILP(dim=D, num_patches=N, dtype=jnp.float32, **kw)
    v = as_np(fm.init(jax.random.key(4), jnp.asarray(x)))
    pm = load_port(ABMILPHead(dim=D, num_patches=N, dtype=torch.float32, **kw),
                   v)
    out_j, attn_j = fm.apply(v, jnp.asarray(x), return_attn=True)
    out_t, attn_t = pm(torch.from_numpy(x), return_attn=True)
    close(out_t.detach().numpy(), out_j, TOL, "forward")
    close(attn_t.detach().numpy(), attn_j, TOL, "attn")


@pytest.mark.parametrize("scale_after", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pooled_mha_matches_jax(scale_after, dtype):
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 2, D), (3, N, D), (3, N, D)))
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    out_j, attn_j = jax_common.pooled_mha(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), 4, 0.3, scale_after)
    out_t, attn_t = pooled_mha(*(torch.from_numpy(a).to(tdt)
                                 for a in (q, k, v)), 4, 0.3, scale_after)
    assert out_t.dtype == tdt and attn_t.dtype == torch.float32
    tol = TOL if dtype == "float32" else 2.0 ** -8
    close(out_t.float().numpy(), np.asarray(out_j, np.float32), tol, "out")
    close(attn_t.numpy(), attn_j, tol, "attn")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_matches_jax(dtype):
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, 3, N, 8)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((1, 3, N, N)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    out_j, probs_j = jax_attention.mha(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), 0.35, temperature=1.5,
        bias=jnp.asarray(bias), return_probs=True)
    out_t, probs_t = mha(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                         0.35, temperature=1.5, bias=torch.from_numpy(bias),
                         return_probs=True)
    tol = TOL if dtype == "float32" else 2.0 ** -8
    close(out_t.float().numpy(), np.asarray(out_j, np.float32), tol, "out")
    close(probs_t.numpy(), probs_j, tol, "probs")
