"""The pooling zoo's heads (``ep_tpu_torch/poolings/``) against their flax
modules (``ep_tpu/poolings/``) with the same parameters, carried by
``convert/from_flax.py::flax_to_torch`` into ``load_state_dict(strict=True)``,
on the same seeded tokens (B=4, N=16 as a 4x4 grid, D=48; see
``tests/test_torch_zoo_util.py``), in float32:

* the forward (eval mode for the BatchNorm pools) and every parameter's
  gradient of a fixed random projection of the output (train mode for the
  BatchNorm pools), at 1e-5: relative, with an absolute floor of 1e-5 of the
  module's largest gradient for gradients that are zero in exact arithmetic
  (a k bias under the softmax's shift invariance leaves rounding noise);
* the BatchNorm pools (aim, cbam, dolg): the running mean and variance after
  a train-mode forward, and the eval-mode forward that reads them;
* ``return_attn``: the attention maps; cait returns ``(pooled, None)``, where
  the JAX module returns the pooled array alone (a difference kept on
  purpose, ROADMAP §3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_zoo_util import HEADS, as_np, close, load_port, tokens
from ep_tpu_torch.convert.from_flax import flax_to_torch

TOL = 1e-5


def _pair(name, seed=0):
    fcls, pcls, kw, bn = HEADS[name]
    x = tokens(seed)
    fm = fcls(**kw, dtype=jnp.float32)
    v = as_np(fm.init(jax.random.key(seed), jnp.asarray(x),
                      **({"train": True} if bn else {})))
    pm = load_port(pcls(**kw, dtype=torch.float32), v)
    return fm, pm, v, x, bn


@pytest.mark.parametrize("name", sorted(HEADS))
def test_forward_and_gradients_match_flax(name):
    fm, pm, v, x, bn = _pair(name)
    # forward, eval mode
    pm.eval()
    out_j = fm.apply(v, jnp.asarray(x), **({"train": False} if bn else {}))
    out_t = pm(torch.from_numpy(x))
    close(out_t.detach().numpy(), out_j, TOL, "forward")

    # gradients of <out, w>, train mode
    w = np.random.default_rng(5).standard_normal(np.shape(out_j)).astype(
        np.float32)

    def loss_j(params):
        kwargs = {"train": True, "mutable": ["batch_stats"]} if bn else {}
        out = fm.apply({**v, "params": params}, jnp.asarray(x), **kwargs)
        out = out[0] if bn else out
        return jnp.sum(out * w)

    grad_j = jax.jit(jax.grad(loss_j))(v["params"])
    grads_j, _ = flax_to_torch({"params": as_np(grad_j)}, device="cpu")
    pm.train()
    (pm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    grads_t = {k: p.grad for k, p in pm.named_parameters()}
    assert grads_t.keys() == grads_j.keys()
    floor = TOL * max(float(g.abs().max()) for g in grads_j.values())
    for k, g in grads_j.items():
        assert grads_t[k] is not None, k
        np.testing.assert_allclose(grads_t[k].numpy(), g.numpy(), rtol=TOL,
                                   atol=floor, err_msg=k)


@pytest.mark.parametrize("name", ["aim", "cbam", "dolg"])
def test_batchnorm_pools_update_and_read_running_statistics(name):
    fm, pm, v, x, _ = _pair(name)
    _, upd = fm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    pm.train()
    pm(torch.from_numpy(x))
    _, stats = flax_to_torch({"batch_stats": as_np(upd["batch_stats"])},
                             device="cpu")
    state = pm.state_dict()
    assert stats  # every pool here holds one BatchNorm
    for k, ref in stats.items():
        if k.endswith("num_batches_tracked"):
            continue
        # the running statistics moved, and both packages moved them alike
        assert not np.allclose(ref.numpy(), 0.0 if "mean" in k else 1.0)
        close(state[k].numpy(), ref.numpy(), TOL, k)
    # eval mode reads them
    pm.eval()
    out_j = fm.apply({**v, **upd}, jnp.asarray(x), train=False)
    close(pm(torch.from_numpy(x)).detach().numpy(), out_j, TOL, "eval")


@pytest.mark.parametrize("name", sorted(HEADS))
def test_return_attn_matches_flax(name):
    fm, pm, v, x, bn = _pair(name, seed=1)
    pm.eval()
    kwargs = {"train": False} if bn else {}
    got = fm.apply(v, jnp.asarray(x), return_attn=True, **kwargs)
    out_t, attn_t = pm(torch.from_numpy(x), return_attn=True)
    if name == "cait":  # the JAX module ignores the flag
        assert attn_t is None
        close(out_t.detach().numpy(), got, TOL, "pooled")
        return
    out_j, attn_j = got
    close(out_t.detach().numpy(), out_j, TOL, "pooled")
    assert attn_t.dtype == {jnp.float32: torch.float32}[attn_j.dtype.type]
    close(attn_t.detach().numpy(), attn_j, TOL, "attn")
    # the pooled output does not depend on the flag
    close(pm(torch.from_numpy(x)).detach().numpy(), out_j, TOL, "no attn")
