"""The port's initial parameters of every pooling head (through
``ProbeHead.init_weights``, classifier included) and extra against the JAX
package's (``init`` of the flax module), parameter by parameter, at D=384
(multiple of every head count: 12, 16, 8, 4) and 196 patch tokens, where
the sampling error is small:

* the same names (``load_state_dict(strict=True)`` of the converted flax
  tree) and shapes, so the same rank (LARS decides by rank);
* a parameter that flax sets to a constant (zeros, ones, cait's 1e-5) is that
  constant in the port, and so are the BatchNorm running statistics;
* a drawn parameter of more than one element comes from the same family and
  scale: the two samples' deviations agree within six standard errors, and a
  two-sample
  Kolmogorov-Smirnov test does not tell them apart at alpha = 1e-4 (a
  uniform, a normal, flax's cut normal and its rescaled cut normal of the
  same scale are told apart at these sizes).
The draws are seeded on both sides, so the test is deterministic.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from test_torch_zoo_util import EXTRAS, as_np
from ep_tpu.configs import TrainConfig
from ep_tpu.poolings.registry import ProbeHead as FlaxProbeHead
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models.vit import ATTENTIVE_POOLINGS
from ep_tpu_torch.poolings.registry import ProbeHead

D, N = 384, 196


def _compare(flax_state: dict, port_state: dict) -> None:
    assert flax_state.keys() == port_state.keys()
    for k, ref in flax_state.items():
        f = ref.double().flatten().numpy()
        t = port_state[k].detach().double().flatten().numpy()
        assert ref.shape == port_state[k].shape, k
        if f.size == 1:  # one draw (abmilp's last bias): no statistics
            continue
        if f.min() == f.max():
            assert (t == f[0]).all(), (k, f[0], t[:4])
            continue
        n = f.size
        assert abs(t.std() / f.std() - 1) <= 6 / np.sqrt(2 * n), (
            k, t.std(), f.std())
        assert stats.ks_2samp(f, t).pvalue > 1e-4, (k, stats.ks_2samp(f, t))


@pytest.mark.parametrize("name", ATTENTIVE_POOLINGS + ["cls"])
def test_head_init_matches_flax(name):
    cfg = TrainConfig(cls_features=name, ep_queries=32, nb_classes=1000)
    x = jnp.zeros((2, N, D) if name != "cls" else (2, D))
    flax_vars = as_np(FlaxProbeHead(cfg, D, N, dtype=jnp.float32).init(
        jax.random.key(0), x, train=True))
    params, buffers = flax_to_torch(flax_vars, device="cpu")
    head = ProbeHead(PortTrainConfig(**dataclasses.asdict(cfg)), D, N,
                     dtype=torch.float32)
    head.load_state_dict({**params, **buffers}, strict=True)  # the names
    head.init_weights(torch.Generator().manual_seed(0))
    own = {k: v for k, v in head.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    _compare({**params, **{k: v for k, v in buffers.items()
                           if not k.endswith("num_batches_tracked")}}, own)


@pytest.mark.parametrize("name", sorted(EXTRAS))
def test_extra_init_matches_flax(name):
    fcls, pcls, kw = EXTRAS[name]
    kw = {**kw, "dim": D} if "dim" in kw else kw
    flax_vars = as_np(fcls(**kw).init(jax.random.key(0), jnp.ones((2, N, D))))
    params, _ = flax_to_torch(flax_vars, device="cpu")
    pool = pcls(**kw)
    pool.init_weights(torch.Generator().manual_seed(0))
    _compare(params, dict(pool.named_parameters()))
