"""The whole probe model with every pooling head: ep_tpu's ProbeModel (flax)
against ep_tpu_torch's with the same weights (``flax_to_torch``), for the 14
``--cls_features`` heads on the patch tokens and the 11 ``_all`` variants on
[CLS] + patch tokens, on a tiny ViT (16 px, patch 4: 16 patch tokens, D=48,
4 heads, depth 1, float32; ``--num_heads 4`` for aim and jepa, 4 EP queries;
esimpool keeps its 12 heads, which divide 48).

* Logits in train mode (batch statistics) and every BatchNorm running
  statistic it updates, then logits in eval mode, at 1e-5; with
  ``return_attn`` and ``return_backbone_features`` the tuple in the JAX
  order, (logits, feats, attn), the map equal.
* An ``_all`` variant's logits differ from its base variant's on the same
  weights: [CLS] reaches the pool.
* ``clip_all``, ``cbam_all`` and ``dolg_all`` raise the JAX package's
  ``ValueError``, as its own registry does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_zoo_util import as_np, close
from ep_tpu.configs import TrainConfig
from ep_tpu.models.assembly import ProbeModel as FlaxProbeModel
from ep_tpu.models.vit import ViTConfig as FlaxViTConfig
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models.assembly import ProbeModel, build_backbone_config
from ep_tpu_torch.models.vit import ATTENTIVE_POOLINGS

IMG, PATCH, D, B, C = 16, 4, 48, 4, 5
TOL = 1e-5
GRID_ALL = ["clip", "cbam", "dolg"]
WORKING_ALL = [n for n in ATTENTIVE_POOLINGS if n not in GRID_ALL]


def _cfg(name):
    return TrainConfig(model="vit_tiny_patch16", cls_features=name,
                       ep_queries=4, d_out=1, nb_classes=C, image_size=IMG,
                       batch_size=B, amp="float32", pallas_pool=False,
                       num_heads=4)


def _port(cfg, variables=None):
    pcfg = PortTrainConfig(**dataclasses.asdict(cfg))
    bcfg = build_backbone_config(pcfg).replace(patch_size=PATCH, embed_dim=D,
                                               depth=1, num_heads=4)
    model = ProbeModel(bcfg, pcfg)
    if variables is not None:
        params, buffers = flax_to_torch(variables, device="cpu")
        model.load_state_dict({**params, **buffers}, strict=True)
    return model


def _flax(cfg):
    return FlaxProbeModel(FlaxViTConfig(
        img_size=IMG, patch_size=PATCH, embed_dim=D, depth=1, num_heads=4,
        dtype=jnp.float32, attn_impl="xla"), cfg)


def _images(seed=0):
    return np.random.default_rng(seed).standard_normal((B, IMG, IMG, 3),
                                                       np.float32)


def _grown_gammas(v):
    """cait's LayerScale gammas at 0.5 instead of their initial 1e-5. At
    1e-5 every image's pooled descriptor is the shared cls token plus 1e-5 of
    its own, so the descriptor BN (train mode, 4 images) divides by a
    deviation 1e5 times under the values and turns float32 rounding into
    1e-3 of the logits; grown gammas, as training grows them, keep the
    comparison at 1e-5."""
    pool = dict(v["params"]["head"]["pool"])
    for k in pool:
        if "_gamma_" in k:
            pool[k] = np.full_like(pool[k], 0.5)
    head = {**v["params"]["head"], "pool": pool}
    return {**v, "params": {**v["params"], "head": head}}


@pytest.mark.parametrize("name", ATTENTIVE_POOLINGS
                         + [f"{n}_all" for n in WORKING_ALL])
def test_probe_model_matches_flax(name):
    cfg = _cfg(name)
    fm = _flax(cfg)
    x = _images()
    v = as_np(fm.init(jax.random.key(0), jnp.asarray(x), train=True))
    if name.startswith("cait"):
        v = _grown_gammas(v)
    tm = _port(cfg, v)

    out_j, upd = fm.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    close(tm.train()(torch.from_numpy(x)).detach().numpy(), out_j, TOL,
          "train logits")
    _, stats = flax_to_torch({"batch_stats": as_np(upd["batch_stats"])},
                             device="cpu")
    state = tm.state_dict()
    for k, ref in stats.items():
        if not k.endswith("num_batches_tracked"):
            close(state[k].numpy(), ref.numpy(), TOL, k)

    tm.eval()
    # the JAX head cannot return cait's (missing) map: ask it for none
    cait = name.startswith("cait")
    got = fm.apply({**v, **upd}, jnp.asarray(x), train=False,
                   return_backbone_features=True, return_attn=not cait)
    logits_j, feats_j, attn_j = (*got, None) if cait else got
    logits_t, feats_t, attn_t = tm(torch.from_numpy(x),
                                   return_backbone_features=True,
                                   return_attn=True)
    close(logits_t.detach().numpy(), logits_j, TOL, "eval logits")
    close(feats_t.numpy(), feats_j, TOL, "features")
    if cait:  # no map: the kept difference (ROADMAP §3)
        assert attn_t is None
    else:
        close(attn_t.detach().numpy(), attn_j, TOL, "attn")
    assert feats_t.shape[1] == 16 + name.endswith("_all")


@pytest.mark.parametrize("name", WORKING_ALL)
def test_all_variant_differs_from_its_base(name):
    x = torch.from_numpy(_images(1))
    model_all = _port(_cfg(f"{name}_all")).eval()
    model_all.reset_parameters(torch.Generator().manual_seed(0))
    model_base = _port(_cfg(name)).eval()
    model_base.load_state_dict(model_all.state_dict(), strict=True)
    with torch.no_grad():
        d = (model_all(x) - model_base(x)).abs().max()
    assert d > 1e-6, f"{name}_all gives {name}'s logits"


@pytest.mark.parametrize("name", GRID_ALL)
def test_grid_all_variants_raise_the_jax_error(name):
    with pytest.raises(ValueError) as port:
        _port(_cfg(f"{name}_all"))
    fm = _flax(_cfg(f"{name}_all"))
    with pytest.raises(ValueError) as jax_err:
        fm.init(jax.random.key(0), jnp.zeros((B, IMG, IMG, 3)), train=True)
    assert str(port.value) == str(jax_err.value)


def test_cait_return_attn_gives_none_where_the_jax_head_breaks():
    """The JAX CaiTPooling ignores ``return_attn`` and its ProbeHead unpacks
    the (B, D) array as a pair: at batch 3 that raises, at batch 2 it would
    split the batch. The port's head returns (logits, None), the contract of
    ``tools/extract_pool_attention.py``."""
    from ep_tpu.poolings.registry import ProbeHead as FlaxProbeHead
    from ep_tpu_torch.poolings.registry import ProbeHead

    cfg = _cfg("cait")
    x = np.random.default_rng(2).standard_normal((3, 16, D)).astype(np.float32)
    head_j = FlaxProbeHead(cfg, D, 16, dtype=jnp.float32)
    v = as_np(head_j.init(jax.random.key(0), jnp.asarray(x), train=True))
    with pytest.raises(ValueError, match="too many values to unpack"):
        head_j.apply(v, jnp.asarray(x), return_attn=True)
    head = ProbeHead(PortTrainConfig(**dataclasses.asdict(cfg)), D, 16,
                     dtype=torch.float32)
    params, buffers = flax_to_torch(v, device="cpu")
    head.load_state_dict({**params, **buffers}, strict=True)
    logits, attn = head.eval()(torch.from_numpy(x), return_attn=True)
    assert attn is None
    close(logits.detach().numpy(), head_j.apply(v, jnp.asarray(x)), TOL,
          "logits")


def test_ep_return_attn_under_the_fused_route_raises(monkeypatch):
    """With EP_TPU_EP_FUSED set the JAX package prints a line and runs its
    plain composition for ``return_attn``; the port raises, as it does for
    ``qkv_bias`` (the fused kernel G computes no map)."""
    model = _port(_cfg("ep"))
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images())
    logits, attn = model.eval()(x, return_attn=True)
    assert attn.shape == (B, 4, 16)
    monkeypatch.setenv("EP_TPU_EP_FUSED", "1")
    torch.testing.assert_close(model(x), logits, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="return_attn"):
        model(x, return_attn=True)
