"""Shared by the pooling-zoo parity tests (``tests/test_torch_poolings*.py``,
``tests/test_torch_all_variants.py``): each head and extra of
``ep_tpu/poolings/`` beside its counterpart in ``ep_tpu_torch/poolings/``,
built with the same arguments, and the helpers that carry one module's flax
variables into the other.

D=48 is the tiny width: 12 (esimpool's fixed heads), 8 (cae, dinovit,
siglip, coca) and 4 (cait, clip, and aim and jepa here) all divide it, so
both packages run their own registry unpatched. N=16 tokens are a 4x4 grid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import ep_tpu.poolings as J
import ep_tpu.poolings.extras as JX
import ep_tpu_torch.poolings.abmilp as P_abmilp
import ep_tpu_torch.poolings.aim as P_aim
import ep_tpu_torch.poolings.cae as P_cae
import ep_tpu_torch.poolings.cait as P_cait
import ep_tpu_torch.poolings.cbam as P_cbam
import ep_tpu_torch.poolings.clip_pool as P_clip
import ep_tpu_torch.poolings.coca as P_coca
import ep_tpu_torch.poolings.dinovit as P_dinovit
import ep_tpu_torch.poolings.dolg as P_dolg
import ep_tpu_torch.poolings.ep as P_ep
import ep_tpu_torch.poolings.extras as PX
import ep_tpu_torch.poolings.jepa as P_jepa
import ep_tpu_torch.poolings.simpool as P_simpool
from ep_tpu_torch.convert.from_flax import flax_to_torch

B, N, D = 4, 16, 48
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# name -> (flax class, port class, arguments, holds BatchNorm state)
HEADS = {
    "simpool": (J.SimPool, P_simpool.SimPool, dict(dim=D), False),
    "esimpool": (J.SimPoolNoLinears, P_simpool.SimPoolNoLinears,
                 dict(dim=D, num_heads=12), False),
    "aim": (J.AIMAttentionPooling, P_aim.AIMAttentionPooling,
            dict(dim=D, num_heads=4), True),
    "cae": (J.CAEAttentiveBlock, P_cae.CAEAttentiveBlock, dict(dim=D), False),
    "cait": (J.CaiTPooling, P_cait.CaiTPooling, dict(embed_dim=D), False),
    "jepa": (J.JEPAAttentivePooler, P_jepa.JEPAAttentivePooler,
             dict(embed_dim=D, num_heads=4), False),
    "clip": (J.CLIPAttentionPool2d, P_clip.CLIPAttentionPool2d,
             dict(in_features=D, feat_size=4), False),
    "siglip": (J.SigLIPAttentionPool, P_clip.SigLIPAttentionPool,
               dict(in_features=D), False),
    "coca": (J.CoCaCrossAttnPooling, P_coca.CoCaCrossAttnPooling,
             dict(dim=D), False),
    "dinovit": (J.DinoViTBlockPooling, P_dinovit.DinoViTBlockPooling,
                dict(d_model=D), False),
    "abmilp": (J.ABMILPHead, P_abmilp.ABMILPHead,
               dict(dim=D, num_patches=N), False),
    "cbam": (J.CbamPooling, P_cbam.CbamPooling, dict(channels=D), True),
    "dolg": (J.DOLGSpatialAttention, P_dolg.DOLGSpatialAttention,
             dict(in_c=D, s3_dim=D), True),
    "ep": (J.EfficientProbing, P_ep.EfficientProbing,
           dict(dim=D, num_queries=4), False),
}
EXTRAS = {
    "lse": (JX.LSEPool, PX.LSEPool, dict()),
    "gem": (JX.GeMPool, PX.GeMPool, dict()),
    "gmp": (JX.GeneralizedMaxPool, PX.GeneralizedMaxPool, dict()),
    "slot": (JX.SlotPooling, PX.SlotPooling, dict(dim=D)),
}


def tokens(seed=0, n=N, dim=D, batch=B, positive=False):
    x = np.random.default_rng(seed).standard_normal((batch, n, dim),
                                                     dtype=np.float32)
    return np.abs(x) + 0.1 if positive else x


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def load_port(module, variables):
    """``module`` with the flax ``variables`` of its counterpart, strictly."""
    params, buffers = flax_to_torch(as_np(variables), device="cpu")
    module.load_state_dict({**params, **buffers}, strict=True)
    return module


def close(a, b, tol, what=""):
    """|a - b| <= tol * (1 + |b|) elementwise, for arrays of any dtype."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)
