"""Shared by the backbone-family parity tests (``tests/test_torch_backbones.py``,
``tests/test_torch_features.py``, ``tests/test_torch_convert_variants.py``,
``tests/test_torch_model.py``): a flax module of ``ep_tpu/models/`` and its
counterpart of ``ep_tpu_torch/models/`` built from one configuration, with
the flax weights drawn from a numpy seed and carried across by
``convert/from_flax.py``.

Tiny sizes: D=64, 2 heads of width 32, depth 2, 32 px images with patch 8 (a
4x4 grid, N=16). The flax side takes its kernel path (the supercell and the
fused attention in interpret mode, ``attn_impl="pallas"``), whose cast
points the port's plain versions keep.

Weights: flax initialises LayerScale at a constant and registers, rel-pos
tables and q/v biases at zero, which would leave those paths untested; every
leaf is redrawn: LayerNorm scales 1 + 0.1 n, LayerScale 0.5 + 0.1 n, dense
and conv kernels n / sqrt(fan-in), the rest 0.1 n.

Tolerances: float32 at 1e-5 (the suite's parity bar). In bfloat16 both
sides round at the same points, but a few products round once where flax
rounds twice (the product, then the bias add) and sums run in another order;
one bf16 step (2**-8) taken early moves through two blocks, so features and
logits agree within 2**-5 of their largest magnitude (3e-2, as in
``test_torch_model.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ep_tpu.models import mae as jmae
from ep_tpu.models.vit import ViTConfig as FlaxViTConfig
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models import mae as pmae
from ep_tpu_torch.models.vit import ViTConfig

IMG, PATCH, D, DEPTH, HEADS, B = 32, 8, 64, 2, 2, 4
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -5
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TINY = dict(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
            num_heads=HEADS)


def flax_cfg(dtype="float32", **kw) -> FlaxViTConfig:
    return FlaxViTConfig(**{**TINY, "attn_impl": "pallas", **kw,
                            "dtype": DT[dtype][0]})


def port_cfg(fcfg):
    """The port's config of the same backbone (``ViTConfig`` or
    ``MAEConfig``), from the flax one."""
    cls = pmae.MAEConfig if isinstance(fcfg, jmae.MAEConfig) else ViTConfig
    names = {f.name for f in dataclasses.fields(cls)} - {"dtype"}
    dtype = torch.float32 if fcfg.dtype == jnp.float32 else torch.bfloat16
    return cls(**{n: getattr(fcfg, n) for n in names}, dtype=dtype)


def images(seed=0, n=B, size=IMG):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3),
                                                       np.float32)


def redraw(tree, seed=0):
    """Every leaf of a flax parameter tree drawn anew from a numpy seed."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(a.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * n
        if name.startswith("gamma"):
            return 0.5 + 0.1 * n
        if name == "kernel":
            return n / np.float32(np.sqrt(np.prod(a.shape[:-1])))
        return np.float32(0.1) * n
    return jax.tree_util.tree_map_with_path(leaf, tree)


def redraw_backbone(variables, seed=0, keys=("backbone", "oracle")):
    """``variables`` with the backbone's (and the oracle's) parameters
    redrawn, as numpy arrays."""
    v = jax.tree_util.tree_map(np.asarray, variables)
    params = dict(v["params"])
    for i, k in enumerate(keys):
        if k in params:
            params[k] = redraw(params[k], seed + i)
    return {**v, "params": params}


def load_port(module, variables):
    """Load flax ``variables`` into a port module, strictly."""
    params, buffers = flax_to_torch(variables, device="cpu")
    module.load_state_dict({**params, **buffers}, strict=True)
    return module


def close(out_t, out_j, dtype, what=""):
    a = out_t.detach().float().numpy()
    b = np.asarray(jnp.asarray(out_j, jnp.float32))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=BF16_TOL * float(np.abs(b).max()),
                                   err_msg=what)
