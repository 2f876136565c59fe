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

DINOv2's hub layout (the port's ``dinov2_config``; ROADMAP's differences
kept on purpose): the port builds the SwiGLU giant at DINOv2's hidden width
and a ``_reg`` tower's position embedding without rows for its registers.
The flax side is given the same model (:func:`hub_twin`,
:func:`hub_variables`): the port's hidden width as its ``mlp_ratio``, and
its position embedding zero at the registers, whose rows
:func:`drop_register_rows` leaves out of what the port loads.

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
PORT_ONLY = ("reg_pos_embed", "rope_base")  # the port's config fields flax's lacks


def flax_cfg(dtype="float32", **kw) -> FlaxViTConfig:
    return FlaxViTConfig(**{**TINY, "attn_impl": "pallas", **kw,
                            "dtype": DT[dtype][0]})


def port_cfg(fcfg, **port):
    """The port's config of the same backbone (``ViTConfig`` or
    ``MAEConfig``), from the flax one; ``port`` sets the fields the flax
    config lacks (``PORT_ONLY``), else they keep their defaults."""
    cls = pmae.MAEConfig if isinstance(fcfg, jmae.MAEConfig) else ViTConfig
    names = {f.name for f in dataclasses.fields(cls)} - {"dtype", *PORT_ONLY}
    dtype = torch.float32 if fcfg.dtype == jnp.float32 else torch.bfloat16
    return cls(**{n: getattr(fcfg, n) for n in names}, dtype=dtype, **port)


def hub_twin(fcfg, pcfg):
    """The flax config ``fcfg`` of the model the port's ``pcfg`` builds: the
    port's MLP hidden width as its ``mlp_ratio`` (DINOv2's SwiGLU width,
    where the JAX package keeps 4 * D). Every other field must be the
    port's already."""
    if isinstance(pcfg, pmae.MAEConfig):
        assert port_cfg(fcfg) == pcfg
        return fcfg
    hidden = int(pcfg.embed_dim * pcfg.mlp_ratio)
    twin = fcfg.replace(mlp_ratio=hidden / fcfg.embed_dim)
    assert int(twin.embed_dim * twin.mlp_ratio) == hidden
    own = {n: getattr(pcfg, n) for n in PORT_ONLY}
    assert port_cfg(twin, **own) == pcfg.replace(mlp_ratio=twin.mlp_ratio)
    return twin


def _register_rows(pcfg):
    """(first row, rows) of the registers in the flax position embedding
    that the port's ``pcfg`` has no rows for, or None."""
    if getattr(pcfg, "reg_pos_embed", True) or not pcfg.reg_tokens:
        return None
    return (1 if pcfg.class_token else 0), pcfg.reg_tokens


def hub_variables(variables, pcfg):
    """flax ``variables`` with the backbone position embedding's register
    rows zeroed where the port's ``pcfg`` has none: the flax model adds no
    position at its registers, as the hub's does not."""
    rows = _register_rows(pcfg)
    if rows is None:
        return variables
    first, n = rows
    params = dict(variables["params"])
    backbone = dict(params["backbone"])
    pos = np.array(backbone["pos_embed"])
    pos[:, first:first + n] = 0
    backbone["pos_embed"] = pos
    params["backbone"] = backbone
    return {**variables, "params": params}


def drop_register_rows(state, pcfg, key="backbone.pos_embed"):
    """A state dict (or gradients) converted from flax, in the port's
    layout: the rows of ``key`` at the registers left out where ``pcfg``
    has none."""
    rows = _register_rows(pcfg)
    if rows is None or key not in state:
        return state
    first, n = rows
    pos = state[key]
    return {**state, key: torch.cat([pos[:, :first], pos[:, first + n:]], 1)}


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


def load_port(module, variables, hub=None):
    """Load flax ``variables`` into a port module, strictly; with ``hub``, the
    port's backbone config, in its layout (:func:`drop_register_rows`)."""
    params, buffers = flax_to_torch(variables, device="cpu")
    state = {**params, **buffers}
    if hub is not None:
        state = drop_register_rows(state, hub)
    module.load_state_dict(state, strict=True)
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
