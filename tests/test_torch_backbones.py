"""Each backbone family of the port against the flax module with the same
weights: DINOv2 with registers and LayerScale, its SwiGLU giant, CAPI (no
[CLS], the register mean), OpenCLIP (openai's QuickGELU and laion's GELU,
ln_pre, ln_post, the cls projection), SimMIM (shared and per-block
relative-position bias, ``qv_only`` bias) and MAE (the latent, and the loss
at mask ratio 0.75 from the same noise); fine-tuning gradients of a
LayerScale backbone under each remat policy; the new parameters' initial
draws; and which route each family's blocks take.

Every family is built by ``build_backbone_config`` from a ``TrainConfig`` on
both sides and cut to the tiny size of ``test_torch_backbone_util.py``
(widths, depth and grid; the family's own switches kept); its tolerances
hold here (f32 at 1e-5, bf16 within 2**-5 of the largest magnitude).

MAE's encoder takes the flax side's XLA attention (``MAEConfig.encoder_vit``
leaves ``attn_impl="xla"``) and the port's supercell: the same function with
the softmax scale applied to q before its product on one side and to the
logits on the other, which agree at both tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_backbone_util import (B, DEPTH, D, HEADS, IMG, PATCH, close,
                                      drop_register_rows, hub_twin,
                                      hub_variables, images, load_port,
                                      port_cfg, redraw, redraw_backbone)
from ep_tpu.configs import TrainConfig
from ep_tpu.models import mae as jmae
from ep_tpu.models.assembly import (ProbeModel as FlaxProbeModel,
                                    build_backbone_config as
                                    jax_build_backbone_config)
from ep_tpu.train import steps as jax_steps
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.models import mae as pmae
from ep_tpu_torch.models.assembly import (ProbeModel, build_backbone_config,
                                          init_probe_model)
from ep_tpu_torch.models.vit import int8_mlp_inactive_reason
from ep_tpu_torch.train.steps import cross_entropy

C = 5
TINY_MAE = dict(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
                num_heads=HEADS, decoder_embed_dim=32, decoder_depth=1,
                decoder_num_heads=2)
FAMILIES = {
    "dinov2_vitb14_reg": dict(model="dinov2_vitb14_reg"),
    "dinov2_vitg14": dict(model="dinov2_vitg14"),
    "capi_vitl14": dict(model="capi_vitl14"),
    "openclip_openai": dict(model="ViT-B-16", openclip=True),
    "openclip_laion": dict(model="ViT-B-16", openclip=True,
                           openclip_pretrain="laion2b_s34b_b88k"),
    "simmim": dict(simmim=True),
    "mae_vit_base_patch16": dict(model="mae_vit_base_patch16"),
}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")


def _cfg(amp="float32", **kw):
    return TrainConfig(**{**dict(
        model="vit_tiny_patch16", cls_features="ep", ep_queries=4, d_out=1,
        nb_classes=C, image_size=IMG, amp=amp, batch_size=B,
        eff_batch_size=B), **kw})


def tiny(bcfg, **kw):
    """A family's config cut to the tiny size, its switches kept; the flax
    side on its kernel path."""
    if isinstance(bcfg, (jmae.MAEConfig, pmae.MAEConfig)):
        return dataclasses.replace(bcfg, **TINY_MAE)
    extra = {"attn_impl": "pallas"} if hasattr(bcfg, "attn_impl") else {}
    if bcfg.proj_dim:
        extra["proj_dim"] = 32
    return bcfg.replace(img_size=IMG, patch_size=PATCH, embed_dim=D,
                        depth=DEPTH, num_heads=HEADS, **extra, **kw)


def models(cfg, seed=0, **kw):
    """(flax model, its variables with redrawn backbone weights, the port's
    model with them). The flax model is the port's: DINOv2 in the hub's
    layout (``hub_twin``, ``hub_variables``)."""
    pcfg = PortTrainConfig(**dataclasses.asdict(cfg))
    pbcfg = tiny(build_backbone_config(pcfg), **kw)
    fcfg = hub_twin(tiny(jax_build_backbone_config(cfg), **kw), pbcfg)
    fm = FlaxProbeModel(fcfg, cfg)
    v = fm.init(jax.random.key(0), jnp.zeros((2, IMG, IMG, 3)), train=True)
    v = hub_variables(redraw_backbone(v, seed), pbcfg)
    return fm, v, load_port(ProbeModel(pbcfg, pcfg), v, hub=pbcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family, feats", [
    ("dinov2_vitb14_reg", "ep"), ("dinov2_vitb14_reg", "cls"),
    ("dinov2_vitg14", "ep"), ("capi_vitl14", "ep"), ("capi_vitl14", "cls"),
    ("openclip_openai", "cls"), ("openclip_laion", "ep"), ("simmim", "ep"),
    ("mae_vit_base_patch16", "ep")])
def test_family_matches_flax(family, feats, dtype):
    """Logits (BN in eval mode) and the backbone's features."""
    amp = "bfloat16" if dtype == "bfloat16" else "float32"
    fm, v, pm = models(_cfg(amp, cls_features=feats, **FAMILIES[family]))
    pm.eval()
    x = images(1)
    logits_j, feats_j = fm.apply(v, jnp.asarray(x), train=False,
                                 return_backbone_features=True)
    logits_t, feats_t = pm(torch.from_numpy(x), return_backbone_features=True)
    close(feats_t, feats_j, dtype, "features")
    close(logits_t, logits_j, dtype, "logits")


def test_openclip_head_is_proj_dim_wide():
    """The cls descriptors of OpenCLIP are ``proj_dim`` wide (512 at
    ViT-B-16), not the width of the patch tokens."""
    cfg = PortTrainConfig(model="ViT-B-16", openclip=True, cls_features="cls",
                          nb_classes=C)
    bcfg = build_backbone_config(cfg).replace(depth=1)
    pm = ProbeModel(bcfg, cfg)
    assert bcfg.proj_dim == 512 and bcfg.mlp_type == "quick_gelu"
    assert pm.head.fc.weight.shape == (C, 512)
    assert tuple(pm.backbone.proj.shape) == (768, 512)


@pytest.mark.parametrize("kw", [dict(rel_pos_bias="per_block"),
                                dict(rel_pos_bias="none", init_values=None)])
def test_simmim_variants_match_flax(kw):
    """SimMIM with a table a block, and the ``qv_only`` bias alone (no
    LayerScale, no table: still the plain route, through the fused core)."""
    fm, v, pm = models(_cfg(simmim=True), seed=2, **kw)
    assert not any(b.supercell for b in pm.backbone.blocks)
    pm.eval()
    x = images(2)
    close(pm(torch.from_numpy(x)), fm.apply(v, jnp.asarray(x), train=False),
          "float32", str(kw))


@pytest.mark.parametrize("norm_pix", [False, True])
def test_mae_loss_matches_flax(norm_pix):
    """The autoencoder's loss, prediction and mask at mask ratio 0.75 from
    the same uniform noise (JAX draws it from the key; the port takes it)."""
    fcfg = dataclasses.replace(jmae.mae_vit_base_patch16(dtype=jnp.float32),
                               norm_pix_loss=norm_pix, **TINY_MAE)
    fm = jmae.MaskedAutoencoderViT(fcfg)
    x = images(3)
    key = jax.random.key(5)
    v = fm.init({"params": jax.random.key(0), "masking": key},
                jnp.asarray(x[:2]))
    v = {"params": redraw(v["params"], 6)}
    loss_j, pred_j, mask_j = fm.apply(v, jnp.asarray(x), 0.75, rng=key)
    pm = load_port(pmae.MaskedAutoencoderViT(port_cfg(fcfg)), v)
    noise = np.array(jax.random.uniform(key, (B, 16)))
    loss_t, pred_t, mask_t = pm(torch.from_numpy(x), 0.75,
                                noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert float(mask_t.sum()) == B * 12
    close(pred_t, pred_j, "float32", "pred")
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)


def test_mae_latent_matches_flax():
    fcfg = dataclasses.replace(jmae.mae_vit_base_patch16(dtype=jnp.float32),
                               **TINY_MAE)
    fm = jmae.MaskedAutoencoderViT(fcfg)
    x = images(4)
    v = {"params": redraw(fm.init(jax.random.key(0), jnp.asarray(x[:2]),
                                  0.0)["params"], 7)}
    latent_j, mask_j, ids_j = fm.apply(v, jnp.asarray(x), 0.0,
                                       return_latent=True)
    pm = load_port(pmae.MaskedAutoencoderViT(port_cfg(fcfg)), v)
    latent_t, mask_t, ids_t = pm(torch.from_numpy(x), 0.0, return_latent=True)
    close(latent_t, latent_j, "float32", "latent")
    assert not mask_t.any()
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


def _grads(pm, x, y):
    pm.train()
    pm.zero_grad(set_to_none=True)
    loss = cross_entropy(pm(torch.from_numpy(x)),
                         torch.from_numpy(y).long()).mean()
    loss.backward()
    return loss.item(), {k: p.grad for k, p in pm.named_parameters()}


@pytest.mark.parametrize("policy", ["none", "attn_out", "attn_fc1", "dots"])
def test_layerscale_finetune_grads_match_flax(policy):
    """Every parameter's gradient of a fine-tuned DINOv2 (registers,
    LayerScale, the plain route) under each remat policy, against the flax
    model under the same policy (its blocks scanned, as remat needs)."""
    cfg = _cfg(model="dinov2_vitb14_reg", finetuning=True, scan_blocks=True,
               remat_blocks=True, remat_policy=policy)
    fm, v, pm = models(cfg, seed=8)
    x = images(8)
    y = np.random.default_rng(8).integers(0, C, B).astype(np.int32)

    def loss_fn(params):
        logits, _ = fm.apply({"params": params,
                              "batch_stats": v["batch_stats"]},
                             jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        return jax_steps.cross_entropy(logits, jnp.asarray(y)).mean()

    loss_j, grads_j = jax.value_and_grad(loss_fn)(v["params"])
    from ep_tpu_torch.convert.from_flax import flax_to_torch
    grads_j, _ = flax_to_torch({"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), grads_j)}, device="cpu")
    # the registers' rows of flax's position embedding are the hub's none
    grads_j = drop_register_rows(grads_j, pm.backbone.cfg)
    loss_t, grads_t = _grads(pm, x, y)
    assert all(b.remat is not None for b in pm.backbone.blocks)
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-5)
    assert grads_t.keys() == grads_j.keys()
    assert "backbone.blocks.1.ls1.gamma" in grads_t
    assert "backbone.reg_token" in grads_t
    top = max(float(g.abs().max()) for g in grads_j.values())
    for k, g in grads_t.items():
        b = grads_j[k].numpy()
        if k == "backbone.norm.bias":
            # zero in exact arithmetic: a shift of every token after the
            # final norm, which the EP softmax and the BN cancel; both sides
            # hold f32 rounding noise
            assert max(float(g.abs().max()), float(np.abs(b).max())) \
                < 1e-6 * top
            continue
        # each at its own largest magnitude, floored at 1e-3 of the model's
        # (test_torch_finetune.py)
        own = float(np.abs(b).max())
        np.testing.assert_allclose(g.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * max(own, 1e-3 * top),
                                   err_msg=k)


def test_new_parameters_take_the_jax_initializers():
    """LayerScale at its constant, zero registers, q/v biases and tables,
    OpenCLIP's proj N(0, 1/D), MAE's cls token N(0, 0.02) (a probe holds
    the encoder alone: no mask token)."""
    def built(**kw):
        cfg = PortTrainConfig(nb_classes=C, image_size=IMG, **kw)
        return init_probe_model(cfg, 0, tiny(build_backbone_config(cfg)),
                                device="cpu")
    m = built(model="dinov2_vitb14_reg")
    assert torch.equal(m.backbone.blocks[0].ls2.gamma,
                       torch.full((D,), 1e-5))
    assert not m.backbone.reg_token.any()
    m = built(simmim=True)
    assert not m.backbone.rel_pos_bias.relative_position_bias_table.any()
    assert not m.backbone.blocks[1].attn.v_bias.any()
    assert torch.equal(m.backbone.blocks[1].ls1.gamma, torch.full((D,), 0.1))
    proj = built(model="ViT-L-14", openclip=True,
                 cls_features="cls").backbone.proj
    assert proj.shape == (D, 32)
    assert abs(float(proj.std()) - D ** -0.5) < 0.1 * D ** -0.5
    mae = built(model="mae_vit_large_patch16").backbone
    assert 0.01 < float(mae.cls_token.std()) < 0.03
    assert not hasattr(mae, "mask_token")


@pytest.mark.parametrize("family, supercell", [
    ("dinov2_vitb14_reg", False), ("capi_vitl14", True),
    ("openclip_openai", True), ("simmim", False),
    ("mae_vit_base_patch16", True)])
def test_blocks_take_the_jax_gate(family, supercell):
    """The supercell where the JAX package's gate lets a block take it (full
    qkv bias, no LayerScale, no rel-pos bias), the plain route elsewhere; the
    int8 half is refused where the supercell is."""
    cfg = PortTrainConfig(nb_classes=C, image_size=IMG, int8_mlp=True,
                          **FAMILIES[family])
    pm = ProbeModel(tiny(build_backbone_config(cfg)), cfg)
    assert all(b.supercell == supercell for b in pm.backbone.blocks)
    if family in ("dinov2_vitb14_reg", "simmim"):
        bcfg = tiny(build_backbone_config(cfg)).replace(int8_mlp=True)
        assert int8_mlp_inactive_reason(bcfg)
        pm = ProbeModel(bcfg, cfg)
        assert not any(b.int8_mlp for b in pm.backbone.blocks)


def test_mae_decoder_takes_the_plain_route(monkeypatch):
    """MAE's decoder asks for plain attention (``attn_impl="xla"``, the JAX
    decoder's) and its encoder for the kernels: the decoder's blocks never
    reach the supercell or the fused attention (either would raise here),
    and the loss is flax's."""
    import ep_tpu_torch.models.vit as pvit
    fcfg = dataclasses.replace(jmae.mae_vit_base_patch16(dtype=jnp.float32),
                               **TINY_MAE)
    pcfg = port_cfg(fcfg)
    assert pcfg.encoder_vit().attn_impl == "auto"
    assert pcfg.decoder_vit().attn_impl == "xla"
    fm = jmae.MaskedAutoencoderViT(fcfg)
    x = images(5)
    key = jax.random.key(6)
    v = {"params": redraw(fm.init({"params": jax.random.key(0),
                                   "masking": key},
                                  jnp.asarray(x[:2]))["params"], 9)}
    pm = load_port(pmae.MaskedAutoencoderViT(pcfg), v)
    assert all(b.supercell and b.attn.kernel for b in pm.blocks)
    assert not any(b.supercell or b.attn.kernel for b in pm.decoder_blocks)

    calls = []
    supercell = pvit.attn_supercell

    def counted(*a, **k):
        calls.append(a[0].shape)
        return supercell(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("a decoder block took the fused attention")
    monkeypatch.setattr(pvit, "attn_supercell", counted)
    monkeypatch.setattr(pvit, "attention_qkv_fused", refuse)
    noise = np.array(jax.random.uniform(key, (B, 16)))
    loss_t, _, _ = pm(torch.from_numpy(x), 0.75,
                      noise=torch.from_numpy(noise))
    loss_j, _, _ = fm.apply(v, jnp.asarray(x), 0.75, rng=key)
    assert calls == [(B, 5, D)] * DEPTH  # the encoder's blocks only
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)


@pytest.mark.parametrize("family", ["vit_base_patch16", *FAMILIES])
@pytest.mark.parametrize("attn_impl", ["xla", "auto", "pallas"])
def test_attn_impl_picks_the_route(family, attn_impl, monkeypatch):
    """``--attn_impl xla`` puts every block of a ViT-B-shaped backbone (and
    of every family) on the plain route through ``mha``, as the JAX package
    routes it to XLA, and leaves the int8 half inactive; ``auto`` and
    ``pallas`` keep the routes of ``test_blocks_take_the_jax_gate``. MAE's
    encoder takes the kernels whatever the flag says."""
    import ep_tpu_torch.models.vit as pvit
    spec = FAMILIES.get(family, dict(model=family))
    cfg = PortTrainConfig(nb_classes=C, image_size=IMG, attn_impl=attn_impl,
                          **spec)
    bcfg = build_backbone_config(cfg)
    plain = attn_impl == "xla" and family != "mae_vit_base_patch16"
    if family == "vit_base_patch16":
        assert (bcfg.embed_dim, bcfg.num_heads) == (768, 12)
        assert bool(int8_mlp_inactive_reason(
            bcfg.replace(int8_mlp=True))) == plain
    small = tiny(bcfg)
    if not isinstance(bcfg, pmae.MAEConfig):  # tiny() asks for "pallas"
        small = small.replace(attn_impl=attn_impl)
    pm = ProbeModel(small, cfg)
    blocks = pm.backbone.blocks
    assert not any(b.attn.kernel for b in blocks) if plain else \
        all(b.attn.kernel for b in blocks)
    if plain:
        assert not any(b.supercell for b in blocks)

        def refuse(*a, **k):
            raise AssertionError("a plain block took a kernel route")
        monkeypatch.setattr(pvit, "attn_supercell", refuse)
        monkeypatch.setattr(pvit, "attention_qkv_fused", refuse)
        pm.eval()
        assert torch.isfinite(pm(torch.from_numpy(images(6)))).all()


@pytest.mark.parametrize("family", [
    "vit_tiny_patch16", "dinov2_vitb14_reg", "capi_vitl14", "openclip_openai",
    "simmim", "mae_vit_base_patch16"])
def test_init_probe_model_draws_what_reset_parameters_draws(family):
    """``init_probe_model`` skips the constructors' own initialisation: every
    parameter and buffer equals that of a model built with it and then
    drawn from the same seed, for each family and, on the plain ViT, each
    head of the zoo, its ``_all`` variant and the ``dino`` oracle."""
    from ep_tpu_torch.configs import POOLING_NAMES
    spec = FAMILIES.get(family, dict(model=family))
    heads = (["cls", "pos", "dino"] + POOLING_NAMES
             + ["ep_all", "aim_all", "cait_all"]
             if family == "vit_tiny_patch16" else ["ep"])
    for head in heads:
        cfg = PortTrainConfig(nb_classes=C, image_size=IMG, cls_features=head,
                              ep_queries=4, num_heads=4, **spec)
        bcfg = tiny(build_backbone_config(cfg))
        got = init_probe_model(cfg, 3, bcfg, device="cpu").state_dict()
        ref = ProbeModel(bcfg, cfg)
        ref.reset_parameters(torch.Generator().manual_seed(3))
        want = ref.state_dict()
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), (family, head, k)
