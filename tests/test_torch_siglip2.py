"""SigLIP2 SO400M/14 (``siglip2_so400m_patch14``) in the port at transformers'
layout, on the CPU:

* the port builds the tower at its published widths (D=1152, depth 27, 16
  heads of 72, MLP hidden 4304, patch 14, 729 position rows at 384 px, no
  [CLS] and no registers, LayerNorm eps 1e-6, the tanh GELU, a final LN)
  through ``build_backbone_config``, and the benchmark's width check
  (``benchmark/program.py``) accepts ``configs/siglip2-so400m14-ep32.json``;
* one block in transformers' ``SiglipVisionModel`` names loads strictly
  through ``convert/torch_vit.py``, the MAP head dropped;
* the patch embedding at 384 px is the valid ``Conv2d(stride=14)``, the
  last 6 rows and columns of pixels dropped; ``Mlp`` with ``"gelu_tanh"``
  computes the tanh GELU in float32 too, and takes fc1's epilogue where the
  GELU MLP does; head width 72 goes to kernel F at every T;
* a feature mode that reads a class token is refused for this tower;
* the port against the benchmark's plain reference
  (``benchmark/references/siglip2_ep.py``) at a tiny size that keeps every
  switch: D=144, 2 heads of 72, depth 2, 62 px images with patch 14 (a 4x4
  grid, 6 px cropped), batch 8, EP-4, 10 classes, the hidden ratio 4304 /
  1152. The port is built by the benchmark's ``Program`` with the weights
  the benchmark draws, its backbone config cut to that size. Logits, patch
  features, the head's gradients and a fine-tuning step's gradients agree in
  float32 and bfloat16, and a reference with the erf GELU, one that crops
  the bottom-right pixels, one without the final LN and one with a [CLS]
  prepended do not; ``benchmark.run`` runs the tiny cell.

Tolerances (each beside its comparison): float32 both sides compute the
same function with sums in another order (einsum and a convolution against
``F.linear``), some 6e-7 of the largest magnitude apart; bfloat16 the port
rounds after every operation where the reference does not round at all.
"""
import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark import check, flops
from benchmark.program import Program
from benchmark.references import siglip2_ep
from benchmark.weights import draw_batches, draw_weights
from ep_tpu_torch.configs import TrainConfig
from ep_tpu_torch.convert.torch_vit import torch_vit_to_backbone
from ep_tpu_torch.models import assembly
from ep_tpu_torch.models.assembly import SkipDefaultInit
from ep_tpu_torch.models.vit import Mlp, PatchEmbed, VisionTransformer
from ep_tpu_torch.models.wrappers import siglip2_config
from ep_tpu_torch.ops.attn_fused import attn_route, bwd_route
from ep_tpu_torch.ops.fc1_gelu import takes_gelu_epilogue

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "benchmark" / "configs" / "siglip2-so400m14-ep32.json")
                 .read_text())
SMALL = dict(embed_dim=144, depth=2, num_heads=2)
TINY = dict(hidden_size=144, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=538, ep_queries=4, num_classes=10)
SEED = 2 ** 31 + 29
# float32: ~6e-7 apart (sums in another order); 1e-5 of the largest
# magnitude leaves room, and the nearest faulted reference (the erf GELU,
# whose values differ from the tanh GELU's by some 1e-4 at most) lies 1.5e-4
# away
F32_TOL = 1e-5
# bfloat16: the port rounds after every operation (a step of 2**-8), which
# two blocks carry to the features (measured 8.5e-3); 2**-5 of the largest
# magnitude, the suite's bar for bf16 backbones
# (tests/test_torch_backbone_util.py)
BF16_TOL = 2.0 ** -5
# gradients (check.grad_dist: the norm of the difference over the leaf's
# norm, worst leaf): f32 the sums' order again (measured 1.0e-6 probing,
# 1.6e-6 fine-tuning); bf16 the features' rounding carried through the
# head's softmax, BatchNorm and classifier (measured 1.1e-2, 1.8e-2)
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# the losses of 3 steps (check.loss_gap, relative): the same, a scalar
# (measured 2.7e-7 and 1.9e-3 at most)
LOSS_TOL = {"float32": 5e-6, "bfloat16": 1e-2}


def tiny_cfg(dtype: str) -> dict:
    return {**CFG, **TINY, "dtype": dtype}


def traffic(step: str) -> dict:
    return dict(step=step, batch=8, image_size=62, host_steps=1,
                trace_steps=1)


@pytest.fixture
def tiny_port(monkeypatch):
    """The port's backbone config of ``siglip2_so400m_patch14`` cut to
    SMALL, every switch kept (the hidden width follows the ratio 4304 /
    1152: 538)."""
    full = assembly.build_backbone_config
    monkeypatch.setattr(assembly, "build_backbone_config",
                        lambda tc: full(tc).replace(**SMALL))


def rel_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest magnitude of b."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


# ---- published widths and transformers' layout --------------------------------

def test_so400m_is_built_at_the_published_widths():
    cfg = assembly.build_backbone_config(TrainConfig(
        model="siglip2_so400m_patch14", image_size=384, amp="bfloat16",
        cls_features="ep"))
    assert cfg == siglip2_config("siglip2_so400m_patch14", 384)
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.patch_size) == (
        1152, 27, 16, 14)
    assert cfg.embed_dim // cfg.num_heads == 72
    assert int(cfg.embed_dim * cfg.mlp_ratio) == 4304
    assert cfg.grid_size == 27 and cfg.num_patches == 729
    assert cfg.num_prefix_tokens == 0 and not cfg.class_token
    assert cfg.mlp_type == "gelu_tanh" and cfg.norm_eps == 1e-6
    assert cfg.final_norm == "ln" and cfg.supercell  # A, F, C on the card
    with torch.device("meta"):
        m = VisionTransformer(cfg)
    blk = m.blocks[0]
    assert tuple(m.pos_embed.shape) == (1, 729, 1152)
    assert tuple(blk.attn.qkv.weight.shape) == (3456, 1152)
    assert tuple(blk.attn.qkv.bias.shape) == (3456,)
    assert tuple(blk.mlp.fc1.weight.shape) == (4304, 1152)
    assert tuple(blk.mlp.fc2.weight.shape) == (1152, 4304)
    assert blk.mlp.approximate == "tanh" and blk.ls1 is None
    assert m.cls_token is None and m.reg_token is None and m.norm is not None
    assert blk.norm1.eps == m.norm.eps == 1e-6
    assert len(m.blocks) == 27
    n = sum(p.numel() for p in m.parameters())
    assert 412.8e6 < n < 413.0e6  # 412.9 M parameters, 0.83 GB in bf16
    # float32 keeps the tanh GELU too
    f32 = siglip2_config("siglip2_so400m_patch14", 384, torch.float32)
    with torch.device("meta"):
        assert VisionTransformer(f32).blocks[0].mlp.approximate == "tanh"
    with pytest.raises(ValueError, match="unknown SigLIP2"):
        siglip2_config("siglip2_base_patch16")


class _Built(Exception):
    pass


def test_benchmark_program_accepts_the_config(monkeypatch):
    """``Program`` checks the port's widths against the file's before it
    builds the model; here the build stops just after that check."""
    def stop(*a, **k):
        raise _Built
    monkeypatch.setattr(assembly, "ProbeModel", stop)
    t = json.loads((ROOT / "benchmark" / "traffic" / "probe-b128-384px.json")
                   .read_text())
    with pytest.raises(_Built):
        Program(CFG, t, {}, "cpu")
    wide = {**CFG, "intermediate_size": 4608}  # 4 * D, not the published
    with pytest.raises(ValueError, match="other sizes"):
        Program(wide, t, {}, "cpu")


def siglip_state_dict(depth: int = 1, seed: int = 0) -> dict:
    """A ``SiglipVisionModel`` state dict (transformers' names, with the
    ``vision_model.`` prefix and the MAP head) at the published widths,
    ``depth`` layers; values from a cheap deterministic fill (the test
    compares where each lands, not what they are)."""
    D, F_, P = 1152, 4304, 729
    counter = [seed]

    def r(*shape):
        counter[0] += 1
        return torch.full(shape, float(counter[0])) + torch.linspace(
            0, 1, shape[-1])
    v = "vision_model."
    sd = {v + "embeddings.patch_embedding.weight": r(D, 3, 14, 14),
          v + "embeddings.patch_embedding.bias": r(D),
          v + "embeddings.position_embedding.weight": r(P, D),
          v + "post_layernorm.weight": r(D), v + "post_layernorm.bias": r(D),
          v + "head.probe": r(1, 1, D),
          v + "head.attention.in_proj_weight": r(3 * D, D),
          v + "head.attention.in_proj_bias": r(3 * D),
          v + "head.attention.out_proj.weight": r(D, D),
          v + "head.attention.out_proj.bias": r(D),
          v + "head.layernorm.weight": r(D), v + "head.layernorm.bias": r(D),
          v + "head.mlp.fc1.weight": r(F_, D), v + "head.mlp.fc1.bias": r(F_),
          v + "head.mlp.fc2.weight": r(D, F_), v + "head.mlp.fc2.bias": r(D)}
    for i in range(depth):
        b = f"{v}encoder.layers.{i}."
        for n in ("k_proj", "v_proj", "q_proj", "out_proj"):
            sd[f"{b}self_attn.{n}.weight"] = r(D, D)
            sd[f"{b}self_attn.{n}.bias"] = r(D)
        sd.update({b + "layer_norm1.weight": r(D), b + "layer_norm1.bias": r(D),
                   b + "mlp.fc1.weight": r(F_, D), b + "mlp.fc1.bias": r(F_),
                   b + "mlp.fc2.weight": r(D, F_), b + "mlp.fc2.bias": r(D),
                   b + "layer_norm2.weight": r(D),
                   b + "layer_norm2.bias": r(D)})
    return sd


@pytest.mark.parametrize("prefix", ["vision_model.", "encoder-stripped"])
def test_transformers_layout_loads_strictly(capsys, prefix):
    """Every entry lands where its name says; the MAP head is dropped, and
    so is a whole ``SiglipModel``'s text tower. ``encoder-stripped``: the
    tower's own state dict after the loader's ``encoder.`` prefix strip
    (``_state_dict_of``), its layers as ``layers.{i}``."""
    cfg = siglip2_config("siglip2_so400m_patch14", 384,
                         torch.float32).replace(depth=1)
    with SkipDefaultInit():
        model = VisionTransformer(cfg)
    sd = siglip_state_dict()
    src = dict(sd)
    if prefix == "vision_model.":
        src["text_model.embeddings.token_embedding.weight"] = torch.zeros(4, 8)
        src["logit_scale"] = torch.zeros(1)
    else:
        src = {k[len("vision_model."):].replace("encoder.layers.", "layers."):
               t for k, t in sd.items()}
    state = torch_vit_to_backbone(src, model, cfg)
    model.load_state_dict(state, strict=True)
    assert "unused checkpoint keys" not in capsys.readouterr().out
    v, b = "vision_model.", "vision_model.encoder.layers.0."
    assert torch.equal(model.patch_embed.proj.weight,
                       sd[v + "embeddings.patch_embedding.weight"])
    assert torch.equal(model.pos_embed[0],
                       sd[v + "embeddings.position_embedding.weight"])
    qkv = model.blocks[0].attn.qkv
    for j, n in enumerate(("q_proj", "k_proj", "v_proj")):
        assert torch.equal(qkv.weight[j * 1152:(j + 1) * 1152],
                           sd[f"{b}self_attn.{n}.weight"])
        assert torch.equal(qkv.bias[j * 1152:(j + 1) * 1152],
                           sd[f"{b}self_attn.{n}.bias"])
    blk = model.blocks[0]
    assert torch.equal(blk.attn.proj.weight, sd[b + "self_attn.out_proj.weight"])
    assert torch.equal(blk.norm1.bias, sd[b + "layer_norm1.bias"])
    assert torch.equal(blk.norm2.weight, sd[b + "layer_norm2.weight"])
    assert torch.equal(blk.mlp.fc1.weight, sd[b + "mlp.fc1.weight"])
    assert torch.equal(blk.mlp.fc2.bias, sd[b + "mlp.fc2.bias"])
    assert torch.equal(model.norm.weight, sd[v + "post_layernorm.weight"])


# ---- the tower's parts --------------------------------------------------------

def test_patch_embedding_at_384_px_is_the_valid_convolution():
    """``PatchEmbed`` on a 384 px image (27 * 14 + 6) equals
    ``F.conv2d(stride=14)`` over the whole image with the same weights:
    the last 6 rows and columns are not read."""
    g = torch.Generator().manual_seed(11)
    pe = PatchEmbed(14, 3, 1152)
    with torch.no_grad():
        pe.proj.weight.copy_(torch.randn(1152, 3, 14, 14, generator=g) * 0.02)
        pe.proj.bias.copy_(torch.randn(1152, generator=g))
    x = torch.randn(2, 384, 384, 3, generator=g)
    with torch.no_grad():
        got = pe(x, torch.float32)
        want = F.conv2d(x.permute(0, 3, 1, 2), pe.proj.weight, pe.proj.bias,
                        stride=14).flatten(2).transpose(1, 2)
        assert got.shape == (2, 729, 1152)
        # f32 sums in another order: ~1e-6 of the largest magnitude
        assert rel_dist(got, want) < 1e-5
        y = x.clone()
        y[:, 378:] = 1e3
        y[:, :, 378:] = -1e3
        assert torch.equal(pe(y, torch.float32), got)


def test_tanh_gelu_mlp_at_every_precision(monkeypatch):
    """``Mlp(act="gelu_tanh")`` computes the tanh GELU in float32 (where the
    GELU MLP computes the erf GELU, as the JAX package does) and bfloat16;
    fc1's epilogue takes it on the card exactly where it takes the GELU
    MLP."""
    torch.manual_seed(12)
    x = torch.randn(5, 144)
    for dtype in (torch.float32, torch.bfloat16):
        mlp = Mlp(144, 538, dtype, act="gelu_tanh")
        with torch.no_grad():
            got = mlp(x)
            h = F.gelu(mlp.fc1(x), approximate="tanh")
            assert torch.equal(got, mlp.fc2(h))
    erf = Mlp(144, 538, torch.float32)
    erf.load_state_dict(Mlp(144, 538, torch.float32, "gelu_tanh").state_dict())
    with torch.no_grad():
        h = erf.fc1(x)
        assert torch.equal(erf(x), erf.fc2(F.gelu(h)))
        assert not torch.equal(F.gelu(h), F.gelu(h, approximate="tanh"))
    cuda = torch.device("cuda")
    for act in ("gelu", "gelu_tanh"):
        assert takes_gelu_epilogue(cuda, torch.bfloat16, act, False, False)
        assert not takes_gelu_epilogue(cuda, torch.float32, act, False, False)
        assert not takes_gelu_epilogue(cuda, torch.bfloat16, act, False, True)
    assert not takes_gelu_epilogue(cuda, torch.bfloat16, "quick_gelu", False,
                                   False)


def test_head_width_72_routes():
    """F takes head width 72 at every T (B is not built for it); the
    backward takes the tiled plain version (E is not either)."""
    for T in (1, 256, 257, 729, 1025):
        assert attn_route(T, 72, 16) == "flash"
        assert bwd_route(T, 72) == "long"


@pytest.mark.parametrize("mode", ["cls", "ep_all", "ca2", "attn-mn"])
def test_features_that_read_a_class_token_are_refused(mode):
    """SigLIP2 has no [CLS]: ``cls`` would train on a zero vector and the
    ``_all``, ``ca*`` and ``attn-*`` modes read a class token's place. The
    patch-token modes build; the MAE tower without [CLS] keeps the JAX
    package's behaviour."""
    with pytest.raises(ValueError, match="ep.*gap"):
        assembly.build_backbone_config(TrainConfig(
            model="siglip2_so400m_patch14", image_size=384, cls_features=mode))
    for ok in ("ep", "pos", "raw", "cp2", "aim"):
        assembly.build_backbone_config(TrainConfig(
            model="siglip2_so400m_patch14", image_size=384, cls_features=ok))
    no_cls = assembly.build_backbone_config(TrainConfig(
        model="vit_huge_patch14", cls_features="cls", no_cls_token=True))
    assert not no_cls.class_token


# ---- the port against the plain reference -------------------------------------

def port_and_reference(dtype: str, step: str):
    cfg, t = tiny_cfg(dtype), traffic(step)
    W = draw_weights(cfg, t["image_size"], SEED, "cpu",
                     frozen_encoder=step == "probe")
    images, labels = draw_batches(cfg, t, SEED, "cpu")
    prog = Program(cfg, t, dict(W), "cpu")
    ref = siglip2_ep.Reference(W, siglip2_ep.dims(cfg, t["image_size"]),
                               cfg["optimizer"], step == "finetune")
    return cfg, t, prog, ref, images, labels


def features_and_logits(prog, ref, images):
    """(port's patch features, port's logits, reference's, reference's)."""
    with torch.no_grad():
        logits, feats = prog.model(images, return_backbone_features=True)
        rf = siglip2_ep.encode(ref.W, images, ref.d, ref.mm)
        rl = siglip2_ep.head_logits(ref.W, rf, ref.d, ref.mm)
    return feats, logits, rf, rl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_features_and_logits_match_the_reference(tiny_port, dtype):
    _, _, prog, ref, images, _ = port_and_reference(dtype, "probe")
    assert all(b.supercell for b in prog.model.backbone.blocks)
    assert ref.d["T"] == ref.d["N"] == 16 and images.shape[2] == 62
    feats, logits, rf, rl = features_and_logits(prog, ref, images[0])
    assert feats.shape == (8, 16, 144) and logits.shape == (8, 10)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert rel_dist(feats, rf) < tol
    assert rel_dist(logits, rl) < tol


ORIGINAL = {"tokens": siglip2_ep.tokens,
            "post_layernorm": siglip2_ep.post_layernorm}


def _erf_gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _bottom_right(W, images, d, mm):
    """The crop at the other corner: the first rows and columns dropped."""
    c = images.shape[1] - d["grid"] * d["p"]
    return ORIGINAL["tokens"](W, images[:, c:, c:], d, mm)


def _with_cls(W, images, d, mm):
    """A [CLS] token (the patch bias's values) before the patches."""
    x = ORIGINAL["tokens"](W, images, d, mm)
    return torch.cat([W["patch_b"].float().expand(x.shape[0], 1, -1), x], 1)


@pytest.mark.parametrize("fault", ["erf-gelu", "bottom-right-crop",
                                   "no-post-layernorm", "cls-prepended"])
def test_a_reference_with_a_fault_fails(tiny_port, monkeypatch, fault):
    """The comparison sees each switch of the tower: the float32 port lies
    outside F32_TOL of a reference with the erf GELU, one that crops the
    image's first rows and columns instead of its last, one without the
    final LayerNorm, and one with a [CLS] token in the attention (dropped
    after the final norm), by ten times the tolerance."""
    _, _, prog, ref, images, _ = port_and_reference("float32", "probe")
    if fault == "erf-gelu":
        monkeypatch.setattr(siglip2_ep, "gelu_tanh", _erf_gelu)
    elif fault == "bottom-right-crop":
        monkeypatch.setattr(siglip2_ep, "tokens", _bottom_right)
    elif fault == "no-post-layernorm":
        monkeypatch.setattr(siglip2_ep, "post_layernorm", lambda W, x, d: x)
    else:
        monkeypatch.setattr(siglip2_ep, "tokens", _with_cls)
        monkeypatch.setattr(
            siglip2_ep, "post_layernorm",
            lambda W, x, d: ORIGINAL["post_layernorm"](W, x, d)[:, 1:])
    feats, _, rf, _ = features_and_logits(prog, ref, images[0])
    assert feats.shape == rf.shape
    assert rel_dist(feats, rf) > 10 * F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", ["probe", "finetune"])
def test_port_gradients_match_the_reference(tiny_port, dtype, step):
    """The first step's gradients of every trained leaf (the head's when
    probing, every leaf when fine-tuning) and the losses of 3 steps, as the
    benchmark's check reads them."""
    cfg, t, prog, _, images, labels = port_and_reference(dtype, step)
    first = cfg["optimizer"]["schedule"]["start_step"]
    got = check.program_readings(prog, images, labels, first)
    want = check.reference_readings(cfg, t, SEED, "cpu")
    g = check.gaps(got, want)
    assert set(got["grads"]) == set(want["grads"])
    if step == "finetune":
        assert {"pos", "patch_w", "norm_w", "blocks.1.fc1_w",
                "blocks.0.qkv_b"} <= set(got["grads"])
    assert g["grad_dist"] < GRAD_TOL[dtype], g
    assert g["loss_gap"] < LOSS_TOL[dtype], g


def test_benchmark_runs_the_cell_on_the_cpu(tiny_port):
    """``benchmark.run.run`` on the configuration at the tiny size, traced:
    correct under limits of this test's own (the card's plain versions are
    not the CPU's); no device, so the kernels' metrics are left out."""
    from benchmark import manifest, run
    m = manifest.load()
    cell = manifest.cell("siglip2so400m14-384-probe-b128", m)
    tiny = manifest.Cell(
        name="tiny-siglip2", chips=1, config=tiny_cfg("bfloat16"),
        traffic=traffic("probe"),
        limits={"loss_gap": 1e-2, "grad_gap": 0.05, "update_gap": 0.05,
                "grad_dist": 0.1},
        end_to_end=cell.end_to_end, per_layer=cell.per_layer)
    kernels = {"flash_ms", "flash_roofline"}
    assert kernels <= {p["name"] for p in cell.per_layer}
    assert not {"swiglu_ms", "rope_ms"} & {p["name"] for p in cell.per_layer}
    out = run.run(tiny, SEED, 0.2, trace=True, device="cpu")
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["host_ms"]["value"] > 0
    assert not kernels & set(out["metrics"])


def test_counts_of_the_cell():
    """T = N = 729 with no prefix; kernel F's operations a call are
    4 B H T^2 Dh at Dh = 72 (313 GFLOP at the cell's shape: the kernel's
    rest columns are not counted); an image's encoder forward is 666 GFLOP,
    66 of them attention's two products."""
    from benchmark import flash_ops
    d = siglip2_ep.dims(CFG, 384)
    assert (d["T"], d["N"], d["grid"], d["hidden"]) == (729, 729, 27, 4304)
    ops, moved = flash_ops.flash_call(CFG, 384, 128)
    assert ops == 4 * 128 * 16 * 729 ** 2 * 72
    assert moved == 2 * 128 * 729 * 4 * 1152
    fwd = flops.encoder_forward(d)
    assert 666e9 < fwd < 667e9
    assert 65e9 < 27 * 4 * 729 ** 2 * 1152 < 67e9
