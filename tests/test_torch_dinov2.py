"""DINOv2 ViT-g/14 with registers (``dinov2_vitg14_reg``) in the port at the
hub's layout, on the CPU:

* the port builds the giant at its published widths (``w12`` (8192, 1536),
  ``w3`` (1536, 4096), ``pos_embed`` (1, 257, 1536) at 224 px, ``reg_token``
  (1, 4, 1536)), and the benchmark's width check (``benchmark/program.py``)
  accepts ``configs/dinov2-g14-reg-ep32.json``;
* a state dict with the hub's names and shapes (2 blocks at the published
  widths, the 518-px position embedding) loads strictly through
  ``convert/torch_vit.py``, its position embedding resized over one prefix
  row;
* the SwiGLU gate's routes (the kernel's entry without a gradient, the plain
  chain with one or when cut) and its span;
* the port against the benchmark's plain reference
  (``benchmark/references/dinov2_ep.py``) at a tiny size that keeps every
  switch of the giant: SwiGLU at the giant's hidden-width ratio, LayerScale,
  4 registers outside the position embedding, the final LayerNorm. D=64, 2
  heads, depth 2, 56 px images (a 4x4 grid of patch 14, T=21), batch 8,
  EP-4, 10 classes; the hidden width int(64 * 4096 / 1536) = 170. The port
  is built by the benchmark's ``Program`` with the weights the benchmark
  draws, its backbone config cut to that size. Logits, patch features, the
  head's gradients and a fine-tuning step's gradients agree in float32 and
  bfloat16, and a reference without LayerScale, without its registers or
  without the gate's ``x2`` does not;
* ``flops.mlp_half`` under the reference's ``dims`` counts ``w12`` and
  ``w3``.

Tolerances (each beside its comparison): float32 both sides compute the
same function with sums in another order (einsum against ``F.linear``), some
1e-6 of the largest magnitude apart; bfloat16 the port rounds after every
operation where the reference does not round at all.
"""
import json
from pathlib import Path

import pytest
import torch

import ep_tpu_torch.models.vit as pvit
from benchmark import check, flops
from benchmark.program import Program
from benchmark.references import dinov2_ep
from benchmark.weights import draw_batches, draw_weights
from ep_tpu_torch.convert.torch_vit import torch_vit_to_backbone
from ep_tpu_torch.models import assembly
from ep_tpu_torch.models.assembly import SkipDefaultInit
from ep_tpu_torch.models.vit import SwiGLUMlp, VisionTransformer
from ep_tpu_torch.models.wrappers import dinov2_config, swiglu_hidden
from ep_tpu_torch.ops.swiglu import swiglu_gate, swiglu_gate_ref
from ep_tpu_torch.utils.pos_embed import interpolate_pos_embed

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "benchmark" / "configs" / "dinov2-g14-reg-ep32.json")
                 .read_text())
SMALL = dict(embed_dim=64, depth=2, num_heads=2)
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=170, ep_queries=4, num_classes=10)
SEED = 2 ** 31 + 22
# float32: ~1e-6 apart (sums in another order); 1e-4 of the largest
# magnitude leaves room, and a reference without LayerScale, registers or
# x2 lies 1e-2 or more away
F32_TOL = 1e-4
# bfloat16: the port rounds after every operation (a step of 2**-8), which
# two blocks carry to the features; 2**-5 of the largest magnitude, the
# suite's bar for bf16 backbones (tests/test_torch_backbone_util.py)
BF16_TOL = 2.0 ** -5
# gradients (check.grad_dist: the norm of the difference over the leaf's
# norm, worst leaf): f32 the sums' order again; bf16 the features' rounding
# carried through the head's softmax, BatchNorm and classifier
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# the losses of 3 steps (check.loss_gap, relative): the same, a scalar
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def tiny_cfg(dtype: str) -> dict:
    return {**CFG, **TINY, "dtype": dtype}


def traffic(step: str) -> dict:
    return dict(step=step, batch=8, image_size=56, host_steps=1,
                trace_steps=1)


@pytest.fixture
def tiny_port(monkeypatch):
    """The port's backbone config of ``dinov2_vitg14_reg`` cut to SMALL,
    every switch kept (the hidden width follows the giant's ratio)."""
    full = assembly.build_backbone_config
    monkeypatch.setattr(assembly, "build_backbone_config",
                        lambda tc: full(tc).replace(**SMALL))


def rel_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest magnitude of b."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


# ---- published widths and the hub's layout ----------------------------------

def test_giant_is_built_at_the_hub_widths():
    cfg = dinov2_config("dinov2_vitg14_reg")
    assert swiglu_hidden(1536) == 4096
    assert int(cfg.embed_dim * cfg.mlp_ratio) == 4096
    assert cfg.num_prefix_tokens == 5 and cfg.num_pos_prefix_tokens == 1
    with torch.device("meta"):
        m = VisionTransformer(cfg)
    blk = m.blocks[0]
    assert tuple(blk.mlp.w12.weight.shape) == (8192, 1536)
    assert tuple(blk.mlp.w3.weight.shape) == (1536, 4096)
    assert tuple(m.pos_embed.shape) == (1, 257, 1536)
    assert tuple(m.reg_token.shape) == (1, 4, 1536)
    assert len(m.blocks) == 40 and blk.ls1 is not None and m.norm is not None
    assert not blk.supercell  # LayerScale: the plain attention route
    # CAPI keeps registers with rows of the position embedding
    capi = assembly.capi_config(224)
    assert capi.num_pos_prefix_tokens == capi.num_prefix_tokens == 16


class _Built(Exception):
    pass


def test_benchmark_program_accepts_the_config(monkeypatch):
    """``Program`` checks the port's widths against the file's before it
    builds the model; here the build stops just after that check."""
    def stop(*a, **k):
        raise _Built
    monkeypatch.setattr(assembly, "ProbeModel", stop)
    t = json.loads((ROOT / "benchmark" / "traffic" / "probe-b128-224px.json")
                   .read_text())
    with pytest.raises(_Built):
        Program(CFG, t, {}, "cpu")
    wide = {**CFG, "intermediate_size": 6144}  # the JAX package's width
    with pytest.raises(ValueError, match="other sizes"):
        Program(wide, t, {}, "cpu")


def hub_state_dict(depth: int = 2, seed: int = 0) -> dict:
    """``dinov2_vitg14_reg``'s hub checkpoint layout (``DinoVisionTransformer``
    at img_size 518, block_chunks 0) at published widths, ``depth`` blocks,
    random values."""
    g = torch.Generator().manual_seed(seed)
    D, F = 1536, 4096

    def r(*shape):
        return torch.randn(shape, generator=g)
    sd = {"cls_token": r(1, 1, D), "pos_embed": r(1, 1 + 37 * 37, D),
          "register_tokens": r(1, 4, D), "mask_token": r(1, D),
          "patch_embed.proj.weight": r(D, 3, 14, 14),
          "patch_embed.proj.bias": r(D), "norm.weight": r(D),
          "norm.bias": r(D)}
    for i in range(depth):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": r(D), b + "norm1.bias": r(D),
                   b + "attn.qkv.weight": r(3 * D, D),
                   b + "attn.qkv.bias": r(3 * D),
                   b + "attn.proj.weight": r(D, D), b + "attn.proj.bias": r(D),
                   b + "ls1.gamma": r(D), b + "norm2.weight": r(D),
                   b + "norm2.bias": r(D), b + "mlp.w12.weight": r(2 * F, D),
                   b + "mlp.w12.bias": r(2 * F), b + "mlp.w3.weight": r(D, F),
                   b + "mlp.w3.bias": r(D), b + "ls2.gamma": r(D)})
    return sd


def test_hub_layout_loads_strictly_at_published_widths():
    cfg = dinov2_config("dinov2_vitg14_reg", 224, torch.float32).replace(
        depth=2)
    with SkipDefaultInit():
        model = VisionTransformer(cfg)
    sd = hub_state_dict()
    state = torch_vit_to_backbone(dict(sd), model, cfg)
    model.load_state_dict(state, strict=True)
    assert torch.equal(model.reg_token, sd["register_tokens"])
    assert torch.equal(model.blocks[1].mlp.w12.weight,
                       sd["blocks.1.mlp.w12.weight"])
    assert torch.equal(model.blocks[0].mlp.w3.weight,
                       sd["blocks.0.mlp.w3.weight"])
    assert torch.equal(model.blocks[1].ls1.gamma, sd["blocks.1.ls1.gamma"])
    assert torch.equal(model.norm.weight, sd["norm.weight"])
    # one prefix row ([CLS]) kept, the 37x37 grid resized to 16x16
    assert model.pos_embed.shape == (1, 257, 1536)
    assert torch.equal(model.pos_embed,
                       interpolate_pos_embed(sd["pos_embed"], 256, 1))
    assert torch.equal(model.pos_embed[:, :1], sd["pos_embed"][:, :1])


# ---- the gate ---------------------------------------------------------------

def test_gate_routes_and_span(monkeypatch):
    """No gradient: the kernel's entry (the plain chain on the CPU); with a
    gradient, or cut over a model group, the chain itself; ``ep::swiglu_gate``
    around either."""
    from torch.profiler import ProfilerActivity, profile
    mlp = SwiGLUMlp(64, 176, torch.float32)
    x = torch.randn(2, 5, 64)
    took = []
    monkeypatch.setattr(pvit, "swiglu_gate",
                        lambda t: took.append("entry") or swiglu_gate(t))
    monkeypatch.setattr(pvit, "swiglu_gate_ref",
                        lambda t: took.append("chain") or swiglu_gate_ref(t))
    with torch.no_grad():
        y0 = mlp(x)
    x12 = mlp.w12(x)
    x1, x2 = x12.chunk(2, -1)
    torch.testing.assert_close(y0, mlp.w3(x1 * torch.sigmoid(x1) * x2),
                               rtol=0, atol=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y1 = mlp(x)
    y1.sum().backward()
    assert mlp.w12.weight.grad is not None
    mlp.tp = object()  # cut: the chain, whatever the gradient
    with torch.no_grad(), pytest.raises(AttributeError):
        mlp(x)  # row_parallel reads the cut's mesh, which this object lacks
    assert took == ["entry", "chain", "chain"]
    names = [e.name for e in prof.events()]
    assert names.count("ep::swiglu_gate") == 1
    torch.testing.assert_close(y0, y1.detach(), rtol=0, atol=0)


def test_gate_plain_version_rounds_like_the_chain():
    """On the CPU the gate is the bf16 chain: the sigmoid rounded, then each
    product rounded."""
    g = torch.Generator().manual_seed(1)
    x12 = torch.randn(3, 7, 2 * 24, generator=g).to(torch.bfloat16)
    x1, x2 = x12.float().chunk(2, -1)
    s = torch.sigmoid(x1).to(torch.bfloat16).float()
    want = ((x1 * s).to(torch.bfloat16).float() * x2).to(torch.bfloat16)
    assert torch.equal(swiglu_gate(x12), want)


# ---- the port against the plain reference -------------------------------------

def port_and_reference(dtype: str, step: str):
    cfg, t = tiny_cfg(dtype), traffic(step)
    W = draw_weights(cfg, t["image_size"], SEED, "cpu",
                     frozen_encoder=step == "probe")
    images, labels = draw_batches(cfg, t, SEED, "cpu")
    prog = Program(cfg, t, dict(W), "cpu")
    ref = dinov2_ep.Reference(W, dinov2_ep.dims(cfg, t["image_size"]),
                              cfg["optimizer"], step == "finetune")
    return cfg, t, prog, ref, images, labels


def features_and_logits(prog, ref, images, mutate=None):
    """(port's patch features, port's logits, reference's, reference's);
    ``mutate(W, d)`` changes the reference's weights and sizes first."""
    with torch.no_grad():
        logits, feats = prog.model(images, return_backbone_features=True)
    W, d = dict(ref.W), dict(ref.d)
    if mutate is not None:
        mutate(W, d)
    with torch.no_grad():
        rf = dinov2_ep.encode(W, images, d, ref.mm)
        rl = dinov2_ep.head_logits(W, rf, d, ref.mm)
    return feats, logits, rf, rl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_features_and_logits_match_the_reference(tiny_port, dtype):
    _, _, prog, ref, images, _ = port_and_reference(dtype, "probe")
    assert all(not b.supercell for b in prog.model.backbone.blocks)
    feats, logits, rf, rl = features_and_logits(prog, ref, images[0])
    assert feats.shape == (8, 16, 64) and logits.shape == (8, 10)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert rel_dist(feats, rf) < tol
    assert rel_dist(logits, rl) < tol


def _no_layerscale(W, d):
    W["ls1"] = torch.ones_like(W["ls1"])
    W["ls2"] = torch.ones_like(W["ls2"])


def _no_registers(W, d):
    d["R"] = 0
    W["reg"] = W["reg"][:, :0]


@pytest.mark.parametrize("fault", ["layerscale", "registers", "x2"])
def test_a_reference_without_a_switch_fails(tiny_port, monkeypatch, fault):
    """The comparison sees each switch of the giant: the float32 port lies
    outside F32_TOL of a reference that leaves out LayerScale, the
    registers or the gate's second half, by ten times the tolerance."""
    _, _, prog, ref, images, _ = port_and_reference("float32", "probe")
    mutate = {"layerscale": _no_layerscale, "registers": _no_registers,
              "x2": None}[fault]
    if fault == "x2":
        monkeypatch.setattr(dinov2_ep, "swiglu",
                            lambda u: torch.nn.functional.silu(
                                u.chunk(2, -1)[0]))
    feats, _, rf, _ = features_and_logits(prog, ref, images[0], mutate)
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
        assert "blocks.1.w12_w" in got["grads"] and "reg" in got["grads"]
    assert g["grad_dist"] < GRAD_TOL[dtype], g
    assert g["loss_gap"] < LOSS_TOL[dtype], g


def test_benchmark_runs_the_cell_on_the_cpu(tiny_port):
    """``benchmark.run.run`` on the configuration at the tiny size, traced:
    correct under limits of this test's own (the card's plain versions are
    not the CPU's); no device, so the gate's metrics are left out."""
    from benchmark import manifest, run
    m = manifest.load()
    cell = manifest.cell("dinov2g14reg-probe-b128", m)
    tiny = manifest.Cell(
        name="tiny-dinov2", chips=1, config=tiny_cfg("bfloat16"),
        traffic=traffic("probe"),
        limits={"loss_gap": 1e-2, "grad_gap": 0.05, "update_gap": 0.05,
                "grad_dist": 0.1},
        end_to_end=cell.end_to_end, per_layer=cell.per_layer)
    assert {"swiglu_ms", "swiglu_roofline"} <= {p["name"]
                                                for p in cell.per_layer}
    out = run.run(tiny, SEED, 0.2, trace=True, device="cpu")
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["host_ms"]["value"] > 0
    assert "swiglu_ms" not in out["metrics"]
    assert "swiglu_roofline" not in out["metrics"]


def test_mlp_half_counts_w12_and_w3():
    """``flops.mlp_half`` reads ``hidden`` = 3F/2: its two products are the
    giant's w12 (D -> 2F) and w3 (F -> D), and its weight bytes theirs."""
    d = dinov2_ep.dims(CFG, 224)
    assert (d["ffn"], d["hidden"], d["T"]) == (4096, 6144, 261)
    T, D, F, B = d["T"], d["D"], d["ffn"], 128
    ops, moved = flops.mlp_half(CFG, 224, B)
    assert ops == B * (2 * T * D * 2 * F + 2 * T * F * D)
    weights = 2 * F * D + F * D
    assert moved - 2 * (2 * B * T * D) == pytest.approx(2 * weights,
                                                        rel=1e-3)
