"""DINOv3 ViT-7B/16 (``dinov3_vit7b16``) in the port at the hub's layout, on
the CPU:

* the port builds the 7B at its published widths (D=4096, depth 40, 32
  heads of 128, SwiGLU 8192, 4 storage tokens, no position embedding, no
  qkv bias, LayerNorm eps 1e-5) through ``build_backbone_config``, and the
  benchmark's width check (``benchmark/program.py``) accepts
  ``configs/dinov3-vit7b16-ep32.json``;
* a state dict with the hub's names (one block at the published widths)
  loads strictly through ``convert/torch_vit.py``: ``storage_tokens``,
  ``mlp.w1``/``mlp.w2`` into ``mlp.w12``, the training-only entries dropped
  and RoPE's periods checked;
* RoPE's tables against the hub's formula written out here, its plain chain
  against the rotation written out per head, its routes (the kernel's entry
  without a gradient, the chain with one), its span inside the attention
  half's, a head slice rotating as the whole does, and ``shuffle_subsets``
  refused;
* head width 128's routes: kernel F at every T, the tiled backward (which
  differentiates on the CPU);
* the port against the benchmark's plain reference
  (``benchmark/references/dinov3_ep.py``) at a tiny size that keeps every
  switch of the 7B: D=128, 2 heads of 64, depth 2, 64 px images (a 4x4 grid
  of patch 16, T=21), batch 8, EP-4, 10 classes, the hidden ratio 2. The
  port is built by the benchmark's ``Program`` with the weights the
  benchmark draws, its backbone config cut to that size. Logits, patch
  features, the head's gradients and a fine-tuning step's gradients agree in
  float32 and bfloat16, and a reference without RoPE, with the prefix tokens
  rotated too, with the grid's h and w swapped, or without LayerScale does
  not; ``benchmark.run`` runs the tiny cell.

Tolerances (each beside its comparison): float32 both sides compute the
same function with sums in another order (einsum against ``F.linear``), some
1e-6 of the largest magnitude apart; bfloat16 the port rounds after every
operation where the reference does not round at all.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import ep_tpu_torch.models.vit as pvit
from benchmark import check, flops
from benchmark.program import Program
from benchmark.references import dinov3_ep
from benchmark.weights import draw_batches, draw_weights
from ep_tpu_torch.configs import TrainConfig
from ep_tpu_torch.convert.torch_vit import torch_vit_to_backbone
from ep_tpu_torch.models import assembly
from ep_tpu_torch.models.assembly import SkipDefaultInit, oracle_config
from ep_tpu_torch.models.vit import VisionTransformer
from ep_tpu_torch.models.wrappers import dinov3_config
from ep_tpu_torch.ops import LAUNCHES, reset_launches
from ep_tpu_torch.ops.attn_fused import (attention_qkv_fused,
                                         attention_qkv_fused_bwd_long,
                                         attn_route, bwd_route)
from ep_tpu_torch.ops.rope import rope_qk, rope_qk_ref, rope_tables

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "benchmark" / "configs" / "dinov3-vit7b16-ep32.json")
                 .read_text())
SMALL = dict(embed_dim=128, depth=2, num_heads=2)
TINY = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=256, ep_queries=4, num_classes=10)
SEED = 2 ** 31 + 26
# float32: ~1e-6 apart (sums in another order); 1e-4 of the largest
# magnitude leaves room, and each faulted reference lies 1e-2 or more away
F32_TOL = 1e-4
# bfloat16: the port rounds after every operation (a step of 2**-8), which
# two blocks carry to the features (measured 1.0e-2 to 1.1e-2); 2**-5 of
# the largest magnitude, the suite's bar for bf16 backbones
# (tests/test_torch_backbone_util.py)
BF16_TOL = 2.0 ** -5
# gradients (check.grad_dist: the norm of the difference over the leaf's
# norm, worst leaf): f32 the sums' order again; bf16 the features' rounding
# carried through the head's softmax, BatchNorm and classifier (measured
# 1.2e-2 probing, 2.7e-2 fine-tuning)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# the losses of 3 steps (check.loss_gap, relative): the same, a scalar
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def tiny_cfg(dtype: str) -> dict:
    return {**CFG, **TINY, "dtype": dtype}


def traffic(step: str) -> dict:
    return dict(step=step, batch=8, image_size=64, host_steps=1,
                trace_steps=1)


@pytest.fixture
def tiny_port(monkeypatch):
    """The port's backbone config of ``dinov3_vit7b16`` cut to SMALL,
    every switch kept (the hidden width follows the 7B's ratio)."""
    full = assembly.build_backbone_config
    monkeypatch.setattr(assembly, "build_backbone_config",
                        lambda tc: full(tc).replace(**SMALL))


def rel_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest magnitude of b."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


# ---- published widths and the hub's layout ----------------------------------

def test_7b_is_built_at_the_hub_widths():
    cfg = assembly.build_backbone_config(TrainConfig(
        model="dinov3_vit7b16", image_size=448, amp="bfloat16"))
    assert cfg == dinov3_config("dinov3_vit7b16", 448)
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.patch_size) == (
        4096, 40, 32, 16)
    assert int(cfg.embed_dim * cfg.mlp_ratio) == 8192
    assert cfg.rope_base == 100.0 and cfg.norm_eps == 1e-5
    assert cfg.num_patches == 784 and cfg.num_prefix_tokens == 5
    assert not cfg.supercell  # LayerScale and RoPE: the plain route
    with torch.device("meta"):
        m = VisionTransformer(cfg)
    blk = m.blocks[0]
    assert tuple(blk.attn.qkv.weight.shape) == (3 * 4096, 4096)
    assert blk.attn.qkv.bias is None
    assert tuple(blk.mlp.w12.weight.shape) == (16384, 4096)
    assert tuple(blk.mlp.w3.weight.shape) == (4096, 8192)
    assert tuple(m.reg_token.shape) == (1, 4, 4096)
    assert m.pos_embed is None and m.norm is not None and blk.ls1 is not None
    assert blk.norm1.eps == m.norm.eps == 1e-5
    assert len(m.blocks) == 40
    n = sum(p.numel() for p in m.parameters())
    assert 6.71e9 < n < 6.72e9  # 6.72 B parameters, 13.4 GB in bf16
    # the DINO oracle of a RoPE backbone has none
    assert oracle_config(cfg).rope_base is None
    with pytest.raises(ValueError, match="unknown DINOv3"):
        dinov3_config("dinov3_vitl16")


class _Built(Exception):
    pass


def test_benchmark_program_accepts_the_config(monkeypatch):
    """``Program`` checks the port's widths against the file's before it
    builds the model; here the build stops just after that check."""
    def stop(*a, **k):
        raise _Built
    monkeypatch.setattr(assembly, "ProbeModel", stop)
    t = json.loads((ROOT / "benchmark" / "traffic" / "probe-b8-448px.json")
                   .read_text())
    with pytest.raises(_Built):
        Program(CFG, t, {}, "cpu")
    wide = {**CFG, "intermediate_size": 12288}  # ffn_ratio 3 uncut
    with pytest.raises(ValueError, match="other sizes"):
        Program(wide, t, {}, "cpu")


def hub_state_dict(depth: int = 1, seed: int = 0) -> dict:
    """``dinov3_vit7b16``'s hub checkpoint layout at published widths,
    ``depth`` blocks; values from a cheap deterministic fill (the test
    compares where each lands, not what they are)."""
    D, F = 4096, 8192
    counter = [seed]

    def r(*shape):
        counter[0] += 1
        return torch.full(shape, float(counter[0])) + torch.linspace(
            0, 1, shape[-1])
    sd = {"cls_token": r(1, 1, D), "storage_tokens": r(1, 4, D),
          "mask_token": r(1, D),
          "rope_embed.periods": 100.0 ** (2 * torch.arange(32) / 64),
          "patch_embed.proj.weight": r(D, 3, 16, 16),
          "patch_embed.proj.bias": r(D), "norm.weight": r(D),
          "norm.bias": r(D), "local_cls_norm.weight": r(D),
          "local_cls_norm.bias": r(D)}
    for i in range(depth):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": r(D), b + "norm1.bias": r(D),
                   b + "attn.qkv.weight": r(3 * D, D),
                   b + "attn.qkv.bias_mask": torch.ones(3 * D),
                   b + "attn.proj.weight": r(D, D), b + "attn.proj.bias": r(D),
                   b + "ls1.gamma": r(D), b + "norm2.weight": r(D),
                   b + "norm2.bias": r(D), b + "mlp.w1.weight": r(F, D),
                   b + "mlp.w1.bias": r(F), b + "mlp.w2.weight": r(F, D),
                   b + "mlp.w2.bias": r(F), b + "mlp.w3.weight": r(D, F),
                   b + "mlp.w3.bias": r(D), b + "ls2.gamma": r(D)})
    return sd


def test_hub_layout_loads_strictly_at_published_widths(capsys):
    cfg = dinov3_config("dinov3_vit7b16", 448, torch.float32).replace(depth=1)
    with SkipDefaultInit():
        model = VisionTransformer(cfg)
    sd = hub_state_dict()
    state = torch_vit_to_backbone(dict(sd), model, cfg)
    model.load_state_dict(state, strict=True)
    assert "unused checkpoint keys" not in capsys.readouterr().out
    assert torch.equal(model.reg_token, sd["storage_tokens"])
    w12 = model.blocks[0].mlp.w12
    assert torch.equal(w12.weight[:8192], sd["blocks.0.mlp.w1.weight"])
    assert torch.equal(w12.weight[8192:], sd["blocks.0.mlp.w2.weight"])
    assert torch.equal(w12.bias, torch.cat([sd["blocks.0.mlp.w1.bias"],
                                            sd["blocks.0.mlp.w2.bias"]]))
    assert torch.equal(model.blocks[0].mlp.w3.weight,
                       sd["blocks.0.mlp.w3.weight"])
    assert torch.equal(model.blocks[0].ls2.gamma, sd["blocks.0.ls2.gamma"])
    assert torch.equal(model.norm.weight, sd["norm.weight"])
    # a checkpoint trained at another RoPE base is refused
    other = {**sd, "rope_embed.periods": 10.0 ** (2 * torch.arange(32) / 64)}
    with pytest.raises(ValueError, match="rope_embed.periods"):
        torch_vit_to_backbone(other, model, cfg)


# ---- RoPE -------------------------------------------------------------------

def hub_rope(H: int, W: int, head_dim: int, base: float):
    """``RopePositionEmbedding`` at inference (``normalize_coords=
    "separate"``, no shift, jitter or rescale), its lines as the hub writes
    them."""
    dd = {"device": "cpu", "dtype": torch.float32}
    periods = base ** (2 * torch.arange(head_dim // 4, **dd) / (head_dim // 2))
    coords_h = torch.arange(0.5, H, **dd) / H
    coords_w = torch.arange(0.5, W, **dd) / W
    coords = torch.stack(torch.meshgrid(coords_h, coords_w, indexing="ij"),
                         dim=-1)
    coords = coords.flatten(0, 1)
    coords = 2.0 * coords - 1.0
    angles = 2 * math.pi * coords[:, :, None] / periods[None, None, :]
    angles = angles.flatten(1, 2)
    angles = angles.tile(2)
    return torch.sin(angles), torch.cos(angles)


@pytest.mark.parametrize("H, W, Dh", [(28, 28, 128), (3, 5, 16), (4, 4, 64)])
def test_rope_tables_are_the_hub_formula(H, W, Dh):
    sin, cos = rope_tables(H, W, Dh, 100.0)
    hs, hc = hub_rope(H, W, Dh, 100.0)
    assert torch.equal(sin, hs) and torch.equal(cos, hc)
    # the formula itself in float64, patch (r, c) at row r * W + c
    per = 100.0 ** (2 * np.arange(Dh // 4) / (Dh // 2))
    for r, c in ((0, 0), (H - 1, W - 1), (H // 2, W - 1), (1 % H, 0)):
        ch, cw = 2 * (r + 0.5) / H - 1, 2 * (c + 0.5) / W - 1
        a = 2 * np.pi * np.concatenate([ch / per, cw / per])
        a = np.concatenate([a, a])
        np.testing.assert_allclose(sin[r * W + c].numpy(), np.sin(a),
                                   atol=2e-6)
        np.testing.assert_allclose(cos[r * W + c].numpy(), np.cos(a),
                                   atol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_chain_rotates_q_and_k_of_the_patch_rows(dtype):
    """``rope_qk_ref`` against the rotation written out head by head: q and
    k of the rows past the prefix rotated in f32 and rounded once; the
    prefix rows and v unchanged, bit for bit."""
    B, prefix, N, H, Dh = 2, 5, 12, 3, 16
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(B, prefix + N, 3 * H * Dh, generator=g).to(dtype)
    sin, cos = rope_tables(3, 4, Dh, 100.0)
    out = rope_qk_ref(qkv, sin, cos, H)
    assert out.dtype == dtype and out.shape == qkv.shape
    assert torch.equal(out[:, :prefix], qkv[:, :prefix])
    assert torch.equal(out[:, :, 2 * H * Dh:], qkv[:, :, 2 * H * Dh:])
    for part in range(2):
        for h in range(H):
            cols = slice((part * H + h) * Dh, (part * H + h + 1) * Dh)
            x = qkv[:, prefix:, cols].float()
            x1, x2 = x[..., :Dh // 2], x[..., Dh // 2:]
            want = torch.cat([x1 * cos[:, :Dh // 2] - x2 * sin[:, :Dh // 2],
                              x2 * cos[:, Dh // 2:] + x1 * sin[:, Dh // 2:]],
                             -1).to(dtype)
            assert torch.equal(out[:, prefix:, cols], want)
    # on CPU tensors the kernel's entry is the chain, and launches nothing
    reset_launches()
    assert torch.equal(rope_qk(qkv, sin, cos, H), out)
    assert not any(LAUNCHES.values())
    with pytest.raises(ValueError, match="tables"):
        rope_qk_ref(qkv[:, :10], sin, cos, H)


def test_a_head_slice_rotates_as_the_whole():
    """Every head takes the same tables, so a tensor-parallel rank's heads
    (its slices of q, k and v) rotate as their columns of the whole do."""
    B, prefix, N, H, Dh = 2, 1, 16, 4, 16
    qkv = torch.randn(B, prefix + N, 3 * H * Dh,
                      generator=torch.Generator().manual_seed(4))
    sin, cos = rope_tables(4, 4, Dh, 100.0)
    whole = rope_qk_ref(qkv, sin, cos, H)
    for h0, h1 in ((0, 2), (2, 4)):
        cols = [slice((p * H + h0) * Dh, (p * H + h1) * Dh) for p in range(3)]
        local = torch.cat([qkv[..., c] for c in cols], -1)
        got = rope_qk_ref(local, sin, cos, h1 - h0)
        assert torch.equal(got, torch.cat([whole[..., c] for c in cols], -1))


def test_rope_routes_and_span(monkeypatch):
    """No gradient: the kernel's entry (the plain chain on the CPU); with a
    gradient, the chain itself; ``ep::rope`` inside ``ep::attn_half`` on
    either; the tables built once a grid."""
    from torch.profiler import ProfilerActivity, profile
    cfg = dinov3_config("dinov3_vit7b16", 64, torch.float32).replace(**SMALL)
    with SkipDefaultInit():
        m = VisionTransformer(cfg)
    assembly.init_backbone(m, torch.Generator().manual_seed(5))
    took = []
    monkeypatch.setattr(pvit, "rope_qk",
                        lambda *a: took.append("entry") or rope_qk(*a))
    monkeypatch.setattr(pvit, "rope_qk_ref",
                        lambda *a: took.append("chain") or rope_qk_ref(*a))
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        y0 = m(x, "pos")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y1 = m(x, "pos")
    y1.sum().backward()
    assert m.blocks[0].attn.qkv.weight.grad is not None
    assert took == ["entry"] * 2 + ["chain"] * 2
    torch.testing.assert_close(y0, y1.detach(), rtol=0, atol=0)
    assert len(m._rope) == 1  # one grid, one device
    ev = [e for e in prof.events() if e.name in ("ep::rope", "ep::attn_half")]
    rope = [e for e in ev if e.name == "ep::rope"]
    halves = [e for e in ev if e.name == "ep::attn_half"]
    assert len(rope) == len(halves) == 2
    for r, a in zip(rope, halves):
        assert a.time_range.start <= r.time_range.start
        assert r.time_range.end <= a.time_range.end
    with pytest.raises(ValueError, match="RoPE"):
        m(x, "pos", shuffle_subsets=2)


# ---- head width 128 ----------------------------------------------------------

def test_head_width_128_routes():
    """F takes head width 128 at every T (B is not built for it); the
    backward takes the tiled plain version at every T (E is not either)."""
    for T in (1, 21, 201, 272, 789):
        assert attn_route(T, 128, 32) == "flash"
        assert bwd_route(T, 128) == "long"
    assert attn_route(201, 64, 12) == "core" and bwd_route(201, 64) == "core"


def test_head_width_128_backward_differentiates_on_the_cpu():
    """At head width 128 the fused attention's backward is
    ``attention_qkv_fused_bwd_long``, whose gradient equals autograd's
    through the plain forward."""
    T, H, Dh = 21, 2, 128
    g = torch.Generator().manual_seed(7)
    qkv = torch.randn(2, T, 3 * H * Dh, generator=g)
    dout = torch.randn(2, T, H * Dh, generator=g)
    x = qkv.clone().requires_grad_(True)
    attention_qkv_fused(x, H, Dh ** -0.5).backward(dout)
    torch.testing.assert_close(
        x.grad, attention_qkv_fused_bwd_long(qkv, dout, H, Dh ** -0.5),
        rtol=0, atol=0)
    y = qkv.clone().requires_grad_(True)
    q, k, v = y.reshape(2, T, 3, H, Dh).permute(2, 0, 3, 1, 4)
    a = torch.softmax(q @ k.transpose(-1, -2) * Dh ** -0.5, -1)
    (a @ v).transpose(1, 2).reshape(2, T, -1).backward(dout)
    torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-5)


# ---- the port against the plain reference -------------------------------------

def port_and_reference(dtype: str, step: str):
    cfg, t = tiny_cfg(dtype), traffic(step)
    W = draw_weights(cfg, t["image_size"], SEED, "cpu",
                     frozen_encoder=step == "probe")
    images, labels = draw_batches(cfg, t, SEED, "cpu")
    prog = Program(cfg, t, dict(W), "cpu")
    ref = dinov3_ep.Reference(W, dinov3_ep.dims(cfg, t["image_size"]),
                              cfg["optimizer"], step == "finetune")
    return cfg, t, prog, ref, images, labels


def features_and_logits(prog, ref, images, mutate=None):
    """(port's patch features, port's logits, reference's, reference's);
    ``mutate(W)`` changes the reference's weights first."""
    with torch.no_grad():
        logits, feats = prog.model(images, return_backbone_features=True)
    W = dict(ref.W)
    if mutate is not None:
        mutate(W)
    with torch.no_grad():
        rf = dinov3_ep.encode(W, images, ref.d, ref.mm)
        rl = dinov3_ep.head_logits(W, rf, ref.d, ref.mm)
    return feats, logits, rf, rl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_features_and_logits_match_the_reference(tiny_port, dtype):
    _, _, prog, ref, images, _ = port_and_reference(dtype, "probe")
    assert all(not b.supercell for b in prog.model.backbone.blocks)
    assert ref.d["T"] == 21 and ref.d["N"] == 16
    feats, logits, rf, rl = features_and_logits(prog, ref, images[0])
    assert feats.shape == (8, 16, 128) and logits.shape == (8, 10)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert rel_dist(feats, rf) < tol
    assert rel_dist(logits, rl) < tol


def _no_layerscale(W):
    W["ls1"] = torch.ones_like(W["ls1"])
    W["ls2"] = torch.ones_like(W["ls2"])


def _swapped_tables(grid_h, grid_w, head_dim, base, device):
    """The grid's h and w swapped: patch (r, c) gets the angles of (c, r)."""
    sin, cos = FAULTS_ORIGINAL["rope_tables"](grid_h, grid_w, head_dim, base,
                                              device)
    return tuple(t.reshape(grid_h, grid_w, -1).transpose(0, 1)
                 .reshape(grid_h * grid_w, -1) for t in (sin, cos))


def _prefix_rotated(q, k, sin, cos, prefix):
    """The prefix rows rotated too, by the first patch's angles."""
    full = [torch.cat([t[:1].expand(prefix, -1), t]) for t in (sin, cos)]
    return (dinov3_ep.rotate(q, *full), dinov3_ep.rotate(k, *full))


FAULTS_ORIGINAL = {"rope_tables": dinov3_ep.rope_tables}


@pytest.mark.parametrize("fault", ["no-rope", "prefix-rotated",
                                   "grid-swapped", "no-layerscale"])
def test_a_reference_with_a_fault_fails(tiny_port, monkeypatch, fault):
    """The comparison sees each switch of the 7B: the float32 port lies
    outside F32_TOL of a reference that leaves out RoPE, rotates [CLS] and
    the storage tokens too, swaps the grid's h and w, or leaves out
    LayerScale, by ten times the tolerance."""
    _, _, prog, ref, images, _ = port_and_reference("float32", "probe")
    mutate = None
    if fault == "no-rope":
        monkeypatch.setattr(dinov3_ep, "rope_qk",
                            lambda q, k, sin, cos, prefix: (q, k))
    elif fault == "prefix-rotated":
        monkeypatch.setattr(dinov3_ep, "rope_qk", _prefix_rotated)
    elif fault == "grid-swapped":
        monkeypatch.setattr(dinov3_ep, "rope_tables", _swapped_tables)
    else:
        mutate = _no_layerscale
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
        assert "blocks.0.qkv_w" in got["grads"]
    assert g["grad_dist"] < GRAD_TOL[dtype], g
    assert g["loss_gap"] < LOSS_TOL[dtype], g


def test_benchmark_runs_the_cell_on_the_cpu(tiny_port):
    """``benchmark.run.run`` on the configuration at the tiny size, traced:
    correct under limits of this test's own (the card's plain versions are
    not the CPU's); no device, so the kernels' metrics are left out."""
    from benchmark import manifest, run
    m = manifest.load()
    cell = manifest.cell("dinov3vit7b16-448-probe-b8", m)
    tiny = manifest.Cell(
        name="tiny-dinov3", chips=1, config=tiny_cfg("bfloat16"),
        traffic=traffic("probe"),
        limits={"loss_gap": 1e-2, "grad_gap": 0.05, "update_gap": 0.05,
                "grad_dist": 0.1},
        end_to_end=cell.end_to_end, per_layer=cell.per_layer)
    kernels = {"rope_ms", "rope_roofline", "flash_ms", "flash_roofline",
               "swiglu_ms", "swiglu_roofline"}
    assert kernels <= {p["name"] for p in cell.per_layer}
    out = run.run(tiny, SEED, 0.2, trace=True, device="cpu")
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["host_ms"]["value"] > 0
    assert not kernels & set(out["metrics"])


def test_counts_of_the_new_metrics():
    """``flops.mlp_half`` reads ``hidden`` = 3F/2 (``w12`` and ``w3``);
    kernel F's operations a call are 4 B H T^2 Dh, 81.6 GFLOP at the cell's
    shape; RoPE's bytes a call 206 MB."""
    from benchmark import flash_ops, rope_bytes
    d = dinov3_ep.dims(CFG, 448)
    assert (d["ffn"], d["hidden"], d["T"], d["N"]) == (8192, 12288, 789, 784)
    ops, moved = flops.mlp_half(CFG, 448, 8)
    assert ops == 8 * (2 * 789 * 4096 * 2 * 8192 + 2 * 789 * 8192 * 4096)
    ops, moved = flash_ops.flash_call(CFG, 448, 8)
    assert ops == 4 * 8 * 32 * 789 ** 2 * 128
    assert moved == 2 * 8 * 789 * 4 * 4096
    assert rope_bytes.rope_call(CFG, 448, 8) == (
        2 * 2 * 8 * 784 * 8192 + 2 * 4 * 784 * 128)
    assert 11.0e12 < flops.encoder_forward(d) < 11.01e12
