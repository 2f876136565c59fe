"""The port's spans (``runtime/profiler.py::span``) on the CPU: the shared
no-op with no profiler running, and under ``torch.profiler`` the ``ep::``
ranges of a tiny ViT's train step, properly nested, in step order, with the
MLP half opened again in the backward under ``remat_blocks``; the epoch
loop's input spans; ``trace`` writing its Chrome trace."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ep_tpu_torch.configs import TrainConfig
from ep_tpu_torch.models.assembly import ProbeModel, build_backbone_config
from ep_tpu_torch.runtime import profiler
from ep_tpu_torch.runtime.profiler import span, trace
from ep_tpu_torch.train import engine
from ep_tpu_torch.train.lars import LARS
from ep_tpu_torch.train.state import freeze
from ep_tpu_torch.train.steps import make_train_step

IMG, B, C, DEPTH = 32, 4, 5, 2
STEP_CHILDREN = ["ep::forward", "ep::loss", "ep::backward", "ep::metrics",
                 "ep::optimizer", "ep::metrics"]


def tiny_step(finetuning: bool = False, remat_policy: str | None = None):
    cfg = TrainConfig(model="vit_tiny_patch16", cls_features="ep",
                      ep_queries=4, nb_classes=C, image_size=IMG,
                      amp="float32", finetuning=finetuning,
                      scan_blocks=remat_policy is not None,
                      remat_blocks=remat_policy is not None,
                      remat_policy=remat_policy or "none")
    torch.manual_seed(0)
    model = ProbeModel(build_backbone_config(cfg).replace(
        embed_dim=64, depth=DEPTH, num_heads=2), cfg)
    opt = LARS(freeze(model, finetuning), weight_decay=0.05)
    return make_train_step(model, opt, lambda step: 0.1)


def batch(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, IMG, IMG, 3, generator=g),
            torch.randint(0, C, (B,), generator=g))


def spans_of(prof, tmp_path) -> list:
    """(start, end, name, tid) of every host ``ep::`` range in the trace,
    by start, an enclosing range before the ranges it holds."""
    path = tmp_path / "spans.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["ts"], e["ts"] + e["dur"], e["name"], e["tid"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith("ep::")]
    return sorted(out, key=lambda r: (r[0], -r[1]))


def parents(spans: list) -> list:
    """The innermost enclosing span on the same thread of each span (None
    at the top), checking that no two spans cross."""
    out, stacks = [], {}
    for s in spans:
        stack = stacks.setdefault(s[3], [])
        while stack and stack[-1][1] <= s[0]:
            stack.pop()
        if stack:
            assert s[1] <= stack[-1][1], ("spans cross", stack[-1], s)
        out.append(stack[-1] if stack else None)
        stack.append(s)
    return out


def traced_steps(step, tmp_path, n: int = 1) -> list:
    images, labels = batch()
    step(0, images, labels)  # outside the profiler: the optimizer's state
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(n):
            step(1 + i, images, labels)
    return spans_of(prof, tmp_path)


@pytest.mark.parametrize("name", ["ep::step", "ep::backward", "ep::optimizer",
                                  "ep::attn_half", "ep::data_wait"])
def test_span_without_a_profiler_is_the_shared_no_op(name):
    s = span(name)
    assert s is profiler._OFF and s is span("ep::other")
    with s as entered:
        assert entered is None


def test_span_under_a_profiler_is_a_record_function(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = span("ep::probe")
        assert s is not profiler._OFF
        with s:
            torch.ones(2).sum()
    assert span("ep::probe") is profiler._OFF
    assert [r[2] for r in spans_of(prof, tmp_path)] == ["ep::probe"]


@pytest.mark.parametrize("finetuning", [False, True])
def test_train_step_nests_its_spans_in_step_order(finetuning, tmp_path):
    spans = traced_steps(tiny_step(finetuning), tmp_path, n=2)
    parent = dict(zip(spans, parents(spans)))
    steps = [s for s in spans if s[2] == "ep::step"]
    assert len(steps) == 2 and all(parent[s] is None for s in steps)
    for st in steps:
        children = [s for s in spans if parent[s] == st]
        assert [s[2] for s in children] == STEP_CHILDREN
        forward = children[0]
        inside = [s[2] for s in spans if parent[s] == forward]
        assert sorted(inside) == sorted(
            ["ep::attn_half"] * DEPTH + ["ep::mlp_half"] * DEPTH
            + ["ep::head"])
        assert inside[-1] == "ep::head"
    # a span of the model lies in the forward and nowhere else
    for s in spans:
        if s[2] in ("ep::attn_half", "ep::mlp_half", "ep::head"):
            assert parent[s][2] == "ep::forward"


@pytest.mark.parametrize("policy,whole_block", [
    ("attn_out", False), ("attn_fc1", False), ("none", True), ("dots", True)])
def test_remat_opens_the_mlp_half_again_in_the_backward(policy, whole_block,
                                                        tmp_path):
    spans = traced_steps(tiny_step(True, policy), tmp_path)
    (bwd,) = [s for s in spans if s[2] == "ep::backward"]

    def count(name, in_backward):
        return sum(1 for s in spans if s[2] == name
                   and (bwd[0] <= s[0] and s[1] <= bwd[1]) == in_backward)
    assert count("ep::mlp_half", False) == DEPTH
    assert count("ep::mlp_half", True) == DEPTH
    assert count("ep::attn_half", False) == DEPTH
    assert count("ep::attn_half", True) == (DEPTH if whole_block else 0)


def test_the_epoch_loop_spans_its_input(tmp_path):
    cfg = TrainConfig(amp="float32", pin_mem=False)
    images, labels = batch()
    loader = [(images.numpy(), labels.numpy(), np.ones(B))] * 3

    def step(i, im, lab):
        with span("ep::step"):
            return {k: torch.zeros(()) for k in
                    ("loss", "acc1", "acc5", "lr", "grad_norm")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.train_one_epoch(step, 0, loader, torch.device("cpu"), 0, cfg)
    names = [r[2] for r in spans_of(prof, tmp_path)]
    # the loader's fourth ``next`` ends the epoch
    assert names.count("ep::data_wait") == 4
    assert names.count("ep::h2d") == 3 and names.count("ep::step") == 3
    assert names[:3] == ["ep::data_wait", "ep::h2d", "ep::step"]


def test_trace_writes_the_chrome_trace_with_the_spans(tmp_path):
    step = tiny_step()
    images, labels = batch()
    with trace("") as prof:
        assert prof is None
        step(0, images, labels)
    with trace(str(tmp_path / "prof")) as prof:
        step(1, images, labels)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"ep::step", "ep::backward", "ep::optimizer"} <= names
    assert span("ep::step") is profiler._OFF
