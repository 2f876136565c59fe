"""The harness's own arithmetic and its manifest, on the CPU."""
import ast
import json
import re
import statistics
from pathlib import Path

import pytest

from benchmark import devtrace, flops, imports, manifest, run
from benchmark.references.vit_ep import dims

BENCH = Path(manifest.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_manifest_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["traffic"] for w in bench["workloads"]]
    assert all(NAME.match(n) for n in names), names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_is_found_by_name(bench):
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["step"] in ("probe", "finetune")
        assert set(cell.limits) == {"loss_gap", "grad_gap", "update_gap",
                                    "grad_dist"}
        assert {m["name"] for m in cell.end_to_end} >= {"img_s", "setup_s"}
        assert cell.per_layer
    with pytest.raises(KeyError):
        manifest.cell("no-such-cell", bench)


def test_every_config_file_is_its_own_and_at_published_widths(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    published = {"vit-b16-ep32": (768, 12, 12, 3072, 16),
                 "vit-h14-ep32": (1280, 32, 16, 5120, 14)}
    for c in bench["configs"]:
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        got = tuple(cfg[k] for k in ("hidden_size", "num_hidden_layers",
                                     "num_attention_heads",
                                     "intermediate_size", "patch_size"))
        assert got == published[c["name"]]


def test_every_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))


def test_vit_b16_flops_per_image():
    cfg = json.loads((BENCH / "configs" / "vit-b16-ep32.json").read_text())
    assert flops.encoder_forward(dims(cfg, 224)) == pytest.approx(35.13e9,
                                                                  abs=0.01e9)
    d = dims(cfg, 224)
    enc, head = flops.encoder_forward(d), flops.head_forward(d)
    assert head == pytest.approx(0.2425e9, rel=1e-3)
    assert flops.step_per_image(cfg, 224, False) == enc + 3 * head
    assert flops.step_per_image(cfg, 224, True) == 3 * (enc + head)
    # one call of each half at batch 1 adds up to a block's operations
    a, _ = flops.attn_half(cfg, 224, 1)
    m, _ = flops.mlp_half(cfg, 224, 1)
    patch = 2 * d["N"] * 768 * 768
    assert 12 * (a + m) + patch == pytest.approx(
        flops.encoder_forward(d))


def test_p90_is_over_all_steps():
    steady = [45.0] * 80 + [90.0] * 20  # a stall every fifth step
    assert run.p90(steady) == 90.0
    assert statistics.median(steady) == 45.0
    vals = list(range(1, 101))
    assert run.p90(vals) == statistics.quantiles(vals, n=10,
                                                 method="inclusive")[8]


def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def hand_trace():
    ua = "user_annotation"
    ev = [_x(ua, "bench::window", 0, 100, 1),
          _x(ua, "bench::step", 0, 50, 1), _x(ua, "bench::step", 50, 50, 1),
          _x(ua, "bench::forward", 1, 29, 1),
          _x(ua, "bench::attn_half", 2, 8, 1),
          _x(ua, "bench::mlp_half", 10, 10, 1),
          _x(ua, "bench::head", 20, 9, 1),
          _x("cpu_op", "aten::mm", 22, 6, 1),
          _x(ua, "bench::mlp_half", 35, 5, 2),  # recomputed in the backward
          _x("gpu_user_annotation", "bench::head", 20, 50, 7)]
    launches = [(1, 3, 1), (2, 12, 1), (3, 21, 1), (4, 29.5, 1), (5, 36, 2),
                (6, 41, 2), (7, 55, 1), (8, 150, 1)]
    for corr, ts, tid in launches:
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 0.5, tid,
                     correlation=corr))
    kernels = [(1, 4, 10, 7), (2, 14, 6, 7), (3, 18, 4, 8), (4, 30, 5, 7),
               (5, 40, 10, 7), (6, 60, 20, 7), (7, 85, 10, 7), (8, 150, 5, 7)]
    for corr, ts, dur, stream in kernels:
        ev.append(_x("kernel", f"k{corr}", ts, dur, stream, correlation=corr))
    return ev


def test_trace_union_and_attribution(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": hand_trace()}))
    s = devtrace.Summary(devtrace.load(path))
    assert s.steps == 2 and s.window_s == pytest.approx(100e-6)
    # kernels 2 and 3 overlap on two streams: the union counts them once
    assert s.busy_s == pytest.approx(63e-6)
    us = {k: v * 1e6 for k, v in s.by_label.items()}
    assert us == pytest.approx({"bench::attn_half": 10, "bench::mlp_half": 16,
                                "bench::head": 4, "bench::forward": 5,
                                None: 20, "bench::step": 10})
    assert s.calls["bench::mlp_half"] == 2 and s.calls["bench::attn_half"] == 1
    assert s.outside_forward_ms() == pytest.approx(15e-3)
    assert s.per_step_ms("bench::mlp_half") == pytest.approx(8e-3)
    assert s.idle_by_host["aten::mm"] == pytest.approx(8e-6)
    assert sum(s.idle_by_host.values()) == pytest.approx(37e-6)
    b = s.breakdown()
    assert b["device_ops"][0] == ["k6", pytest.approx(20e-6)]
    assert len(b["device_ops"]) == 7  # k8 was launched after the window


def test_union_and_innermost():
    assert devtrace.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [
        (0, 4), (5, 6)]
    ranges = [(0, 10, "a"), (2, 4, "b"), (6, 8, "c")]
    assert devtrace.innermost(ranges, [1, 3, 5, 7, 9, 11]) == [
        "a", "b", "a", "c", "a", None]


def test_import_check_compares_whole_top_level_names():
    assert imports.forbidden(["ep_tpu_torch", "ep_tpu_torch.ops", "numpy",
                              "jaxtyping"]) == []
    assert imports.forbidden(["ep_tpu.ops.attention"]) == ["ep_tpu"]
    assert imports.forbidden(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def _imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    return names


def test_references_import_nothing_of_the_port():
    paths = sorted((BENCH / "references").glob("*.py"))
    assert len(paths) >= 2
    for path in paths:
        names = _imported(path)
        assert names <= {"__future__", "math", "torch"}, (path, names)
        assert not names & {"ep_tpu_torch", "ep_tpu", "jax", "jaxlib", "flax"}


def test_every_config_names_a_reference_and_covers_its_layout(bench):
    for c in bench["configs"]:
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        ref = manifest.reference(cfg)
        keys = set(ref.layout(ref.dims(cfg, cfg["image_size"])))
        assert set(cfg["init"]) == keys == set(cfg["port_names"])


def test_harness_imports_the_port_only_in_program_and_run():
    for path in BENCH.rglob("*.py"):
        names = _imported(path)
        assert not names & {"ep_tpu", "jax", "jaxlib", "flax"}, path
        if "ep_tpu_torch" in names:
            assert path.name in ("program.py", "run.py", "control.py") or (
                path.parent.name == "tests"), path
