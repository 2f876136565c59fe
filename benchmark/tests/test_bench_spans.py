"""The ``ep::`` attribution of ``benchmark/spans.py`` on a hand-made trace,
and on a traced run on the CPU at a tiny size."""
import json

import pytest

from benchmark import devtrace, spans
from benchmark.tests.test_bench_faults import SEED, tiny_cell
from benchmark.tests.test_bench_harness import _x

UA = "user_annotation"
MAIN, AUTOGRAD, STREAM = 1, 2, 7


def bench_ranges():
    """The harness's ranges: the window, one step, a layer on each thread."""
    return [_x(UA, "bench::window", 0, 100, MAIN),
            _x(UA, "bench::step", 0, 100, MAIN),
            _x(UA, "bench::forward", 2, 18, MAIN),
            _x(UA, "bench::attn_half", 4, 6, MAIN),
            _x(UA, "bench::mlp_half", 30, 10, AUTOGRAD)]


def ep_ranges():
    """The program's spans: a step whose backward hands straight over to
    the optimizer, the MLP half recomputed on autograd's thread."""
    return [_x(UA, "ep::step", 1, 98, MAIN),
            _x(UA, "ep::forward", 2, 18, MAIN),
            _x(UA, "ep::attn_half", 4.5, 5, MAIN),
            _x(UA, "ep::loss", 20, 2, MAIN),
            _x(UA, "ep::backward", 22, 38, MAIN),
            _x(UA, "ep::mlp_half", 30, 10, AUTOGRAD),
            _x(UA, "ep::optimizer", 60, 30, MAIN),
            _x(UA, "ep::metrics", 90, 5, MAIN),
            # the same name on the device's timeline is no host span
            _x("gpu_user_annotation", "ep::backward", 0, 100, STREAM)]


def device_ops():
    """(correlation, launch ts, launching thread, kernel ts, kernel dur)."""
    ops = [(1, 5, MAIN, 6, 4), (2, 21, MAIN, 21, 1), (3, 25, AUTOGRAD, 25, 10),
           (4, 35, AUTOGRAD, 36, 4), (5, 45, AUTOGRAD, 45, 5),
           (7, 63, MAIN, 64, 2), (8, 80, MAIN, 80, 5)]
    ev = []
    for corr, launch, tid, ts, dur in ops:
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", launch, 0.5, tid,
                     correlation=corr))
        ev.append(_x("kernel", f"k{corr}", ts, dur, STREAM, correlation=corr))
    return ev


def summary_and_spans(events):
    s = devtrace.Summary(events)
    return s, spans.Spans(events, s)


@pytest.fixture
def split():
    return summary_and_spans(bench_ranges() + ep_ranges() + device_ops())


def test_a_kernel_of_autograds_thread_belongs_to_the_mains_backward(split):
    s, sp = split
    us = {k: v * 1e6 for k, v in sp.device_s.items()}
    # k3 and k5: autograd's thread has no span open at their launch
    assert us["ep::backward"] == pytest.approx(15)
    assert sp.metrics()["bwd_ms"] == pytest.approx(15e-3)


def test_autograds_own_span_keeps_its_kernels(split):
    s, sp = split
    us = {k: v * 1e6 for k, v in sp.device_s.items()}
    assert us == pytest.approx({"ep::attn_half": 4, "ep::loss": 1,
                                "ep::backward": 15, "ep::mlp_half": 4,
                                "ep::optimizer": 7})
    assert sp.calls["ep::mlp_half"] == 1 and sp.calls["ep::backward"] == 1


def test_an_idle_gap_is_split_by_exact_overlap(split):
    s, sp = split
    us = {k: v * 1e6 for k, v in sp.idle_s.items()}
    # the gap from 50 to 64 crosses the backward's end at 60
    assert us["ep::backward"] == pytest.approx(3 + 1 + 5 + 10)
    assert us["ep::optimizer"] == pytest.approx(4 + 14 + 5)
    assert us == pytest.approx({None: 2, "ep::step": 5, "ep::forward": 12.5,
                                "ep::attn_half": 1.5, "ep::loss": 1,
                                "ep::backward": 19, "ep::optimizer": 23,
                                "ep::metrics": 5})
    assert sum(us.values()) == pytest.approx(1e6 * (s.window_s - s.busy_s))
    m = sp.metrics()
    assert m["bwd_idle_ms"] == pytest.approx(19e-3)
    assert m["opt_idle_ms"] == pytest.approx(23e-3)


def test_host_self_time_leaves_out_child_spans(split):
    s, sp = split
    us = {k: v * 1e6 for k, v in sp.host_s.items()}
    assert us["ep::optimizer"] == pytest.approx(30)
    assert us["ep::step"] == pytest.approx(98 - 18 - 2 - 38 - 30 - 5)
    assert us["ep::forward"] == pytest.approx(18 - 5)
    assert "ep::mlp_half" not in us  # autograd's thread
    assert sp.metrics()["opt_host_ms"] == pytest.approx(30e-3)


def test_the_split_adds_up_to_bwd_opt_ms(split):
    s, sp = split
    r = sp.report()
    assert r["split_ms"] == pytest.approx(r["bwd_opt_ms"])
    assert r["outside_spans_pct"] == 0
    assert sum(r["idle_ms"].values()) == pytest.approx(r["window_idle_ms"])


def test_the_spans_leave_the_bench_attribution_as_it_was(split):
    with_ep, _ = split
    without = devtrace.Summary(bench_ranges() + device_ops())
    for name in ("by_label", "calls", "by_name"):
        assert getattr(with_ep, name) == getattr(without, name), name
    for name in ("busy_s", "steps", "window_s"):
        assert getattr(with_ep, name) == getattr(without, name), name
    assert with_ep.outside_forward_ms() == without.outside_forward_ms()


def test_a_trace_without_spans_reads_none():
    _, sp = summary_and_spans(bench_ranges() + device_ops())
    assert sp.metrics() == dict.fromkeys(
        ("bwd_ms", "opt_ms", "opt_host_ms", "bwd_idle_ms", "opt_idle_ms"))


@pytest.mark.parametrize("step", ["probe", "finetune"])
def test_a_cpu_traced_run_reads_the_host_alone(step):
    out = spans.measure(tiny_cell(step), SEED, device="cpu")
    m = out["metrics"]
    assert m["opt_host_ms"] > 0
    assert m["bwd_ms"] is m["opt_ms"] is None
    assert m["bwd_idle_ms"] is m["opt_idle_ms"] is None
    assert "split_ms" not in out
    calls = out["calls_per_step"]
    assert calls["ep::step"] == calls["ep::backward"] == 1
    assert calls["ep::metrics"] == 2
    # recomputed in the backward under remat_blocks
    assert calls["ep::mlp_half"] == (2 if step == "finetune" else 1) * 12
    json.dumps(out)
