"""A whole run on the CPU, the look for a card skipped, at a tiny size: the
sound program passes the comparison and each fault that a training cell
can have, planted under the timed path, makes ``correct`` come out false.

The limits here are the test's own: the plain versions of the CPU differ
from the card's kernels, so the cells' limits do not carry over."""
import json

import pytest

from benchmark import manifest, run

LIMITS = {"loss_gap": 5e-2, "grad_gap": 0.1, "update_gap": 0.1,
          "grad_dist": 0.2}
SEED = 2 ** 31 + 12345  # past 32 signed bits, as the driver's seeds are


def tiny_cell(step: str) -> manifest.Cell:
    cfg = json.loads((manifest.HERE / "configs" / "vit-b16-ep32.json")
                     .read_text())
    cfg.update(model="vit_tiny_patch16", hidden_size=192,
               num_attention_heads=3, intermediate_size=768, ep_queries=4,
               num_classes=10)
    traffic = dict(step=step, batch=8, image_size=32, host_steps=2,
                   trace_steps=2)
    if step == "finetune":
        traffic.update(remat_blocks=True, remat_policy="attn_out")
    m = manifest.load()
    return manifest.Cell(name=f"tiny-{step}", chips=1, config=cfg,
                         traffic=traffic, limits=LIMITS,
                         end_to_end=m["end_to_end"], per_layer=m["per_layer"])


@pytest.mark.parametrize("step", ["probe", "finetune"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half-batch"])
def test_fault_makes_correct_false(step, fault):
    out = run.run(tiny_cell(step), SEED, 0.2, trace=False, device="cpu",
                  fault=fault)
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"img_s", "step_ms_p90", "peak_mem_gib",
                                   "setup_s"}


def test_traced_run_on_the_cpu_reads_the_host():
    out = run.run(tiny_cell("probe"), SEED, 0.2, trace=True, device="cpu")
    assert out["correct"] is True
    assert out["metrics"]["host_ms"]["value"] > 0
    # no device in this trace: the device metrics are left out, never 0
    assert "idle_share" not in out["metrics"]
    assert "mfu" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
