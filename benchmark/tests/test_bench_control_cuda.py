"""The control and the faults at each cell's own size, on the card: the
reference in float8 in the program's place, a step that leaves its state
unchanged and half of the batch left out each fail the cell's limits on
three seeds, while the program passes them.

    python -m pytest benchmark/tests -m cuda -q     (on the card)
"""
import pytest
import torch

from benchmark import check, control, manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_the_cells_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    cell = manifest.cell(name)
    rows = control.readings(cell, SEEDS, set(SEEDS), "cuda",
                            emit=lambda line: None)
    for r in rows:
        ok, checks = check.judge(r, cell.limits)
        assert ok is (r["kind"] == "sound"), (r["kind"], r["seed"], checks)
