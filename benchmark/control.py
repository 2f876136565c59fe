"""The readings that set a cell's limits of the correctness check.

    python3 -m benchmark.control --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--out <file.jsonl>]

For every seed, the gaps (``check.gaps``) of the program's checked steps, as
a run drives them, against the reference. For every control seed also:

- ``control``: the reference computed on products whose operands are
  rounded to float8 e4m3, the precision below the configuration's bfloat16,
  put in the program's place;
- ``unchanged``: the program with a step that returns its state unchanged;
- ``half-batch``: the program with half of the batch left out of the loss.

Then, for each gap: the lower reading (the largest of the sound runs), the
upper (the smallest of the control and of the faults that read ten times the
lower or more; a state left unchanged, three times), and a limit between
them, nearer the upper: lower^(1/3) * upper^(2/3). The benchmark's runs never
run this; it runs on the card, one process for all seeds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, manifest
from .weights import draw_batches, draw_weights

FAULTS = ("unchanged", "half-batch")


def program_gaps(cell, seed: int, ref: dict, device, fault=None) -> dict:
    from .program import Program
    cfg, traffic = cell.config, cell.traffic
    W = draw_weights(cfg, traffic["image_size"], seed, device,
                     frozen_encoder=traffic["step"] != "finetune")
    images, labels = draw_batches(cfg, traffic, seed, device)
    prog = Program(cfg, traffic, W, device)
    del W
    with prog.fault(fault):
        r = check.program_readings(prog, images, labels,
                                   cfg["optimizer"]["schedule"]["start_step"])
    del prog, images, labels
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return check.gaps(r, ref)


def readings(cell, seeds, control_seeds, device="cuda", emit=print) -> list:
    """One row (seed, kind, gaps) per reading."""
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        ref = check.reference_readings(cell.config, cell.traffic, seed, device)
        kinds = [("sound", None)]
        if seed in control_seeds:
            kinds += [("control", "fp8")] + [(f, f) for f in FAULTS]
        for kind, arg in kinds:
            if kind == "control":
                r = check.reference_readings(cell.config, cell.traffic, seed,
                                             device, precision="fp8")
                g = check.gaps(r, ref)
            else:
                g = program_gaps(cell, seed, ref, device, arg)
            row = {"cell": cell.name, "seed": seed, "kind": kind, **g}
            rows.append(row)
            emit(json.dumps(row))
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr,
              flush=True)
    return rows


def limits(rows: list) -> dict:
    """gap -> {lower, upper, limit, upper_from} from the rows."""
    out = {}
    for gap in check.GAPS:
        lower = max(r[gap] for r in rows if r["kind"] == "sound")
        cands = {}
        for kind in ("control",) + FAULTS:
            vals = [r[gap] for r in rows if r["kind"] == kind]
            if not vals:
                continue
            least = min(vals)
            need = 3.0 if kind in ("control", "unchanged") else 10.0
            if least >= need * lower:
                cands[kind] = least
        if cands:
            kind = min(cands, key=cands.get)
            upper = cands[kind]
            out[gap] = dict(lower=lower, upper=upper, upper_from=kind,
                            limit=lower ** (1 / 3) * upper ** (2 / 3))
        else:
            out[gap] = dict(lower=lower, upper=None, upper_from=None,
                            limit=None)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(a.workload)
    f = open(a.out, "a") if a.out else None
    try:
        def emit(line):
            print(line, flush=True)
            if f:
                f.write(line + "\n")
                f.flush()
        rows = readings(cell, a.seeds, set(a.control_seeds), "cuda", emit)
        summary = {"cell": cell.name, "limits": limits(rows)}
        emit(json.dumps(summary))
    finally:
        if f:
            f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
