#!/usr/bin/env python3
"""The multi-process phases of chip_smoke.py alone, on one CUDA card.

    python3 scripts/chip_ddp_check.py

Builds the kernels, runs chip_smoke.py's train phase (3 steps at batch 512,
for step 0's loss) and its driver phase (whose epochs and training_log.txt
lines the next phase is compared with), then ddp-nccl-1, ddp-gloo-2,
tp-gloo-2 and use-grain, with the same checks; any failure exits non-zero.
A few minutes where the whole chip_smoke.py takes ten.
"""
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

t0 = time.perf_counter()
card = cs.card_line()
cs.log(f"[device] {card} torch {torch.__version__} cuda {torch.version.cuda}")
from ep_tpu_torch.ops import _build  # noqa: E402
path, secs, compiled = _build.build()
_build.library()
cs.log(f"[build] {secs:.1f} s")
paths = {}
model, images, paths["train"], med, losses = cs.train("train", 512, 3, card)
del model, images
torch.cuda.empty_cache()
with tempfile.TemporaryDirectory() as tmp:
    epochs, extracted, lines = cs.driver(card, paths, Path(tmp) / "ep.pth")
cs.log(f"[wall] driver at {time.perf_counter() - t0:.1f} s")
cs.ddp_nccl_1(card, paths, epochs, lines)
cs.log(f"[wall] ddp-nccl-1 at {time.perf_counter() - t0:.1f} s")
cs.ddp_gloo_2(card, paths, losses[0])
cs.log(f"[wall] ddp-gloo-2 at {time.perf_counter() - t0:.1f} s")
cs.tp_gloo_2(card, paths)
cs.log(f"[wall] tp-gloo-2 at {time.perf_counter() - t0:.1f} s")
cs.grain_phase(card, paths)
cs.log(f"[wall] done at {time.perf_counter() - t0:.1f} s")
