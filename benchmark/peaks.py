"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives: NVIDIA's data sheet for the H100 SXM
part, dense rates without sparsity, at its full 700 W limit."""
from __future__ import annotations

H100_SXM = {"bf16_flops": 989e12, "fp8_flops": 1979e12, "int8_ops": 1979e12,
            "tf32_flops": 495e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks(kind: str):
    """The card's peaks, or None for a card the table lacks."""
    return PEAKS.get(kind)


def bound_s(ops: float, moved: float, card: dict) -> float:
    """The least time the card could take: operations over the bf16 peak or
    bytes over the memory rate, whichever is larger."""
    return max(ops / card["bf16_flops"], moved / card["hbm_bytes"])
