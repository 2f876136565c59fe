"""attn_roofline: the attention halves' share of their roofline, in %: the
least time the card could take for the work of every call the trace shows
(``flops.attn_half``: LN1, qkv, QK^T, PV, the projection, the residual),
over their device time (``attn_ms``'s). Layer: encoder attention half.
Moves ``img_s``."""
from benchmark.flops import attn_half
from benchmark.peaks import bound_s

RANGE = "bench::attn_half"


def read(r):
    s = r.summary
    if s is None or r.card is None or not s.calls.get(RANGE):
        return None
    t = s.by_label.get(RANGE, 0.0)
    if t <= 0:
        return None
    ops, moved = attn_half(r.cfg, r.traffic["image_size"], r.traffic["batch"])
    n = s.calls[RANGE]
    return 100.0 * bound_s(ops * n, moved * n, r.card) / t
