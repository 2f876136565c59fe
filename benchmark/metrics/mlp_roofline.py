"""mlp_roofline: the MLP halves' share of their roofline, in %: the least
time the card could take for the work of every call the trace shows
(``flops.mlp_half``: LN2, fc1, GELU, fc2, the residual), over their device
time (``mlp_ms``'s). Layer: encoder MLP half. Moves ``img_s``."""
from benchmark.flops import mlp_half
from benchmark.peaks import bound_s

RANGE = "bench::mlp_half"


def read(r):
    s = r.summary
    if s is None or r.card is None or not s.calls.get(RANGE):
        return None
    t = s.by_label.get(RANGE, 0.0)
    if t <= 0:
        return None
    ops, moved = mlp_half(r.cfg, r.traffic["image_size"], r.traffic["batch"])
    n = s.calls[RANGE]
    return 100.0 * bound_s(ops * n, moved * n, r.card) / t
