"""flash_roofline: kernel F's share of its roofline, in %: the least time
the card could take for the work of every F call the trace shows
(``flash_ops.flash_call``: QK^T and PV, qkv in and the output out; one call
a ``bench::attn_half`` range where F is on the path), over the device time
of the operations whose name holds ``attn_flash_kernel`` (``flash_ms``'s).
Layer: encoder attention half: kernel F. Moves ``img_s``."""
from benchmark.flash_ops import flash_call
from benchmark.peaks import bound_s

NAME = "attn_flash_kernel"
RANGE = "bench::attn_half"


def read(r):
    s = r.summary
    if s is None or r.card is None or not s.calls.get(RANGE):
        return None
    t = sum(v for k, v in s.by_name.items() if NAME in k)
    if t <= 0:
        return None
    ops, moved = flash_call(r.cfg, r.traffic["image_size"], r.traffic["batch"])
    n = s.calls[RANGE]
    return 100.0 * bound_s(ops * n, moved * n, r.card) / t
