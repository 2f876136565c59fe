"""rope_roofline: the RoPE kernel's share of its roofline, in %: the least
time the card could take for the bytes of every RoPE call the trace shows
(``rope_bytes.rope_call``; one call a ``bench::attn_half`` range), over the
device time of the operations whose name holds ``rope_qk`` (``rope_ms``'s).
Layer: encoder attention half: RoPE. Moves ``img_s``."""
from benchmark.peaks import bound_s
from benchmark.rope_bytes import rope_call

NAME = "rope_qk"
RANGE = "bench::attn_half"


def read(r):
    s = r.summary
    if s is None or r.card is None or not s.calls.get(RANGE):
        return None
    t = sum(v for k, v in s.by_name.items() if NAME in k)
    if t <= 0:
        return None
    moved = rope_call(r.cfg, r.traffic["image_size"], r.traffic["batch"])
    return 100.0 * bound_s(0.0, moved * s.calls[RANGE], r.card) / t
