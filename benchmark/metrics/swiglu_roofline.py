"""swiglu_roofline: the SwiGLU gate kernel's share of its roofline, in %:
the least time the card could take for the bytes of every gate call the
trace shows (``swiglu_bytes.gate_call``; one call a ``bench::mlp_half``
range), over the device time of the operations whose name holds
``swiglu_gate`` (``swiglu_ms``'s). Layer: encoder MLP half: SwiGLU gate.
Moves ``img_s``."""
from benchmark.peaks import bound_s
from benchmark.swiglu_bytes import gate_call

NAME = "swiglu_gate"
RANGE = "bench::mlp_half"


def read(r):
    s = r.summary
    if s is None or r.card is None or not s.calls.get(RANGE):
        return None
    t = sum(v for k, v in s.by_name.items() if NAME in k)
    if t <= 0:
        return None
    moved = gate_call(r.cfg, r.traffic["image_size"], r.traffic["batch"])
    return 100.0 * bound_s(0.0, moved * s.calls[RANGE], r.card) / t
