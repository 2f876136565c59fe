"""swiglu_ms: device ms per step of the operations whose name holds
``swiglu_gate`` (the SwiGLU gate's kernel, ``csrc/swiglu_gate.cu``), over
the traced steps. Layer: encoder MLP half: SwiGLU gate. Moves ``img_s``."""

NAME = "swiglu_gate"


def read(r):
    s = r.summary
    if s is None or s.steps == 0:
        return None
    t = sum(v for k, v in s.by_name.items() if NAME in k)
    if t <= 0:
        return None
    return 1e3 * t / s.steps
