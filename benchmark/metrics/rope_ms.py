"""rope_ms: device ms per step of the operations whose name holds
``rope_qk`` (the RoPE pass's kernel, ``csrc/rope_qk.cu``), over the traced
steps. Layer: encoder attention half: RoPE. Moves ``img_s``."""

NAME = "rope_qk"


def read(r):
    s = r.summary
    if s is None or s.steps == 0:
        return None
    t = sum(v for k, v in s.by_name.items() if NAME in k)
    if t <= 0:
        return None
    return 1e3 * t / s.steps
