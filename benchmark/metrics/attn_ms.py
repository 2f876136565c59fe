"""attn_ms: device ms per step of the operations launched inside the
blocks' attention halves (``Block.attn_half``: kernels A, B or F, and C on
the supercell route). Layer: encoder attention half. Moves ``img_s``."""


def read(r):
    s = r.summary
    if s is None or not s.calls.get("bench::attn_half"):
        return None
    return s.per_step_ms("bench::attn_half")
