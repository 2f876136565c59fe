"""mlp_ms: device ms per step of the operations launched inside the
blocks' MLP halves (``Block.mlp_half``: LN2, fc1, GELU, fc2, the residual;
under ``remat_blocks`` also their recomputation in the backward). Layer:
encoder MLP half. Moves ``img_s``."""


def read(r):
    s = r.summary
    if s is None or not s.calls.get("bench::mlp_half"):
        return None
    return s.per_step_ms("bench::mlp_half")
