"""flash_ms: device ms per step of the operations whose name holds
``attn_flash_kernel`` (kernel F, ``csrc/attn_flash.cu``, at any head width),
over the traced steps. Layer: encoder attention half: kernel F. Moves
``img_s``."""

NAME = "attn_flash_kernel"


def read(r):
    s = r.summary
    if s is None or s.steps == 0:
        return None
    t = sum(v for k, v in s.by_name.items() if NAME in k)
    if t <= 0:
        return None
    return 1e3 * t / s.steps
