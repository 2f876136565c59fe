"""bwd_opt_ms: device ms per step of the operations launched outside the
model's forward: the loss, the backward (autograd; kernel E and the
products' gradients when fine-tuning), the metrics and LARS. Layer:
backward and optimizer. Moves ``img_s``."""


def read(r):
    s = r.summary
    if s is None or s.steps == 0 or not s.by_label:
        return None
    return s.outside_forward_ms()
