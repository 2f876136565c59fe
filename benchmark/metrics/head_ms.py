"""head_ms: device ms per step of the operations launched inside the
head's forward (``ProbeModel.head``: the value projection, kernel D, the
BatchNorm, the classifier). Layer: head. Moves ``img_s``."""


def read(r):
    s = r.summary
    if s is None or not s.calls.get("bench::head"):
        return None
    return s.per_step_ms("bench::head")
