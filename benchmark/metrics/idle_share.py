"""idle_share: the share of the traced stretch, in %, in which no kernel,
copy or set ran on the card: one minus the union of the device intervals
over the stretch. Layer: device. Moves ``img_s``."""


def read(r):
    s = r.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
