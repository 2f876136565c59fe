"""host_ms: the host's wall time for ``train_step`` to return, in ms, the
mean over the traced run's ``host_steps`` steps, each started after a sync
(so the launch queue has room). Layer: host dispatch. Moves ``img_s``."""


def read(r):
    if not r.host_ms:
        return None
    return sum(r.host_ms) / len(r.host_ms)
