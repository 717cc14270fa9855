"""idle_share: the share of the traced window's first phase in which no
kernel ran on the card.  Layer: device."""


def read(r):
    ph = r.phase("device")
    if ph is None or not ph.kernels:
        return None
    return 100.0 * (1.0 - r.busy_s("device") / ph.seconds)
