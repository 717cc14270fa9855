"""mfu: the operations that the first phase's served tokens needed
(``bench/work``: contractions at their real rows and stored channels,
attention, the scan), divided by the phase's length times the card's TF32
peak.  Layer: the whole step."""
from bench.harness.common import PEAK_TF32_FLOP_S
from bench.harness.readings import share


def read(r):
    ph = r.phase("device")
    if ph is None:
        return None
    return share(r.work("device")["model_flops"],
                 ph.seconds * PEAK_TF32_FLOP_S)
