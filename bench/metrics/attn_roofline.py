"""attn_roofline: the least time the attention that the first phase's
served tokens needed could take on the card (``bench/work``), as a share
of the device time of the attention kernel group (K1 / K4).  Layer:
attention K1 / K4 (``kernels/attention.py``, ``csrc/flash_attention.cu``,
``csrc/paged_attention.cu``)."""
from bench.harness.readings import share


def read(r):
    if r.phase("device") is None:
        return None
    return share(r.work("device")["attn"]["bound_s"],
                 r.group_s("device", "attn"))
