"""ssd_roofline: the least time the SSD scan that the second phase's
served tokens needed could take on the card (``bench/work``: 4 H P N
operations a real token a Mamba layer; the fp32 state read and written
once for each advanced row, x, B, C, dt and y once a token), as a share
of the device time of the kernels inside the program's ``ssd_chunk_scan``
profiler range in that phase.  Layer: SSD scan (``models/ssm.py``)."""
from bench.harness.readings import share


def read(r):
    if r.phase("ranges") is None:
        return None
    work = r.work("ranges").get("ssd")
    if work is None:
        return None
    return share(work["bound_s"], r.range_s("ranges", "ssd_chunk_scan"))
