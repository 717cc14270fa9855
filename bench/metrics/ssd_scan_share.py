"""ssd_scan_share: device time of the kernels inside the program's
``ssd_chunk_scan`` profiler range as a share of the device's busy time, in
the traced window's second phase.  Layer: SSD scan (``models/ssm.py``)."""
from bench.harness.readings import share


def read(r):
    if r.phase("ranges") is None:
        return None
    return share(r.range_s("ranges", "ssd_chunk_scan"), r.busy_s("ranges"))
