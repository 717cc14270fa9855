"""itl_p99_ms.chat: the 99th percentile of the gaps between consecutive
visible tokens of one stream, both inside the traced window's first phase,
in milliseconds.  Layer: step loop (``serve/step_loop.py``)."""
from bench.harness.common import percentile


def read(r):
    if not r.served or r.phase("device") is None:
        return None
    a, b = r.bounds("device")
    gaps = [1e3 * (t1 - t0) for q in r.record.reqs.values()
            for t0, t1 in zip(q.stamps, q.stamps[1:]) if a <= t0 and t1 < b]
    return percentile(gaps, 99) if gaps else None
