"""ttft_p90_s.chat: the 90th percentile of the seconds from a request's
submission to its first visible token, over the requests submitted in the
traced window's first phase; one still without a token at the phase's end
counts with its time so far.  Layer: front end (``serve/frontend.py``)."""
from bench.harness.common import percentile


def read(r):
    if not r.served or r.phase("device") is None:
        return None
    a, b = r.bounds("device")
    vals = [(min(q.stamps[0], b) if q.stamps else b) - q.submit_t
            for q in r.record.reqs.values() if a <= q.submit_t < b]
    return percentile(vals, 90) if vals else None
