"""lanes_per_step: decode tokens (every visible token but each request's
first) divided by the model calls that carry decode lanes, in the traced
window's first phase: every ``model_step``, or a monolithic run's decode
steps, each at its batch's mean lanes (``ServeStats``).  Layer: scheduler (``serve/scheduler.py``,
``serve/paged_kv.py``)."""


def read(r):
    if r.phase("device") is None:
        return None
    s = r.summary("device")
    calls = s["decode_calls"] + s["chunk_calls"]
    return s["decode_tokens"] / calls if calls and s["decode_tokens"] \
        else None
