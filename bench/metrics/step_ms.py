"""step_ms: the traced window's first phase, in milliseconds, divided by
the model calls in it (``model_step``, ``prefill``, ``decode_step_paged``).
Layer: step loop and engine (``serve/step_loop.py``,
``serve/engine.py::_run_monolithic``)."""


def read(r):
    if r.phase("device") is None:
        return None
    n = r.model_calls("device")
    return 1e3 * r.phase("device").seconds / n if n else None
