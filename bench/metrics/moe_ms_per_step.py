"""moe_ms_per_step: device milliseconds of the kernels inside the
program's ``moe_dispatch`` and ``moe_gather`` profiler ranges, divided by
the model calls, in the traced window's second phase.  Layer: MoE FFN
(``models/layers.py::_moe_ffn_impl``)."""


def read(r):
    if r.phase("ranges") is None:
        return None
    s = r.range_s("ranges", "moe_dispatch") + r.range_s("ranges",
                                                         "moe_gather")
    n = r.model_calls("ranges")
    return 1e3 * s / n if s > 0 and n else None
