"""launches_per_step: device kernels (copies and fills left out) in the
traced window's first phase divided by the model calls in it.  Layer: model (``models/transformer.py``,
``models/ssm.py``, ``models/layers.py``)."""


def read(r):
    if r.phase("device") is None:
        return None
    n = r.model_calls("device")
    k = sum(not name.startswith(("Memcpy", "Memset"))
            for _, _, name in r.phase("device").kernels)
    return k / n if n and k else None
