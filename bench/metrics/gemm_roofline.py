"""gemm_roofline: the least time the contractions that the first phase's
served tokens needed could take on the card (``bench/work``), as a share
of the device time of the GEMM kernel group (K2 / K3).  Layer:
contraction K2 / K3 (``kernels/ops.py``, ``quant_matmul.py``,
``packed_matmul.py``, ``csrc/*_matmul.cu``, ``gemm_tiles.cuh``)."""
from bench.harness.readings import share


def read(r):
    if r.phase("device") is None:
        return None
    return share(r.work("device")["gemm"]["bound_s"],
                 r.group_s("device", "gemm"))
