"""ssd_row_share: the real tokens whose state the scan advanced
(``tokens``) as a share of the rows x columns it computed (``rows``),
summed over the program's ``mamba`` spans (``repro_torch.spans``) that
start in the traced window's first phase.  Layer: SSD scan
(``models/ssm.py::mamba_step``)."""
from bench.harness.program_spans import count_sums
from bench.harness.readings import share


def read(r):
    ph = r.phase("device")
    if ph is None:
        return None
    return share(*count_sums(ph, "mamba", "tokens", "rows"))
