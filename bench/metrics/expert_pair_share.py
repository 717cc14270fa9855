"""expert_pair_share: the routed (token, expert) pairs (``pairs``, T x K) as
a share of the dispatch buffer's rows that the expert GEMMs compute
(``rows``, E_phys x groups x C), summed over the program's ``moe`` spans
(``repro_torch.spans``) that start in the traced window's first phase.
Dropless routing gives every expert all T rows: K / E.  Layer: MoE FFN
(``models/layers.py::_moe_ffn_impl``)."""
from bench.harness.program_spans import count_sums
from bench.harness.readings import share


def read(r):
    ph = r.phase("device")
    if ph is None:
        return None
    return share(*count_sums(ph, "moe", "pairs", "rows"))
