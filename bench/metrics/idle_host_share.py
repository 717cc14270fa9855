"""idle_host_share: the share of the traced window's first phase in which
no kernel ran on the card while the host was inside one of the program's
``step`` spans (``repro_torch.spans``) but outside its ``step.wait``: the
idle time that the host's own step work left.  The phase traces the card
alone, so the host runs as untraced.  Layer: step loop
(``serve/step_loop.py``)."""
from bench.harness import program_spans


def read(r):
    ph = r.phase("device")
    if ph is None or not ph.kernels:
        return None
    spans = program_spans.in_phase(ph)
    if not any(s[0] == "step" for _, s in spans):
        return None
    return 100.0 * program_spans.idle_host_ns(ph, spans) / (
        ph.ns_end - ph.ns_start)
