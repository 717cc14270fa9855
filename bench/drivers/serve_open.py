"""Open loop through ``ServeEngine.serve``: requests arrive at the mix's
gaps whether or not earlier ones have finished, each timed from when it was
due.  The window closes at ``seconds`` as in ``serve_closed``."""
from __future__ import annotations

import time

from bench.drivers.serve_closed import serve_kwargs, warm  # noqa: F401
from bench.harness.record import Record, WindowClosed


def drive(engine, server, mix, stream, seconds, tracer, record: Record):
    from repro_torch.serve import FrontEnd
    fe = FrontEnd(clock=time.perf_counter)
    tracer.start(seconds)
    t0 = time.perf_counter()
    record.t0 = t0

    def deadline():
        return t0 + seconds + tracer.paused
    record.chunk_tokens = server["chunk_tokens"]

    def on_token(rid, index, token):
        now = record.on_token(rid, index, token, deadline())

    t = t0
    while True:
        prompt, n_new, gap = stream.next()
        t += gap
        if t >= t0 + seconds:
            break
        req = fe.submit({"tokens": prompt, "n_new": n_new}, at=t,
                        on_token=on_token)
        record.add(req.rid, prompt, n_new, t)
    try:
        while time.perf_counter() < deadline():
            engine.serve(fe, **serve_kwargs(server))
    except WindowClosed:
        pass
    record.t_end = deadline()
