"""Offline batches through ``ServeEngine.run(prefill="monolithic")``, back
to back from the window's start until ``seconds`` have passed: the window
is the whole batches' time, and a batch's tokens become visible when its
``run`` returns."""
from __future__ import annotations

import time

import numpy as np

from bench.harness.record import Record


def run_kwargs(server):
    return dict(page_size=server["page_size"], max_slots=server["max_slots"],
                prefill="monolithic")


def warm(engine, server, stream) -> None:
    """The mix's longest prompt, two tokens out: the largest prefill and a
    decode step over every slot (not drawn from the stream)."""
    longest = max(p for p, _ in stream.sizes)
    prompt = (np.arange(longest, dtype=np.int32) * 7919) % stream.vocab
    engine.run([(prompt, 2)], **run_kwargs(server))


def drive(engine, server, mix, stream, seconds, tracer, record: Record):
    tracer.start(seconds)
    t0 = time.perf_counter()
    record.t0 = t0
    rid = 0
    while True:
        batch = stream.take(mix["batch"])
        tb = time.perf_counter()
        ids = []
        for prompt, n_new in batch:
            record.add(rid, prompt, n_new, tb)
            ids.append(rid)
            rid += 1
        res = engine.run(batch, **run_kwargs(server))
        done = time.perf_counter()
        for i, out in zip(ids, res["outputs"]):
            r = record.reqs[i]
            r.tokens = [int(t) for t in out]
            r.stamps = [done] * len(r.tokens)
        st = res["stats"]
        record.batches.append((tb, done, st.tokens_out - st.prefill_tokens,
                               st.steps))
        if done >= t0 + seconds + tracer.paused:
            break
    record.t_end = time.perf_counter()      # after the last stamp
