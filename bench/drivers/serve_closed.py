"""Closed loop through ``ServeEngine.serve``: ``sessions`` clients, each
sending its next request, with no think time, the moment the last one's
final token becomes visible.

The window measures the loop in its steady state.  Each session's first
request is the one it is in the middle of there (``bench/harness/
traffic.py``: part of its output already served, as part of its prompt),
and all are submitted in set-up; the window opens at the first model call
after every session has made a token visible, so that their prefills are
set-up this traffic needs.  The window closes ``seconds`` later (later by
the time a traced run's phase switch took): the first stream callback
after that raises, which stops the program's loop where it stands; work
still in flight is not counted."""
from __future__ import annotations

import math
import time

import numpy as np

from bench.harness.record import Record, WindowClosed


def serve_kwargs(server):
    return dict(page_size=server["page_size"], max_slots=server["max_slots"],
                chunk_tokens=server["chunk_tokens"],
                token_budget=server["token_budget"])


def warm(engine, server, stream) -> None:
    """One request a slot, each a chunk and one token long, two tokens
    out: the window's two step shapes, (slots, chunk) and (slots, 1), and
    its pool, at their sizes.  The prompts are not drawn from the stream,
    which the window then starts afresh."""
    n = server["chunk_tokens"] + 1
    prompt = (np.arange(n, dtype=np.int32) * 7919) % stream.vocab
    engine.run([(prompt, 2)] * server["max_slots"], prefill="chunked",
               **serve_kwargs(server))


def drive(engine, server, mix, stream, seconds, tracer, record: Record):
    from repro_torch.serve import FrontEnd
    fe = FrontEnd(clock=time.perf_counter)
    record.chunk_tokens = server["chunk_tokens"]
    opened = []                   # the window's start, once it has opened
    waiting = set(stream.first)   # sessions with no visible token yet
    session_of = {}

    def deadline():
        return opened[0] + seconds + tracer.paused if opened else math.inf

    def open_window():
        if not waiting and not opened:
            tracer.start(seconds)
            record.t0 = time.perf_counter()
            opened.append(record.t0)
            record.on_call = None

    def submit(session, now):
        prompt, n_new = stream.next(session)
        req = fe.submit({"tokens": prompt, "n_new": n_new}, on_token=on_token)
        record.add(req.rid, prompt, n_new, now)
        session_of[req.rid] = session

    def on_token(rid, index, token):
        now = record.on_token(rid, index, token, deadline())
        waiting.discard(session_of[rid])
        if index == record.reqs[rid].n_new - 1:
            submit(session_of[rid], now)

    record.on_call = open_window
    now = time.perf_counter()
    for session in stream.first:
        submit(session, now)
    try:
        while time.perf_counter() < deadline():
            # serve() returns early only when every session finished in one
            # step: the callbacks have queued their next requests
            engine.serve(fe, **serve_kwargs(server))
    except WindowClosed:
        pass
    record.t_end = deadline()
