"""A whole run on the CPU (the look for a card skipped, the smoke sizes of
each cell's configuration) with the timed path broken underneath: the
check has to come out not correct.  The faults a served cell can have: a
token altered where it is produced, a step that leaves its state unchanged
(K / V never written to the pool; a mamba decode step that returns the
state it was given), half of the batch left out (the odd rows' logits
zeroed).  The cells run on one chip: no exchange between chips to leave
out."""
import functools

import pytest
import torch

from bench.harness import common
from bench.tests import smoke


def _limit(cell):
    return common.part("workloads", cell)["check"]["limits"]


def alter_token(engine):
    orig = engine._sample_span

    def sample(logits, lanes):
        toks, states = orig(logits, lanes)
        return (toks + 1) % engine.model.cfg.vocab, states
    engine._sample_span = sample


def drop_half(engine):
    for attr in ("_model_step", "_decode_paged"):
        orig = getattr(engine, attr)

        @functools.wraps(orig)
        def step(*a, _orig=orig, **kw):
            logits, cache = _orig(*a, **kw)
            logits = logits.clone()
            logits[:(logits.shape[0] + 1) // 2] = 0.0
            return logits, cache
        setattr(engine, attr, step)


def kv_unwritten(monkeypatch):
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "_kv_write_paged",
                        lambda cache, k, v, wp, bt: None)


def state_unchanged(monkeypatch):
    from repro_torch.models import ssm
    orig = ssm.mamba_decode_step

    def step(params, x, cache, cfg, d_model):
        out, new = orig(params, x, cache, cfg, d_model)
        return out, {"state": cache["state"].clone(), "conv": new["conv"]}
    monkeypatch.setattr(ssm, "mamba_decode_step", step)


@pytest.mark.parametrize("cell", ["granite-chat", "mamba2-docs"])
def test_sound_run_is_correct(cell, capsys):
    res = smoke.run(cell, seed=2 ** 31 + 3, limit=_limit(cell),
                    capsys=capsys)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("cell", ["granite-chat", "mamba2-docs"])
@pytest.mark.parametrize("fault", ["alter_token", "drop_half", "state"])
def test_fault_is_not_correct(cell, fault, capsys, monkeypatch):
    brk = {"alter_token": alter_token, "drop_half": drop_half}.get(fault)
    if fault == "state":
        (kv_unwritten if cell == "granite-chat" else
         state_unchanged)(monkeypatch)
    res = smoke.run(cell, seed=2 ** 31 + 3, fault=brk, limit=_limit(cell),
                    capsys=capsys)
    assert not res["correct"], res["check"]
    assert any(res["check"][name]["value"] > lim
               for name, lim in _limit(cell).items())


def test_without_card_no_result(capsys):
    """The real entry point refuses to run without a CUDA card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from bench import run
    rc = run.main(["--workload", "granite-chat", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_open_loop_driver_runs(capsys):
    """The open-loop driver and the Poisson mix, for cells that later PRs
    add as data: a sound run at smoke size is correct."""
    from bench import run as bench_run
    import json
    f = smoke.files("granite-chat")
    f["traffic"] = dict(f["traffic"], kind="poisson", rate_per_s=4.0)
    del f["traffic"]["sessions"]
    f["workload"]["driver"] = "serve_open"
    f["workload"]["check"]["limits"] = _limit("granite-chat")
    rc = bench_run.main(["--workload", "granite-chat", "--seed", "5",
                         "--seconds", "2", "--trace", "1"],
                        require_card=False, configs=f)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] >= 4, res["check"]
    assert "ttft_p90_s.chat" in res["metrics"]
