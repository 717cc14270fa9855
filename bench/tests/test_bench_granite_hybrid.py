"""The cell ``granite-h-chat`` at the smoke size of its configuration on
the CPU (``bench/tests/smoke.py`` gives the other cells theirs): a sound
run is correct and a traced one reports the SSD scan's metrics, the
faults of ``test_bench_faults.py`` and a zeroed recurrent state are not
correct, the reference matches the program's plain path, and the work
counter by hand."""
import copy
import json

import pytest
import torch

from bench.harness import check, common, system
from bench.reference import granite_hybrid
from bench.tests import smoke
from bench.tests.test_bench_faults import alter_token, drop_half

CELL = "granite-h-chat"
DIMS = {
    "d_model": 64, "n_layers": 10,
    "pattern": ["mamba"] * 5 + ["attention"] + ["mamba"] * 4,
    "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "vocab": 256,
    "vocab_padded": 256, "norm_eps": 1e-05,
    "ssm": {"d_state": 16, "d_conv": 4, "expand": 2, "head_dim": 16,
            "chunk": 8},
    "moe": {"n_experts": 8, "top_k": 3, "d_ff": 32, "shared_d_ff": 48},
    "mup": {"embedding_multiplier": 12.0, "residual_multiplier": 0.22,
            "attention_multiplier": 0.0078125, "logits_scaling": 16.0}}
SERVER = {"max_len": 80, "max_slots": 3, "page_size": 4, "chunk_tokens": 8,
          "token_budget": 24}


def files():
    """The cell's files at smoke size, as ``smoke.files`` makes them."""
    man = copy.deepcopy(common.manifest())
    w = next(w for w in man["workloads"] if w["name"] == CELL)
    cfg = copy.deepcopy(common.part("configs", w["config"]))
    cfg["dims"] = copy.deepcopy(DIMS)
    cfg["port"]["variant"] = "smoke"
    cfg["port"]["overrides"] = {}
    mix = {**common.part("traffic", w["traffic"]), **smoke.MIX["chat"]}
    wl = copy.deepcopy(common.part("workloads", CELL))
    wl["server"] = dict(SERVER)
    wl["check"].update(requests=6, min_tokens=3)
    return {"manifest": man, "config": cfg, "traffic": mix, "workload": wl}


def run(seed=2 ** 31 + 3, trace=0, fault=None, capsys=None):
    from bench import run as bench_run
    rc = bench_run.main(["--workload", CELL, "--seed", str(seed),
                         "--seconds", "2", "--trace", str(trace)],
                        require_card=False, configs=files(), fault=fault)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_runs_are_correct_and_traced_reads_the_scan(capsys):
    res = run(capsys=capsys)
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"output_tok_s", "setup_s"}
    res = run(trace=1, capsys=capsys)
    assert res["correct"], res["check"]
    m = res["metrics"]
    for name in ("ssd_scan_share", "ssd_roofline", "ssd_row_share",
                 "real_row_share", "expert_pair_share", "mfu"):
        assert name in m, name
    assert 0 < m["ssd_row_share"]["value"] <= 100
    assert 0 < m["ssd_roofline"]["value"] <= 100


def state_zeroed(monkeypatch):
    from repro_torch.models import ssm
    orig = ssm.mamba_step

    def step(params, x, cache, q_pos, cfg, d_model):
        cache = {k: torch.zeros_like(v) for k, v in cache.items()}
        return orig(params, x, cache, q_pos, cfg, d_model)
    monkeypatch.setattr(ssm, "mamba_step", step)


@pytest.mark.parametrize("fault", ["alter_token", "drop_half", "state"])
def test_fault_is_not_correct(fault, capsys, monkeypatch):
    brk = {"alter_token": alter_token, "drop_half": drop_half}.get(fault)
    if fault == "state":
        state_zeroed(monkeypatch)
    res = run(fault=brk, capsys=capsys)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("act", [8, 32])
def test_reference_matches_program_plain_path(act):
    from repro_torch.quant.apply import apply_policy_to_params
    cfg = files()["config"]
    cfg["policy"]["act_qbn"] = act
    seed = 2 ** 31 + 11
    policy = system.make_policy(cfg, seed)
    model = system.port_lm(cfg, "smoke")
    graph, qp = system.program_policy(cfg, model, policy)
    fq = apply_policy_to_params(system.make_weights(cfg, seed, "cpu"), graph,
                                qp)
    act_bits = model.block_act_bits(graph, [float(act)] * len(graph.layers))
    toks = torch.as_tensor(
        system.seed_stream(seed, "t").integers(0, DIMS["vocab"], 37))
    want, _ = model.apply(fq, {"tokens": toks[None]}, act_bits=act_bits,
                          attn_impl="ref")
    w = check.reference_weights(cfg, seed, policy, "cpu")
    got = system.family(cfg).logits(w, cfg["dims"], toks, float(act),
                                    range(toks.numel()))
    torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-4)


def test_published_config_is_cut_in_depth_only():
    """The file holds the catalog's keys; only ``num_hidden_layers`` moves
    (40 to 10, the port's ``n_layers`` override), and ``dims`` are the
    published widths."""
    cfg = common.part("configs", "granite-4.0-h-small")
    assert cfg["reduced"] == ["num_hidden_layers"]
    assert cfg["num_hidden_layers"] == cfg["port"]["overrides"]["n_layers"]
    assert cfg["published"]["num_hidden_layers"] == 40
    d = cfg["dims"]
    assert d["pattern"] == [("attention" if t == "attention" else "mamba")
                            for t in cfg["layer_types"][:d["n_layers"]]]
    assert (d["d_model"], d["n_heads"], d["n_kv_heads"], d["vocab"]) == (
        cfg["hidden_size"], cfg["num_attention_heads"],
        cfg["num_key_value_heads"], cfg["vocab_size"])
    assert d["ssm"]["d_state"] == cfg["mamba_d_state"]
    assert d["ssm"]["head_dim"] == cfg["mamba_d_head"]
    assert d["ssm"]["expand"] * d["d_model"] // d["ssm"]["head_dim"] == \
        cfg["mamba_n_heads"]
    assert (d["moe"]["n_experts"], d["moe"]["top_k"], d["moe"]["d_ff"],
            d["moe"]["shared_d_ff"]) == (
        cfg["num_local_experts"], cfg["num_experts_per_tok"],
        cfg["intermediate_size"], cfg["shared_intermediate_size"])
    assert d["mup"]["logits_scaling"] == cfg["logits_scaling"]


def test_work_by_hand():
    """The scan: 4 H P N a token a Mamba layer; bytes: the state twice an
    advanced row, x, B, C, dt and y once a token."""
    from bench.work import granite_hybrid as work
    d = DIMS
    H, P, N = 8, 16, 16
    s = work.ssd(d, tokens=10, rows=3)
    assert s["flops"] == 9 * 10 * 4 * H * P * N
    assert s["bytes"] == 9 * (3 * 2 * 4 * H * P * N +
                              10 * 4 * (2 * H * P + 2 * N + H))
    widths = {name: {8: c} for name, _, c in granite_hybrid.sites(d)}
    ph = work.phase(d, widths, {"prefill_lens": [20], "decode_pos": [5, 6],
                                "decode_tokens": 2, "chunk_calls": 3,
                                "decode_calls": 1, "chunk": 8})
    # three chunks of the prompt and the two decode lanes advance rows
    assert ph["ssd"] == work.ssd(d, 22, 5)
    g = work.gemm(d, widths, 1, 4, 1)
    # one shared-expert wg over 4 rows: 2 x 4 x 64 x 48
    assert g["flops"] > 2 * 4 * 64 * 48


def test_reference_and_work_load_no_program():
    from bench.tests.test_bench_imports import FORBIDDEN, _fresh
    tops = _fresh(
        "import json, sys\n"
        "import bench.reference.granite_hybrid, bench.work.granite_hybrid\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not tops & (FORBIDDEN | {"repro_torch"}), tops
