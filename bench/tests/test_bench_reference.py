"""Each plain reference against repro_torch's plain path (the fake-quant
store, the plain attention) at the smoke sizes of its configuration."""
import pytest
import torch

from bench.harness import check, system
from bench.tests import smoke


@pytest.mark.parametrize("cell", ["granite-chat", "mamba2-docs"])
@pytest.mark.parametrize("act", [8, 32])
def test_reference_matches_program_plain_path(cell, act):
    from repro_torch.quant.apply import apply_policy_to_params
    cfg = smoke.files(cell)["config"]
    cfg["policy"]["act_qbn"] = act
    seed = 2 ** 31 + 11
    policy = system.make_policy(cfg, seed)
    model = system.port_lm(cfg, "smoke")
    graph, qp = system.program_policy(cfg, model, policy)
    params = system.make_weights(cfg, seed, "cpu")
    fq = apply_policy_to_params(params, graph, qp)
    act_bits = model.block_act_bits(graph, [float(act)] * len(graph.layers))
    toks = torch.as_tensor(
        system.seed_stream(seed, "t").integers(0, cfg["dims"]["vocab"], 37))
    want, _ = model.apply(fq, {"tokens": toks[None]}, act_bits=act_bits,
                          attn_impl="ref")
    w = check.reference_weights(cfg, seed, policy, "cpu")
    got = system.family(cfg).logits(w, cfg["dims"], toks, float(act),
                                    range(toks.numel()))
    V = cfg["dims"]["vocab"]
    torch.testing.assert_close(got[:, :V], want[0, :, :V], rtol=0,
                               atol=2e-4)


def test_dequantized_weights_match_the_program_store():
    """The reference's grid, worked out again, is the program's fake-quant
    store bit for bit."""
    from repro_torch.quant.apply import apply_policy_to_params, get_path
    cfg = smoke.files("granite-chat")["config"]
    policy = system.make_policy(cfg, 3)
    model = system.port_lm(cfg, "smoke")
    graph, qp = system.program_policy(cfg, model, policy)
    fq = apply_policy_to_params(system.make_weights(cfg, 3, "cpu"), graph, qp)
    w = check.reference_weights(cfg, 3, policy, "cpu")
    for name, path, _ in system.family(cfg).sites(cfg["dims"]):
        assert torch.equal(get_path(w, path), get_path(fq, path)), name


def test_ssd_blocks_match_the_recurrence():
    """The reference's blocked scan against the plain recurrence, over
    several blocks and a ragged tail."""
    from bench.reference import mamba2
    g = torch.Generator().manual_seed(0)
    S, H, P, N = 2 * mamba2.CHUNK + 37, 3, 4, 5
    x = torch.randn(S, H, P, generator=g, dtype=torch.float64)
    B = torch.randn(S, N, generator=g, dtype=torch.float64)
    C = torch.randn(S, N, generator=g, dtype=torch.float64)
    dt = torch.rand(S, H, generator=g, dtype=torch.float64) * 0.2
    A = -torch.rand(H, generator=g, dtype=torch.float64)
    state = torch.zeros(H, P, N, dtype=torch.float64)
    want = []
    for t in range(S):
        state = state * torch.exp(dt[t] * A)[:, None, None] + \
            (dt[t][:, None] * x[t])[..., None] * B[t]
        want.append(torch.einsum("n,hpn->hp", C[t], state))
    torch.testing.assert_close(mamba2.ssd(x, B, C, dt, A),
                               torch.stack(want), rtol=1e-10, atol=1e-10)
