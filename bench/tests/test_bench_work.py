"""The work counters against shapes worked by hand."""
import pytest

from bench.harness.common import PEAK_HBM_BYTES_S, PEAK_TF32_FLOP_S
from bench.work import mamba2, transformer

DENSE = {"d_model": 4, "n_layers": 2, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 2, "vocab": 5, "vocab_padded": 8,
         "ffn": {"kind": "dense", "d_ff": 3}}
N_OUT = {"p0.wq": 4, "p0.wk": 2, "p0.wv": 2, "p0.wo": 4, "p0.wg": 3,
         "p0.wu": 3, "p0.wd": 4, "unembed": 8}


def _int8(n_out):
    return {k: {8: n} for k, n in n_out.items()}


def test_dense_gemm_by_hand():
    g = transformer.gemm(DENSE, _int8(N_OUT), calls=1, rows=3, logit_rows=1)
    # sum over the layer's sites of K * N: 16 + 8 + 8 + 16 + 12 + 12 + 12
    assert g["flops"] == 2 * 3 * 84 * 2 + 2 * 1 * 4 * 8
    # weights at 1 byte + a 4-byte scale a channel: 172 a layer; x and y
    # in fp32: 4 * 3 * 49 a layer; the unembedding 32 + 32 and 4 * 12
    assert g["bytes"] == 2 * 172 + 2 * 588 + 64 + 48
    assert g["bound_s"] >= max(g["flops"] / PEAK_TF32_FLOP_S,
                               g["bytes"] / PEAK_HBM_BYTES_S)


def test_pruned_and_subbyte_channels():
    w = _int8(N_OUT)
    w["p0.wq"] = {0: 1, 2: 1, 4: 1, 8: 1}
    full = transformer.gemm(DENSE, _int8(N_OUT), 1, 3, 1)
    part = transformer.gemm(DENSE, w, 1, 3, 1)
    # one pruned channel of wq: 2 * 3 * 4 operations a layer fewer
    assert full["flops"] - part["flops"] == 2 * 3 * 4 * 2
    # wq's weight bytes: 4 * (2 + 4 + 8) / 8 + 4 * 3 = 19 against 32; one
    # output channel fewer written: 4 * 3
    assert full["bytes"] - part["bytes"] == 2 * (32 - 19) + 2 * 4 * 3


def test_attention_by_hand():
    fl, by = transformer._attn_query(DENSE, ctx=3, q_rows=3)
    assert fl == 2 * 4 * 2 * 2 * 6          # 6 causal (query, key) pairs
    assert by == 2 * 4 * (2 * 1 * 2 * 3 + 2 * 2 * 2 * 3)
    fl1, _ = transformer._attn_query(DENSE, ctx=5, q_rows=1)
    assert fl1 == 2 * 4 * 2 * 2 * 5


def test_moe_routed_rows_and_experts_reached():
    moe = dict(DENSE, ffn={"kind": "moe", "n_experts": 4, "top_k": 2,
                           "d_ff": 3})
    assert transformer.experts_reached(moe, 1) == pytest.approx(2.0)
    assert transformer.experts_reached(moe, 1000) == pytest.approx(4.0)
    d = transformer.gemm(DENSE, _int8(N_OUT), 1, 3, 1)
    m = transformer.gemm(moe, _int8(N_OUT), 1, 3, 1)
    # the three expert sites run top_k = 2 rows a token
    assert m["flops"] - d["flops"] == 2 * 3 * (12 + 12 + 12) * 2


def test_phase_counts_prefill_and_decode():
    s = {"prefill_lens": [3], "decode_pos": [3, 4], "chunk_calls": 1,
         "decode_calls": 1, "chunk": 2}
    w = transformer.phase(DENSE, _int8(N_OUT), s)
    # chunks [0, 2) and [2, 3), decode at contexts 4 and 5
    pairs = 3 + 3 + 4 + 5
    assert w["attn"]["flops"] == pytest.approx(2 * 4 * 2 * 2 * pairs)
    assert w["model_flops"] > w["gemm"]["flops"] + w["attn"]["flops"] - 1


MAMBA = {"d_model": 4, "n_layers": 2, "d_state": 2, "d_conv": 4,
         "expand": 2, "head_dim": 2, "vocab": 5, "vocab_padded": 8}


def test_mamba_gemm_and_scan_by_hand():
    w = {"p0.w_xz": {8: 16}, "p0.w_bc": {8: 4}, "p0.w_out": {8: 4},
         "unembed": {8: 8}}
    g = mamba2.gemm(MAMBA, w, calls=1, rows=5, logit_rows=1)
    assert g["flops"] == 2 * 5 * (4 * 16 + 4 * 4 + 8 * 4) * 2 + 2 * 4 * 8
    s = {"prefill_lens": [5], "decode_tokens": 0, "decode_calls": 0}
    ph = mamba2.phase(MAMBA, w, s)
    # H = 4 heads of P = 2, N = 2: 4 H P N = 64; conv 2 * 4 * 8 = 64;
    # w_dt 2 * 4 * 4 = 32: 160 a token a layer
    assert ph["model_flops"] == g["flops"] + 5 * 2 * 160
