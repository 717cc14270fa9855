# Copied from src/repro/configs/llama4_scout_17b_a16e.py; imports renamed.
"""llama4-scout-17b-a16e [moe] -- 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.configs.base import dense, spec
from repro_torch.models.api import LMConfig, MoECfg

SPEC = spec(
    "llama4-scout-17b-a16e",
    LMConfig(name="llama4-scout-17b-a16e", d_model=5120, n_heads=40,
             n_kv_heads=8, d_ff=8192, vocab=202048, n_layers=48,
             pattern=(dense(moe=True),),
             moe=MoECfg(n_experts=16, top_k=1, d_ff=8192)),
    LMConfig(name="llama4-smoke", d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=64, vocab=256, n_layers=4, pattern=(dense(moe=True),),
             moe=MoECfg(n_experts=4, top_k=1, d_ff=64, capacity_factor=0.0)),
    family="moe")
