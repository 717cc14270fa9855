# Copied from src/repro/configs/granite_moe_3b_a800m.py; imports renamed.
"""granite-moe-3b-a800m [moe] -- 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert
vocab=49155, MoE 40e top-8 [hf:ibm-granite/granite-3.0-3b-a800m-base]."""
from repro_torch.configs.base import dense, spec
from repro_torch.models.api import LMConfig, MoECfg

SPEC = spec(
    "granite-moe-3b-a800m",
    LMConfig(name="granite-moe-3b-a800m", d_model=1536, n_heads=24,
             n_kv_heads=8, d_ff=512, vocab=49155, n_layers=32,
             pattern=(dense(moe=True),),
             moe=MoECfg(n_experts=40, top_k=8, d_ff=512)),
    LMConfig(name="granite-smoke", d_model=48, n_heads=3, n_kv_heads=1,
             d_ff=32, vocab=256, n_layers=3, pattern=(dense(moe=True),),
             moe=MoECfg(n_experts=8, top_k=4, d_ff=32, capacity_factor=0.0)),
    family="moe")
