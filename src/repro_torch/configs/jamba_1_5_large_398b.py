# Copied from src/repro/configs/jamba_1_5_large_398b.py; imports renamed.
"""jamba-1.5-large-398b [hybrid] -- 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave, MoE every 2nd layer
[arXiv:2403.19887; hf].  Pattern period 8: attention at position 4, MoE on odd
positions (36 MoE layers -> ~398B total / ~94B active)."""
from repro_torch.configs.base import ArchSpec, dense, spec
from repro_torch.models.api import BlockDef, LMConfig, MoECfg, SSMCfg

PATTERN = tuple(
    BlockDef(kind=("attn" if i == 4 else "mamba"), use_moe=(i % 2 == 1))
    for i in range(8))

SPEC = spec(
    "jamba-1.5-large-398b",
    LMConfig(
        name="jamba-1.5-large-398b", d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab=65536, n_layers=72, pattern=PATTERN,
        moe=MoECfg(n_experts=16, top_k=2, d_ff=24576),
        ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256)),
    LMConfig(
        name="jamba-smoke", d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, n_layers=8, pattern=PATTERN,
        moe=MoECfg(n_experts=4, top_k=2, d_ff=128, capacity_factor=0.0),
        ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8)),
    family="hybrid", skip_long=False)
