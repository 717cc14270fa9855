# Copied from src/repro/configs/mamba2_780m.py; imports renamed.
"""mamba2-780m [ssm] -- 48L d_model=1536 attn-free d_ff=0 vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified].
Blocks carry no separate FFN (mixing lives in the SSD block)."""
from repro_torch.configs.base import spec
from repro_torch.models.api import BlockDef, LMConfig, SSMCfg

SPEC = spec(
    "mamba2-780m",
    LMConfig(name="mamba2-780m", d_model=1536, n_heads=1, n_kv_heads=1,
             d_ff=0, vocab=50280, n_layers=48,
             pattern=(BlockDef(kind="mamba", has_ffn=False),),
             ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64,
                        chunk=256)),
    LMConfig(name="mamba2-smoke", d_model=64, n_heads=1, n_kv_heads=1,
             d_ff=0, vocab=256, n_layers=4,
             pattern=(BlockDef(kind="mamba", has_ffn=False),),
             ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16,
                        chunk=8)),
    family="ssm", skip_long=False)
