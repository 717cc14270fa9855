# Copied from src/repro/configs/gemma2_2b.py; imports renamed.
"""gemma2-2b [dense/hybrid-attn] -- 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000, local+global alternating attention (window 4096), attn/logit
softcaps [arXiv:2408.00118; hf].  head_dim=256 (q width 2048 != d_model)."""
from repro_torch.configs.base import dense, spec
from repro_torch.models.api import LMConfig

SPEC = spec(
    "gemma2-2b",
    LMConfig(name="gemma2-2b", d_model=2304, n_heads=8, n_kv_heads=4,
             d_ff=9216, vocab=256000, n_layers=26, head_dim=256,
             pattern=(dense("local_attn"), dense("attn")),
             window=4096, attn_softcap=50.0, logit_softcap=30.0),
    LMConfig(name="gemma2-smoke", d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab=256, n_layers=4, head_dim=16,
             pattern=(dense("local_attn"), dense("attn")),
             window=8, attn_softcap=50.0, logit_softcap=30.0),
    family="hybrid-attn", skip_long=False)
