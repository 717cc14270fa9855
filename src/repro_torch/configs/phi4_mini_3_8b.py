# Copied from src/repro/configs/phi4_mini_3_8b.py; imports renamed.
"""phi4-mini-3.8b [dense] -- 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""
from repro_torch.configs.base import dense, spec
from repro_torch.models.api import LMConfig

SPEC = spec(
    "phi4-mini-3.8b",
    LMConfig(name="phi4-mini-3.8b", d_model=3072, n_heads=24, n_kv_heads=8,
             d_ff=8192, vocab=200064, n_layers=32, pattern=(dense(),)),
    LMConfig(name="phi4-smoke", d_model=48, n_heads=3, n_kv_heads=1, d_ff=96,
             vocab=256, n_layers=3, pattern=(dense(),)),
    family="dense")
