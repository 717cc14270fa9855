# Copied from src/repro/configs/starcoder2_7b.py; imports renamed.
"""starcoder2-7b [dense] -- 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, GQA + RoPE [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import dense, spec
from repro_torch.models.api import LMConfig

SPEC = spec(
    "starcoder2-7b",
    LMConfig(name="starcoder2-7b", d_model=4608, n_heads=36, n_kv_heads=4,
             d_ff=18432, vocab=49152, n_layers=32, pattern=(dense(),)),
    LMConfig(name="starcoder2-smoke", d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=192, vocab=256, n_layers=4, pattern=(dense(),)),
    family="dense")
