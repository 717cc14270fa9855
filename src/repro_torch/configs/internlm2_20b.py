# Copied from src/repro/configs/internlm2_20b.py; imports renamed.
"""internlm2-20b [dense] -- 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import dense, spec
from repro_torch.models.api import LMConfig

SPEC = spec(
    "internlm2-20b",
    LMConfig(name="internlm2-20b", d_model=6144, n_heads=48, n_kv_heads=8,
             d_ff=16384, vocab=92544, n_layers=48, pattern=(dense(),)),
    LMConfig(name="internlm2-smoke", d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab=256, n_layers=4, pattern=(dense(),)),
    family="dense")
