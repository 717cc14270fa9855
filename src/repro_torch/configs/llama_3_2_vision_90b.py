# Copied from src/repro/configs/llama_3_2_vision_90b.py; imports renamed.
"""llama-3.2-vision-90b [vlm] -- 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attn image layers every 5th [hf:meta-llama/
Llama-3.2-11B-Vision; unverified].  Backbone only: vision frontend is a stub;
input_specs provides precomputed patch embeddings (B, 1600, d_model)."""
from repro_torch.configs.base import dense, spec
from repro_torch.models.api import LMConfig

SPEC = spec(
    "llama-3.2-vision-90b",
    LMConfig(name="llama-3.2-vision-90b", d_model=8192, n_heads=64,
             n_kv_heads=8, d_ff=28672, vocab=128256, n_layers=100,
             pattern=(dense(), dense(), dense(), dense(),
                      dense("cross_attn")),
             n_img_tokens=1600, frontend="vision_stub"),
    LMConfig(name="llama32v-smoke", d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab=256, n_layers=5,
             pattern=(dense(), dense(), dense(), dense(),
                      dense("cross_attn")),
             n_img_tokens=16, frontend="vision_stub"),
    family="vlm")
