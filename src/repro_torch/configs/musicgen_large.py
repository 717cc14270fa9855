# Copied from src/repro/configs/musicgen_large.py; imports renamed.
"""musicgen-large [audio] -- 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048,
decoder-only over EnCodec tokens [arXiv:2306.05284; hf].  Backbone only: the
EnCodec frontend is a stub; input_specs provides precomputed frame embeddings
(B, S, d_model) per the assignment."""
from repro_torch.configs.base import dense, spec
from repro_torch.models.api import LMConfig

SPEC = spec(
    "musicgen-large",
    LMConfig(name="musicgen-large", d_model=2048, n_heads=32, n_kv_heads=32,
             d_ff=8192, vocab=2048, n_layers=48, pattern=(dense(),),
             frontend="audio_stub"),
    LMConfig(name="musicgen-smoke", d_model=64, n_heads=4, n_kv_heads=4,
             d_ff=128, vocab=64, n_layers=4, pattern=(dense(),),
             frontend="audio_stub"),
    family="audio")
