"""granite-4.0-h-small [hybrid] -- 40L d_model=4096, a period of 10 (five
Mamba-2 layers, one attention layer, four Mamba-2 layers: attention at 5,
15, 25, 35), every layer's mixer followed by a MoE FFN of 72 experts of
768, top-10, plus one shared expert of 1536; Mamba-2 128 heads of 64
(expand 2), d_state 128, d_conv 4 over x, B and C, one group, chunk 256;
GQA 32 q / 8 kv heads of 128 without positional encoding; muP scalars
(embedding 12, residual 0.22, attention 1/128, logits / 16); vocab 100352
[hf:ibm-granite/granite-4.0-h-small].

A port-only preset (``registry.PORT_ONLY``): the reference has no such
architecture.  Routing dropless, as published.  The embedding and the
unembedding are two matrices, as in the port's other presets (the
published model ties them; the work is the same)."""
from repro_torch.configs.base import spec
from repro_torch.models.api import (BlockDef, HybridLMConfig, Mamba2Cfg,
                                    SharedMoECfg)

PATTERN = tuple(BlockDef(kind=("attn" if i == 5 else "mamba"), use_moe=True)
                for i in range(10))

SPEC = spec(
    "granite-4.0-h-small",
    HybridLMConfig(
        name="granite-4.0-h-small", d_model=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=768, vocab=100352, n_layers=40, pattern=PATTERN,
        moe=SharedMoECfg(n_experts=72, top_k=10, d_ff=768,
                         capacity_factor=0.0, shared_d_ff=1536),
        ssm=Mamba2Cfg(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk=256),
        rope_theta=None, embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=0.0078125, logits_scaling=16.0),
    HybridLMConfig(
        name="granite-h-smoke", d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=32, vocab=256, n_layers=10, pattern=PATTERN,
        moe=SharedMoECfg(n_experts=8, top_k=3, d_ff=32, capacity_factor=0.0,
                         shared_d_ff=48),
        ssm=Mamba2Cfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8),
        rope_theta=None, embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=0.0078125, logits_scaling=16.0),
    family="hybrid", skip_long=False)
