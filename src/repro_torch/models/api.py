# Copied from src/repro/models/api.py; the port-only subclasses at the end
# (SharedMoECfg, Mamba2Cfg, HybridLMConfig) are not in the reference.
"""Model configuration dataclasses and the public LM protocol.

An :class:`LMConfig` fully describes a decoder LM as a *periodic pattern* of
blocks repeated ``n_repeat`` times -- e.g. Jamba's (7 mamba + 1 attn) period,
gemma2's (local, global) pairs, llama-3.2-vision's (4 self + 1 cross).  The
periodic layout is what lets every stack lower as ``lax.scan`` over repeats,
keeping HLO size O(period) instead of O(depth) (DESIGN.md section 5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden width
    capacity_factor: float = 1.25
    pad_to: Optional[int] = None  # physical expert count (EP divisibility);
                                  # padded experts are never routed to
    local_dispatch: bool = False  # shard_map dispatch over DP (small experts)

    @property
    def n_experts_phys(self) -> int:
        return self.pad_to or self.n_experts


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256             # SSD block-decomposition chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """One block of the periodic pattern."""
    kind: str                    # "attn" | "local_attn" | "mamba" | "cross_attn"
    use_moe: bool = False        # MoE FFN instead of dense FFN
    has_ffn: bool = True         # mamba2-style blocks have no separate FFN


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_layers: int
    pattern: Tuple[BlockDef, ...]
    head_dim: Optional[int] = None
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    rope_theta: float = 1e4
    window: Optional[int] = None          # sliding window for local_attn blocks
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    logit_softcap: Optional[float] = None # gemma2: 30.0
    n_img_tokens: int = 0                 # vlm: cross-attn memory length
    frontend: Optional[str] = None        # None | "audio_stub" | "vision_stub"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of "
            f"pattern length {len(self.pattern)}")

    @property
    def n_repeat(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 128 so the embedding/unembedding
        tables shard over the model axis (Megatron-style padding; padded
        logits are masked to -inf in logits_of)."""
        return -(-self.vocab // 128) * 128

    @property
    def q_groups(self) -> int:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        return self.n_heads // max(self.n_kv_heads, 1)

    def has_kind(self, kind: str) -> bool:
        return any(b.kind == kind for b in self.pattern)

    def cache_kinds(self) -> Tuple[str, ...]:
        """Decode-state kind per pattern position, from the serving engine's
        point of view:

        * ``"paged"``  -- self-attention (global or sliding-window): per-token
          K/V that a paged pool can hold (serve/paged_kv.py);
        * ``"memory"`` -- cross-attention: a fixed-length per-sequence memory
          written once at prefill, read-only during decode;
        * ``"state"``  -- recurrent (mamba) state: O(1)-size per sequence,
          indexed by batch slot, no paging needed.

        The paged serving path (transformer.init_paged_cache, serve/engine
        ``run``) keys its cache layout and prefill scatter off this tuple.
        """
        out = []
        for b in self.pattern:
            if b.kind == "mamba":
                out.append("state")
            elif b.kind == "cross_attn":
                out.append("memory")
            else:
                out.append("paged")
        return tuple(out)

    @property
    def is_subquadratic(self) -> bool:
        """True when decode state does not require a full-attention KV cache
        in every block (SSM / hybrid / local+global alternation)."""
        full_attn = sum(b.kind in ("attn", "cross_attn") for b in self.pattern)
        return full_attn < len(self.pattern)


# ------------------------------------------------------ port-only presets
# Fields that only the port's granitemoehybrid preset sets live in
# subclasses, so that every other preset's config, and its repr, stays the
# reference's.  The model reads them through ``getattr`` with the values
# below as defaults (``transformer.LM``, ``ssm.conv_dim``).


@dataclasses.dataclass(frozen=True)
class SharedMoECfg(MoECfg):
    """An MoE FFN with one shared SwiGLU expert of width ``shared_d_ff``
    beside the routed ones, every token through it."""
    shared_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class Mamba2Cfg(SSMCfg):
    """Mamba-2 as published: the depthwise causal conv and its SiLU run
    over x, B and C together (``conv_dim`` = d_inner + 2 d_state), where
    the reference's block convolves x alone."""
    conv_bc: bool = True


@dataclasses.dataclass(frozen=True)
class HybridLMConfig(LMConfig):
    """The muP scalars of granitemoehybrid: embeddings times
    ``embedding_multiplier``, each residual branch times
    ``residual_multiplier``, attention scores times
    ``attention_multiplier`` (in place of 1 / sqrt(head_dim)), logits
    divided by ``logits_scaling``.  ``rope_theta=None`` is attention
    without positional encoding (NoPE)."""
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    logits_scaling: float = 1.0


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One assigned (input-shape) cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    mode: str                    # "train" | "prefill" | "decode"


SHAPES = (
    ShapeCfg("train_4k", 4096, 256, "train"),
    ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    ShapeCfg("decode_32k", 32768, 128, "decode"),
    ShapeCfg("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCfg:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
