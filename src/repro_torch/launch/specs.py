"""Meta-device stand-ins for every step argument (port of
``repro/launch/specs.py``, whose ``ShapeDtypeStruct`` becomes a tensor on
the ``meta`` device: shape and dtype, no allocation).  The dry run
distributes these onto a mesh and runs the step on them.  One function per
step kind:

* train:   (params, opt_state, batch)
* prefill: (params, batch, cache)
* decode:  (params, tokens, cache, pos)
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.core.ddpg import tree_map
from repro_torch.models.api import LMConfig, ShapeCfg
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_struct(cfg: LMConfig, shape: ShapeCfg, mode: str
                 ) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    if mode == "decode":
        if cfg.frontend == "audio_stub":
            batch["tokens"] = _meta((B, 1, cfg.d_model), torch.bfloat16)
        else:
            batch["tokens"] = _meta((B, 1), torch.int32)
        return batch
    if cfg.frontend == "audio_stub":
        batch["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    if cfg.frontend == "vision_stub":
        batch["img_embeds"] = _meta((B, cfg.n_img_tokens, cfg.d_model),
                                    torch.bfloat16)
    if mode == "train":
        batch["labels"] = _meta((B, S), torch.int32)
    return batch


def params_struct(model: LM, dtype=torch.bfloat16) -> Any:
    """The model's parameter tree on the meta device, every leaf in
    ``dtype`` (bf16 by default, as the reference's)."""
    return tree_map(lambda t: t.to(dtype), model.init(device=META))


def opt_struct(params_sds: Any, optimizer: AdamW) -> Any:
    return optimizer.init(params_sds)


def cache_struct(model: LM, batch: int, max_len: int,
                 dtype=torch.bfloat16, kv_bits=None) -> Any:
    return model.init_cache(batch, max_len, dtype=dtype, kv_bits=kv_bits,
                            device=META)


def step_structs(spec: ArchSpec, shape: ShapeCfg, optimizer: AdamW,
                 dtype=torch.bfloat16, cfg_override=None, quant_serve=False,
                 kv_bits=None) -> Tuple[Any, ...]:
    """All argument stand-ins for the step of this shape's mode.

    quant_serve: params in the int8 serving store (``{"q", "s"}`` per
    matmul weight); kv_bits=8: int8 KV cache with per-(pos, head) scales.
    A decode step's position is the int ``seq_len - 1``, the last slot of
    the cache (the port's ``decode_step`` takes a Python int)."""
    cfg = cfg_override or spec.config
    model = LM(cfg)
    p = params_struct(model, dtype)
    if quant_serve:
        p = model.quantize_params_int8(p)
    if shape.mode == "train":
        return (p, opt_struct(p, optimizer),
                batch_struct(cfg, shape, "train"))
    cache = cache_struct(model, shape.global_batch, shape.seq_len, dtype,
                         kv_bits=kv_bits)
    if shape.mode == "prefill":
        return (p, batch_struct(cfg, shape, "prefill"), cache)
    return (p, batch_struct(cfg, shape, "decode")["tokens"], cache,
            shape.seq_len - 1)
