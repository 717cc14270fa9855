"""Kernel K1: flash-attention forward (prefill and dense-cache decode).

Port of ``repro/kernels/attention.py::flash_attention`` as a CUDA C++
kernel (``csrc/flash_attention.cu``).  Same contract: q (B, Sq, Hq, D),
k / v (B, Skv, Hkv, D), q_pos (B, Sq) and kv_pos (B, Skv) int32; causal and
sliding-window validity come from comparing positions alone, so ring-buffer
caches and sentinel tails (``POS_SENTINEL``) need no other argument.

The wrapper runs the plain version, ``models.layers.attention_ref`` (the
port of the reference's chunked jnp scan), for CPU tensors and the kernel
for CUDA tensors; there is no fallback between them.
"""
from __future__ import annotations

import functools
import ctypes
import math

import torch

from repro_torch.kernels import build

COUNT = build.LaunchCount("flash_attention")
MAX_HEAD_DIM = 256      # csrc/flash_attention.cu: DMAX
MAX_GROUP = 32          # query heads per kv head that fit one block


@functools.lru_cache(maxsize=None)
def _fn():
    return build.bind("flash_attention", "flash_attention_f32", 6, 8,
                      tail=(ctypes.c_float, ctypes.c_float))


def _check(q, k, v, q_pos, kv_pos):
    dev = q.device
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        build.expect(t, what, torch.float32, 4, dev)
    build.expect(q_pos, "q_pos", torch.int32, 2, dev)
    build.expect(kv_pos, "kv_pos", torch.int32, 2, dev)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or tuple(q_pos.shape) != (B, Sq)
            or tuple(kv_pos.shape) != (B, Skv)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}, kv_pos {tuple(kv_pos.shape)}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads: need a "
                         f"whole group of at most {MAX_GROUP}")


def flash_attention(q, k, v, *, q_pos, kv_pos, causal=True, window=None,
                    attn_cap=None):
    """Tiled flash-attention forward.  Returns (B, Sq, Hq, D) f32."""
    _check(q, k, v, q_pos, kv_pos)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        from repro_torch.models.layers import attention_ref
        return attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                             causal=causal, window=window, attn_cap=attn_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"head dim {D}: the kernel takes multiples of 8 up "
                         f"to {MAX_HEAD_DIM}")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    q_pos.data_ptr(), kv_pos.data_ptr(), o.data_ptr(),
                    B, Sq, Skv, Hq, Hkv, D, int(bool(causal)),
                    int(window or 0), float(attn_cap or 0.0),
                    1.0 / math.sqrt(D), build.stream_of(q))
    COUNT.launches += 1
    build.check(build.load(COUNT.name), err, COUNT.name)
    return o
