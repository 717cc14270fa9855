"""Sub-byte weight packing: the stored form of searched QBN policies.

Port of ``repro/kernels/pack.py``, byte for byte.  Channels with QBN <= 4
are packed along the contraction (K) axis, little-endian within the byte:

    packed[r] = sum_i (q[r*f + i] & mask) << (store_bits * i),   f = 8/store_bits

K is zero-padded to a multiple of ``f``; fields are two's complement in
``store_bits``; the N axis is never packed.  :func:`extract_fields` is the
one definition of the read side; ``csrc/gemm_tiles.cuh`` (``field``) does
the same shifts and masks on the card.

:class:`PackedWeight` is the bucketed whole-tensor store: a plain class of
tensors whose parts keep any leading (repeat) dims, with the reference's
layouts: ``(..., ceil(K/f), nb)`` int8 packed data and ``(..., nb)`` f32
scales.  :meth:`PackedWeight.take` gives repeat ``r`` of a stacked store,
:meth:`PackedWeight.prefix` its first ``d`` repeats.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

# storage width -> values per byte
SUB8_FACTORS = {2: 4, 4: 2}
STORE_BITS = {"int2": 2, "int4": 4, "int8": 8}
# bucket order of every PackedWeight (and of quant_pack_sub8's routing)
BUCKETS = ("pruned", "int2", "int4", "int8", "full")


def bucket_of_bits(bits: float) -> str:
    """Storage bucket for one channel's QBN: <=0 pruned, <=2 int2, <=4
    int4, <=8 int8, >8 bf16 passthrough."""
    b = round(float(bits))
    if b <= 0:
        return "pruned"
    if b <= 2:
        return "int2"
    if b <= 4:
        return "int4"
    if b <= 8:
        return "int8"
    return "full"


def pack_sub8(q: torch.Tensor, store_bits: int, axis: int = -2) -> torch.Tensor:
    """Pack integer values (fitting signed ``store_bits``) into int8 bytes
    along ``axis``, which shrinks to ceil(K / (8/store_bits))."""
    f = SUB8_FACTORS[store_bits]
    mask = (1 << store_bits) - 1
    axis = axis % q.ndim
    qm = torch.movedim(q.to(torch.int32), axis, 0)
    pad = (-qm.shape[0]) % f
    if pad:
        qm = torch.cat([qm, qm.new_zeros((pad,) + qm.shape[1:])], 0)
    qm = (qm & mask).reshape((qm.shape[0] // f, f) + qm.shape[1:])
    packed = torch.zeros_like(qm[:, 0])
    for i in range(f):
        packed = packed | (qm[:, i] << (store_bits * i))
    packed = packed - ((packed >> 7) << 8)       # byte pattern as signed
    return torch.movedim(packed.to(torch.int8), 0, axis).contiguous()


def extract_fields(pm: torch.Tensor, store_bits: int) -> list:
    """Sign-extended field planes of packed bytes (int32).  Plane ``i``
    holds original K position ``r*f + i`` of packed row ``r``."""
    mask = (1 << store_bits) - 1
    out = []
    for i in range(SUB8_FACTORS[store_bits]):
        m = (pm >> (store_bits * i)) & mask
        out.append(m - ((m >> (store_bits - 1)) << store_bits))
    return out


def unpack_sub8(packed: torch.Tensor, store_bits: int, k: int,
                axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`pack_sub8`: int8 bytes -> int8 values, ``axis``
    restored to length ``k``."""
    f = SUB8_FACTORS[store_bits]
    axis = axis % packed.ndim
    pm = torch.movedim(packed, axis, 0).to(torch.int32)
    v = torch.stack(extract_fields(pm, store_bits), dim=1)   # (Kp, f, ...)
    v = v.reshape((pm.shape[0] * f,) + pm.shape[1:])[:k]
    return torch.movedim(v.to(torch.int8), 0, axis)


@dataclasses.dataclass
class PackedWeight:
    """Bucketed sub-byte store of one (..., K, N) matmul weight.

    ``parts[i]`` mirrors ``buckets[i] = (name, channel indices)``:
      pruned -> (sentinel (..., K, 0) int8,)
      int2   -> (packed (..., ceil(K/4), nb) int8, scale (..., nb) f32)
      int4   -> (packed (..., ceil(K/2), nb) int8, scale (..., nb) f32)
      int8   -> (q      (..., K, nb)      int8, scale (..., nb) f32)
      full   -> (w      (..., K, nb)      bf16,)
    """
    parts: Tuple[Tuple[torch.Tensor, ...], ...]
    k: int
    n: int
    buckets: Tuple[Tuple[str, Tuple[int, ...]], ...]
    out_dtype: str = "float32"
    # bucket name -> channel-index tensor, per device (built at first use)
    _index: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.parts[0][0].device

    def index(self, name: str) -> torch.Tensor:
        """Channel indices of bucket ``name`` as a tensor on the store's
        device (cached: the scatter of every matmul reads it)."""
        key = (name, self.device)
        if key not in self._index:
            idx = dict(self.buckets)[name]
            self._index[key] = torch.as_tensor(idx, dtype=torch.int64,
                                               device=self.device)
        return self._index[key]

    def take(self, r: int) -> "PackedWeight":
        """Repeat ``r`` of a stacked store (views; shares the index cache)."""
        parts = tuple(tuple(a[r] for a in part) for part in self.parts)
        return PackedWeight(parts=parts, k=self.k, n=self.n,
                            buckets=self.buckets, out_dtype=self.out_dtype,
                            _index=self._index)

    def prefix(self, d: int) -> "PackedWeight":
        """The first ``d`` repeats of a stacked store (views of every part;
        shares the buckets and the index cache, copies nothing)."""
        parts = tuple(tuple(a[:d] for a in part) for part in self.parts)
        return PackedWeight(parts=parts, k=self.k, n=self.n,
                            buckets=self.buckets, out_dtype=self.out_dtype,
                            _index=self._index)

    def dequant(self) -> torch.Tensor:
        """Reconstruct the dequantized (..., K, N) weight."""
        lead = self.parts[0][0].shape[:-2]
        out = torch.zeros(lead + (self.k, self.n), dtype=torch.float32,
                          device=self.device)
        for (name, _), part in zip(self.buckets, self.parts):
            if name == "pruned":
                continue
            if name == "full":
                cols = part[0].to(torch.float32)
            else:
                data, scale = part
                if name != "int8":
                    data = unpack_sub8(data, STORE_BITS[name], self.k, axis=-2)
                cols = data.to(torch.float32) * \
                    scale.to(torch.float32)[..., None, :]
            out[..., self.index(name)] = cols
        return out.to(getattr(torch, self.out_dtype))

    def bucket_nbytes(self) -> dict:
        """Stored bytes per bucket (packed buffers + scales)."""
        return {name: int(sum(a.numel() * a.element_size() for a in part))
                for (name, _), part in zip(self.buckets, self.parts)}

    def hbm_bytes(self) -> int:
        """Total weight-side device-memory bytes of this store."""
        return int(sum(self.bucket_nbytes().values()))
