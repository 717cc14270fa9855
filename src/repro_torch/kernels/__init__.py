"""Hand-written CUDA kernels of the port and their plain versions.

flash_attention  (K1, csrc/flash_attention.cu) -- flash forward for
                 prefill and dense-cache decode
quant_matmul     (K2, csrc/quant_matmul.cu) -- int8 weight GEMM (and
                 quant_matmul_grouped: an expert stack over row groups)
packed_matmul    (K3, csrc/packed_matmul.cu) -- int4 / int2 packed GEMM
                 (and packed_matmul_grouped)
paged_prefill_attention (K4, csrc/paged_attention.cu) -- causal attention
                 over the paged KV pool (chunks and decode tokens)
packed_mixed_matmul -- a PackedWeight's product: on the tensor-core route
                 one launch for every bucket (packed_matmul.mixed_matmul),
                 else one K2/K3 launch per bucket
fake_quant_channels (B5, csrc/fake_quant.cu) -- per-channel fake-quant
                 of the search's QUANT evaluations
binary_matmul    (B6, csrc/binary_matmul.cu) -- bit-plane product of the
                 search's BINARIZE evaluations

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors, counting launches in its ``LaunchCount``
(:func:`launch_counts`).  ``build.py`` compiles the sources with nvcc at
first use; ``pack.py`` holds the byte format and the PackedWeight store.
"""
from repro_torch.kernels import (attention, binary_matmul, fake_quant,
                                 packed_matmul, quant_matmul)
from repro_torch.kernels.attention import (flash_attention,
                                          paged_decode_attention,
                                          paged_prefill_attention)
from repro_torch.kernels.ops import packed_mixed_matmul
from repro_torch.kernels.pack import PackedWeight, pack_sub8, unpack_sub8

COUNTS = (attention.COUNT, quant_matmul.COUNT, packed_matmul.COUNT,
          attention.PAGED_COUNT, fake_quant.COUNT, binary_matmul.COUNT)


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {c.name: c.launches for c in COUNTS}


def launch_routes() -> dict:
    """Launches of each kernel by route since the last
    :func:`reset_launch_counts` (K2 and K3; the others count none)."""
    return {c.name: dict(c.routes) for c in COUNTS}


def reset_launch_counts() -> None:
    for c in COUNTS:
        c.reset()


__all__ = ["flash_attention", "paged_prefill_attention",
           "paged_decode_attention", "packed_mixed_matmul", "PackedWeight",
           "pack_sub8", "unpack_sub8", "launch_counts", "launch_routes",
           "reset_launch_counts"]
