"""Attention kernels of the port.

K1 -- :func:`flash_attention`, the flash-attention forward for prefill and
dense-cache decode: port of ``repro/kernels/attention.py::flash_attention``
as a CUDA C++ kernel (``csrc/flash_attention.cu``).  q (B, Sq, Hq, D) f32
or bf16 (upcast and scaled in fp32 as it is staged; the output is written
once, in q's dtype, from the fp32 accumulator, as the reference's kernel
writes ``q.dtype``), k / v (B, Skv, Hkv, D) f32 or bf16 (a bf16 cache,
converted to f32 as it is read), q_pos (B, Sq) and kv_pos (B, Skv) int32;
causal and sliding-window validity come from comparing positions alone,
so ring-buffer caches and sentinel tails (``POS_SENTINEL``) need no other
argument.
Prefill runs a walk on TF32 tensor cores with both operands of both
products split in three passes (fp32 accuracy;
``ref.attention_tf32x3_ref`` states its arithmetic).  Decode, where one
q tile holds every position and that walk would leave most of the card
idle, splits the KV walk across blocks (:func:`decode_splits`) and merges
the splits in a second pass.

K4 -- :func:`paged_prefill_attention` (and :func:`paged_decode_attention`,
its k = 1 wrapper), causal attention for q tiles of k left-aligned tokens
per sequence over the paged KV pool: port of the reference's function of
the same name as ``csrc/paged_attention.cu``.  The kernel walks each
sequence's block-table row itself; bf16 pools are converted and int8
pools dequantized on load.  q is f32 or bf16, as K1's, and the output
takes its dtype.
Chunk steps run K1's tensor-core walk over the pool's slots (three TF32
passes; ``ref.paged_attention_split_ref(mm=ref.einsum_tf32x3)`` states
it); decode tokens, whose q tile holds a few real rows, run a CUDA-core
walk over those rows alone (:func:`paged_walk` picks the walk).  Either
walk cuts each row's live slot range across blocks
(:func:`paged_chunk_splits`, :func:`paged_decode_splits`;
``ref.paged_split_slots`` states the cut) and merges the splits in a
second pass.

Each wrapper runs its plain version (``models.layers.attention_ref``,
``models.layers.paged_attention_ref``) for CPU tensors and its kernel for
CUDA tensors; there is no fallback between them.
"""
from __future__ import annotations

import functools
import ctypes
import math

import torch

from repro_torch.kernels import build

COUNT = build.LaunchCount("flash_attention")
PAGED_COUNT = build.LaunchCount("paged_attention")
MAX_HEAD_DIM = 256      # csrc/flash_attention.cu: DMAX
# K/V element types the kernels read (csrc/attn_tile.cuh: KvType)
KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# query (and output) element types (csrc/attn_tile.cuh: QT)
Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 32          # query heads per kv head that fit one block
ROWS = BKV = 32         # csrc/attn_tile.cuh: query rows of a block, KV tile
TC_ROWS = 128           # csrc/attn_tc.cuh: query rows of a tensor-core block
POS_SENTINEL = 2**31 - 1


def decode_splits(B: int, Sq: int, Hq: int, Hkv: int, Skv: int,
                  n_sm: int) -> int:
    """Number of KV splits of K1's split walk, 1 for the single walk.

    Splits are taken where one q tile of ``32 // G`` positions holds every
    query position and the single walk's ``Hkv * B`` blocks are fewer than
    the card's ``n_sm`` SMs.  They aim at about two blocks per SM, hold
    whole 32-row KV tiles, never outnumber the tiles, and are none of them
    empty under :func:`split_tiles`' rule."""
    G = Hq // Hkv
    blocks = -(-Sq // (ROWS // G)) * Hkv * B
    n_tiles = -(-Skv // BKV)
    if Sq > ROWS // G or blocks >= n_sm or n_tiles <= 1:
        return 1
    per = -(-n_tiles // min(n_tiles, -(-2 * n_sm // blocks)))
    return -(-n_tiles // per)


def split_tiles(Skv: int, n_splits: int):
    """The KV tile ranges ``[t0, t1)`` of each split, as the kernel cuts
    them: ``ceil(tiles / n_splits)`` tiles a split, the last one short."""
    n_tiles = -(-Skv // BKV)
    per = -(-n_tiles // n_splits)
    return [(s * per, min(n_tiles, (s + 1) * per)) for s in range(n_splits)]


@functools.lru_cache(maxsize=None)
def _fn():
    return build.bind("flash_attention", "flash_attention_fwd", 8, 11,
                      tail=(ctypes.c_float, ctypes.c_float))


def _expect_q(q):
    if q.dtype not in Q_TYPES:
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    build.expect(q, "q", q.dtype, 4, q.device)


def _check(q, k, v, q_pos, kv_pos):
    dev = q.device
    _expect_q(q)
    if k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"k: expected float32 or bfloat16, got {k.dtype}")
    build.expect(k, "k", k.dtype, 4, dev)
    build.expect(v, "v", k.dtype, 4, dev)
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
    """Tiled flash-attention forward; q f32 or bf16, k and v f32 or bf16
    (one type).  Returns (B, Sq, Hq, D) in q's dtype."""
    build.refuse_dtensor("flash_attention", q, k, v, q_pos, kv_pos)
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
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % 16:                       # 16-byte vector loads
            raise ValueError(f"{what}: data must be 16-byte aligned")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    ns = decode_splits(B, Sq, Hq, Hkv, Skv, build.sm_count(q.device))
    ml, pacc = _split_partials(q, ns)
    err = build.launch(_fn(), q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       q_pos.data_ptr(), kv_pos.data_ptr(), o.data_ptr(), ml,
                       pacc, B, Sq, Skv, Hq, Hkv, D, KV_TYPES[k.dtype],
                       Q_TYPES[q.dtype], int(bool(causal)),
                       int(window or 0), ns, float(attn_cap or 0.0),
                       1.0 / math.sqrt(D))
    COUNT.launches += 1
    build.check(build.load(COUNT.name), err, COUNT.name)
    return o


def _split_partials(q, ns, merged=None):
    """Pointers (m and l, acc) into one fp32 allocation of the partials of
    ``ns`` splits for q (B, Sq, Hq, D); (None, None) for a walk that writes
    its output itself (``merged`` false, by default ``ns > 1``)."""
    if not (ns > 1 if merged is None else merged):
        return None, None
    B, Sq, Hq, D = q.shape
    rows = B * Hq * ns * Sq
    ml_len = -(-2 * rows // 4) * 4          # acc starts 16-byte aligned
    part = torch.empty(ml_len + rows * D, dtype=torch.float32,
                       device=q.device)
    return part.data_ptr(), part[ml_len:].data_ptr()


# --------------------------------------------------------------- paged (K4)
def paged_decode_splits(B: int, k: int, Hq: int, Hkv: int, n_slots: int,
                        n_sm: int) -> int:
    """Number of splits of K4's decode walk (CUDA cores), 1 for an
    unsplit walk (:func:`paged_walk` picks the walk).

    ``n_slots = nb * page_size`` is a block-table row's capacity: the rule
    reads shapes only, never positions, so the step loop need not sync.
    Splits are taken where one q sub-tile of ``32 // G`` columns holds
    every query column and the single walk's ``Hkv * B`` blocks are fewer
    than the card's ``n_sm`` SMs, as :func:`decode_splits` does for K1:
    about two blocks per SM, never more splits than 32-slot tiles.  Unlike
    K1's rule the count rounds down, to at most two blocks per SM: an fp32
    pool's block holds ~140 KB of shared memory and runs alone on its SM,
    so a grid just over two blocks per SM would take a third, nearly empty
    wave."""
    G = Hq // Hkv
    blocks = Hkv * B
    n_tiles = -(-n_slots // BKV)
    if k > ROWS // G or blocks >= n_sm or n_tiles <= 1:
        return 1
    per = -(-n_tiles // min(n_tiles, max(1, 2 * n_sm // blocks)))
    return -(-n_tiles // per)


def paged_chunk_splits(B: int, k: int, Hq: int, Hkv: int, n_slots: int,
                       n_sm: int) -> int:
    """Number of splits of K4's tensor-core walk (chunk steps), 1 for an
    unsplit walk.

    The rule reads shapes only (``n_slots = nb * page_size``), so the step
    loop need not sync.  A block holds 128 query rows (``128 // G``
    positions of one kv head) and runs alone on its SM (~200 KB of shared
    memory).  At run()'s chunk shape (4 rows x 512, G = 2, 4224 slots) the
    unsplit grid is 8 x 4 x 4 = 128 blocks, one wave whose time is set by
    the q tiles of a long row's late chunk, each walking ~130 of the row's
    32-slot tiles while a short row's walk little.  Splitting each row's
    live range into NS runs of whole tiles caps a block's walk at
    ``ceil(tiles / NS)``, so the long row's blocks, wherever the scheduler
    starts them, end soon after the short ones; the cost is the partials,
    ``B Hq NS k (D + 2)`` floats written once and read once by the merge
    (~135 MB at NS = 8).  On an H100 at that shape, forced split counts
    showed the walk falling from NS = 1 to a floor around NS = 6-12 and
    rising past it, so splits are taken up to about eight blocks per SM,
    and never outnumber the tiles."""
    G = Hq // Hkv
    blocks = -(-k // (TC_ROWS // G)) * Hkv * B
    n_tiles = -(-n_slots // BKV)
    if n_tiles <= 1:
        return 1
    return max(1, min(n_tiles, (8 * n_sm) // blocks))


def paged_walk(B: int, k: int, Hq: int, Hkv: int, n_slots: int,
               n_sm: int):
    """(walk, splits) of a K4 call, from shapes alone: ``"decode"`` (the
    CUDA-core walk over the block's ``k * G`` real rows) for q tiles of at
    most ``32 // G`` columns, whatever the batch, with
    :func:`paged_decode_splits` splits (1 where the rows alone fill the
    card); else ``"tc"`` (the 128-row tensor-core walk) with
    :func:`paged_chunk_splits` splits.  The C entry point takes the walk
    as given and only checks that it fits."""
    if k <= ROWS // (Hq // Hkv):
        return "decode", paged_decode_splits(B, k, Hq, Hkv, n_slots, n_sm)
    return "tc", paged_chunk_splits(B, k, Hq, Hkv, n_slots, n_sm)


@functools.lru_cache(maxsize=None)
def _paged_fn():
    return build.bind("paged_attention", "paged_attention_fwd", 11, 13,
                      tail=(ctypes.c_float, ctypes.c_float))


def _check_paged(q, k_pages, v_pages, pos_pages, block_tables, q_pos,
                 k_scale_pages, v_scale_pages):
    dev = q.device
    _expect_q(q)
    kv_dt = k_pages.dtype          # one of KV_TYPES: the caller checked it
    build.expect(k_pages, "k_pages", kv_dt, 4, dev)
    build.expect(v_pages, "v_pages", kv_dt, 4, dev)
    build.expect(pos_pages, "pos_pages", torch.int32, 2, dev)
    build.expect(block_tables, "block_tables", torch.int32, 2, dev)
    build.expect(q_pos, "q_pos", torch.int32, 2, dev)
    B, k, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    if (v_pages.shape != k_pages.shape or k_pages.shape[3] != D
            or tuple(pos_pages.shape) != (P, ps)
            or block_tables.shape[0] != B or tuple(q_pos.shape) != (B, k)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}, pos "
            f"{tuple(pos_pages.shape)}, block_tables "
            f"{tuple(block_tables.shape)}, q_pos {tuple(q_pos.shape)}")
    for t, what in ((k_scale_pages, "k_scale_pages"),
                    (v_scale_pages, "v_scale_pages")):
        if t is not None:
            build.expect(t, what, torch.float32, 3, dev)
            if tuple(t.shape) != (P, ps, Hkv):
                raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                                 f"{(P, ps, Hkv)}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads: need a "
                         f"whole group of at most {MAX_GROUP}")
    for t, what in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        if t.data_ptr() % (4 * t.element_size()):  # 4-element vector loads
            raise ValueError(f"{what}: data must be aligned to 4 elements")
    if q.data_ptr() % 16:                             # 16-byte vector loads
        raise ValueError("q: data must be 16-byte aligned")


def paged_prefill_attention(q, k_pages, v_pages, pos_pages, block_tables, *,
                            q_pos, window=None, attn_cap=None,
                            k_scale_pages=None, v_scale_pages=None):
    """Causal attention over the paged KV pool for q tiles of k tokens.

    q: (B, k, Hq, D) f32 or bf16; ``*_pages``: (P, page_size, Hkv, D)
    f32, bf16 or int8, ``pos_pages`` (P, page_size) int32; block_tables:
    (B, nb) int32 physical page ids; q_pos: (B, k) int32, real tokens left-aligned in
    ascending position order and padded columns ``POS_SENTINEL``.  int8
    pools pass ``k_scale_pages`` / ``v_scale_pages`` (P, page_size, Hkv)
    f32, and only they do.  Returns (B, k, Hq, D) in q's dtype.

    Padded (sentinel) query columns are garbage the scheduler never reads,
    and they differ between the two versions: the kernel returns exact
    zeros for a row whose columns are all sentinel, the plain version lets
    a sentinel query attend every written slot (as the reference does)."""
    build.refuse_dtensor("paged_prefill_attention", q, k_pages, v_pages,
                         pos_pages, block_tables, q_pos, k_scale_pages,
                         v_scale_pages)
    if k_pages.dtype not in KV_TYPES:
        raise ValueError(f"k_pages: expected float32, bfloat16 or int8, got "
                         f"{k_pages.dtype}")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale_pages is not None) or \
            quant != (v_scale_pages is not None):
        raise AssertionError("int8 pools require scale pages (and float "
                             "pools must not pass them)")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    B, k = q.shape[0], q.shape[1]
    q_pos = q_pos.reshape(B, k)
    if q.device.type == "cpu":
        from repro_torch.models.layers import paged_attention_ref
        return paged_attention_ref(
            q, k_pages, v_pages, pos_pages, block_tables, q_pos=q_pos,
            window=window, attn_cap=attn_cap, k_scale_pages=k_scale_pages,
            v_scale_pages=v_scale_pages)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for {q.device}")
    _check_paged(q, k_pages, v_pages, pos_pages, block_tables, q_pos,
                 k_scale_pages, v_scale_pages)
    _, _, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"head dim {D}: the kernel takes multiples of 8 up "
                         f"to {MAX_HEAD_DIM}")
    walk, ns = paged_walk(B, k, Hq, Hkv, nb * ps, build.sm_count(q.device))
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    # the decode walk merges its partials even unsplit
    ml, pacc = _split_partials(q, ns, merged=walk == "decode" or ns > 1)
    err = build.launch(
        _paged_fn(), q, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pos_pages.data_ptr(), block_tables.data_ptr(), q_pos.data_ptr(),
        k_scale_pages.data_ptr() if quant else None,
        v_scale_pages.data_ptr() if quant else None, o.data_ptr(), ml, pacc,
        B, k, P, ps, Hq, Hkv, D, nb, KV_TYPES[k_pages.dtype],
        Q_TYPES[q.dtype], int(window or 0),
        int(walk == "tc"), ns, float(attn_cap or 0.0), 1.0 / math.sqrt(D))
    PAGED_COUNT.launches += 1
    build.check(build.load(PAGED_COUNT.name), err, PAGED_COUNT.name)
    return o


def paged_decode_attention(q, k_pages, v_pages, pos_pages, block_tables, *,
                           q_pos, window=None, attn_cap=None,
                           k_scale_pages=None, v_scale_pages=None):
    """Single-token decode over the paged pool: the k = 1 q tile of
    :func:`paged_prefill_attention` (same kernel, same launch count).
    q: (B, 1, Hq, D); q_pos: (B, 1) or (B,) int32."""
    B = q.shape[0]
    return paged_prefill_attention(
        q, k_pages, v_pages, pos_pages, block_tables,
        q_pos=q_pos.reshape(B, 1), window=window, attn_cap=attn_cap,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
