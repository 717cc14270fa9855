"""Multi-bit binarization: W ~= sum_m alpha_m B_m, B_m in {-1, +1} (port of
``repro/quant/binarize.py``).

Greedy residual binarization (B_m = sign(R_m), alpha_m = E|R_m|) with a
joint least-squares refit of the alphas per output channel
(:func:`binarize_residual`), and the masked greedy expansion the search
evaluates (:func:`fake_binarize_per_channel`): ``bits = 0`` prunes a
channel and bit-widths are capped at ``MAX_PLANES``.

The deployment form of a binarized product is the bit-plane matmul
y = sum_m alpha_m (x @ B_m) (kernel B6, ``kernels/binary_matmul.py``);
:func:`fake_binarize_planes` gives a weight in that form, masked as
:func:`fake_binarize_per_channel` masks it and from the same arithmetic.
"""
from __future__ import annotations

import torch

MAX_PLANES = 8


def binarize_residual(w: torch.Tensor, planes: int, axis: int = -1):
    """Greedy residual binarization with a joint per-channel alpha refit.

    Returns (B, alpha): B int8 {-1, +1} of shape (planes, *w.shape); alpha
    f32 of shape (planes, *broadcast_shape), 1 everywhere except the
    channel axis."""
    planes = int(planes)
    w = w.to(torch.float32)
    axis_ = axis % w.ndim
    red = tuple(d for d in range(w.ndim) if d != axis_)

    bs, r = [], w
    for _ in range(planes):
        b = torch.where(r >= 0, 1.0, -1.0)
        a = r.abs().mean(dim=red, keepdim=True)
        r = r - a * b
        bs.append(b)
    B = torch.stack(bs)                                     # (m, ...)

    # joint least-squares refit per channel: solve (B B^T) a = B w
    m, c = planes, w.shape[axis_]
    wt = torch.movedim(w, axis_, 0).reshape(c, -1)          # (c, k)
    Bt = torch.movedim(B, axis_ + 1, 1).reshape(m, c, -1)   # (m, c, k)
    G = torch.einsum("mck,nck->cmn", Bt, Bt)                # (c, m, m)
    rhs = torch.einsum("mck,ck->cm", Bt, wt)                # (c, m)
    eye = torch.eye(m, dtype=torch.float32, device=w.device)
    a = torch.linalg.solve(G + 1e-6 * eye, rhs[..., None])[..., 0]

    shape = [1] * w.ndim
    shape[axis_] = c
    alpha = torch.stack([a[:, i].reshape(shape) for i in range(m)])
    return B.to(torch.int8), alpha.to(torch.float32)


def reconstruct(B: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """sum_m alpha_m B_m."""
    return torch.sum(alpha * B.to(torch.float32), dim=0)


def _clipped_bits(bits_per_channel, shape, device) -> torch.Tensor:
    b = torch.as_tensor(bits_per_channel, dtype=torch.float32, device=device)
    return torch.clamp(b.reshape(shape), 0.0, float(MAX_PLANES))


def _greedy_planes(w: torch.Tensor, bits_per_channel, axis: int):
    """The masked greedy expansion, plane by plane: yields (b, a, keep)
    for each of MAX_PLANES planes, b the signs of the residual, a its
    per-channel mean |r| (keepdim), keep = BBN > m.  The residual update is
    unconditional.  :func:`fake_binarize_per_channel` and
    :func:`fake_binarize_planes` both run it, so their planes and alphas
    are the same bits: a mean over another layout of the same weight (a
    conv's im2col rows) sums in another order, and an alpha off by one ulp
    can flip the sign of a residual near 0 in a later plane."""
    w = w.to(torch.float32)
    axis_ = axis % w.ndim
    red = tuple(d for d in range(w.ndim) if d != axis_)
    shape = [1] * w.ndim
    shape[axis_] = w.shape[axis_]
    bits = _clipped_bits(bits_per_channel, shape, w.device)
    r = w
    for m in range(MAX_PLANES):
        b = torch.where(r >= 0, 1.0, -1.0)
        a = r.abs().mean(dim=red, keepdim=True)
        yield b, a, bits > (m + 0.5)
        r = r - a * b


def fake_binarize_per_channel(w: torch.Tensor, bits_per_channel,
                              axis: int = -1) -> torch.Tensor:
    """Binarize-dequantize with a *vector* of per-channel plane counts.

    Always MAX_PLANES greedy planes; plane m is masked off for channels
    whose BBN <= m (bits clipped to [0, MAX_PLANES]).  The residual update
    is unconditional, so a channel's reconstruction at BBN = b is its
    b-plane greedy expansion."""
    out = torch.zeros_like(w, dtype=torch.float32)
    for b, a, keep in _greedy_planes(w, bits_per_channel, axis):
        contrib = a * b
        out = out + torch.where(keep, contrib, torch.zeros_like(contrib))
    return out


def fake_binarize_planes(w: torch.Tensor, bits_per_channel):
    """:func:`fake_binarize_per_channel` of a weight with its channels on
    the last axis (N of them), in plane form: ``planes`` (MAX_PLANES,
    *w.shape) int8 {-1, +1} from the greedy residual, ``alpha``
    (MAX_PLANES, N) f32, mean|r| of plane m masked by ``bits > m + 0.5``.
    Summed plane by plane in order, ``alpha * planes`` is the dense
    fake-binarized weight bit for bit."""
    planes, alpha = [], []
    for b, a, keep in _greedy_planes(w, bits_per_channel, -1):
        planes.append(b.to(torch.int8))
        alpha.append(torch.where(keep, a, torch.zeros_like(a)).reshape(-1))
    return torch.stack(planes), torch.stack(alpha)
