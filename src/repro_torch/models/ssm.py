"""Mamba2 (SSD, state-space duality) block (port of ``repro/models/ssm.py``).

Training and prefill use the SSD block decomposition: inside chunks of
length Q the recurrence is evaluated as attention-like matmuls, and across
chunks a Python loop (the reference's ``lax.scan``) carries the
(B, H, P, N) fp32 state; the loop's count comes from shapes, so it never
reads the device.  Decode is the O(1) single-step state update.  Single
B/C group.  The depthwise causal conv runs on x alone, as in the
reference, or, where the config says so (``api.Mamba2Cfg.conv_bc``, as
Mamba-2 publishes it), on x, B and C together, SiLU after it on all three.

:func:`mamba_step` is the serving engine's token-budget step: each row
carries its own recurrent state and conv window in and out (a prompt
chunk, one decode token or nothing), and the scan advances over the row's
real columns alone.  Its projections and gate take the rows of the
step's layout (``layers.StepLayout``), and the conv and scan its (R, w)
grid.

The projections go through :func:`layers.linear`: a PackedWeight reaches
K2 / K3 and an int8-store leaf K2, a dense weight is a plain matmul.
The reference runs no Pallas kernel here, and the port none of its own:
the chunk scan runs in plain PyTorch inside the span ``SSD_SCAN``
(``repro_torch.spans``, recorded while a profiler runs), which a profile
reads to split its device time from the rest; the caller's span ``MAMBA``
(``transformer.LM._mamba_block``) encloses each block.

Shapes: B batch, S seq, H heads, P head_dim, N d_state, Q chunk, C the
conv's channels (:func:`conv_dim`).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.models.api import SSMCfg
from repro_torch.models.layers import (POS_SENTINEL, _contiguous_stride,
                                       at_least_f32, linear, rmsnorm,
                                       split_heads)
from repro_torch.sharding import ctx

# spans: the SSD chunk scan (plain PyTorch kernels), and the whole block
# around it (opened by the model)
SSD_SCAN, MAMBA = "ssd_chunk_scan", "mamba"


def conv_dim(cfg: SSMCfg, d_model: int) -> int:
    """Channels of the depthwise conv: d_inner, plus B's and C's 2 d_state
    where the conv takes them too (``Mamba2Cfg.conv_bc``)."""
    extra = 2 * cfg.d_state if getattr(cfg, "conv_bc", False) else 0
    return cfg.d_inner(d_model) + extra


def init_mamba_params(lin, zeros, d_model: int, cfg: SSMCfg):
    """One block's parameters from the reference's distributions, built by
    the caller's ``lin(fan_in, *shape)`` (``normal / sqrt(fan_in)``) and
    ``zeros(*shape)``, which also add any leading stack dims.  ``A_log``
    0 gives A = -1 and ``D`` is 1, as in the reference."""
    di = cfg.d_inner(d_model)
    H, N = cfg.n_heads(d_model), cfg.d_state
    return {
        "w_xz": lin(d_model, d_model, 2 * di),
        "w_bc": lin(d_model, d_model, 2 * N),
        "w_dt": lin(d_model, d_model, H),
        "dt_bias": zeros(H),
        "A_log": zeros(H),
        "D": zeros(H) + 1.0,
        "conv_w": lin(cfg.d_conv, cfg.d_conv, conv_dim(cfg, d_model)),
        "conv_b": zeros(conv_dim(cfg, d_model)),
        "norm_w": zeros(di),
        "w_out": lin(di, di, d_model),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C); w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    # the zero rows by concatenation, not F.pad: DTensor's pad strategy
    # fails to redistribute on some torch releases (2.11)
    xp = torch.cat([x.new_zeros((x.shape[0], K - 1, x.shape[2])), x], dim=1)
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    return out + b


def _conv_in(xi: torch.Tensor, bc: torch.Tensor, cfg: SSMCfg):
    """The conv's input: x, or x, B and C side by side (``conv_bc``)."""
    return torch.cat([xi, bc], dim=-1) if getattr(cfg, "conv_bc", False) \
        else xi


def _conv_out(conv: torch.Tensor, bc: torch.Tensor, di: int, cfg: SSMCfg):
    """SiLU over the conv's output; returns (x, B and C)."""
    act = F.silu(conv)
    if getattr(cfg, "conv_bc", False):
        return act[..., :di], act[..., di:]
    return act, bc


def _ssd_chunk_scan(xh, Bm, Cm, dt, A, chunk: int, state=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh: (B, S, H, P); Bm, Cm: (B, S, N); dt: (B, S, H); A: (H,) negative;
    all fp32; ``state`` (B, H, P, N) the state before position 0 (zeros
    when None).  Returns (y (B, S, H, P), final_state (B, H, P, N)).  A
    tail that is not a whole chunk is padded with dt = 0 steps (decay 1,
    no state update), so the final state is the state at the last real
    position; a step given dt = 0 leaves the state alone in the same
    way."""
    Bb, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        S += pad
    nc = S // Q
    la = dt * A                                              # (B, S, H)
    xc = xh.reshape(Bb, nc, Q, H, P)
    Bc = Bm.reshape(Bb, nc, Q, N)
    Cc = Cm.reshape(Bb, nc, Q, N)
    dtc = dt.reshape(Bb, nc, Q, H)
    lac = la.reshape(Bb, nc, Q, H)
    # below and on the diagonal; rel is masked to -inf *before* exp: above
    # it l_t - l_s is positive and exp can overflow, and inf * 0 would be
    # NaN in the backward
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))[None, :, :, None]

    if state is None:
        state = torch.zeros((Bb, H, P, N), dtype=xh.dtype, device=xh.device)
    ys = []
    for c in range(nc):
        xq, bq, cq = xc[:, c], Bc[:, c], Cc[:, c]
        dq, lq = dtc[:, c], lac[:, c]
        l_cum = torch.cumsum(lq, dim=1)                      # (B, Q, H)
        l_tot = l_cum[:, -1]                                 # (B, H)
        # inter-chunk: the carried state's contribution
        dec_in = torch.exp(l_cum)
        y_inter = torch.einsum("bqn,bhpn->bqhp", cq, state) * \
            dec_in[..., None]
        # intra-chunk: M[t, s] = e^{l_t - l_s} dt_s (C_t . B_s)
        rel = l_cum[:, :, None, :] - l_cum[:, None, :, :]    # (B, Qt, Qs, H)
        rel = torch.where(causal, rel, torch.full_like(rel, -math.inf))
        cb = torch.einsum("btn,bsn->bts", cq, bq)            # (B, Qt, Qs)
        M = torch.exp(rel) * cb[..., None] * dq[:, None, :, :]
        y_intra = torch.einsum("btsh,bshp->bthp", M, xq)
        # state update
        dec_out = torch.exp(l_tot[:, None, :] - l_cum)       # (B, Q, H)
        upd = torch.einsum("bqhp,bqn->bhpn",
                           (dec_out * dq)[..., None] * xq, bq)
        state = state * torch.exp(l_tot)[..., None, None] + upd
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, dim=1).reshape(Bb, S, H, P)
    return y[:, :S_orig], state


def _ssd_scan(xh, Bm, Cm, dt, A, chunk: int):
    """:func:`_ssd_chunk_scan`, under a mesh on each rank's local shards:
    the scan is independent per (batch row, head), so every mesh dim that
    shards xh's batch shards all of them there, one that shards its heads
    (where it divides H) shards xh's, dt's and A's heads, and any other
    sharding is gathered first.  DTensor thus never sees the scan's
    flattening einsums (some torch releases refuse them on a sharded
    dim)."""
    if not any(ctx.is_dtensor(t) for t in (xh, Bm, Cm, dt, A)):
        return _ssd_chunk_scan(xh, Bm, Cm, dt, A, chunk)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = next(t for t in (xh, Bm, Cm, dt, A)
                if ctx.is_dtensor(t)).device_mesh
    xh, Bm, Cm, dt, A = (ctx.replicated(t, mesh)
                         for t in (xh, Bm, Cm, dt, A))
    H = xh.shape[2]
    picks = []                          # (xh / y, Bm / Cm, dt, A, state)
    for size, p in zip(mesh.mesh.shape, xh.placements):
        if isinstance(p, Shard) and p.dim == 0:
            picks.append((Shard(0), Shard(0), Shard(0), Replicate(),
                          Shard(0)))
        elif isinstance(p, Shard) and p.dim == 2 and H % size == 0:
            picks.append((Shard(2), Replicate(), Shard(2), Shard(0),
                          Shard(1)))
        else:
            picks.append((Replicate(),) * 5)
    px, pb, pd, pa, ps = (list(c) for c in zip(*picks))
    y, state = _ssd_chunk_scan(
        xh.redistribute(mesh, px).to_local(),
        Bm.redistribute(mesh, pb).to_local(),
        Cm.redistribute(mesh, pb).to_local(),
        dt.redistribute(mesh, pd).to_local(),
        A.redistribute(mesh, pa).to_local(), chunk)
    B, S, _, P = xh.shape
    st_shape = (B, H, P, Bm.shape[-1])
    return (DTensor.from_local(y, mesh, px, run_check=False,
                               shape=xh.shape,
                               stride=_contiguous_stride(tuple(xh.shape))),
            DTensor.from_local(state, mesh, ps, run_check=False,
                               shape=st_shape,
                               stride=_contiguous_stride(st_shape)))


def _last_conv_window(xin: torch.Tensor, cfg: SSMCfg) -> torch.Tensor:
    """The (d_conv - 1) trailing conv inputs, for decode to continue from;
    a prompt shorter than that is padded on the left."""
    K, S = cfg.d_conv, xin.shape[1]
    if S >= K - 1:
        return xin[:, S - (K - 1):, :]
    return F.pad(xin, (0, 0, K - 1 - S, 0))


def mamba_forward(params, x: torch.Tensor, cfg: SSMCfg, d_model: int):
    """Full-sequence forward.  x: (B, S, d).  Returns (y (B, S, d),
    {"state": (B, H, P, N) fp32, "conv": (B, d_conv - 1, di)})."""
    Bb, S, _ = x.shape
    di = cfg.d_inner(d_model)
    H, P = cfg.n_heads(d_model), cfg.head_dim

    xz = linear(x, params["w_xz"])
    xi, z = xz[..., :di], xz[..., di:]
    bc = linear(x, params["w_bc"])
    xin = _conv_in(xi, bc, cfg)
    xi, bc = _conv_out(_causal_conv(xin, params["conv_w"], params["conv_b"]),
                       bc, di, cfg)
    Bm, Cm = at_least_f32(bc).chunk(2, dim=-1)
    dt = F.softplus(at_least_f32(linear(x, params["w_dt"])) +
                    at_least_f32(params["dt_bias"]))
    A = -torch.exp(at_least_f32(params["A_log"]))

    xh = split_heads(at_least_f32(xi), H, P)
    with spans.span(SSD_SCAN):
        y, state = _ssd_scan(xh, Bm, Cm, dt, A, cfg.chunk)
    y = y + at_least_f32(params["D"])[:, None] * xh
    y = y.reshape(Bb, S, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params["norm_w"])
    out = linear(y, params["w_out"], role="w_row")
    return out, {"state": state, "conv": _last_conv_window(xin, cfg)}


def init_mamba_cache(batch: int, d_model: int, cfg: SSMCfg,
                     dtype: torch.dtype, lead: Tuple[int, ...] = (),
                     device=None):
    """Decode state of one block: ``state`` (lead..., batch, H, P, N) in
    fp32 and ``conv`` (lead..., batch, d_conv - 1, C) in ``dtype``."""
    H, P, N = cfg.n_heads(d_model), cfg.head_dim, cfg.d_state
    C = conv_dim(cfg, d_model)
    return {
        "state": torch.zeros(lead + (batch, H, P, N), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros(lead + (batch, cfg.d_conv - 1, C), dtype=dtype,
                            device=device),
    }


def mamba_decode_step(params, x: torch.Tensor, cache, cfg: SSMCfg,
                      d_model: int):
    """Single-token decode.  x: (B, 1, d).  Returns (y (B, 1, d), the new
    {"state", "conv"}).  The window joins the cached one and the new token
    in the type the two promote to, as the reference's ``jnp.concatenate``
    does, and comes back in it: fp32 for an fp32 model or an fp32 cache,
    bf16 for a bf16 model on a bf16 cache."""
    Bb = x.shape[0]
    di = cfg.d_inner(d_model)
    H, P = cfg.n_heads(d_model), cfg.head_dim

    xz = linear(x, params["w_xz"])
    xi, z = xz[..., :di], xz[..., di:]                       # (B, 1, di)
    bc = linear(x, params["w_bc"])
    xin = _conv_in(xi, bc, cfg)                              # (B, 1, C)
    wdt = torch.promote_types(cache["conv"].dtype, xin.dtype)
    win = torch.cat([cache["conv"].to(wdt), xin.to(wdt)], dim=1)  # (B, K, C)
    conv = (win * params["conv_w"][None]).sum(dim=1, keepdim=True) + \
        params["conv_b"]
    xi, bc = _conv_out(conv, bc, di, cfg)

    Bm, Cm = at_least_f32(bc)[:, 0].chunk(2, dim=-1)         # (B, N)
    dt = F.softplus(at_least_f32(linear(x, params["w_dt"]))[:, 0] +
                    at_least_f32(params["dt_bias"]))         # (B, H)
    A = -torch.exp(at_least_f32(params["A_log"]))
    a = torch.exp(dt * A)                                    # (B, H)

    xh = at_least_f32(xi).reshape(Bb, H, P)
    upd = (dt[..., None] * xh)[..., None] * Bm[:, None, None, :]
    state = cache["state"] * a[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, state)
    y = y + at_least_f32(params["D"])[:, None] * xh
    y = y.reshape(Bb, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params["norm_w"])
    out = linear(y, params["w_out"], role="w_row")
    return out, {"state": state, "conv": win[:, 1:, :]}


def mamba_step(params, x: torch.Tensor, cache, layout, cfg: SSMCfg,
               d_model: int):
    """One token-budget step over carried state.  ``layout``
    (``layers.StepLayout``): the step's (R, w) grid, row r's real columns
    left-aligned in position order and its padded columns at
    ``POS_SENTINEL`` in ``layout.pos``; x: the layout's rows (the grid
    (R, w, d), or its computed cells (B, 1, d)); ``cache``: the grid rows'
    own {"state" (R, H, P, N) fp32, "conv" (R, d_conv - 1, C)}.  The
    projections, the gate and ``w_out`` run on x's rows, and the conv and
    the scan on the grid that the layout scatters them into.

    A row whose first column sits at position 0 starts a prompt: its state
    and window start from zeros, decided on the device.  The scan advances
    each row over its real columns alone (dt = 0 on a padded column: no
    decay, no update), so a decode token (one real column), a prompt
    chunk and an empty row take the same path.  The conv reads [window,
    the row's inputs]; the new window is the last d_conv - 1 real inputs
    of that.  Returns (y like x, the new {"state", "conv"}), the window
    in the type the cached one and the inputs promote to, as
    :func:`mamba_decode_step`'s.  Reads nothing back to the host."""
    q_pos = layout.pos
    R, w = q_pos.shape
    di = cfg.d_inner(d_model)
    H, P, K = cfg.n_heads(d_model), cfg.head_dim, cfg.d_conv
    real = q_pos != POS_SENTINEL                             # (R, w)
    fresh = q_pos[:, 0] == 0                                 # (R,)

    xz = linear(x, params["w_xz"])
    xi, z = xz[..., :di], xz[..., di:]
    bc = linear(x, params["w_bc"])
    dt = F.softplus(at_least_f32(linear(x, params["w_dt"])) +
                    at_least_f32(params["dt_bias"]))
    xi, bc, dt = (layout.scatter(t) for t in (xi, bc, dt))
    xin = _conv_in(xi, bc, cfg)                              # (R, w, C)
    wdt = torch.promote_types(cache["conv"].dtype, xin.dtype)
    win = cache["conv"].masked_fill(fresh[:, None, None], 0).to(wdt)
    full = torch.cat([win, xin.to(wdt)], dim=1)              # (R, K-1+w, C)
    conv = sum(full[:, i:i + w, :] * params["conv_w"][i] for i in range(K))
    xi, bc = _conv_out(conv + params["conv_b"], bc, di, cfg)
    last = real.sum(dim=1)[:, None] + torch.arange(K - 1, device=x.device)
    new_win = torch.gather(full, 1,
                           last[..., None].expand(-1, -1, full.shape[-1]))

    Bm, Cm = at_least_f32(bc).chunk(2, dim=-1)
    dt = dt.masked_fill(~real[..., None], 0.0)               # (R, w, H)
    A = -torch.exp(at_least_f32(params["A_log"]))
    xh = split_heads(at_least_f32(xi), H, P)
    state = cache["state"].masked_fill(fresh[:, None, None, None], 0.0)
    with spans.span(SSD_SCAN):
        y, state = _ssd_chunk_scan(xh, Bm, Cm, dt, A, cfg.chunk, state)
    y = layout.gather(
        (y + at_least_f32(params["D"])[:, None] * xh).reshape(R, w, di))
    y = rmsnorm(y.to(x.dtype) * F.silu(z), params["norm_w"])
    out = linear(y, params["w_out"], role="w_row")
    return out, {"state": state, "conv": new_win}
