"""Mamba2 (SSD) block, the state-space substrate of zamba2 (twin of
``repro.nn.ssm``).

Scalar-decay state space (Mamba2's SSD form): per head h with state size
N,

    H_t = a_t * H_{t-1} + dt_t * B_t (x) x_t        H in R^{N x P}
    y_t = C_t . H_t + D * x_t

a_t = exp(-dt_t * A_h) with per-head A > 0, dt via softplus.  ``a_log``,
``d_skip`` and ``dt_bias`` are f32 in every model dtype; the state and the
scan are f32.  Decode carries (H, the conv's last 3 taps): O(1) a step.

Training and prefill scan the linear recurrence over time in chunks of
``SCAN_CHUNK`` steps: inside a chunk a log-step (Hillis-Steele) scan of
the (a, increment) pairs under the reference's combine
``(a1 a2, a2 u1 + u2)``, then the carried state enters as
``A_cum H_prev + U_cum``.  The reference runs one
``jax.lax.associative_scan`` over the whole sequence: the same products
and sums, grouped in another order, so the two agree to rounding (a
stated tolerance in the tests).  Per chunk the increments, the states and
the output's C . H contraction are formed and dropped, and under autograd
each chunk is checkpointed: at zamba2's width (d_inner 5,120, 80 heads,
N 64, P 64) the [tokens, H, N, P] increments and states take 1.31 MB a
token each in f32, 10.7 GB each at [4, 2048], which the reference holds
whole.  Plain PyTorch, as the reference is plain XLA.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.act_constraints import by_batch
from repro_torch.nn.layers import _normal, dense_init
from repro_torch.nn.xlstm import softplus

SCAN_CHUNK = 64


class Mamba2Params(NamedTuple):
    in_proj: torch.Tensor     # [d, 2*di + 2*N + H]   (x, z, B, C, dt)
    conv_w: torch.Tensor      # [4, di + 2*N]         depthwise conv over time
    a_log: torch.Tensor       # [H]   f32
    d_skip: torch.Tensor      # [H]   f32
    dt_bias: torch.Tensor     # [H]   f32
    norm_scale: torch.Tensor  # [di]
    out_proj: torch.Tensor    # [di, d]


class Mamba2State(NamedTuple):
    h: torch.Tensor           # [B, H, N, P]    SSM state (f32)
    conv: torch.Tensor        # [B, 3, di+2N]   last taps of the causal conv


def dims(d_model: int, ssm_state: int, expand: int = 2,
         head_p: int = 64) -> tuple[int, int, int]:
    di = expand * d_model
    n_heads = di // head_p
    return di, n_heads, ssm_state


def init_mamba2(gen: Optional[torch.Generator], d_model: int,
                ssm_state: int, dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> Mamba2Params:
    di, h, n = dims(d_model, ssm_state)
    dev = device if device is not None else (
        gen.device if gen is not None else None)
    f32 = torch.float32
    conv_ch = di + 2 * n
    return Mamba2Params(
        in_proj=dense_init(gen, d_model, 2 * di + 2 * n + h, dtype, device),
        conv_w=(0.5 * _normal(gen, (4, conv_ch), device)).to(dtype),
        a_log=torch.zeros((h,), dtype=f32, device=dev),
        d_skip=torch.ones((h,), dtype=f32, device=dev),
        dt_bias=torch.full((h,), -2.0, dtype=f32, device=dev),
        norm_scale=torch.ones((di,), dtype=dtype, device=dev),
        out_proj=dense_init(gen, di, d_model, dtype, device))


def _split(proj: torch.Tensor, di: int, n: int):
    x = proj[..., :di]
    z = proj[..., di:2 * di]
    bmat = proj[..., 2 * di:2 * di + n]
    cmat = proj[..., 2 * di + n:2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n:]
    return x, z, bmat, cmat, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel 4, its taps summed in order.
    x: [B, S, C], w: [4, C]."""
    s = x.shape[1]
    pad = F.pad(x, (0, 0, 3, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, 4):
        out = out + pad[:, i:i + s] * w[i]
    return out


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """y * silu(z), then the grouped RMSNorm (one group, eps 1e-5)."""
    y = y.to(dtype) * F.silu(z)
    y32 = y.float()
    var = torch.mean(y32 * y32, -1, keepdim=True)
    return (y32 * torch.rsqrt(var + 1e-5) * scale.float()).to(dtype)


def _scan_chunk(h0, a, dt, bmat, xh, cmat):
    """One chunk of the recurrence.  h0 [B, H, N, P] (the carried state),
    a / dt [B, L, H], bmat / cmat [B, L, N] f32, xh [B, L, H, P] f32 ->
    (C . H_t [B, L, H, P], H at the chunk's end)."""
    acum = a                                                # [B, L, H]
    u = torch.einsum('bsh,bsn,bshp->bshnp', dt, bmat, xh)   # [B,L,H,N,P]
    n = a.shape[1]
    shift = 1
    while shift < n:
        # element t absorbs element t - shift: (a1 a2, a2 u1 + u2)
        a_hi = acum[:, shift:]
        u = torch.cat([u[:, :shift],
                       a_hi[..., None, None] * u[:, :-shift] + u[:, shift:]],
                      dim=1)
        acum = torch.cat([acum[:, :shift], acum[:, :-shift] * a_hi], dim=1)
        shift *= 2
    hs = acum[..., None, None] * h0[:, None] + u
    y = torch.einsum('bsn,bshnp->bshp', cmat, hs)
    return y, hs[:, -1]


def apply_mamba2_train(p: Mamba2Params, xin: torch.Tensor, d_model: int,
                       ssm_state: int) -> torch.Tensor:
    """xin: [B, S, d] -> [B, S, d], the recurrence scanned over time in
    chunks (module docstring)."""
    di, h, n = dims(d_model, ssm_state)
    # the recurrence reads one sequence at a time: on a mesh, each rank's
    # rows (``act_constraints.by_batch``)
    y = by_batch(_mamba2_rows, 1, xin @ p.in_proj, p.conv_w, p.dt_bias,
                 p.a_log, p.d_skip, p.norm_scale, di, h, n, xin.dtype)
    return y @ p.out_proj


def _mamba2_rows(proj: torch.Tensor, conv_w: torch.Tensor,
                 dt_bias: torch.Tensor, a_log: torch.Tensor,
                 d_skip: torch.Tensor, norm_scale: torch.Tensor, di: int,
                 h: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    """The block between its projections: proj [B, S, 2 di + 2 N + H] ->
    the gated, normed scan output [B, S, di] in ``dtype``."""
    pdim = di // h
    b, s, _ = proj.shape
    x, z, bmat, cmat, dt = _split(proj, di, n)
    xbc = torch.cat([x, bmat, cmat], dim=-1)
    xbc = F.silu(_causal_conv(xbc, conv_w))
    x, bmat, cmat = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]

    dt = softplus(dt.float() + dt_bias)                          # [B,S,H]
    a = torch.exp(-dt * torch.exp(a_log))                        # [B,S,H]
    xh = x.reshape(b, s, h, pdim).float()
    b32, c32 = bmat.float(), cmat.float()
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (a, xh, b32, c32))
    state = torch.zeros((b, h, n, pdim), dtype=torch.float32,
                        device=proj.device)
    ys = []
    for c in range(0, s, SCAN_CHUNK):
        sl = slice(c, c + SCAN_CHUNK)
        args = (state, a[:, sl], dt[:, sl], b32[:, sl], xh[:, sl], c32[:, sl])
        yc, state = checkpoint(_scan_chunk, *args, use_reentrant=False) \
            if remat else _scan_chunk(*args)
        ys.append(yc)
    y = torch.cat(ys, dim=1) + d_skip[None, None, :, None] * xh
    return _gated_norm(y.reshape(b, s, di), z, norm_scale, dtype)


def init_mamba2_state(b: int, d_model: int, ssm_state: int,
                      dtype: torch.dtype = torch.float32,
                      device: Optional[torch.device] = None) -> Mamba2State:
    di, h, n = dims(d_model, ssm_state)
    return Mamba2State(
        h=torch.zeros((b, h, n, di // h), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((b, 3, di + 2 * n), dtype=dtype, device=device))


def apply_mamba2_step(p: Mamba2Params, xin: torch.Tensor,
                      state: Mamba2State, d_model: int, ssm_state: int
                      ) -> tuple[torch.Tensor, Mamba2State]:
    """One decode step.  xin: [B, 1, d] -> ([B, 1, d], the new state)."""
    di, h, n = dims(d_model, ssm_state)
    pdim = di // h
    b = xin.shape[0]
    proj = xin[:, 0] @ p.in_proj
    x, z, bmat, cmat, dt = _split(proj, di, n)
    xbc = torch.cat([x, bmat, cmat], dim=-1)                    # [B, C]
    taps = torch.cat([state.conv, xbc[:, None]], dim=1)         # [B, 4, C]
    xbc = F.silu(torch.einsum('btc,tc->bc', taps, p.conv_w))
    new_conv = taps[:, 1:]
    x, bmat, cmat = xbc[:, :di], xbc[:, di:di + n], xbc[:, di + n:]

    dt = softplus(dt.float() + p.dt_bias)                       # [B, H]
    a = torch.exp(-dt * torch.exp(p.a_log))
    xh = x.reshape(b, h, pdim).float()
    hnew = a[..., None, None] * state.h + torch.einsum(
        'bh,bn,bhp->bhnp', dt, bmat.float(), xh)
    y = torch.einsum('bn,bhnp->bhp', cmat.float(), hnew)
    y = y + p.d_skip[None, :, None] * xh
    y = _gated_norm(y.reshape(b, di), z, p.norm_scale, xin.dtype)
    return (y @ p.out_proj)[:, None], Mamba2State(hnew, new_conv)
