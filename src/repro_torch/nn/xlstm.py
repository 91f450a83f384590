"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(twin of ``repro.nn.xlstm``).

mLSTM: per head, a matrix memory C in R^{dk x dv} with exponential gating,

    C_t = f_t C_{t-1} + i_t k_t v_t^T        n_t = f_t n_{t-1} + i_t k_t
    h_t = C_t^T q_t / max(|n_t^T q_t|, 1)

with log-space gate stabilisation (m_t).  Training and prefill use the
parallel (decay-masked quadratic) form in query chunks of at most 1,024
rows; decode the O(1) recurrence.  In the stabilised space the
normaliser's floor 1 becomes exp(-m), in both forms.

sLSTM: a scalar-memory LSTM with exponential gating.  Its recurrence is
nonlinear in h_{t-1}, so training loops over time step by step, as the
reference's ``lax.scan`` does; the input projection of every step is one
product before the loop.  The state's ``h`` stays f32; the cell returns
it in the input's dtype and the next step reads it in that dtype.

Plain PyTorch, as the reference is plain XLA.  The row max of the
parallel form is ``amax``, which splits its gradient evenly among ties as
JAX's ``max`` does.  The decode steps return new states; ``models.lm``
writes them into the stacked cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.nn.layers import _normal, dense_init


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (no linear threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log sigmoid(x) as the reference writes it: -softplus(-x)."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMParams(NamedTuple):
    wq: torch.Tensor        # [d, H*dk]
    wk: torch.Tensor        # [d, H*dk]
    wv: torch.Tensor        # [d, H*dv]
    w_if: torch.Tensor      # [d, 2*H]   input/forget gate pre-activations
    wo: torch.Tensor        # [H*dv, d]
    ogate: torch.Tensor     # [d, H*dv]


def init_mlstm(gen: Optional[torch.Generator], d: int, n_heads: int,
               dtype: torch.dtype = torch.float32,
               device: Optional[torch.device] = None) -> MLSTMParams:
    dk = d // n_heads
    return MLSTMParams(
        wq=dense_init(gen, d, n_heads * dk, dtype, device),
        wk=dense_init(gen, d, n_heads * dk, dtype, device),
        wv=dense_init(gen, d, n_heads * dk, dtype, device),
        w_if=dense_init(gen, d, 2 * n_heads, dtype, device),
        wo=dense_init(gen, d, d, dtype, device),
        ogate=dense_init(gen, d, d, dtype, device))


_CHUNK = 1024


def _mlstm_chunk(qc, fc, off, fcum, logi, k32, v32):
    """Rows [off, off + c) of the parallel form.  qc [B, c, H, dk] f32,
    fc [B, c, H]; fcum / logi [B, S, H]; k32 / v32 [B, S, H, dk]."""
    s = fcum.shape[1]
    # score(t, u) = F_t - F_u + log i_u for u <= t, stabilised per row
    scores = fc[:, :, None, :] - fcum[:, None, :, :] \
        + logi[:, None, :, :]                              # [B, c, S, H]
    tidx = off + torch.arange(qc.shape[1], device=qc.device)
    causal = tidx[:, None] >= torch.arange(s, device=qc.device)[None, :]
    scores = scores.masked_fill(~causal[None, :, :, None], float("-inf"))
    m = torch.amax(scores, dim=2, keepdim=True)
    dmat = torch.exp(scores - m)
    sim = torch.einsum('bthd,buhd->btuh', qc, k32)
    w = sim * dmat
    norm = torch.maximum(torch.abs(torch.sum(w, dim=2)),
                         torch.exp(-m[:, :, 0]))
    return torch.einsum('btuh,buhd->bthd', w, v32) / norm[..., None]


def apply_mlstm_train(p: MLSTMParams, x: torch.Tensor,
                      n_heads: int) -> torch.Tensor:
    """Parallel (decay-masked quadratic) form.  x: [B, S, d] -> [B, S, d].
    Rows go in chunks of 1,024 when S is a larger multiple of it, so the
    [chunk, S] decay matrix never reaches [S, S]; otherwise in one."""
    b, s, d = x.shape
    dk = d // n_heads
    q = (x @ p.wq).reshape(b, s, n_heads, dk) / math.sqrt(dk)
    k = (x @ p.wk).reshape(b, s, n_heads, dk)
    v = (x @ p.wv).reshape(b, s, n_heads, dk)
    gates = (x @ p.w_if).reshape(b, s, n_heads, 2).float()
    logi = log_sigmoid(gates[..., 0])      # log i_t (sigmoid input gate)
    logf = log_sigmoid(gates[..., 1])      # log f_t
    fcum = torch.cumsum(logf, dim=1)                       # [B, S, H]
    chunk = min(_CHUNK, s)
    q32, k32, v32 = q.float(), k.float(), v.float()
    if s % chunk == 0 and s > chunk:
        h = torch.cat([
            _mlstm_chunk(q32[:, c:c + chunk], fcum[:, c:c + chunk], c, fcum,
                         logi, k32, v32)
            for c in range(0, s, chunk)], dim=1)
    else:
        h = _mlstm_chunk(q32, fcum, 0, fcum, logi, k32, v32)
    h = h.reshape(b, s, d).to(x.dtype)
    return (h * torch.sigmoid(x @ p.ogate)) @ p.wo


class MLSTMState(NamedTuple):
    c: torch.Tensor        # [B, H, dk, dv]
    n: torch.Tensor        # [B, H, dk]
    m: torch.Tensor        # [B, H]     log-space stabiliser


def init_mlstm_state(b: int, d: int, n_heads: int,
                     device: Optional[torch.device] = None) -> MLSTMState:
    dk = d // n_heads
    f32 = torch.float32
    return MLSTMState(
        torch.zeros((b, n_heads, dk, dk), dtype=f32, device=device),
        torch.zeros((b, n_heads, dk), dtype=f32, device=device),
        torch.full((b, n_heads), -1e30, dtype=f32, device=device))


def apply_mlstm_step(p: MLSTMParams, x: torch.Tensor, state: MLSTMState,
                     n_heads: int) -> tuple[torch.Tensor, MLSTMState]:
    """x: [B, 1, d] -> ([B, 1, d], the new state).  O(1) per step."""
    b, _, d = x.shape
    dk = d // n_heads
    xt = x[:, 0]
    q = (xt @ p.wq).reshape(b, n_heads, dk).float() / math.sqrt(dk)
    k = (xt @ p.wk).reshape(b, n_heads, dk).float()
    v = (xt @ p.wv).reshape(b, n_heads, dk).float()
    gates = (xt @ p.w_if).reshape(b, n_heads, 2).float()
    logi = log_sigmoid(gates[..., 0])
    logf = log_sigmoid(gates[..., 1])

    m_new = torch.maximum(state.m + logf, logi)
    fs = torch.exp(state.m + logf - m_new)
    is_ = torch.exp(logi - m_new)
    c = fs[..., None, None] * state.c + is_[..., None, None] * \
        torch.einsum('bhk,bhv->bhkv', k, v)
    n = fs[..., None] * state.n + is_[..., None] * k
    num = torch.einsum('bhk,bhkv->bhv', q, c)
    den = torch.maximum(torch.abs(torch.einsum('bhk,bhk->bh', q, n)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, d).to(x.dtype)
    out = (h * torch.sigmoid(xt @ p.ogate)) @ p.wo
    return out[:, None], MLSTMState(c, n, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMParams(NamedTuple):
    w_x: torch.Tensor      # [d, 4*d]   (i, f, z, o) input projections
    w_h: torch.Tensor      # [d, 4*d]   recurrent projections
    b: torch.Tensor        # [4*d]
    wo: torch.Tensor       # [d, d]


def init_slstm(gen: Optional[torch.Generator], d: int,
               dtype: torch.dtype = torch.float32,
               device: Optional[torch.device] = None) -> SLSTMParams:
    """The reference's distributions: N(0, 1/d) input and output
    projections, N(0, 0.09/d) recurrent ones, a zero bias."""
    dev = device if device is not None else (
        gen.device if gen is not None else None)
    return SLSTMParams(
        w_x=dense_init(gen, d, 4 * d, dtype, device),
        w_h=(0.3 * _normal(gen, (d, 4 * d), device) / math.sqrt(d)
             ).to(dtype),
        b=torch.zeros((4 * d,), dtype=dtype, device=dev),
        wo=dense_init(gen, d, d, dtype, device))


class SLSTMState(NamedTuple):
    h: torch.Tensor        # [B, d]
    c: torch.Tensor        # [B, d]
    n: torch.Tensor        # [B, d]
    m: torch.Tensor        # [B, d]


def init_slstm_state(b: int, d: int,
                     device: Optional[torch.device] = None) -> SLSTMState:
    f32 = torch.float32
    return SLSTMState(torch.zeros((b, d), dtype=f32, device=device),
                      torch.zeros((b, d), dtype=f32, device=device),
                      torch.ones((b, d), dtype=f32, device=device),
                      torch.full((b, d), -1e30, dtype=f32, device=device))


def _slstm_cell(p: SLSTMParams, xw: torch.Tensor, st: SLSTMState
                ) -> tuple[torch.Tensor, SLSTMState]:
    """One step from ``xw`` = x_t @ w_x [B, 4d] in the input's dtype."""
    pre = (xw + st.h.to(xw.dtype) @ p.w_h + p.b).float()
    zi, zf, zz, zo = torch.chunk(pre, 4, dim=-1)
    logi = zi                      # exponential input gate (log space)
    logf = log_sigmoid(zf)         # sigmoid forget gate (log space)
    m_new = torch.maximum(st.m + logf, logi)
    i = torch.exp(logi - m_new)
    f = torch.exp(st.m + logf - m_new)
    z = torch.tanh(zz)
    o = torch.sigmoid(zo)
    c = f * st.c + i * z
    n = torch.clamp_min(f * st.n + i, 1e-6)
    h = o * (c / n)
    return h.to(xw.dtype), SLSTMState(h, c, n, m_new)


def apply_slstm_train(p: SLSTMParams, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d], the cell applied step by step."""
    b, s, d = x.shape
    st = init_slstm_state(b, d, x.device)
    xw = x @ p.w_x                                         # [B, S, 4d]
    hs = []
    for t in range(s):
        h, st = _slstm_cell(p, xw[:, t], st)
        hs.append(h)
    return torch.stack(hs, dim=1) @ p.wo


def apply_slstm_step(p: SLSTMParams, x: torch.Tensor, st: SLSTMState
                     ) -> tuple[torch.Tensor, SLSTMState]:
    h, st2 = _slstm_cell(p, x[:, 0] @ p.w_x, st)
    return (h @ p.wo)[:, None], st2
