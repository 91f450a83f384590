"""GQA attention for the LM backbones: training, prefill and cached decode
(twin of ``repro.nn.attention``).

Layout conventions (the reference's: batch/seq leading, heads x head_dim
last):
  activations  [B, S, d_model]
  q            [B, S, Hq, dh]
  k, v         [B, S, Hkv, dh]      (GQA: Hq = G * Hkv, head h = kv * G + j)
  KV cache     [B, S_max, Hkv, dh]  (indexed by absolute position)

``decode_attend`` writes the new token into the cache's ``k`` / ``v`` in
place and returns them with ``pos + 1`` (the reference returns fresh
arrays): at llama3.2-3b's width and ``--context 1024`` a functional update
would copy 16.8 MB a layer every step.  Callers treat the cache they pass
in as consumed.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.act_constraints import (by_heads, is_dtensor,
                                                     split_ready)
from repro_torch.nn.layers import dense_init, rmsnorm, rope


class AttnParams(NamedTuple):
    wq: torch.Tensor       # [d, Hq*dh]
    wk: torch.Tensor       # [d, Hkv*dh]
    wv: torch.Tensor       # [d, Hkv*dh]
    wo: torch.Tensor       # [Hq*dh, d]
    q_norm: torch.Tensor   # [dh] (qk_norm archs; ones otherwise)
    k_norm: torch.Tensor   # [dh]


def init_attn(gen: Optional[torch.Generator], d: int, n_heads: int,
              n_kv: int, head_dim: int, dtype: torch.dtype = torch.float32,
              device: Optional[torch.device] = None) -> AttnParams:
    dev = device if device is not None else (
        gen.device if gen is not None else None)
    return AttnParams(
        wq=dense_init(gen, d, n_heads * head_dim, dtype, device),
        wk=dense_init(gen, d, n_kv * head_dim, dtype, device),
        wv=dense_init(gen, d, n_kv * head_dim, dtype, device),
        wo=dense_init(gen, n_heads * head_dim, d, dtype, device),
        q_norm=torch.ones((head_dim,), dtype=dtype, device=dev),
        k_norm=torch.ones((head_dim,), dtype=dtype, device=dev))


def qkv(p: AttnParams, x: torch.Tensor, n_heads: int, n_kv: int,
        head_dim: int, positions: torch.Tensor, *, qk_norm: bool = False,
        rope_theta: float = 500000.0, use_rope: bool = True):
    b, s, _ = x.shape
    q = split_ready(x @ p.wq, -1, n_heads).reshape(b, s, n_heads, head_dim)
    k = split_ready(x @ p.wk, -1, n_kv).reshape(b, s, n_kv, head_dim)
    v = split_ready(x @ p.wv, -1, n_kv).reshape(b, s, n_kv, head_dim)
    if qk_norm:
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    if use_rope:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


_Q_CHUNK = 1024


def _gqa_attend_block(q, k, v, causal, kv_mask, q_offset):
    """One query block of GQA attention.  q: [B, sq, Hq, dh]."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    s = torch.einsum('bqhgd,bkhd->bhgqk', qg.float(), k.float()) \
        / math.sqrt(dh)
    if causal:
        qi = q_offset + torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(~(ki <= qi)[None, None, None], float("-inf"))
    if kv_mask is not None:
        s = s.masked_fill(~(kv_mask[:, None, None, None, :] > 0),
                          float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum('bhgqk,bkhd->bqhgd', p, v.float())
    return o.reshape(b, sq, hq, dh).to(q.dtype)


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True,
               kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-query attention.

    q: [B, Sq, Hq, dh], k/v: [B, Skv, Hkv, dh] -> [B, Sq, Hq, dh].
    kv_mask: [B, Skv] validity (decode with a ragged cache).

    Sequences longer than ``_Q_CHUNK`` (and a multiple of it) go in query
    chunks of ``_Q_CHUNK`` rows, so the score block never exceeds
    [_Q_CHUNK, skv], as in the reference.  Under autograd each chunk is
    checkpointed, as the reference's ``jax.checkpoint`` does: its
    [_Q_CHUNK, skv] scores are recomputed in the backward pass, not
    stored (8 GiB a layer of f32 scores otherwise at [4, 24, 2048, 2048]).
    """
    if is_dtensor(q):
        return by_heads(lambda *a: gqa_attend(*a[:3], causal=causal,
                                              kv_mask=a[3]), q, k, v, kv_mask)
    b, sq, hq, dh = q.shape
    skv = k.shape[1]
    if sq <= _Q_CHUNK or sq % _Q_CHUNK != 0:
        qoff = (skv - sq) if causal else 0
        return _gqa_attend_block(q, k, v, causal, kv_mask, qoff)
    remat = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v))

    def block(c):
        args = (q[:, c:c + _Q_CHUNK], k, v, causal, kv_mask, (skv - sq) + c)
        if remat:
            return checkpoint(_gqa_attend_block, *args, use_reentrant=False)
        return _gqa_attend_block(*args)
    return torch.cat([block(c) for c in range(0, sq, _Q_CHUNK)], dim=1)


class KVCache(NamedTuple):
    k: torch.Tensor      # [B, S_max, Hkv, dh]
    v: torch.Tensor      # [B, S_max, Hkv, dh]
    pos: torch.Tensor    # [] int32 -- number of tokens already cached


def init_kv_cache(b: int, s_max: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[torch.device] = None) -> KVCache:
    return KVCache(
        torch.zeros((b, s_max, n_kv, head_dim), dtype=dtype, device=device),
        torch.zeros((b, s_max, n_kv, head_dim), dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def decode_attend(q: torch.Tensor, cache: KVCache, k_new: torch.Tensor,
                  v_new: torch.Tensor) -> tuple[torch.Tensor, KVCache]:
    """One-token cached decode.  q/k_new/v_new: [B, 1, H*, dh].

    The token lands in slot ``pos``, clamped to ``S_max - 1`` as the
    reference's ``dynamic_update_slice`` clamps its start (a full cache
    overwrites its last slot); the mask keeps the unclamped ``pos``.  The
    write is in place (module docstring)."""
    s_max = cache.k.shape[1]
    slot = cache.pos.clamp(0, s_max - 1).reshape(1).long()
    if is_dtensor(cache.k):
        # DTensor cannot lay out an in-place indexed write: new arrays,
        # as the reference makes them
        k = cache.k.index_copy(1, slot, k_new.to(cache.k.dtype))
        v = cache.v.index_copy(1, slot, v_new.to(cache.v.dtype))
    else:
        k, v = cache.k, cache.v
        k.index_copy_(1, slot, k_new.to(k.dtype))
        v.index_copy_(1, slot, v_new.to(v.dtype))
    valid = (torch.arange(s_max, device=q.device) <= cache.pos).float()
    mask = valid[None, :].expand(k.shape[0], s_max)
    out = gqa_attend(q, k, v, causal=False, kv_mask=mask)
    return out, KVCache(k, v, cache.pos + 1)
