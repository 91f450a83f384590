"""VQ-Attention: the paper's approximated message passing on the token
graph (twin of ``repro.nn.vq_attention``).

A causal attention layer is a dense graph convolution over tokens; VQ-GNN's
Eq. 6 replaces the messages from far-away context with messages from k
codewords.  At decode time each (batch, kv-head) keeps
  * a codebook: running sums of the (key, value) pairs of every token that
    has left the exact window, and their cluster masses -- a cluster of
    mass m scores ``q.k~ + log m`` (App. E row-normalization, exact);
  * a ring window of the last W tokens, attended exactly;
so a step costs O(k + W) whatever the context length.  The softmax over
both runs in one kernel (``kernels/ops.py:vq_attention_decode``, the CUDA
``vq_attention`` kernel on the card).

Reference behaviours kept as they are (``ROADMAP.md`` queue 3): the
assignment of an evicted key sees every codeword as live (the counts are
clamped to 1e-9 first), so an empty codeword's centroid 0 scores exactly
0 and ties at 0 go to the lowest index; only while every count of the
whole batch is 0 does an eviction seed slot ``pos % k``; the window mask
is ``arange(W) <= pos`` before the increment; the evicted token is read
from ring slot ``pos % W`` before the new token overwrites it; the
centroids reach the kernel in the queries' dtype, the masses in f32.

The decode step updates the cache's sums, counts and window in place and
returns them with ``pos + 1`` (the reference returns fresh arrays): the
caller's cache is consumed.

Training and prefill (``vq_attention_train``) walk the sequence in blocks
of W tokens.  Each block's queries softmax over the codewords (masked
where a count is 0), the previous block (exact) and the block itself
(causal); then the previous block, now leaving the window, is folded
into the codebook -- so the codewords are first read at block 2.  The
codebook is a streaming k-means on keys: while every count of a (batch,
kv-head) is 0 the fold seeds slots ``(argmin(count) + arange(W)) % k``,
after that each key goes to its nearest live centroid (dead codewords
masked with ``0.5 * finfo(f32).max``).  The assignment is stop-gradient
and the sums stay inside autograd (straight-through), so gradients reach
past tokens' keys and values through the centroids: an exact VJP of the
approximation, in place of the GNN's Eq. 7 injection.  Kept from the
reference: once a head's first fold has seeded ``min(W, k)`` slots, no
dead codeword is ever chosen again, so with k > W only W codewords of a
head ever come alive (``ROADMAP.md`` queue 3).  The training path is
plain PyTorch, as it is plain JAX in the reference: it launches no
hand-written kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.act_constraints import by_heads, is_dtensor
from repro_torch.kernels import ops as kops


class VQAttnConfig(NamedTuple):
    k: int = 1024          # codewords per (batch, kv-head)
    window: int = 512      # exact-attention window width


class VQKVCache(NamedTuple):
    """Decode-time state: codebook summaries + exact ring window.

    Shapes (per layer):
      sum_k/sum_v: [B, Hkv, k, dh]   running cluster sums (f32)
      count:       [B, Hkv, k]       cluster masses (f32)
      win_k/win_v: [B, W, Hkv, dh]   ring buffer of the last W tokens
      pos:         []                absolute position (int32)
    """
    sum_k: torch.Tensor
    sum_v: torch.Tensor
    count: torch.Tensor
    win_k: torch.Tensor
    win_v: torch.Tensor
    pos: torch.Tensor


def init_vq_cache(b: int, n_kv: int, head_dim: int, cfg: VQAttnConfig,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[torch.device] = None) -> VQKVCache:
    f32 = torch.float32
    return VQKVCache(
        sum_k=torch.zeros((b, n_kv, cfg.k, head_dim), dtype=f32,
                          device=device),
        sum_v=torch.zeros((b, n_kv, cfg.k, head_dim), dtype=f32,
                          device=device),
        count=torch.zeros((b, n_kv, cfg.k), dtype=f32, device=device),
        win_k=torch.zeros((b, cfg.window, n_kv, head_dim), dtype=dtype,
                          device=device),
        win_v=torch.zeros((b, cfg.window, n_kv, head_dim), dtype=dtype,
                          device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def _centroids(sum_k, sum_v, count):
    denom = torch.clamp_min(count, 1e-6)[..., None]
    return sum_k / denom, sum_v / denom


def _assign(keys: torch.Tensor, cent_k: torch.Tensor, count: torch.Tensor
            ) -> torch.Tensor:
    """Nearest centroid (masked to live clusters).  keys: [..., m, dh],
    cent_k: [..., k, dh], count: [..., k] -> [..., m] int32 (the lowest
    index on ties)."""
    c32 = cent_k.float()
    d = -2.0 * torch.einsum('...md,...kd->...mk', keys.float(), c32) \
        + torch.sum(c32 ** 2, -1)[..., None, :]
    d = torch.where(count[..., None, :] > 0, d,
                    0.5 * torch.finfo(torch.float32).max)
    return torch.argmin(d, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# training and prefill: a block loop with a streaming codebook
# ---------------------------------------------------------------------------

def vq_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cfg: VQAttnConfig) -> torch.Tensor:
    """Causal VQ-Attention over a full training sequence (module
    docstring).  q: [B, S, Hq, dh], k/v: [B, S, Hkv, dh] -> [B, S, Hq, dh]
    in ``q``'s dtype; S must be a multiple of min(cfg.window, S).  The
    scores and the codebook are f32; the previous block is carried in the
    keys' dtype.  DTensor q / k / v run each rank's (batch, kv head)
    blocks locally (``act_constraints.by_heads``: a codebook is a (batch,
    kv head)'s own)."""
    if is_dtensor(q):
        return by_heads(vq_attention_train, q, k, v, cfg)
    return train_blocks(q, k, v, cfg)[0]


def train_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cfg: VQAttnConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """``vq_attention_train``'s output and the cluster masses [B, Hkv, k]
    its codebook ends with (the reference returns the output only)."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    w = min(cfg.window, s)
    if s % w != 0:
        raise ValueError(f"sequence {s} is not a multiple of the window {w}")
    kcb, dev, f32 = cfg.k, q.device, torch.float32
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=f32, device=dev))
    qh = q.reshape(b, s, hkv, g, dh).permute(0, 2, 3, 1, 4)  # [B,Hkv,g,S,dh]
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)            # [B,Hkv,S,dh]
    causal = torch.ones((w, w), dtype=torch.bool, device=dev).tril()
    neg_inf = float("-inf")

    sum_k = torch.zeros((b, hkv, kcb, dh), dtype=f32, device=dev)
    sum_v = torch.zeros((b, hkv, kcb, dh), dtype=f32, device=dev)
    count = torch.zeros((b, hkv, kcb), dtype=f32, device=dev)
    prev_k = torch.zeros((b, hkv, w, dh), dtype=q.dtype, device=dev)
    prev_v = torch.zeros((b, hkv, w, dh), dtype=q.dtype, device=dev)
    outs = []
    for i in range(s // w):
        blk = slice(i * w, (i + 1) * w)
        qi, ki, vi = qh[:, :, :, blk], kh[:, :, blk], vh[:, :, blk]
        cent_k, cent_v = _centroids(sum_k, sum_v, count)
        q32 = qi.float() * scale
        # codeword context (C~_out X~): a cluster of mass m scores q.k~ +
        # log m
        live = (count > 0)[:, :, None, None, :]
        s_cb = torch.einsum('bhgqd,bhkd->bhgqk', q32, cent_k) \
            + torch.log(torch.clamp_min(count, 1e-9))[:, :, None, None, :]
        s_cb = s_cb.masked_fill(~live, neg_inf)
        # the previous block, exact (none before block 1)
        s_pr = torch.einsum('bhgqd,bhkd->bhgqk', q32, prev_k.float())
        if i == 0:
            s_pr = torch.full_like(s_pr, neg_inf)
        # the block itself, causal (C_in)
        s_in = torch.einsum('bhgqd,bhkd->bhgqk', q32, ki.float())
        s_in = s_in.masked_fill(~causal, neg_inf)
        att = torch.softmax(torch.cat([s_cb, s_pr, s_in], dim=-1), dim=-1)
        outs.append(
            torch.einsum('bhgqk,bhkd->bhgqd', att[..., :kcb], cent_v)
            + torch.einsum('bhgqk,bhkd->bhgqd', att[..., kcb:kcb + w],
                           prev_v.float())
            + torch.einsum('bhgqk,bhkd->bhgqd', att[..., kcb + w:],
                           vi.float()))

        # fold the block leaving the exact window into the clusters: the
        # assignment is stop-gradient, the sums stay in autograd
        # (straight-through).  Before block 1 there is nothing to fold.
        if i > 0:
            pk = prev_k.float()
            with torch.no_grad():
                seed_slot = (torch.argmin(count, dim=-1)[..., None]
                             + torch.arange(w, device=dev)) % kcb
                any_live = count.amax(-1, keepdim=True) > 0
                assign = torch.where(
                    any_live, _assign(pk, _centroids(sum_k, sum_v, count)[0],
                                      count).long(), seed_slot)
                onehot = F.one_hot(assign, kcb).to(f32)      # [B,Hkv,W,k]
            sum_k = sum_k + torch.einsum('bhwk,bhwd->bhkd', onehot, pk)
            sum_v = sum_v + torch.einsum('bhwk,bhwd->bhkd', onehot,
                                         prev_v.float())
            count = count + onehot.sum(2)
        prev_k, prev_v = ki, vi
    o = torch.stack(outs, dim=3).reshape(b, hq, s, dh)      # [B,Hq,S,dh]
    return o.transpose(1, 2).to(q.dtype), count.detach()


# ---------------------------------------------------------------------------
# decode: O(k + W) per step through the vq_attention kernel
# ---------------------------------------------------------------------------

def _decode_gathered(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cache: VQKVCache,
                     cfg: VQAttnConfig) -> tuple[torch.Tensor, VQKVCache]:
    """:func:`vq_attention_decode` on DTensors: the step's inputs and the
    cache gathered whole on every rank, the step run on them, each new
    cache field cut back to its own layout (each rank keeps its part; the
    output whole).  The eviction's argmin over a sharded codebook and the
    global seeding test (``count.max()`` over the whole batch) have no
    per-rank form."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = cache.sum_k.device_mesh

    def whole(t):
        return t.full_tensor() if is_dtensor(t) else t

    def back(w, like):
        pl = like.placements if is_dtensor(like) else \
            [Replicate()] * mesh.ndim
        return distribute_tensor(w, mesh, pl, src_data_rank=None)
    out, new = vq_attention_decode(whole(q), whole(k_new), whole(v_new),
                                   VQKVCache(*(whole(t) for t in cache)),
                                   cfg)
    return back(out, None), VQKVCache(*(back(w, like)
                                        for w, like in zip(new, cache)))


def vq_attention_decode(q: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor, cache: VQKVCache,
                        cfg: VQAttnConfig
                        ) -> tuple[torch.Tensor, VQKVCache]:
    """One decode step.  q: [B, 1, Hq, dh], k/v_new: [B, 1, Hkv, dh] ->
    ([B, 1, Hq, dh], the cache updated in place with ``pos + 1``)."""
    if is_dtensor(cache.sum_k):
        return _decode_gathered(q, k_new, v_new, cache, cfg)
    b, _, hq, dh = q.shape
    hkv = k_new.shape[2]
    g = hq // hkv
    w = cache.win_k.shape[1]
    pos = cache.pos
    dev = q.device

    # fold the token that falls out of the window into the codebook
    slot = (pos % w).reshape(1).long()
    okh = cache.win_k.index_select(1, slot).transpose(1, 2).float()
    ovh = cache.win_v.index_select(1, slot).transpose(1, 2).float()
    evict = (pos >= w).float()
    cent_k, _ = _centroids(cache.sum_k, cache.sum_v, cache.count)
    assign = _assign(okh, cent_k, torch.clamp_min(cache.count, 1e-9))
    # seed an empty codebook: the first eviction claims slot pos % k
    seeded = torch.where(cache.count.max() > 0, assign,
                         (pos % cfg.k).to(torch.int32))      # [B, Hkv, 1]
    rows = seeded.long()
    # each (batch, kv head) adds the evicted pair to one codeword: the
    # reference's sum + evict * onehot * okh, with the same single rounding
    cache.sum_k.scatter_add_(2, rows[..., None].expand(b, hkv, 1, dh),
                             evict * okh)
    cache.sum_v.scatter_add_(2, rows[..., None].expand(b, hkv, 1, dh),
                             evict * ovh)
    cache.count.scatter_add_(2, rows, evict.expand(b, hkv, 1))

    # write the new token into the ring window
    cache.win_k.index_copy_(1, slot, k_new.to(cache.win_k.dtype))
    cache.win_v.index_copy_(1, slot, v_new.to(cache.win_v.dtype))
    # a ring slot is valid iff it has ever been written
    win_mask = (torch.arange(w, device=dev) <= pos).float()

    cent_k, cent_v = _centroids(cache.sum_k, cache.sum_v, cache.count)
    n = b * hkv
    out = kops.vq_attention_decode(
        q[:, 0].reshape(n, g, dh),                # group-major queries
        cent_k.reshape(n, cfg.k, dh).to(q.dtype),
        cent_v.reshape(n, cfg.k, dh).to(q.dtype),
        cache.count.reshape(n, cfg.k),
        cache.win_k.transpose(1, 2).reshape(n, w, dh),
        cache.win_v.transpose(1, 2).reshape(n, w, dh),
        win_mask[None].expand(n, w).contiguous())
    out = out.reshape(b, 1, hq, dh).to(q.dtype)
    return out, cache._replace(pos=pos + 1)
