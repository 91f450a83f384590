"""VQ-Attention decode: the paper's approximated message passing on the
token graph (twin of the decode half of ``repro.nn.vq_attention``).

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
caller's cache is consumed.  ``vq_attention_train`` (training and prefill)
comes with the LM training slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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


def vq_attention_decode(q: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor, cache: VQKVCache,
                        cfg: VQAttnConfig
                        ) -> tuple[torch.Tensor, VQKVCache]:
    """One decode step.  q: [B, 1, Hq, dh], k/v_new: [B, 1, Hkv, dh] ->
    ([B, 1, Hq, dh], the cache updated in place with ``pos + 1``)."""
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
