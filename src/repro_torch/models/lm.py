"""LM backbone: the dense family's decode path (twin of the serving half
of ``repro.models.lm``).

  dense -- granite-3-8b, llama3-405b, qwen3-32b, llama3.2-3b

Entry points: ``init_lm``, ``init_serve_cache``, ``serve_step``.  Blocks
stay stacked ``[L, ...]`` as the reference's vmap builds them, so weights
and caches carry across one to one (``repro_torch.convert``); the layer
loop is a Python loop over views of the stacks, where the reference scans.
Exact attention is the published architectures' baseline; ``cfg.vq_attn``
swaps in VQ-Attention (the paper's technique) behind the same interface:
an O(k + W) cache per sequence instead of O(context).

The other families (moe, ssm, hybrid, audio, vlm) raise, naming the LM
families slice; training and prefill (``forward_train``, ``train_loss``,
``prefill``) come with the LM training slice.  The reference's
``constrain_tokens`` is the identity on one device (no sharding policy is
set), so ``_ffn`` has no counterpart for it.

``serve_step`` updates the cache in place (the KV / VQ buffers of every
layer) and returns it with ``pos + 1``: the cache passed in is consumed.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.attention import KVCache, decode_attend, init_attn, qkv
from repro_torch.nn.ffn import apply_mlp, init_mlp
from repro_torch.nn.layers import dense_init, embed_init, rmsnorm
from repro_torch.nn.vq_attention import (VQAttnConfig, VQKVCache,
                                         vq_attention_decode)
from repro_torch.runtime import LM_FAMILIES_SLICE, resolve_device

Params = dict


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _vq_cfg(cfg: ArchConfig) -> VQAttnConfig:
    return VQAttnConfig(k=cfg.vq_k, window=cfg.vq_window)


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family this slice does not carry."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family comes with "
            f"{LM_FAMILIES_SLICE}; the port serves the dense family")


# ===========================================================================
# stacked [L, ...] trees
# ===========================================================================

def _stack(trees: list) -> Any:
    """Per-layer trees (dicts and NamedTuples of tensors) -> one tree of
    stacked [L, ...] tensors."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return type(first)(*(_stack(list(col)) for col in zip(*trees)))


def per_layer(tree: Any) -> list:
    """A stacked [L, ...] tree (dicts and NamedTuples of tensors) -> the L
    per-layer trees, as views: writing into one writes into the stack."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    if isinstance(tree, dict):
        cols = {k: per_layer(v) for k, v in tree.items()}
        n = len(next(iter(cols.values())))
        return [{k: c[l] for k, c in cols.items()} for l in range(n)]
    cols = [per_layer(v) for v in tree]
    return [type(tree)(*(c[l] for c in cols)) for l in range(len(cols[0]))]


# ===========================================================================
# init
# ===========================================================================

def _init_dense_block(gen: torch.Generator, cfg: ArchConfig,
                      device: torch.device) -> dict:
    dt = _dtype(cfg)
    return {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=device),
            "ln2": torch.ones((cfg.d_model,), dtype=dt, device=device),
            "attn": init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, dt, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)}


def init_lm(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
            *, device: str | torch.device = "cuda") -> Params:
    """Random weights of the reference's distributions: ``embed`` [V, d],
    ``ln_f`` [d], ``head`` [d, V] and ``blocks`` stacked [L, ...].

    Drawn with ``generator`` on its own device and moved to ``device``:
    a CUDA generator draws on the card (seconds for a full-width model), a
    CPU one gives the same weights on every device.  Without a generator
    one seeded 0 on ``device`` is used."""
    dev = resolve_device(device)
    check_family(cfg)
    gen = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(0)
    dt = _dtype(cfg)
    params: Params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dt, dev),
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "head": dense_init(gen, cfg.d_model, cfg.vocab, dt, dev),
    }
    params["blocks"] = _stack([_init_dense_block(gen, cfg, dev)
                               for _ in range(cfg.n_layers)])
    return params


def init_serve_cache(cfg: ArchConfig, batch: int, seq_len: int, *,
                     device: str | torch.device = "cuda"
                     ) -> dict[str, KVCache | VQKVCache]:
    """Decode state, stacked over layers: ``{"kv": KVCache}`` with
    [L, B, seq_len, Hkv, dh] keys and values (exact attention) or
    ``{"kv": VQKVCache}`` with [L, B, Hkv, k, dh] sums, [L, B, Hkv, k]
    counts and an [L, B, W, Hkv, dh] window (VQ-Attention: O(k + W) state,
    whatever ``seq_len``); ``pos`` is [L] int32."""
    dev = resolve_device(device)
    check_family(cfg)
    dt, n, f32 = _dtype(cfg), cfg.n_layers, torch.float32
    hkv, hd = cfg.n_kv_heads, cfg.hd
    pos = torch.zeros((n,), dtype=torch.int32, device=dev)
    if cfg.vq_attn:
        vq = _vq_cfg(cfg)
        return {"kv": VQKVCache(
            sum_k=torch.zeros((n, batch, hkv, vq.k, hd), dtype=f32,
                              device=dev),
            sum_v=torch.zeros((n, batch, hkv, vq.k, hd), dtype=f32,
                              device=dev),
            count=torch.zeros((n, batch, hkv, vq.k), dtype=f32, device=dev),
            win_k=torch.zeros((n, batch, vq.window, hkv, hd), dtype=dt,
                              device=dev),
            win_v=torch.zeros((n, batch, vq.window, hkv, hd), dtype=dt,
                              device=dev),
            pos=pos)}
    return {"kv": KVCache(
        torch.zeros((n, batch, seq_len, hkv, hd), dtype=dt, device=dev),
        torch.zeros((n, batch, seq_len, hkv, hd), dtype=dt, device=dev),
        pos)}


# ===========================================================================
# decode
# ===========================================================================

def _attn_decode(bp: dict, x: torch.Tensor, cache, cfg: ArchConfig):
    b = x.shape[0]
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    positions = cache.pos.expand(b, 1)
    q, k, v = qkv(bp["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                  positions, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)
    if cfg.vq_attn:
        o, cache = vq_attention_decode(q, k, v, cache, _vq_cfg(cfg))
    else:
        o, cache = decode_attend(q, cache, k, v)
    return x + o.reshape(b, 1, -1) @ bp["attn"].wo, cache


def _ffn(bp: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
    return x + apply_mlp(bp["mlp"], h)


def serve_step(params: Params, token: torch.Tensor, cache: dict,
               cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: [B, 1] integer -> (logits [B, vocab] in the
    model's dtype, the cache updated in place with ``pos + 1``)."""
    check_family(cfg)
    x = params["embed"][token]                           # [B, 1, d]
    kv = cache["kv"]
    for bp, c in zip(per_layer(params["blocks"]), per_layer(kv)):
        x, _ = _attn_decode(bp, x, c, cfg)
        x = _ffn(bp, x, cfg)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x[:, 0] @ params["head"], {"kv": kv._replace(pos=kv.pos + 1)}

