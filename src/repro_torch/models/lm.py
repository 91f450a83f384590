"""LM backbone, dense family (twin of ``repro.models.lm``).

  dense -- granite-3-8b, llama3-405b, qwen3-32b, llama3.2-3b

Entry points: ``init_lm``, ``train_loss`` (and ``forward_train`` under
it), ``prefill``, ``init_serve_cache``, ``serve_step``.  Blocks stay
stacked ``[L, ...]`` as the reference's vmap builds them, so weights,
gradients, optimizer moments and caches carry across one to one
(``repro_torch.convert``, ``train/checkpoint.py``); the layer loop is a
Python loop over views of the stacks, where the reference scans, and a
view's gradient lands in its stacked leaf.  ``cfg.remat`` checkpoints
each layer (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of the scan body); ``cfg.remat_group > 1`` nests it
as the reference does: a checkpoint per group of layers around a
checkpoint per layer.  Exact attention is the published architectures'
baseline (``gqa_attend``: plain PyTorch in query chunks, as the
reference's is plain XLA; no model path of the reference calls its
flash kernel); ``cfg.vq_attn`` swaps in VQ-Attention (the paper's
technique) behind the same interface: sub-quadratic training and
prefill, an O(k + W) cache per sequence in decode.

The other families (moe, ssm, hybrid, audio, vlm) raise, naming the LM
families slice.  The reference's ``constrain_tokens`` is the identity on
one device (no sharding policy is set), so the port has no counterpart
for it.

``serve_step`` updates the cache in place (the KV / VQ buffers of every
layer) and returns it with ``pos + 1``: the cache passed in is consumed.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.attention import (KVCache, decode_attend, gqa_attend,
                                      init_attn, qkv)
from repro_torch.nn.ffn import apply_mlp, init_mlp
from repro_torch.nn.layers import dense_init, embed_init, rmsnorm
from repro_torch.nn.vq_attention import (VQAttnConfig, VQKVCache,
                                         vq_attention_decode,
                                         vq_attention_train)
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
# training forward, loss, prefill
# ===========================================================================

def _attn_train(bp: dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = qkv(bp["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                  positions, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)
    if cfg.vq_attn:
        o = vq_attention_train(q, k, v, _vq_cfg(cfg))
    else:
        o = gqa_attend(q, k, v, causal=True)
    return x + o.reshape(b, s, -1) @ bp["attn"].wo


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Embedding rows of ``tokens`` [B, S] -> [B, S, d].

    From vocab 8192 up the reference multiplies a one-hot by the table in
    chunks of 512 tokens, only to keep a vocab-sharded table sharded under
    GSPMD.  A gather gives the same rows bit for bit; gathering from an
    f32 view of the table adds every token's row of the gradient in f32
    and rounds it to the table's dtype once, at the cost of an f32 copy of
    the table, where the one-hot product would spend 2 B x S x V x d
    operations each way.  The reference's chunked product rounds within
    and across its chunks (on XLA's CPU it sums in bf16), so the two bf16
    gradients differ by that rounding (``ROADMAP.md`` queue 3).  Below
    8192 the reference gathers from the table itself, and so does the
    port."""
    tokens = tokens.long()
    if vocab < 8192:
        return embed[tokens]
    return embed.float()[tokens].to(embed.dtype)


def forward_train(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                  aux_embeds: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final hidden states [B, S, d] after ``ln_f``, the
    MoE aux loss: 0 for the dense family).  ``aux_embeds`` is the
    reference's input of the audio / vision families; the dense family
    ignores it."""
    check_family(cfg)
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens, cfg.vocab)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    layers = per_layer(params["blocks"])

    def body(xc, bp):
        return _ffn(bp, _attn_train(bp, xc, cfg, positions), cfg)

    remat = cfg.remat and torch.is_grad_enabled()
    gsz = cfg.remat_group
    if remat and gsz > 1 and cfg.n_layers % gsz == 0:
        # nested remat: a checkpoint per group around a checkpoint per
        # layer, so a group's recompute holds one layer's residuals
        def group_body(xc, group):
            for bp in group:
                xc = checkpoint(body, xc, bp, use_reentrant=False)
            return xc
        for g0 in range(0, cfg.n_layers, gsz):
            x = checkpoint(group_body, x, layers[g0:g0 + gsz],
                           use_reentrant=False)
    else:
        for bp in layers:
            x = checkpoint(body, x, bp, use_reentrant=False) if remat \
                else body(x, bp)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def train_loss(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
               aux_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy, the mean over tokens (+ 0.01 x the MoE
    aux loss).  ``tokens`` [B, S + 1].  The logits are the model-dtype
    product cast to f32, as in the reference; the target logit is a
    gather, bit-equal to the reference's one-hot contraction for finite
    logits, without its [B, S, V] f32 one-hot."""
    hidden, moe_aux = forward_train(params, tokens[:, :-1], cfg, aux_embeds)
    targets = tokens[:, 1:].long()
    logits = (hidden @ params["head"]).float()
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, targets[..., None])[..., 0]
    return torch.mean(lse - target_logit) + 0.01 * moe_aux


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            aux_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill forward: the last position's logits [B, vocab] in the
    model's dtype (the head is applied to that position only)."""
    hidden, _ = forward_train(params, tokens, cfg, aux_embeds)
    return hidden[:, -1] @ params["head"]


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

