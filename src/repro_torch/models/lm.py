"""LM backbone (twin of ``repro.models.lm``), all six of its families:

  dense   -- granite-3-8b, llama3-405b, qwen3-32b, llama3.2-3b
  moe     -- qwen3-moe-30b-a3b, phi3.5-moe-42b (top-k routed experts)
  ssm     -- xlstm-350m (mLSTM / sLSTM pairs, attention-free)
  hybrid  -- zamba2-2.7b (a Mamba2 stack + one shared attention block)
  audio   -- whisper-tiny (encoder-decoder over stub frame embeddings)
  vlm     -- llama-3.2-vision-11b (gated cross-attention image layers
             every ``cross_attn_period`` text layers; stub patches)

Entry points: ``init_lm``, ``train_loss`` (and ``forward_train`` under
it), ``prefill``, ``init_serve_cache``, ``serve_step``.  Stacks stay
stacked as the reference's vmap builds them -- ``blocks`` [L, ...],
``pairs`` [L / 2, ...], zamba2's ``mamba`` two deep [groups, period, ...],
the vlm's ``cross_blocks`` [L / period, ...], whisper's ``enc_blocks``
[enc_layers, ...] -- so weights, gradients, optimizer moments and caches
carry across one to one (``repro_torch.convert``,
``train/checkpoint.py``); the layer loop is a Python loop over views of
the stacks, where the reference scans, and a view's gradient lands in its
stacked leaf.  ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the
scan body): a block, an xLSTM pair, a zamba2 group, a vlm group (its
text blocks and its cross block), an encoder or decoder layer of
whisper; ``cfg.remat_group > 1`` nests it for the dense and moe families
as the reference does: a checkpoint per group of layers around a
checkpoint per layer.  Exact attention is the published architectures'
baseline (``gqa_attend``: plain PyTorch in query chunks, as the
reference's is plain XLA; no model path of the reference calls its flash
kernel); ``cfg.vq_attn`` swaps in VQ-Attention (the paper's technique)
behind the same interface -- in zamba2's shared block and in the
decoder self-attention of the audio and vlm families too; the xLSTM
family has no attention, so it ignores the flag, as the reference does.

The cross-attention families read ``aux_embeds`` in training and
prefill: [B, enc_seq, d] frame embeddings (audio) or [B, n_patches, d]
patch embeddings (vlm), in the model dtype; without them
``forward_train`` raises.  A cross block's query is ``h @ wq`` (no RoPE,
no qk-norm), its keys and values the context times ``wk`` / ``wv`` (no
norm), attended without a mask; the vlm gates the attention output by
``tanh(gate)`` (0 at init), its FFN ungated.  Decoding reads the context
from the cache's ``cross_k`` / ``cross_v``, zeros in a fresh cache, as in
the reference.

The MoE aux loss is summed over the layers (``forward_train``'s second
result) and ``train_loss`` adds 0.01 of it.  The reference's
``constrain_tokens`` is the identity on one device (no sharding policy is
set), so the port has no counterpart for it.

``serve_step`` updates the cache in place (the KV / VQ buffers and the
recurrent states of every layer) and returns it, the attention caches
with ``pos + 1``: the cache passed in is consumed.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.act_constraints import (constrain_tokens,
                                                     gather_params,
                                                     is_dtensor, keep_layout,
                                                     split_ready)
from repro_torch.nn.attention import (KVCache, decode_attend, gqa_attend,
                                      init_attn, qkv)
from repro_torch.nn.ffn import apply_mlp, apply_moe, init_mlp, init_moe
from repro_torch.nn.layers import dense_init, embed_init, rmsnorm
from repro_torch.nn.ssm import (apply_mamba2_step, apply_mamba2_train,
                                init_mamba2, init_mamba2_state)
from repro_torch.nn.vq_attention import (VQAttnConfig, VQKVCache,
                                         vq_attention_decode,
                                         vq_attention_train)
from repro_torch.nn.xlstm import (apply_mlstm_step, apply_mlstm_train,
                                  apply_slstm_step, apply_slstm_train,
                                  init_mlstm, init_mlstm_state, init_slstm,
                                  init_slstm_state)
from repro_torch.runtime import resolve_device
from repro_torch.train.optimizer import tree_map

Params = dict
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
CROSS_FAMILIES = ("audio", "vlm")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _vq_cfg(cfg: ArchConfig) -> VQAttnConfig:
    return VQAttnConfig(k=cfg.vq_k, window=cfg.vq_window)


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family that neither package knows."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown LM family {cfg.family!r}; "
                         f"want one of {', '.join(FAMILIES)}")


# ===========================================================================
# stacked [L, ...] trees
# ===========================================================================

def _stacked(make: Callable[[], Any], lead: tuple[int, ...]) -> Any:
    """``make()`` called prod(``lead``) times in order, its trees stacked
    into one tree of [*lead, ...] tensors, each written into the stack as
    it is made: the stack plus one layer at a time, never two copies of
    the model."""
    n = math.prod(lead)
    first = make()
    out = tree_map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype,
                                         device=t.device), first)
    for l in range(n):
        layer = first if l == 0 else make()
        tree_map(lambda dst, src: dst[l].copy_(src), out, layer)
        del layer
        first = None
    return tree_map(lambda t: t.reshape(*lead, *t.shape[1:]), out)


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


def _write(dst: Any, src: Any) -> None:
    """Copy a new per-layer state into its views of the stacked cache."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


# ===========================================================================
# init
# ===========================================================================

def _ones(cfg: ArchConfig, device: torch.device) -> torch.Tensor:
    return torch.ones((cfg.d_model,), dtype=_dtype(cfg), device=device)


def _init_dense_block(gen: torch.Generator, cfg: ArchConfig,
                      device: torch.device) -> dict:
    dt = _dtype(cfg)
    return {"ln1": _ones(cfg, device), "ln2": _ones(cfg, device),
            "attn": init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, dt, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)}


def _init_moe_block(gen: torch.Generator, cfg: ArchConfig,
                    device: torch.device) -> dict:
    dt = _dtype(cfg)
    return {"ln1": _ones(cfg, device), "ln2": _ones(cfg, device),
            "attn": init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, dt, device),
            "moe": init_moe(gen, cfg.d_model, cfg.n_experts, cfg.d_ff, dt,
                            device)}


def _init_pair(gen: torch.Generator, cfg: ArchConfig,
               device: torch.device) -> dict:
    dt = _dtype(cfg)
    return {"ln1": _ones(cfg, device), "ln2": _ones(cfg, device),
            "mlstm": init_mlstm(gen, cfg.d_model, cfg.n_heads, dt, device),
            "slstm": init_slstm(gen, cfg.d_model, dt, device)}


def _init_mamba_block(gen: torch.Generator, cfg: ArchConfig,
                      device: torch.device) -> dict:
    return {"ln": _ones(cfg, device),
            "mamba": init_mamba2(gen, cfg.d_model, cfg.ssm_state,
                                 _dtype(cfg), device)}


def _init_cross_block(gen: torch.Generator, cfg: ArchConfig,
                      device: torch.device) -> dict:
    """The vlm's image layer: a dense block whose attention is cross
    attention, and a 0-d ``gate``, 0 at init (tanh(0) = 0: the layer's
    attention adds nothing until the gate moves)."""
    blk = _init_dense_block(gen, cfg, device)
    blk["gate"] = torch.zeros((), dtype=_dtype(cfg), device=device)
    return blk


def _init_dec_block(gen: torch.Generator, cfg: ArchConfig,
                    device: torch.device) -> dict:
    """whisper's decoder layer: a dense block plus ``ln_x`` and the
    ``cross`` attention to the encoder."""
    blk = _init_dense_block(gen, cfg, device)
    blk["ln_x"] = _ones(cfg, device)
    blk["cross"] = init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, _dtype(cfg), device)
    return blk


def init_lm(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
            *, device: str | torch.device = "cuda") -> Params:
    """Random weights of the reference's distributions: ``embed`` [V, d],
    ``ln_f`` [d], ``head`` [d, V] and the family's stacks: ``blocks`` [L,
    ...] (dense, moe), ``pairs`` [L / 2, ...] (ssm), ``mamba``
    [L / attn_period, attn_period, ...] and one ``shared`` dense block
    (hybrid), dense ``blocks`` [L, ...] and ``cross_blocks`` [L /
    cross_attn_period, ...] (vlm), or ``enc_blocks`` [enc_layers, ...],
    decoder ``blocks`` [L, ...] and ``enc_ln_f`` (audio).  The MoE router
    and the Mamba2 scalars are f32 in every model dtype, as in the
    reference.

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
        "ln_f": _ones(cfg, dev),
        "head": dense_init(gen, cfg.d_model, cfg.vocab, dt, dev),
    }
    if cfg.family in ("dense", "moe", "vlm"):
        block = _init_moe_block if cfg.family == "moe" \
            else _init_dense_block
        params["blocks"] = _stacked(lambda: block(gen, cfg, dev),
                                    (cfg.n_layers,))
        if cfg.family == "vlm":
            params["cross_blocks"] = _stacked(
                lambda: _init_cross_block(gen, cfg, dev),
                (cfg.n_layers // cfg.cross_attn_period,))
    elif cfg.family == "audio":
        params["enc_blocks"] = _stacked(
            lambda: _init_dense_block(gen, cfg, dev), (cfg.enc_layers,))
        params["blocks"] = _stacked(lambda: _init_dec_block(gen, cfg, dev),
                                    (cfg.n_layers,))
        params["enc_ln_f"] = _ones(cfg, dev)
    elif cfg.family == "ssm":
        params["pairs"] = _stacked(lambda: _init_pair(gen, cfg, dev),
                                   (cfg.n_layers // 2,))
    else:                                                # hybrid
        groups = cfg.n_layers // cfg.attn_period
        params["mamba"] = _stacked(lambda: _init_mamba_block(gen, cfg, dev),
                                   (groups, cfg.attn_period))
        params["shared"] = _init_dense_block(gen, cfg, dev)
    return params


def _attn_cache(cfg: ArchConfig, n: int, batch: int, seq_len: int,
                dev: torch.device) -> KVCache | VQKVCache:
    """``n`` stacked attention caches: exact [n, B, seq_len, Hkv, dh] keys
    and values, or VQ-Attention's [n, B, Hkv, k, dh] sums, [n, B, Hkv, k]
    counts and [n, B, W, Hkv, dh] window; ``pos`` [n] int32."""
    dt, f32 = _dtype(cfg), torch.float32
    hkv, hd = cfg.n_kv_heads, cfg.hd
    pos = torch.zeros((n,), dtype=torch.int32, device=dev)
    if cfg.vq_attn:
        vq = _vq_cfg(cfg)
        return VQKVCache(
            sum_k=torch.zeros((n, batch, hkv, vq.k, hd), dtype=f32,
                              device=dev),
            sum_v=torch.zeros((n, batch, hkv, vq.k, hd), dtype=f32,
                              device=dev),
            count=torch.zeros((n, batch, hkv, vq.k), dtype=f32, device=dev),
            win_k=torch.zeros((n, batch, vq.window, hkv, hd), dtype=dt,
                              device=dev),
            win_v=torch.zeros((n, batch, vq.window, hkv, hd), dtype=dt,
                              device=dev),
            pos=pos)
    return KVCache(
        torch.zeros((n, batch, seq_len, hkv, hd), dtype=dt, device=dev),
        torch.zeros((n, batch, seq_len, hkv, hd), dtype=dt, device=dev),
        pos)


def init_serve_cache(cfg: ArchConfig, batch: int, seq_len: int, *,
                     device: str | torch.device = "cuda") -> dict:
    """Decode state, stacked as the params are.

    dense / moe: ``{"kv": KVCache | VQKVCache}`` over the L layers (exact
    attention: ``seq_len`` slots; VQ-Attention: O(k + W) state whatever
    ``seq_len``).  ssm: ``{"mlstm": MLSTMState, "slstm": SLSTMState}``
    over the L / 2 pairs, f32, constant size.  hybrid: ``{"mamba":
    Mamba2State}`` [groups, period, ...] and ``{"attn": ...}``, one
    attention cache a group for the shared block.  vlm / audio: ``kv``
    over the L decoder layers and the context's ``cross_k`` / ``cross_v``,
    zeros of the model dtype: [L / cross_attn_period, B, n_patches, Hkv,
    dh] (vlm), [L, B, enc_seq, Hkv, dh] (audio); a caller that has the
    context writes its keys and values there."""
    dev = resolve_device(device)
    check_family(cfg)
    if cfg.family in ("dense", "moe"):
        return {"kv": _attn_cache(cfg, cfg.n_layers, batch, seq_len, dev)}
    if cfg.family in CROSS_FAMILIES:
        n, f = ((cfg.n_layers // cfg.cross_attn_period, cfg.n_patches)
                if cfg.family == "vlm" else (cfg.n_layers, cfg.enc_seq))
        shape = (n, batch, f, cfg.n_kv_heads, cfg.hd)
        return {"kv": _attn_cache(cfg, cfg.n_layers, batch, seq_len, dev),
                "cross_k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
                "cross_v": torch.zeros(shape, dtype=_dtype(cfg), device=dev)}
    if cfg.family == "ssm":
        n = cfg.n_layers // 2
        return {"mlstm": _stacked(lambda: init_mlstm_state(
                    batch, cfg.d_model, cfg.n_heads, dev), (n,)),
                "slstm": _stacked(lambda: init_slstm_state(
                    batch, cfg.d_model, dev), (n,))}
    groups = cfg.n_layers // cfg.attn_period
    return {"mamba": _stacked(lambda: init_mamba2_state(
                batch, cfg.d_model, cfg.ssm_state, _dtype(cfg), dev),
                (groups, cfg.attn_period)),
            "attn": _attn_cache(cfg, groups, batch, seq_len, dev)}


# ===========================================================================
# blocks
# ===========================================================================

def _attn_train(bp: dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    x = constrain_tokens(x)
    ln1, attn = gather_params((bp["ln1"], bp["attn"]), x)
    h = rmsnorm(x, ln1, cfg.norm_eps)
    q, k, v = qkv(attn, h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                  positions, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)
    if cfg.vq_attn:
        o = vq_attention_train(q, k, v, _vq_cfg(cfg))
    else:
        o = gqa_attend(q, k, v, causal=True)
    return constrain_tokens(x + o.reshape(b, s, -1) @ attn.wo)


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


def _ffn(bp: dict, x: torch.Tensor, cfg: ArchConfig
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The block's second half -> (x + its output, the MoE aux loss: 0
    for an MLP block)."""
    b, s, d = x.shape
    ln2, ff = gather_params((bp["ln2"], bp["moe" if "moe" in bp else "mlp"]),
                            x)
    h = rmsnorm(x, ln2, cfg.norm_eps)
    if "moe" in bp:
        y, aux = apply_moe(ff, h.reshape(b * s, d), cfg.top_k)
        return constrain_tokens(x + y.reshape(b, s, d)), aux
    return constrain_tokens(x + apply_mlp(ff, h)), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def _cross_attn(bp: dict, x: torch.Tensor, ctx_k: torch.Tensor,
                ctx_v: torch.Tensor, cfg: ArchConfig,
                gated: bool = False) -> torch.Tensor:
    """Cross attention of ``x`` [B, S, d] to context keys / values [B, F,
    Hkv, dh]: whisper's decoder reads ``ln_x`` and ``cross``, the vlm's
    cross block ``ln1`` and ``attn`` and gates the output by
    ``tanh(gate)``."""
    b, s, _ = x.shape
    ln, attn = gather_params((bp["ln_x" if "ln_x" in bp else "ln1"],
                              bp["cross" if "cross" in bp else "attn"]), x)
    h = rmsnorm(x, ln, cfg.norm_eps)
    q = split_ready(h @ attn.wq, -1, cfg.n_heads).reshape(
        b, s, cfg.n_heads, cfg.hd)
    o = gqa_attend(q, ctx_k, ctx_v, causal=False)
    o = o.reshape(b, s, -1) @ attn.wo
    if gated:
        o = torch.tanh(bp["gate"]) * o
    # on a mesh, pinned as the self-attention's output is (the reference
    # leaves this one to GSPMD's propagation)
    return constrain_tokens(x + o)


def _ctx_kv(attn, ctx: torch.Tensor, cfg: ArchConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The context's keys and values [B, F, Hkv, dh] (no norm, no RoPE)."""
    b, f, _ = ctx.shape
    attn = gather_params(attn, ctx)
    return tuple(split_ready(ctx @ w, -1, cfg.n_kv_heads).reshape(
        b, f, cfg.n_kv_heads, cfg.hd) for w in (attn.wk, attn.wv))


def _pair_train(bp: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    bp = gather_params(bp, x)
    x = x + apply_mlstm_train(bp["mlstm"], rmsnorm(x, bp["ln1"],
                                                   cfg.norm_eps),
                              cfg.n_heads)
    return x + apply_slstm_train(bp["slstm"], rmsnorm(x, bp["ln2"],
                                                      cfg.norm_eps))


# ===========================================================================
# training forward, loss, prefill
# ===========================================================================

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
    if is_dtensor(embed):
        # DTensor's vocab-parallel embedding (its rows, and a gradient
        # summed by ``embedding_dense_backward`` in the same dtypes): the
        # indexing's backward (``index_put``) has no sharding rule that
        # holds on every torch release
        if vocab < 8192:
            return F.embedding(tokens, embed)
        return F.embedding(tokens, embed.float()).to(embed.dtype)
    if vocab < 8192:
        return embed[tokens]
    return embed.float()[tokens].to(embed.dtype)


def _sum(auxs: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack(auxs).sum()


def forward_train(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                  aux_embeds: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final hidden states [B, S, d] after ``ln_f``, the
    MoE aux loss summed over the layers: 0 for the other families).
    ``aux_embeds``: the audio family's frame embeddings [B, enc_seq, d]
    or the vlm's patch embeddings [B, n_patches, d] (required there; the
    other families ignore it)."""
    check_family(cfg)
    if cfg.family in CROSS_FAMILIES and aux_embeds is None:
        what = ("stub frame embeddings [B, enc_seq, d_model]"
                if cfg.family == "audio"
                else "stub patch embeddings [B, n_patches, d_model]")
        raise ValueError(f"{cfg.name}: the {cfg.family} family's forward "
                         f"needs aux_embeds, the {what}")
    b, s = tokens.shape
    x = constrain_tokens(embed_lookup(params["embed"], tokens, cfg.vocab))
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()

    def ckpt(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat \
            else fn(*args)

    moe_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "moe"):
        layers = per_layer(params["blocks"])

        def body(xc, bp):
            return _ffn(bp, _attn_train(bp, xc, cfg, positions), cfg)

        gsz = cfg.remat_group
        auxs = []
        if remat and gsz > 1 and cfg.n_layers % gsz == 0:
            # nested remat: a checkpoint per group around a checkpoint per
            # layer, so a group's recompute holds one layer's residuals
            def group_body(xc, group):
                g_aux = []
                for bp in group:
                    xc, a = checkpoint(body, xc, bp, use_reentrant=False)
                    g_aux.append(a)
                return xc, _sum(g_aux)
            for g0 in range(0, cfg.n_layers, gsz):
                x, a = checkpoint(group_body, x, layers[g0:g0 + gsz],
                                  use_reentrant=False)
                auxs.append(a)
        else:
            for bp in layers:
                x, a = ckpt(body, x, bp)
                auxs.append(a)
        moe_aux = _sum(auxs)
    elif cfg.family == "vlm":
        period = cfg.cross_attn_period

        def group_body(xc, text_blocks, cross_bp, ctx):
            for bp in text_blocks:
                xc = _ffn(bp, _attn_train(bp, xc, cfg, positions), cfg)[0]
            ck, cv = _ctx_kv(cross_bp["attn"], ctx, cfg)
            xc = _cross_attn(cross_bp, xc, ck, cv, cfg, gated=True)
            return _ffn(cross_bp, xc, cfg)[0]
        text = per_layer(params["blocks"])
        for g, cross_bp in enumerate(per_layer(params["cross_blocks"])):
            x = ckpt(group_body, x, text[g * period:(g + 1) * period],
                     cross_bp, aux_embeds)
    elif cfg.family == "audio":
        f = aux_embeds.shape[1]
        fpos = torch.arange(f, device=x.device)[None].expand(b, f)

        def enc_body(ec, bp):
            bp = gather_params(bp, ec)
            h = rmsnorm(ec, bp["ln1"], cfg.norm_eps)
            # no qk_norm in the encoder, whatever cfg.qk_norm says (as in
            # the reference)
            q, k, v = qkv(bp["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                          cfg.hd, fpos, rope_theta=cfg.rope_theta)
            o = gqa_attend(q, k, v, causal=False)
            ec = ec + o.reshape(*ec.shape[:2], -1) @ bp["attn"].wo
            return _ffn(bp, ec, cfg)[0]

        def dec_body(xc, bp, enc):
            xc = _attn_train(bp, xc, cfg, positions)
            ck, cv = _ctx_kv(bp["cross"], enc, cfg)
            xc = _cross_attn(bp, xc, ck, cv, cfg)
            return _ffn(bp, xc, cfg)[0]
        enc = aux_embeds
        for bp in per_layer(params["enc_blocks"]):
            enc = ckpt(enc_body, enc, bp)
        enc = rmsnorm(enc, params["enc_ln_f"], cfg.norm_eps)
        for bp in per_layer(params["blocks"]):
            x = ckpt(dec_body, x, bp, enc)
    elif cfg.family == "ssm":
        for bp in per_layer(params["pairs"]):
            x = ckpt(_pair_train, bp, x, cfg)
    else:                                                # hybrid
        shared = params["shared"]

        def group_body(xc, mblocks):
            for bp in per_layer(gather_params(mblocks, xc)):
                # on a mesh, pinned as an attention block's output is
                xc = constrain_tokens(xc + apply_mamba2_train(
                    bp["mamba"], rmsnorm(xc, bp["ln"], cfg.norm_eps),
                    cfg.d_model, cfg.ssm_state))
            xc = _attn_train(shared, xc, cfg, positions)
            return _ffn(shared, xc, cfg)[0]
        for group in per_layer(params["mamba"]):
            x = ckpt(group_body, x, group)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x, moe_aux


def _target_logit(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """``logits[..., targets]``: a gather; on a DTensor (its vocab dim
    possibly sharded) the reference's contraction with the targets'
    one-hot, as a select and a sum over the vocab dim -- exact, since
    every other term adds 0."""
    if not is_dtensor(logits):
        return logits.gather(-1, targets[..., None])[..., 0]
    vocab = torch.arange(logits.shape[-1], device=targets.device)
    hit = targets[..., None] == vocab
    return torch.where(hit, logits, 0.0).sum(-1)


def train_loss(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
               aux_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy, the mean over tokens, + 0.01 x the MoE
    aux loss.  ``tokens`` [B, S + 1].  The logits are the model-dtype
    product cast to f32, as in the reference; the target logit is a
    gather, bit-equal to the reference's one-hot contraction for finite
    logits, without its [B, S, V] f32 one-hot."""
    hidden, moe_aux = forward_train(params, tokens[:, :-1], cfg, aux_embeds)
    targets = tokens[:, 1:].long()
    logits = (hidden @ params["head"]).float()
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = _target_logit(logits, targets)
    return torch.mean(keep_layout(lse - target_logit)) + 0.01 * moe_aux


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            aux_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill forward: the last position's logits [B, vocab] in the
    model's dtype (the head is applied to that position only)."""
    hidden, _ = forward_train(params, tokens, cfg, aux_embeds)
    return hidden[:, -1] @ params["head"]


# ===========================================================================
# decode
# ===========================================================================

def _stack_layers(layers: list) -> Any:
    """Per-layer trees (NamedTuples of tensors, or lists of them for a
    two-deep stack) stacked into one tree along a new leading dim."""
    if isinstance(layers[0], list):
        return _stack_layers([_stack_layers(g) for g in layers])
    return type(layers[0])(*(torch.stack(f) for f in zip(*layers)))


def serve_step(params: Params, token: torch.Tensor, cache: dict,
               cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: [B, 1] integer -> (logits [B, vocab] in the
    model's dtype, the cache updated in place; its attention caches with
    ``pos + 1``).  DTensor params and cache (the dry-run's sharded decode
    cells) run functionally: each layer's new state is kept and the cache
    stacked anew, as the reference returns it."""
    check_family(cfg)
    x = params["embed"][token]                           # [B, 1, d]
    functional = is_dtensor(x)

    def done(stack, news):
        """An attention stack after the step: the views updated in place
        and ``pos + 1``, or the new layers stacked (their ``pos`` + 1)."""
        return _stack_layers(news) if functional \
            else stack._replace(pos=stack.pos + 1)

    def write(view, new, news):
        """A recurrent state's new value: into its view of the stack, or
        kept for the new stack."""
        if functional:
            news.append(new)
        else:
            _write(view, new)

    if cfg.family in ("dense", "moe"):
        kv, news = cache["kv"], []
        for bp, c in zip(per_layer(params["blocks"]), per_layer(kv)):
            x, c = _attn_decode(bp, x, c, cfg)
            news.append(c)
            x, _ = _ffn(bp, x, cfg)
        cache = {"kv": done(kv, news)}
    elif cfg.family in CROSS_FAMILIES:
        kv, news = cache["kv"], []
        layers, caches = per_layer(params["blocks"]), per_layer(kv)
        ctx = list(zip(per_layer(cache["cross_k"]),
                       per_layer(cache["cross_v"])))
        if cfg.family == "vlm":
            # groups of ``period`` text layers, each followed by its
            # gated cross block
            period = cfg.cross_attn_period
            for g, cb in enumerate(per_layer(params["cross_blocks"])):
                for l in range(g * period, (g + 1) * period):
                    x, c = _attn_decode(layers[l], x, caches[l], cfg)
                    news.append(c)
                    x, _ = _ffn(layers[l], x, cfg)
                x = _cross_attn(cb, x, *ctx[g], cfg, gated=True)
                x, _ = _ffn(cb, x, cfg)
        else:
            for bp, c, (ck, cv) in zip(layers, caches, ctx):
                x, c = _attn_decode(bp, x, c, cfg)
                news.append(c)
                x = _cross_attn(bp, x, ck, cv, cfg)
                x, _ = _ffn(bp, x, cfg)
        cache = dict(cache, kv=done(kv, news))
    elif cfg.family == "ssm":
        m_news, s_news = [], []
        for bp, ms, ss in zip(per_layer(params["pairs"]),
                              per_layer(cache["mlstm"]),
                              per_layer(cache["slstm"])):
            o, new = apply_mlstm_step(
                bp["mlstm"], rmsnorm(x, bp["ln1"], cfg.norm_eps), ms,
                cfg.n_heads)
            write(ms, new, m_news)
            x = x + o
            o, new = apply_slstm_step(
                bp["slstm"], rmsnorm(x, bp["ln2"], cfg.norm_eps), ss)
            write(ss, new, s_news)
            x = x + o
        if functional:
            cache = {"mlstm": _stack_layers(m_news),
                     "slstm": _stack_layers(s_news)}
    else:                                                # hybrid
        shared, attn = params["shared"], cache["attn"]
        news, mamba_news = [], []
        for group, states, c in zip(per_layer(params["mamba"]),
                                    per_layer(cache["mamba"]),
                                    per_layer(attn)):
            group_news = []
            for bp, st in zip(per_layer(group), per_layer(states)):
                o, new = apply_mamba2_step(
                    bp["mamba"], rmsnorm(x, bp["ln"], cfg.norm_eps), st,
                    cfg.d_model, cfg.ssm_state)
                write(st, new, group_news)
                x = x + o
            mamba_news.append(group_news)
            x, c = _attn_decode(shared, x, c, cfg)
            news.append(c)
            x, _ = _ffn(shared, x, cfg)
        cache = {"mamba": _stack_layers(mamba_news) if functional
                 else cache["mamba"], "attn": done(attn, news)}
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x[:, 0] @ params["head"], cache
