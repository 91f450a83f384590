"""Fake-tensor stand-ins for every (arch x input-shape) cell (twin of
``repro.launch.input_specs``).

Nothing is allocated: params, optimizer state and caches come from the
port's own ``init_lm`` / ``opt.init`` / ``init_serve_cache`` run under a
``FakeTensorMode`` (the reference's ``jax.eval_shape``), so the dry-run
traces the very trees the runtime builds.  Modality frontends are stubs,
as in the reference: [audio] gets precomputed frame embeddings, [vlm]
precomputed patch embeddings.  Tokens are int32, as the reference's
``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.models import lm
from repro_torch.train.loop import TrainState
from repro_torch.train.optimizer import adam


def arch_for_cell(cfg: ArchConfig, shape_name: str) -> ArchConfig:
    """Cell-specific config adjustments: long_500k needs sub-quadratic
    attention, so VQ-Attention is enabled for the attention families;
    ssm / hybrid run natively."""
    if shape_name == "long_500k" and cfg.family in (
            "dense", "moe", "vlm", "audio"):
        return cfg.with_vq(k=1024, window=512)
    return cfg


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def aux_embed_spec(cfg: ArchConfig, batch: int) -> Optional[torch.Tensor]:
    """The stub context of the audio / vlm families ([B, enc_seq, d] or
    [B, n_patches, d] in the model dtype), else None.  Call under a
    ``FakeTensorMode`` to allocate nothing."""
    if cfg.family == "audio":
        return torch.empty((batch, cfg.enc_seq, cfg.d_model),
                           dtype=_dtype(cfg))
    if cfg.family == "vlm":
        return torch.empty((batch, cfg.n_patches, cfg.d_model),
                           dtype=_dtype(cfg))
    return None


def _tokens(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32)


def input_specs(cfg: ArchConfig, shape_name: str,
                mode: Optional[FakeTensorMode] = None) -> dict[str, Any]:
    """Fake inputs of the cell's entry point, made under ``mode`` (a new
    ``FakeTensorMode`` by default; a caller that traces with them passes
    its own), on the CPU.

    kind == train   -> {state, tokens (+1 for the targets), aux_embeds?}
    kind == prefill -> {params, tokens, aux_embeds?}
    kind == decode  -> {params, token, cache}
    """
    sh = SHAPES[shape_name]
    return cell_specs(arch_for_cell(cfg, shape_name), sh["kind"],
                      sh["global_batch"], sh["seq_len"], mode)


def cell_specs(cfg: ArchConfig, kind: str, b: int, s: int,
               mode: Optional[FakeTensorMode] = None) -> dict[str, Any]:
    """:func:`input_specs` of a cell given by its kind, batch and
    sequence (``cfg`` taken as it is)."""
    with mode or FakeTensorMode():
        params = lm.init_lm(cfg, device="cpu")
        if kind == "train":
            opt = adam(moment_dtype=torch.bfloat16)
            state = TrainState(params, opt.init(params),
                               torch.zeros((), dtype=torch.int32))
            out = {"state": state, "tokens": _tokens(b, s + 1)}
        elif kind == "prefill":
            out = {"params": params, "tokens": _tokens(b, s)}
        else:       # decode: one new token against a cache of seq_len
            return {"params": params, "token": _tokens(b, 1),
                    "cache": lm.init_serve_cache(cfg, b, s, device="cpu")}
        aux = aux_embed_spec(cfg, b)
        if aux is not None:
            out["aux_embeds"] = aux
        return out
