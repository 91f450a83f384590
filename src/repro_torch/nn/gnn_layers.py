"""GNN backbones as generalized graph convolutions (paper Tables 1 & 5).

Torch twin of the fixed-convolution backbones of ``repro.nn.gnn_layers``
-- GCN, SAGE-Mean and GIN -- each with two execution modes over one
parameter dict (weights in the reference's ``[f_in, f_out]`` layout):

  * ``full_apply`` -- exact message passing over the whole graph;
  * ``vq_apply``   -- the paper's approximated message passing on a
    mini-batch (Eq. 6 forward, Eq. 7 backward through the injection when
    ``inject``), with the probe-trick gradient tap: ``z + probe`` at the
    pre-activation, whose gradient is G^(l+1) for the codebook update.
    ``probe=None`` skips the tap (inference, serving, evaluation).

All three route their messages through the same two kernels
(``spmm_ell`` and ``context_ell``); the dense ``m @ w + b`` stays a plain
matmul, as the reference leaves it to XLA.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.codebook import CodebookConfig
from repro_torch.core.conv import (LayerVQState, MinibatchPack,
                                   fixed_conv_operands, layer_codewords)
from repro_torch.core.message_passing import approx_message_passing
from repro_torch.graph.batching import FullGraphOperands
from repro_torch.kernels import ops as kops
from repro_torch.runtime import BACKBONE_SLICE, resolve_device

Params = dict[str, torch.Tensor]


def _dense(f_in: int, f_out: int, generator: Optional[torch.Generator],
           device) -> torch.Tensor:
    w = torch.randn((f_in, f_out), generator=generator, dtype=torch.float32)
    return (w / math.sqrt(f_in)).to(device)


def _tap(z: torch.Tensor, probe: Optional[torch.Tensor]) -> torch.Tensor:
    return z if probe is None else z + probe


def _gcn_edge_vals(ops_: FullGraphOperands
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    dt = ops_.degrees + 1.0
    vals = ops_.nbr_mask / torch.sqrt(dt[:, None] * dt[ops_.nbr_ids.long()])
    return vals, 1.0 / dt


class GCN:
    """Fixed convolution C = D~^-1/2 A~ D~^-1/2."""
    name = "gcn"

    @staticmethod
    def init(f_in: int, f_out: int, *, generator=None, device="cuda",
             **_) -> Params:
        device = resolve_device(device)
        return {"w": _dense(f_in, f_out, generator, device),
                "b": torch.zeros(f_out, device=device)}

    @staticmethod
    def f_grad(f_in: int, f_out: int, **_) -> int:
        return f_out          # gradient codewords live at the Z level

    @staticmethod
    def probe_shape(b: int, f_in: int, f_out: int, **_) -> tuple[int, ...]:
        return (b, f_out)

    @staticmethod
    def full_apply(p: Params, x, ops_: FullGraphOperands, act):
        vals, self_vals = _gcn_edge_vals(ops_)
        m = kops.spmm_ell(ops_.nbr_ids, vals, x, ops_.stripe_index) \
            + self_vals[:, None] * x
        return act(m @ p["w"] + p["b"])

    @staticmethod
    def vq_apply(p: Params, x_b, probe, pack: MinibatchPack,
                 vq: LayerVQState, degrees, cfg: CodebookConfig, act,
                 f_in: int, f_out: int, inject: bool = True):
        ops_, self_vals = fixed_conv_operands('gcn', pack, degrees)
        fcw, gcw = layer_codewords(vq, f_in, cfg)
        m = approx_message_passing(ops_, x_b, fcw, gcw, vq.assignment,
                                   p["w"], inject)
        m = m + self_vals[:, None] * x_b
        return act(_tap(m @ p["w"] + p["b"], probe))


class SAGE:
    """Two fixed convolutions: C1 = I, C2 = D^-1 A (mean aggregator)."""
    name = "sage"

    @staticmethod
    def init(f_in: int, f_out: int, *, generator=None, device="cuda",
             **_) -> Params:
        device = resolve_device(device)
        return {"w1": _dense(f_in, f_out, generator, device),
                "w2": _dense(f_in, f_out, generator, device),
                "b": torch.zeros(f_out, device=device)}

    @staticmethod
    def f_grad(f_in: int, f_out: int, **_) -> int:
        return f_out

    @staticmethod
    def probe_shape(b: int, f_in: int, f_out: int, **_) -> tuple[int, ...]:
        return (b, f_out)

    @staticmethod
    def full_apply(p: Params, x, ops_: FullGraphOperands, act):
        vals = ops_.nbr_mask / torch.clamp(ops_.degrees, min=1.0)[:, None]
        mean_nbr = kops.spmm_ell(ops_.nbr_ids, vals, x, ops_.stripe_index)
        return act(x @ p["w1"] + mean_nbr @ p["w2"] + p["b"])

    @staticmethod
    def vq_apply(p: Params, x_b, probe, pack, vq, degrees, cfg, act,
                 f_in: int, f_out: int, inject: bool = True):
        ops_, _ = fixed_conv_operands('mean', pack, degrees)
        fcw, gcw = layer_codewords(vq, f_in, cfg)
        m2 = approx_message_passing(ops_, x_b, fcw, gcw, vq.assignment,
                                    p["w2"], inject)
        # the identity convolution is always intra-batch: exact autograd
        return act(_tap(x_b @ p["w1"] + m2 @ p["w2"] + p["b"], probe))


class GIN:
    """C1 = A fixed; C2 = (1 + eps) I learnable diagonal; MLP head."""
    name = "gin"

    @staticmethod
    def init(f_in: int, f_out: int, *, generator=None, device="cuda",
             **_) -> Params:
        device = resolve_device(device)
        return {"w1": _dense(f_in, f_out, generator, device),
                "b1": torch.zeros(f_out, device=device),
                "w2": _dense(f_out, f_out, generator, device),
                "b2": torch.zeros(f_out, device=device),
                "eps": torch.zeros((), device=device)}

    @staticmethod
    def f_grad(f_in: int, f_out: int, **_) -> int:
        return f_out

    @staticmethod
    def probe_shape(b: int, f_in: int, f_out: int, **_) -> tuple[int, ...]:
        return (b, f_out)

    @staticmethod
    def full_apply(p: Params, x, ops_: FullGraphOperands, act):
        s = kops.spmm_ell(ops_.nbr_ids, ops_.nbr_mask, x,
                           ops_.stripe_index)
        m = (1.0 + p["eps"]) * x + s
        h = torch.relu(m @ p["w1"] + p["b1"])
        return act(h @ p["w2"] + p["b2"])

    @staticmethod
    def vq_apply(p: Params, x_b, probe, pack, vq, degrees, cfg, act,
                 f_in: int, f_out: int, inject: bool = True):
        ops_, _ = fixed_conv_operands('adj', pack, degrees)
        fcw, gcw = layer_codewords(vq, f_in, cfg)
        s = approx_message_passing(ops_, x_b, fcw, gcw, vq.assignment,
                                   p["w1"], inject)
        m = (1.0 + p["eps"]) * x_b + s
        h = torch.relu(_tap(m @ p["w1"] + p["b1"], probe))
        return act(h @ p["w2"] + p["b2"])


BACKBONES = {c.name: c for c in [GCN, SAGE, GIN]}


def backbone(name: str):
    """The backbone class for ``name``; GAT and the Graph-Transformer (the
    learnable and dense convolutions) raise until their slice lands."""
    if name in ("gat", "transformer"):
        raise NotImplementedError(
            f"backbone {name!r} comes with {BACKBONE_SLICE}; this slice "
            f"ports {', '.join(BACKBONES)}")
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r}")
    return BACKBONES[name]
