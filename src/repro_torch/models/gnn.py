"""Full GNN model: assembly, probe-free VQ forward, mini-batched inference
and the serving step.

Torch twin of the inference half of ``repro.models.gnn``: ``GNNConfig``,
``init_gnn``, ``init_vq_states``, ``vq_forward`` (probe-free),
``vq_infer_layer`` / ``vq_infer_epoch`` (layer-locked inference over the
static wrap-padded batches, optionally refreshing every node's feature-half
assignment first -- the inductive path) and ``vq_serve_batch`` (one
request micro-batch through every layer).  JAX's ``lax.scan`` over the
batches is a Python loop here; PyTorch runs eagerly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import codebook as cbm
from repro_torch.core.codebook import CodebookConfig
from repro_torch.core.conv import (LayerVQState, MinibatchPack,
                                   init_layer_vq_state, refresh_assignment)
from repro_torch.graph.batching import EpochPlan, plan_batch
from repro_torch.nn.gnn_layers import Params, backbone
from repro_torch.runtime import TRAINING_SLICE, resolve_device


class GNNConfig(NamedTuple):
    backbone: str = "gcn"
    f_in: int = 128
    hidden: int = 128
    n_out: int = 40
    n_layers: int = 3
    heads: int = 4
    task: str = "node"            # "node" | "link"
    multilabel: bool = False
    grad_inject: bool = True      # Eq. 7 out-of-batch gradient injection
    codebook: CodebookConfig = CodebookConfig(k=256, f_prod=4)

    def layer_dims(self) -> list[tuple[int, int]]:
        dims = []
        f = self.f_in
        for l in range(self.n_layers):
            last = l == self.n_layers - 1
            f_out = (self.n_out if (last and self.task == "node")
                     else self.hidden)
            dims.append((f, f_out))
            f = f_out
        return dims

    def layer_codebook_cfg(self) -> CodebookConfig:
        return self.codebook


def _layer_out_dims(cfg: GNNConfig) -> list[tuple[int, int]]:
    """(f_in, f_out) of every layer (GAT/Transformer head widening is not
    part of this slice: ``backbone`` rejects those backbones first)."""
    backbone(cfg.backbone)
    return cfg.layer_dims()


def init_gnn(cfg: GNNConfig, generator: Optional[torch.Generator] = None,
             *, device: str | torch.device = "cuda") -> list[Params]:
    """Random parameters from ``generator`` (drawn on the CPU, so a seed
    gives the same weights on every device)."""
    dev = resolve_device(device)
    bk = backbone(cfg.backbone)
    return [bk.init(fi, fo, heads=cfg.heads, generator=generator, device=dev)
            for fi, fo in cfg.layer_dims()]


def init_vq_states(cfg: GNNConfig, n_nodes: int,
                   generator: Optional[torch.Generator] = None, *,
                   device: str | torch.device = "cuda"
                   ) -> list[LayerVQState]:
    dev = resolve_device(device)
    bk = backbone(cfg.backbone)
    cb_cfg = cfg.layer_codebook_cfg()
    return [init_layer_vq_state(n_nodes, fi, bk.f_grad(fi, fo,
                                                       heads=cfg.heads),
                                cb_cfg, generator=generator, device=dev)
            for fi, fo in _layer_out_dims(cfg)]


def _act_for_layer(cfg: GNNConfig, l: int):
    last = l == cfg.n_layers - 1
    return (lambda z: z) if last else torch.relu


def vq_forward(params: list[Params], x_b: torch.Tensor,
               probes: Optional[list[torch.Tensor]],
               pack: MinibatchPack, vq_states: list[LayerVQState],
               degrees: torch.Tensor, cfg: GNNConfig,
               inject: Optional[bool] = None
               ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """All-layer approximated forward of one mini-batch.  Returns (output,
    per-layer input activations).  Forward only in this slice: ``probes``
    must be None and ``inject`` resolve to False."""
    if probes is not None:
        raise NotImplementedError(
            f"probe taps come with {TRAINING_SLICE}; pass probes=None")
    bk = backbone(cfg.backbone)
    cb_cfg = cfg.layer_codebook_cfg()
    inject = cfg.grad_inject if inject is None else inject
    acts = []
    x = x_b
    for l, (p, vq, (fi, fo)) in enumerate(
            zip(params, vq_states, _layer_out_dims(cfg))):
        acts.append(x)
        x = bk.vq_apply(p, x, None, pack, vq, degrees, cb_cfg,
                        _act_for_layer(cfg, l), fi, fo, inject=inject)
    return x, acts


# ---------------------------------------------------------------------------
# mini-batched inference (the refresh pass) and serving
# ---------------------------------------------------------------------------

@torch.no_grad()
def _vq_infer_layer_body(params_l: Params, vq_state: LayerVQState,
                         plan: EpochPlan, perm: torch.Tensor,
                         slot_mask: torch.Tensor, acts: torch.Tensor,
                         degrees: torch.Tensor, *, cfg: GNNConfig,
                         layer: int) -> torch.Tensor:
    """One layer's sweep over all S batches.  Each batch derives its pack
    from the plan on device, runs the probe-free codeword forward and
    scatters its rows into an [n+1, f_out] table; wrap-padded tail slots
    are diverted to the sacrificial row n, so a node duplicated by the
    padding keeps its real-slot output."""
    bk = backbone(cfg.backbone)
    cb_cfg = cfg.layer_codebook_cfg()
    fi, fo = _layer_out_dims(cfg)[layer]
    act = _act_for_layer(cfg, layer)
    n = plan.n
    out = torch.zeros((n + 1, fo), dtype=acts.dtype, device=acts.device)
    sink = torch.tensor(n, dtype=torch.int64, device=acts.device)
    for s in range(perm.shape[0]):
        bids, smask = perm[s], slot_mask[s]
        pack = plan_batch(plan, bids, smask)
        ids64 = bids.long()
        y = bk.vq_apply(params_l, acts[ids64], None, pack, vq_state,
                        degrees, cb_cfg, act, fi, fo, inject=False)
        out.index_copy_(0, torch.where(smask > 0, ids64, sink), y)
    return out[:n]


@torch.no_grad()
def vq_infer_layer(params_l: Params, vq_state: LayerVQState,
                   plan: EpochPlan, perm: torch.Tensor,
                   slot_mask: torch.Tensor, acts: torch.Tensor,
                   degrees: torch.Tensor, cfg: GNNConfig, layer: int,
                   inductive: bool = False
                   ) -> tuple[torch.Tensor, LayerVQState]:
    """Layer-locked mini-batched codeword inference for ONE layer.

    perm [S, b] node ids per batch (``inference_slices``), slot_mask [S, b]
    (0 on wrap-padded slots), acts [n, f_in] every node's layer input.
    With ``inductive`` every node's feature-half assignment is refreshed
    from ``acts`` first (one ``vq_assign`` launch for all branches).
    Returns the [n, f_out] output table and the (refreshed) layer state."""
    if inductive:
        fi, _ = _layer_out_dims(cfg)[layer]
        assign = cbm.assign_features_only(
            vq_state.codebook, acts, fi, cfg.layer_codebook_cfg())
        vq_state = refresh_assignment(
            vq_state, torch.arange(plan.n, dtype=torch.int32,
                                   device=acts.device), assign)
    out = _vq_infer_layer_body(params_l, vq_state, plan, perm, slot_mask,
                               acts, degrees, cfg=cfg, layer=layer)
    return out, vq_state


def vq_infer_epoch(params: list[Params], vq_states: list[LayerVQState],
                   plan: EpochPlan, perm: torch.Tensor,
                   slot_mask: torch.Tensor, x: torch.Tensor,
                   degrees: torch.Tensor, cfg: GNNConfig, *,
                   inductive: bool = False
                   ) -> tuple[torch.Tensor, list[LayerVQState]]:
    """Whole-network layer-synchronous inference: layer l+1 sees refreshed
    layer-l activations (and, inductively, assignments) of every node."""
    acts = x
    states = list(vq_states)
    for l in range(cfg.n_layers):
        acts, states[l] = vq_infer_layer(
            params[l], states[l], plan, perm, slot_mask, acts, degrees,
            cfg, l, inductive)
    return acts, states


@torch.no_grad()
def vq_serve_batch(params: list[Params], vq_states: list[LayerVQState],
                   plan: EpochPlan, bids: torch.Tensor, x: torch.Tensor,
                   degrees: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    """Serving step: all-layer codeword forward for one request micro-batch
    of node ids -- O(b) work, codeword context standing in for every
    out-of-batch neighbor at every layer.  Duplicate ids are safe: the
    node->slot scatter keeps one slot and duplicate rows compute identical
    outputs."""
    pack = plan_batch(plan, bids)
    out, _ = vq_forward(params, x[bids.long()], None, pack, vq_states,
                        degrees, cfg, inject=False)
    return out
