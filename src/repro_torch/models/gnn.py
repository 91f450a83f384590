"""Full GNN model: assembly, losses, train steps, VQ mini-batch inference
and the serving step.

Torch twin of ``repro.models.gnn``: ``GNNConfig``, ``init_gnn``,
``init_vq_states``, ``probe_shapes``, ``vq_forward`` (with or without
probe taps), the node losses and metric, the link task's ``link_loss`` and
``hits_at_k`` (Hits@K on the host), the VQ train step of Alg. 1 for either
task (``_vq_step_body`` behind ``vq_train_step`` and, through
``_vq_epoch_body``, ``vq_train_epoch``: forward with probes, one
``torch.autograd.grad`` for the params and the probes -- the probe
gradients are G^(l+1) -- the optimizer, then per layer
``codebook.update``, ``refresh_assignment`` and, under a quantized tier,
the snapshot's quantize-on-update), ``quantize_vq_states`` (the serving
conversion into a tier's storage), ``vq_eval_batch``, the full-graph
oracle (``full_forward``, ``full_train_step``, ``full_predict``; either
task), the sampling baselines' epoch over a stacked plan of subgraphs
(``sampler_train_epoch``, node task), and inference: ``vq_infer_layer``
/ ``vq_infer_epoch`` (layer-locked, optionally inductive) and
``vq_serve_batch``.

The multi-device hooks take a
:class:`~repro_torch.distributed.sharding.GraphMesh` where the reference
takes ``axis_name``: ``_vq_step_body(mesh=)`` and ``_vq_epoch_body(mesh=,
sharded_state=, compress=)`` are the per-rank bodies of the data-parallel
and row-sharded epochs (``distributed/data_parallel.py``), and
``_vq_infer_layer_sharded`` / ``_vq_serve_body_sharded`` those of the
row-sharded inference and serving; ``vq_serve_batch_rows`` is the serving
mesh's throughput mode (a rank's share of each layer's rows).  JAX's
``lax.scan`` over the batches is a Python loop here; PyTorch runs
eagerly.  Params are lists of ``{name: tensor}`` dicts and every step
returns new ones, as the reference's pure functions do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import codebook as cbm
from repro_torch.core.codebook import CodebookConfig
from repro_torch.core.conv import (LayerVQState, MinibatchPack,
                                   init_layer_vq_state, quantize_layer_state,
                                   hold_table, refresh_assignment)
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import (gather_from_shards,
                                                 shard_scatter_rows_)
from repro_torch.distributed.quantization import PackedAssignment
from repro_torch.distributed.sharding import serve_rows
from repro_torch.graph.batching import (EpochPlan, FullGraphOperands,
                                        SamplerEpochPlan, plan_batch,
                                        plan_batch_sharded)
from repro_torch.kernels import ops as kops
from repro_torch.nn.gnn_layers import Params, backbone
from repro_torch.runtime import resolve_device
from repro_torch.train.optimizer import OptState, Optimizer


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
        if self.backbone == "transformer":
            # the dense learnable convolution needs full-width codewords
            return self.codebook._replace(f_prod=1 << 30)
        return self.codebook


_ATTENTION = ("gat", "transformer")


def _widen(cfg: GNNConfig, fo: int) -> int:
    """An attention layer's output widened to a multiple of the heads (a
    widened last layer emits extra logits, as in the reference)."""
    return -(-fo // cfg.heads) * cfg.heads if cfg.backbone in _ATTENTION \
        else fo


def _layer_out_dims(cfg: GNNConfig) -> list[tuple[int, int]]:
    """(f_in, f_out) of every layer, GAT / Transformer outputs widened to
    a multiple of the heads and each layer's input the widened output
    before it."""
    backbone(cfg.backbone)
    dims, f = [], cfg.f_in
    for _, fo in cfg.layer_dims():
        dims.append((f, _widen(cfg, fo)))
        f = dims[-1][1]
    return dims


def init_gnn(cfg: GNNConfig, generator: Optional[torch.Generator] = None,
             *, device: str | torch.device = "cuda") -> list[Params]:
    """Random parameters from ``generator`` (drawn on the CPU, so a seed
    gives the same weights on every device).  GAT / Transformer outputs
    are widened to a multiple of the heads; each layer's input stays
    ``layer_dims``', as in the reference (the two differ only where
    ``hidden`` is not a multiple of the heads)."""
    dev = resolve_device(device)
    bk = backbone(cfg.backbone)
    return [bk.init(fi, _widen(cfg, fo), heads=cfg.heads,
                    generator=generator, device=dev)
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


def quantize_vq_states(vq_states: list[LayerVQState], cfg: GNNConfig,
                       precision: str | None = None) -> list[LayerVQState]:
    """The per-layer VQ states in a quantized tier's storage, for serving.

    ``precision`` is a tier of ``kops.PRECISIONS`` (default: the active
    ``kernel_precision()``, with fp32 read as int8, as the reference
    does); fp32 returns the states as they are.  Each layer gets a uint8
    table (k <= 256), nibble-packed under the '+a4' tiers (k <= 16), and a
    fresh codeword snapshot in the tier's storage dtype; the f32 codebook
    stays for updates.  Idempotent."""
    if precision is None:
        p = kops.kernel_precision()
        precision = p if p != "fp32" else "int8"
    cw_dtype = kops.precision_codeword_dtype(precision)
    if cw_dtype is None:
        return list(vq_states)
    pack = kops.precision_packs_assignment(precision)
    cb_cfg = cfg.layer_codebook_cfg()
    if cb_cfg.k > 256:
        raise ValueError(
            f"quantized assignment tables need k <= 256, got k={cb_cfg.k}")
    if pack and cb_cfg.k > 16:
        raise ValueError(
            f"nibble-packed ('+a4') assignment tables need k <= 16, got "
            f"k={cb_cfg.k}; use precision={precision.split('+')[0]!r}")
    out = []
    for (fi, _), vq in zip(_layer_out_dims(cfg), vq_states):
        a = vq.assignment
        if isinstance(a, PackedAssignment):
            a = a if pack else a.unpack()
        else:
            a = a.to(torch.uint8)
            if pack:
                a = PackedAssignment.pack(a)
        st = vq._replace(assignment=a, qcw=None)
        out.append(hold_table(quantize_layer_state(st, fi, cb_cfg,
                                                   dtype=cw_dtype)))
    return out


def probe_shapes(cfg: GNNConfig, b: int) -> list[tuple[int, ...]]:
    bk = backbone(cfg.backbone)
    return [bk.probe_shape(b, fi, fo, heads=cfg.heads)
            for fi, fo in _layer_out_dims(cfg)]


def _act_for_layer(cfg: GNNConfig, l: int):
    last = l == cfg.n_layers - 1
    return (lambda z: z) if last else torch.relu


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def full_forward(params: list[Params], x: torch.Tensor,
                 ops_: FullGraphOperands, cfg: GNNConfig) -> torch.Tensor:
    bk = backbone(cfg.backbone)
    for l, p in enumerate(params):
        x = bk.full_apply(p, x, ops_, _act_for_layer(cfg, l))
    return x


def vq_forward(params: list[Params], x_b: torch.Tensor,
               probes: Optional[list[torch.Tensor]],
               pack: MinibatchPack, vq_states: list[LayerVQState],
               degrees: torch.Tensor, cfg: GNNConfig,
               inject: Optional[bool] = None
               ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """All-layer approximated forward of one mini-batch.  Returns (output,
    per-layer input activations) -- the activations pair with the probe
    gradients for the codebook update (Alg. 1 line 15).  ``inject``
    overrides ``cfg.grad_inject`` (the Eq. 7 backward injection);
    ``probes=None`` skips the probe taps (the gradient-free paths)."""
    bk = backbone(cfg.backbone)
    cb_cfg = cfg.layer_codebook_cfg()
    inject = cfg.grad_inject if inject is None else inject
    acts = []
    x = x_b
    for l, (p, vq, (fi, fo)) in enumerate(
            zip(params, vq_states, _layer_out_dims(cfg))):
        acts.append(x)
        x = bk.vq_apply(p, x, None if probes is None else probes[l], pack,
                        vq, degrees, cb_cfg, _act_for_layer(cfg, l), fi, fo,
                        inject=inject)
    return x, acts


# ---------------------------------------------------------------------------
# losses / metrics
# ---------------------------------------------------------------------------

def node_loss_terms(logits: torch.Tensor, labels: torch.Tensor,
                    multilabel: bool, mask: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(numerator, denominator) of the masked-mean CE/BCE."""
    if multilabel:
        per = torch.mean(torch.clamp(logits, min=0) - logits * labels
                         + torch.log1p(torch.exp(-torch.abs(logits))),
                         dim=-1)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        per = -logp.gather(1, labels.long()[:, None])[:, 0]
    return torch.sum(per * mask), torch.sum(mask)


def node_loss(logits: torch.Tensor, labels: torch.Tensor, multilabel: bool,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE/BCE over (optionally masked) rows: batches traverse ALL
    nodes (so every assignment stays fresh) but only labeled nodes
    contribute to the loss."""
    if mask is None:
        mask = torch.ones(logits.shape[0], dtype=logits.dtype,
                          device=logits.device)
    num, den = node_loss_terms(logits, labels, multilabel, mask)
    return num / torch.clamp(den, min=1.0)


def node_metric(logits: torch.Tensor, labels: torch.Tensor,
                multilabel: bool) -> torch.Tensor:
    """Accuracy, or micro-F1 at threshold 0 for multilabel tasks."""
    if multilabel:
        pred = (logits > 0).float()
        tp = torch.sum(pred * labels)
        return 2 * tp / torch.clamp(pred.sum() + labels.sum(), min=1.0)
    return (torch.argmax(logits, -1) == labels).float().mean()


def link_loss(emb: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
              pair_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy of the dot-product scores of positive and
    negative pairs: pos / neg [e, 2] index rows of ``emb``.  ``pair_mask``
    [e] weighs the pairs of lists padded to a static size.  Stable through
    ``softplus`` (log(1 + e^z) overflows at init).  The rows are gathered
    with ``index_select``, whose backward adds with ``index_add_`` where
    advanced indexing's sorts the indices first."""
    def score(pairs):
        p = pairs.long()
        return torch.sum(emb.index_select(0, p[:, 0])
                         * emb.index_select(0, p[:, 1]), dim=-1)
    lp = torch.nn.functional.softplus(-score(pos))
    ln = torch.nn.functional.softplus(score(neg))
    if pair_mask is None:
        return lp.mean() + ln.mean()
    m = torch.clamp(pair_mask.sum(), min=1.0)
    return torch.sum(lp * pair_mask) / m + torch.sum(ln * pair_mask) / m


def hits_at_k(pos_scores: np.ndarray, neg_scores: np.ndarray,
              k: int = 50) -> float:
    """Hits@K (numpy): the share of positive scores strictly above the
    k-th largest negative score -- the smallest negative when there are
    fewer than k, and 0.0 when there are no positives."""
    if len(pos_scores) == 0:
        return 0.0
    if len(neg_scores) < k:
        thresh = neg_scores.min() if len(neg_scores) else -np.inf
    else:
        thresh = np.sort(neg_scores)[-k]
    return float((pos_scores > thresh).mean())


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _grad_leaves(params: list[Params]) -> list[Params]:
    """Fresh leaves of the params that autograd differentiates."""
    return [{k: v.detach().requires_grad_(True) for k, v in p.items()}
            for p in params]


def _grads(loss: torch.Tensor, params: list[Params],
           extra: list[torch.Tensor]
           ) -> tuple[list[Params], list[torch.Tensor]]:
    """d loss / d (params, extra); an unused leaf gets zeros."""
    flat = [v for p in params for v in p.values()]
    got = torch.autograd.grad(loss, flat + extra, allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g
           for t, g in zip(flat + extra, got)]
    it = iter(got[:len(flat)])
    return [{k: next(it) for k in p} for p in params], got[len(flat):]


def vq_loss_and_grads(params: list[Params], vq_states: list[LayerVQState],
                      pack: MinibatchPack, x_b: torch.Tensor,
                      labels_b: torch.Tensor, degrees: torch.Tensor,
                      cfg: GNNConfig,
                      loss_mask: Optional[torch.Tensor] = None,
                      neg_pairs: Optional[torch.Tensor] = None,
                      pos_pairs: Optional[torch.Tensor] = None, mesh=None):
    """The differentiation half of an Alg. 1 step: forward with zero probes
    at every layer's pre-activation, then one ``torch.autograd.grad`` of
    the loss for the params AND the probes -- the probe gradients are
    G^(l+1) = d loss / d Z^(l+1).  The node task's loss is the masked mean
    over ``loss_mask``; the link task's is ``link_loss`` over the batch
    positions ``pos_pairs`` / ``neg_pairs`` [e, 2].  With ``mesh`` (node
    task) the batch is this rank's share and the denominator is the
    global one, all-reduced, so the ranks' losses and gradients add up to
    the whole batch's.  Returns (loss, output, per-layer input
    activations, param grads, probe grads), all detached."""
    dev = x_b.device
    if cfg.task == "node":
        lmask = loss_mask if loss_mask is not None \
            else torch.ones(pack.b, dtype=torch.float32, device=dev)
        den = lmask.sum()
        if mesh is not None:
            den = collectives.all_reduce(den, mesh)  # independent of params
        den = torch.clamp(den, min=1.0)
    leaves = _grad_leaves(params)
    probes = [torch.zeros(s, dtype=torch.float32, device=dev,
                          requires_grad=True)
              for s in probe_shapes(cfg, pack.b)]
    with torch.enable_grad():
        out, acts = vq_forward(leaves, x_b, probes, pack, vq_states,
                               degrees, cfg)
        if cfg.task == "node":
            num, _ = node_loss_terms(out, labels_b, cfg.multilabel, lmask)
            loss = num / den
        else:
            loss = link_loss(out, pos_pairs, neg_pairs)
        gparams, gprobes = _grads(loss, leaves, probes)
    return (loss.detach(), out.detach(), [a.detach() for a in acts],
            gparams, gprobes)


def _vq_step_body(params: list[Params], vq_states: list[LayerVQState],
                  opt_state: OptState, pack: MinibatchPack,
                  x_b: torch.Tensor, labels_b: torch.Tensor,
                  degrees: torch.Tensor, cfg: GNNConfig, opt: Optimizer,
                  loss_mask: Optional[torch.Tensor] = None,
                  neg_pairs: Optional[torch.Tensor] = None,
                  pos_pairs: Optional[torch.Tensor] = None, mesh=None):
    """One Alg. 1 step: the one implementation behind ``vq_train_step``,
    ``vq_train_epoch`` and (with ``mesh``) the data-parallel and
    row-sharded epochs.  The node task weighs its loss by ``loss_mask``;
    the link task scores ``pos_pairs`` / ``neg_pairs`` (batch positions,
    [e, 2]).

    ``vq_loss_and_grads``, the optimizer step, then under ``no_grad`` each
    layer's codebook update from (X^(l) || G^(l+1)) and the refresh of the
    batch's assignments (Alg. 1 lines 15-16).

    With ``mesh`` (node task only) ``pack`` / ``x_b`` are this rank's
    share of the batch and the ranks are glued into one model a step
    (DESIGN.md section 9, "codebook psum rule"): the loss is the global
    masked mean, loss and param grads are SUM-all-reduced before the
    optimizer (one collective; sums, not means: each rank's loss is its
    numerator over the global denominator), ``codebook.update`` all-reduces
    the moments, counts and sums and gathers the revival candidates, and
    the refreshed ids and every layer's assignments are all-gathered in
    rank order (one collective) into the replicated tables.  Returns
    (params, vq_states, opt_state, loss, output, vq_errs [L])."""
    if mesh is not None and cfg.task != "node":
        raise ValueError("dp epoch executor is node-task only")
    loss, out, acts, gparams, gprobes = vq_loss_and_grads(
        params, vq_states, pack, x_b, labels_b, degrees, cfg, loss_mask,
        neg_pairs=neg_pairs, pos_pairs=pos_pairs, mesh=mesh)
    with torch.no_grad():
        if mesh is not None:
            loss, gparams = collectives.psum_tree((loss, gparams), mesh)
        new_params, new_opt = opt.update(gparams, opt_state, params)
        cb_cfg = cfg.layer_codebook_cfg()
        updates = []
        for l, vq in enumerate(vq_states):
            feats = acts[l].float()
            grads = gprobes[l].reshape(pack.b, -1).float()
            # gradients enter the codebook unscaled: Alg. 2's whitening
            # normalizes every concat dim
            updates.append((feats.shape[-1], *cbm.update(
                vq.codebook, feats, grads, cb_cfg, mesh=mesh)))
        refresh_ids = pack.batch_ids
        assigns = [stats.assignment for _, _, stats in updates]
        if mesh is None:
            vq_errs = torch.stack([stats.relative_error()
                                   for _, _, stats in updates])
        else:
            local = torch.cat([pack.batch_ids.to(torch.int32)[None]]
                              + [a.to(torch.int32) for a in assigns])
            rows = collectives.all_gather(local, mesh)   # [ndev, R, b_loc]
            rows = rows.transpose(0, 1).reshape(local.shape[0], -1)
            refresh_ids = rows[0]
            assigns = list(torch.split(rows[1:], [a.shape[0]
                                                  for a in assigns]))
            sums = collectives.all_reduce(torch.stack([torch.stack(
                [stats.qerr.sum(), stats.vnorm2.sum()])
                for _, _, stats in updates]), mesh)
            vq_errs = torch.sqrt(sums[:, 0] / (sums[:, 1] + 1e-12))
        new_states = []
        for vq, (f_feat, new_cb, _), assign in zip(vq_states, updates,
                                                   assigns):
            st = refresh_assignment(
                LayerVQState(new_cb, vq.assignment, vq.counts, vq.qcw),
                refresh_ids, assign)
            if vq.qcw is not None:
                # quantize-on-update: the snapshot follows the post-EMA
                # codebook, keeping its scales inside the drift band
                st = quantize_layer_state(st, f_feat, cb_cfg)
            new_states.append(st)
    return new_params, new_states, new_opt, loss, out, vq_errs


# the reference jits this entry point around the shared body; eager
# PyTorch needs no wrapper
vq_train_step = _vq_step_body


def _vq_epoch_body(params, vq_states, opt_state, plan: EpochPlan,
                   perm: torch.Tensor, slot_mask: torch.Tensor,
                   x: torch.Tensor, labels: torch.Tensor,
                   train_mask: torch.Tensor, degrees: torch.Tensor, *,
                   cfg: GNNConfig, opt: Optimizer, mesh=None,
                   sharded_state: bool = False, compress: bool = False):
    """The step body over the S stacked batches (node task), each batch's
    pack derived from the pack-once plan on device: the one loop behind
    ``vq_train_epoch`` and the data-parallel executors.

    With ``mesh`` this is one rank's body and ``perm`` / ``slot_mask``
    are its [S, b/ndev] columns.  With ``sharded_state`` as well, ``plan``
    / ``x`` / ``labels`` / ``train_mask`` are this rank's contiguous row
    BLOCK of the padded global node tables: every batch's rows come
    cross-shard (``plan_batch_sharded`` and ``gather_from_shards``) and
    the step math is the replicated data-parallel path's.  ``compress``
    moves the feature rows as int8 (lossy, opt-in).  Returns (params,
    vq_states, opt_state, losses [S], vq_errs [S, L])."""
    losses, errs = [], []
    for s in range(perm.shape[0]):
        bids, smask = perm[s], slot_mask[s]
        if sharded_state:
            pack = plan_batch_sharded(plan, bids, mesh, smask)
            x_b = gather_from_shards(x, bids, mesh, compress=compress)
            labels_b = gather_from_shards(labels, bids, mesh)
            lmask = gather_from_shards(train_mask, bids, mesh) * smask
        else:
            ids64 = bids.long()
            pack = plan_batch(plan, bids, smask)
            x_b, labels_b = x[ids64], labels[ids64]
            lmask = train_mask[ids64] * smask
        params, vq_states, opt_state, loss, _, e = _vq_step_body(
            params, vq_states, opt_state, pack, x_b, labels_b, degrees, cfg,
            opt, loss_mask=lmask, mesh=mesh)
        losses.append(loss)
        errs.append(e)
    dev = degrees.device
    return (params, vq_states, opt_state,
            torch.stack(losses) if losses
            else torch.zeros(0, device=dev),
            torch.stack(errs) if errs
            else torch.zeros((0, cfg.n_layers), device=dev))


def vq_train_epoch(params, vq_states, opt_state, plan: EpochPlan,
                   perm: torch.Tensor, slot_mask: torch.Tensor,
                   x: torch.Tensor, labels: torch.Tensor,
                   train_mask: torch.Tensor, degrees: torch.Tensor,
                   cfg: GNNConfig, opt: Optimizer):
    """One epoch of Alg. 1 on the device: ``_vq_epoch_body`` on one device
    (a Python loop where the reference scans).  Its multi-device forms are
    ``distributed.data_parallel.vq_train_epoch_dp`` and
    ``vq_train_epoch_sharded``, the same body with ``mesh=`` (and
    ``sharded_state=``).

    perm [S, b] node ids per batch (``epoch_slices``), slot_mask [S, b] (0
    on wrap-padded tail slots, which are loss-masked), x / labels /
    train_mask full [n, ...] device tables.  Returns (params, vq_states,
    opt_state, losses [S], vq_errs [S, L])."""
    return _vq_epoch_body(params, vq_states, opt_state, plan, perm,
                          slot_mask, x, labels, train_mask, degrees,
                          cfg=cfg, opt=opt)


@torch.no_grad()
def vq_eval_batch(params, vq_states, pack: MinibatchPack, x_b, degrees,
                  cfg: GNNConfig) -> torch.Tensor:
    out, _ = vq_forward(params, x_b, None, pack, vq_states, degrees, cfg,
                        inject=False)
    return out


def full_train_step(params, opt_state, x, ops_: FullGraphOperands, labels,
                    loss_mask, cfg: GNNConfig, opt: Optimizer,
                    neg_pairs=None, pos_pairs=None, pair_mask=None):
    """One exact-message-passing step over a whole (sub)graph (the oracle
    and the sampling baselines); loss_mask [n] weighs the nodes of the
    node task, the link task scores ``pos_pairs`` / ``neg_pairs`` [e, 2]
    (rows of ``x``) weighed by ``pair_mask`` [e] (optional).  Returns
    (params, opt_state, loss)."""
    leaves = _grad_leaves(params)
    with torch.enable_grad():
        out = full_forward(leaves, x, ops_, cfg)
        if cfg.task == "node":
            loss = node_loss(out, labels, cfg.multilabel, loss_mask)
        else:
            loss = link_loss(out, pos_pairs, neg_pairs, pair_mask)
        grads, _ = _grads(loss, leaves, [])
    with torch.no_grad():
        new_params, new_opt = opt.update(grads, opt_state, params)
    return new_params, new_opt, loss.detach()


def sampler_train_epoch(params, opt_state, splan: SamplerEpochPlan,
                        x: torch.Tensor, labels: torch.Tensor,
                        cfg: GNNConfig, opt: Optimizer):
    """One sampling-baseline epoch on the device: ``full_train_step`` over
    the S stacked subgraphs of a :class:`SamplerEpochPlan` (a Python loop
    where the reference scans), carrying (params, opt_state).

    Each step takes its padded subgraph's operands from the plan, gathers
    the batch's features and labels from the full [n, ...] tables and
    weighs the loss by the plan's seed weights.  Padding rows gather node
    0's row; they feed no messages into real rows and carry no loss.  Node
    task only (the link task's pair mining is host work).  Returns
    (params, opt_state, losses [S])."""
    if cfg.task != "node":
        raise ValueError("sampler epoch executor is node-task only")
    losses = []
    for s in range(splan.s):
        nid = splan.node_ids[s].long()
        ops_ = FullGraphOperands(nbr_ids=splan.nbr_ids[s],
                                 nbr_mask=splan.nbr_mask[s],
                                 degrees=splan.degrees[s])
        params, opt_state, loss = full_train_step(
            params, opt_state, x[nid], ops_, labels[nid],
            splan.loss_mask[s], cfg, opt)
        losses.append(loss)
    return (params, opt_state,
            torch.stack(losses) if losses
            else torch.zeros(0, device=x.device))


@torch.no_grad()
def full_predict(params, x, ops_: FullGraphOperands,
                 cfg: GNNConfig) -> torch.Tensor:
    return full_forward(params, x, ops_, cfg)


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
    for s in range(perm.shape[0]):
        bids, smask = perm[s], slot_mask[s]
        pack = plan_batch(plan, bids, smask)
        ids64 = bids.long()
        y = bk.vq_apply(params_l, acts[ids64], None, pack, vq_state,
                        degrees, cb_cfg, act, fi, fo, inject=False)
        out.index_copy_(0, torch.where(smask > 0, ids64, n), y)
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


@torch.no_grad()
def vq_serve_batch_rows(params: list[Params], vq_states: list[LayerVQState],
                        plan: EpochPlan, bids: torch.Tensor, x: torch.Tensor,
                        degrees: torch.Tensor, cfg: GNNConfig, *,
                        mesh) -> torch.Tensor:
    """Throughput-mode twin of :func:`vq_serve_batch`, one rank's part
    (the serving mesh without a row-sharded state, the reference's
    ``serve_batch_spec``): the ids arrive replicated and every rank plans
    the whole batch, then at every layer computes its b/ndev target rows
    (``vq_apply(rows=)``) from the whole batch's activations and
    all-gathers the rows in rank order, so each in-batch neighbour is read
    as the unsharded step reads it.  Returns the whole [b, f_out] output
    on every rank: the unsharded step's rows."""
    pack = plan_batch(plan, bids)
    rows = serve_rows(pack.b, mesh)
    bk = backbone(cfg.backbone)
    cb_cfg = cfg.layer_codebook_cfg()
    h = x[bids.long()]
    for l, (p, vq, (fi, fo)) in enumerate(
            zip(params, vq_states, _layer_out_dims(cfg))):
        y = bk.vq_apply(p, h, None, pack, vq, degrees, cb_cfg,
                        _act_for_layer(cfg, l), fi, fo, inject=False,
                        rows=rows)
        h = collectives.all_gather_rows(y.contiguous(), mesh)
    return h


# ---------------------------------------------------------------------------
# row-sharded inference / serving bodies (DESIGN.md section 14)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _vq_infer_layer_body_sharded(params_l: Params, vq_state: LayerVQState,
                                 plan: EpochPlan, perm: torch.Tensor,
                                 slot_mask: torch.Tensor, acts: torch.Tensor,
                                 degrees: torch.Tensor, *, cfg: GNNConfig,
                                 layer: int, mesh, n_global: int,
                                 compress: bool = False) -> torch.Tensor:
    """Row-sharded twin of :func:`_vq_infer_layer_body`, one rank's part.

    ``plan`` / ``acts`` are this rank's row blocks of the padded global
    tables and ``perm`` / ``slot_mask`` its slice of the SCAN axis: each
    rank sweeps S/ndev whole batches, so every batch computes with its
    full-batch in-batch positions and the result equals the unsharded
    executor's, while compute and activation storage split ndev ways.
    Batch outputs scatter cross-shard into this rank's block (written in
    place, one parked row past its end); wrap-padded and all-masked
    (scan-padding) slots go to the sacrificial global row ``n_global``,
    which lives inside the padded table and is never read back.  Every
    rank must sweep the same number of batches (``_pad_scan_axis``)."""
    bk = backbone(cfg.backbone)
    cb_cfg = cfg.layer_codebook_cfg()
    fi, fo = _layer_out_dims(cfg)[layer]
    act = _act_for_layer(cfg, layer)
    out = torch.zeros((acts.shape[0] + 1, fo), dtype=acts.dtype,
                      device=acts.device)
    for s in range(perm.shape[0]):
        bids, smask = perm[s], slot_mask[s]
        pack = plan_batch_sharded(plan, bids, mesh, smask)
        x_b = gather_from_shards(acts, bids, mesh, compress=compress)
        y = bk.vq_apply(params_l, x_b, None, pack, vq_state, degrees,
                        cb_cfg, act, fi, fo, inject=False)
        dst = torch.where(smask > 0, bids.long(), n_global)
        shard_scatter_rows_(out, dst, y, mesh)
    return out[:-1]


@torch.no_grad()
def _vq_infer_layer_sharded(params_l: Params, vq_state: LayerVQState,
                            plan: EpochPlan, perm: torch.Tensor,
                            slot_mask: torch.Tensor, acts: torch.Tensor,
                            degrees: torch.Tensor, *, cfg: GNNConfig,
                            layer: int, mesh, n_global: int,
                            inductive: bool = False, compress: bool = False
                            ) -> tuple[torch.Tensor, LayerVQState]:
    """Row-sharded twin of :func:`vq_infer_layer`, one rank's part.  The
    inductive refresh assigns this rank's LOCAL activation rows
    (``assign_features_only`` is row-wise: it whitens with the codebook's
    stored moments; one ``vq_assign`` launch), all-gathers the ranks'
    assignment stripes in rank order into the replicated global table
    and drops the pad rows, so every rank derives the same state."""
    if inductive:
        fi, _ = _layer_out_dims(cfg)[layer]
        assign_loc = cbm.assign_features_only(
            vq_state.codebook, acts, fi, cfg.layer_codebook_cfg())
        a = collectives.all_gather(assign_loc, mesh)    # [ndev, nb, n_loc]
        assign = a.transpose(0, 1).reshape(a.shape[1], -1)[:, :n_global]
        vq_state = refresh_assignment(
            vq_state, torch.arange(n_global, dtype=torch.int32,
                                   device=acts.device), assign)
    out = _vq_infer_layer_body_sharded(
        params_l, vq_state, plan, perm, slot_mask, acts, degrees, cfg=cfg,
        layer=layer, mesh=mesh, n_global=n_global, compress=compress)
    return out, vq_state


@torch.no_grad()
def _vq_serve_body_sharded(params: list[Params],
                           vq_states: list[LayerVQState], plan: EpochPlan,
                           bids: torch.Tensor, x: torch.Tensor,
                           degrees: torch.Tensor, cfg: GNNConfig, *, mesh,
                           compress: bool = False) -> torch.Tensor:
    """Row-sharded twin of :func:`vq_serve_batch`, one rank's part: the
    request ids arrive REPLICATED, the batch's plan rows and feature rows
    are gathered cross-shard from the ranks' blocks, and every rank runs
    the same full-batch probe-free forward -- equal to the unsharded
    serving step, the mesh buying graph-state capacity (the O(b * L)
    serving compute is replicated)."""
    bids = bids.to(device=x.device, dtype=torch.int32)
    pack = plan_batch_sharded(plan, bids, mesh)
    x_b = gather_from_shards(x, bids, mesh, compress=compress)
    out, _ = vq_forward(params, x_b, None, pack, vq_states, degrees, cfg,
                        inject=False)
    return out
