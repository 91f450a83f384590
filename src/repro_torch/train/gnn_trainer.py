"""GNN training harness: the paper's training regimes on one API, and
mini-batched codeword inference.

Torch twin of ``repro.train.gnn_trainer``:

  train_full     -- the "Full-Graph" oracle rows of Table 4 (Adam);
  train_vq       -- VQ-GNN, mini-batched, streaming codebooks (RMSprop, lr
                    3e-3, App. F) over the reference's own batches: the
                    same numpy ``rng.permutation`` -> ``epoch_slices``
                    stream (or the caller's ``batch_fn``), so both
                    packages see the same batches for a seed.  The node
                    task runs one ``vq_train_epoch`` per epoch (with
                    ``mesh=``, data-parallel over the ranks of a process
                    group; with ``shard_graph=`` too, on row-sharded node
                    tables); ``REPRO_EPOCH_EXECUTOR=0`` and the link task
                    (whose positive pairs are mined on the host, batch by
                    batch) step the batches from the host, each packed
                    there (``make_pack``);
  train_sampler  -- the NS-SAGE / LABOR / Cluster-GCN / GraphSAINT-RW
                    baselines: each epoch pre-sampled on the host
                    (``sample_epoch``), stacked (``pack_sampler_epoch``)
                    and run by ``sampler_train_epoch``;
                    ``REPRO_SAMPLER_EXECUTOR=0`` and the link task step
                    the batches one by one from the host instead;
  train_hybrid   -- the VQ/sampling hybrid: LABOR-widened batches on the
                    unchanged VQ epoch;
  train_scenario -- one front for every scale method
                    (``REPRO_SCALE_METHOD`` picks the default);
  vq_inference   -- layer-synchronous codeword inference over static
                    wrap-padded batches (``vq_infer_epoch``), optionally
                    inductive; ``REPRO_INFER_EXECUTOR=0`` runs the eager
                    per-batch loop (``eager_inference_loop``) instead.

Each trainer returns the reference's result dict (history of val/test
metrics, params, the Table 3 memory model, ...) plus the per-step losses
and the per-epoch wall seconds (the sampler's split into host sampling,
packing and device steps).  Every entry point runs on the card unless
``device="cpu"`` is passed.  Every backbone of ``BACKBONES`` (GCN, SAGE,
GIN, GAT, the Graph Transformer) and both tasks (node classification,
link prediction scored by Hits@50) run through each of them, except the
hybrid, which is node-task only as in the reference.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import hostenv
from repro_torch.core import codebook as cbm
from repro_torch.core.conv import MinibatchPack, refresh_assignment
from repro_torch.distributed.data_parallel import (ShardedGraphState,
                                                   vq_train_epoch_dp,
                                                   vq_train_epoch_sharded)
from repro_torch.distributed.quantization import dtype_nbits
from repro_torch.graph.batching import (build_epoch_plan, epoch_slices,
                                        full_operands, inference_slices,
                                        make_pack, minibatch_stream,
                                        pack_sampler_epoch, pad_bucket,
                                        plan_batch, subgraph_operands)
from repro_torch.graph.sampling import (SAMPLER_METHODS, hybrid_epoch_batches,
                                        partition_graph, sample_epoch)
from repro_torch.graph.structure import Graph
from repro_torch.models.gnn import (GNNConfig, _act_for_layer,
                                    _layer_out_dims, full_predict,
                                    full_train_step, hits_at_k, init_gnn,
                                    init_vq_states, node_metric,
                                    sampler_train_epoch, vq_infer_epoch,
                                    vq_train_epoch, vq_train_step)
from repro_torch.kernels import ops as kops
from repro_torch.nn.gnn_layers import backbone
from repro_torch.runtime import resolve_device
from repro_torch.train.optimizer import adam, rmsprop


def _labels(g: Graph, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(g.labels)).to(dev)


def _eval_full(params, g: Graph, cfg: GNNConfig, x: torch.Tensor,
               ops) -> dict:
    """Val/test metric of the exact full-graph forward."""
    out = full_predict(params, x, ops, cfg)
    labels = _labels(g, x.device)
    res = {}
    for split, idx in (("val", g.val_idx), ("test", g.test_idx)):
        i = torch.from_numpy(np.asarray(idx)).to(x.device).long()
        res[split] = float(node_metric(out[i], labels[i], cfg.multilabel))
    return res


def _eval_link(params, g: Graph, cfg: GNNConfig, x: torch.Tensor,
               ops) -> dict:
    """Val/test Hits@50 of the exact full-graph embeddings: the pairs are
    scored on the embeddings' device and only the scores are copied to
    the host."""
    emb = full_predict(params, x, ops, cfg)

    def scores(pairs: np.ndarray) -> np.ndarray:
        p = torch.from_numpy(np.asarray(pairs, np.int64)).to(emb.device)
        return torch.sum(emb.index_select(0, p[:, 0])
                         * emb.index_select(0, p[:, 1]), -1).cpu().numpy()
    return {
        "val": hits_at_k(scores(g.val_edges), scores(g.val_neg_edges)),
        "test": hits_at_k(scores(g.test_edges), scores(g.test_neg_edges)),
    }


def _evaluate(params, g: Graph, cfg: GNNConfig, x: torch.Tensor,
              ops) -> dict:
    return (_eval_link if cfg.task == "link" else _eval_full)(
        params, g, cfg, x, ops)


# ---------------------------------------------------------------------------
# memory accounting (paper Table 3: bytes materialized per mini-batch)
# ---------------------------------------------------------------------------

def vq_batch_bytes(b: int, deg: int, f: int, L: int, k: int,
                   f_prod: int = 4, f_grad: Optional[int] = None,
                   precision: Optional[str] = None) -> int:
    """VQ-GNN per-batch device bytes: batch features/acts + packed
    neighbor lists + codebooks (their actual ``branch_layout``) +
    reconstructed context messages.  ``f_grad`` defaults to ``f`` (the
    Z-level gradient codewords of the fixed-convolution backbones).
    ``precision`` (a tier of ``kops.PRECISIONS``; default fp32) sizes the
    codeword tables the kernels read under it -- int8 / fp8 tables at 8
    bits through ``dtype_nbits``, plus their f32 per-channel scales."""
    f_grad = f if f_grad is None else f_grad
    n_branches, fb, gb = cbm.branch_layout(f, f_grad, f_prod)
    pack = b * deg * 4 * 6                     # ids/mask/pos x2 directions
    acts = L * b * f * 4
    cw_dtype = None if precision is None \
        else kops.precision_codeword_dtype(precision)
    if cw_dtype is None:
        books = L * n_branches * k * (fb + gb) * 4
    else:
        bits = L * n_branches * k * (fb + gb) * dtype_nbits(cw_dtype)
        books = (bits + 7) // 8 \
            + L * n_branches * (fb + gb) * 4   # f32 per-channel scales
    recon = b * deg * f * 4                    # reconstructed neighbors
    return pack + acts + books + recon


def subgraph_batch_bytes(n_sub: int, m_sub: int, f: int, L: int) -> int:
    """Sampler per-batch bytes: subgraph features+acts+edges."""
    return n_sub * f * 4 * L + m_sub * 2 * 8


def messages_per_batch_vq(g: Graph, b: int) -> float:
    """Paper Sec. 4: VQ preserves ALL messages to the batch: b*d of them."""
    return b * float(g.m) / g.n


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

def train_full(g: Graph, cfg: GNNConfig, *, epochs: int, lr: float = 1e-2,
               seed: int = 0, eval_every: int = 10,
               device: str | torch.device = "cuda") -> dict:
    """Exact message passing over the whole graph, Adam(lr).  The link
    task scores the message edges (``g.train_edges``) against as many
    uniform node pairs, drawn each epoch from the numpy ``rng`` of
    ``seed``.  Besides the reference's keys the result holds
    ``step_losses`` [epochs] (numpy)."""
    dev = resolve_device(device)
    ops = full_operands(g, device=dev, stripe_index=True)
    x = torch.from_numpy(g.features).to(dev)
    labels = _labels(g, dev)
    params = init_gnn(cfg, torch.Generator().manual_seed(seed), device=dev)
    opt = adam(lr)
    ost = opt.init(params)
    mask_np = np.zeros(g.n, np.float32)
    mask_np[g.train_idx] = 1.0
    mask = torch.from_numpy(mask_np).to(dev)
    rng = np.random.default_rng(seed)
    pos = None if cfg.task != "link" else \
        torch.from_numpy(np.asarray(g.train_edges, np.int64)).to(dev)
    hist, losses, t0 = [], [], time.time()
    for ep in range(epochs):
        if cfg.task == "link":
            e = g.train_edges
            neg = np.stack([rng.integers(0, g.n, len(e)),
                            rng.integers(0, g.n, len(e))], 1)
            params, ost, loss = full_train_step(
                params, ost, x, ops, labels, mask, cfg, opt,
                neg_pairs=torch.from_numpy(neg).to(dev), pos_pairs=pos)
        else:
            params, ost, loss = full_train_step(params, ost, x, ops, labels,
                                                mask, cfg, opt)
        losses.append(loss)
        if (ep + 1) % eval_every == 0 or ep == epochs - 1:
            m = _evaluate(params, g, cfg, x, ops)
            hist.append({"epoch": ep + 1, "time": time.time() - t0, **m})
    return {"history": hist, "final": hist[-1], "params": params,
            "mem_bytes": g.n * g.f * 4 * cfg.n_layers + g.m * 16,
            "step_losses": torch.stack(losses).cpu().numpy()}


def _pack_to(pack: MinibatchPack, dev: torch.device) -> MinibatchPack:
    """A host-built pack's tensors on ``dev`` (no stripe index: the host
    loops pack without one)."""
    return pack._replace(**{
        f: getattr(pack, f).to(dev) for f in MinibatchPack._fields
        if isinstance(getattr(pack, f), torch.Tensor)})


def _positive_pairs(g: Graph, nodes: np.ndarray,
                    positions: np.ndarray) -> np.ndarray:
    """The message edges (``g.train_edges``) with both ends among
    ``nodes``, as [e, 2] pairs of their ``positions``, in edge order."""
    inb = np.full(g.n, -1)
    inb[nodes] = positions
    e = g.train_edges
    sel = (inb[e[:, 0]] >= 0) & (inb[e[:, 1]] >= 0)
    return np.stack([inb[e[sel, 0]], inb[e[sel, 1]]], 1)


def _batch_pairs(g: Graph, bidx: np.ndarray, slot_mask: np.ndarray,
                 rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """One link batch's (positive, negative) pairs of batch positions, as
    the reference mines them: the message edges with both ends on a real
    slot (wrap-padded tail slots are nodes already supervised earlier in
    the epoch), a fixed (0, 0) pair twice when fewer than two are found,
    and as many negatives drawn uniformly over the real slots."""
    slots = np.arange(len(bidx))[slot_mask > 0]
    pos = _positive_pairs(g, bidx[slots], slots)
    if len(pos) < 2:
        pos = np.zeros((2, 2), np.int64)
    neg = slots[rng.integers(0, len(slots), pos.shape)]
    return pos, neg


def train_vq(g: Graph, cfg: GNNConfig, *, epochs: int, batch_size: int,
             lr: float = 3e-3, seed: int = 0, eval_every: int = 10,
             deg_cap: Optional[int] = None, mesh=None,
             shard_graph: bool = False,
             batch_fn: Optional[Callable] = None,
             device: str | torch.device = "cuda") -> dict:
    """VQ-GNN training (Alg. 1), one device, in the active precision tier
    (``kops.configure_kernel_precision``): under a quantized tier the VQ
    states start in its storage (uint8 or packed tables, an int8 / fp8
    codeword snapshot) and every step requantizes the snapshot after the
    codebook update.

    Node task: the graph is packed once into an ``EpochPlan``; each epoch
    draws one ``rng.permutation`` (numpy, ``seed``) and runs
    ``vq_train_epoch`` over its ``epoch_slices`` (wrap-padded tail slots
    are loss-masked).  ``REPRO_EPOCH_EXECUTOR=0`` steps the same batches
    from the host instead, each packed there (``make_pack``); both give
    the same steps.  Link task: always the host loop, over
    ``minibatch_stream``'s batches, the pairs of each mined on the host
    (``_batch_pairs``: one negative draw per batch after the epoch's
    permutation, the reference's order).  Params come from ``seed``, the
    VQ states from ``seed + 1``.  Besides the reference's keys the result
    holds ``step_losses`` [epochs * S] and ``step_vq_errs`` [epochs * S,
    L] (numpy), ``epoch_s``, each epoch's wall seconds up to its losses
    reaching the host, and on the host loop ``pack_s``, each epoch's
    host seconds of packing, pair mining and enqueueing the copies.

    ``batch_fn`` (node task) replaces the epoch's batches:
    ``batch_fn(rng) -> (ids [S, b'], slot_mask [S, b'])`` with distinct ids
    in each row -- the hook of ``train_hybrid``.

    ``mesh`` (a :class:`~repro_torch.distributed.sharding.GraphMesh`;
    every rank of it calls ``train_vq`` with the same arguments, on the
    mesh's device) runs each epoch data-parallel
    (``vq_train_epoch_dp``: each rank trains on b/ndev columns of every
    batch).  ``shard_graph`` (requires ``mesh``) also row-shards every
    node table (plan, features, labels, train mask) over the ranks,
    built once a run (``vq_train_epoch_sharded``); it computes what the
    replicated run at the same mesh size does.  Every rank returns the
    same params and states."""
    if batch_fn is not None and cfg.task != "node":
        raise ValueError("batch_fn= is a node-task batch-construction "
                         "hook (link pair mining is per-batch host work)")
    use_epoch = (cfg.task == "node"
                 and hostenv.env_knob("REPRO_EPOCH_EXECUTOR", "1") != "0")
    if batch_fn is not None and mesh is not None:
        # the data-parallel split assumes the fixed epoch_slices batch
        # width; sampler-widened rows would break its divisibility contract
        raise ValueError("batch_fn= and mesh= are mutually exclusive")
    if mesh is not None and not use_epoch:
        # never fall back to single-device training when the caller asked
        # for data parallelism
        raise ValueError(
            "mesh= (data parallelism over the ranks) requires the epoch "
            "executor: node task and REPRO_EPOCH_EXECUTOR != 0")
    if shard_graph and mesh is None:
        raise ValueError(
            "shard_graph=True row-shards the node tables over a mesh -- "
            "pass mesh= (graph_dp_mesh) as well")
    if mesh is not None:
        # epoch_slices' pool clamp, reported against the caller's numbers
        eff_b = min(batch_size, g.n)
        nd = mesh.world_size
        if eff_b % nd != 0:
            raise ValueError(
                f"effective batch size {eff_b} (batch_size={batch_size} "
                f"clamped to the {g.n}-node pool) is not divisible by the "
                f"data mesh size {nd} -- each mesh rank trains on "
                f"b/{nd} rows of every batch"
                + (f"; with shard_graph it also owns a contiguous "
                   f"1/{nd} row block of the node tables (padded to a "
                   f"multiple of {nd} rows internally), so only the "
                   f"batch size needs adjusting: pick a multiple of {nd}"
                   if shard_graph else ""))
    dev = mesh.device if mesh is not None else resolve_device(device)
    ops = full_operands(g, device=dev, stripe_index=True)
    x = torch.from_numpy(g.features).to(dev)
    labels = _labels(g, dev)
    params = init_gnn(cfg, torch.Generator().manual_seed(seed), device=dev)
    vq = init_vq_states(cfg, g.n, torch.Generator().manual_seed(seed + 1),
                        device=dev)
    opt = rmsprop(lr)   # paper App. F: RMSprop for VQ-GNN
    ost = opt.init(params)
    rng = np.random.default_rng(seed)
    train_mask = np.zeros(g.n, np.float32)
    train_mask[g.train_idx] = 1.0
    tm = torch.from_numpy(train_mask).to(dev)
    plan = build_epoch_plan(g, deg_cap, full_ops=ops, device=dev) \
        if use_epoch else None
    # built once a run, like the plan: the epochs ship only [S, b] ids;
    # ops / x stay whole for the full-graph evaluation
    sstate = ShardedGraphState(mesh, plan, x, ops.degrees, labels=labels,
                               train_mask=tm) if shard_graph else None

    def host_step(pack, bids, **kw):
        nonlocal params, vq, ost
        params, vq, ost, loss, _, e = vq_train_step(
            params, vq, ost, pack, x[bids], labels[bids], ops.degrees, cfg,
            opt, **kw)
        return loss, e

    def host_epoch() -> tuple[list, list, float]:
        """One epoch stepped from the host: (losses, VQ errors, host
        seconds of packing and mining)."""
        ls, es, packing = [], [], 0.0
        if cfg.task == "node":
            ids, smask = (batch_fn(rng) if batch_fn is not None else
                          epoch_slices(rng.permutation(np.arange(g.n)),
                                       batch_size))
            for s in range(ids.shape[0]):
                t = time.time()
                bidx = np.asarray(ids[s])
                pack = make_pack(g, bidx, deg_cap, slot_mask=smask[s],
                                 device=dev)
                lm = torch.from_numpy(train_mask[bidx] * smask[s]).to(dev)
                packing += time.time() - t
                loss, e = host_step(pack, pack.batch_ids.long(),
                                    loss_mask=lm)
                ls.append(loss)
                es.append(e)
            return ls, es, packing
        stream = minibatch_stream(g, batch_size, rng, deg_cap=deg_cap,
                                  device="cpu")
        while True:
            t = time.time()
            pack = next(stream, None)
            if pack is None:
                return ls, es, packing
            pos, neg = _batch_pairs(g, pack.batch_ids.numpy(),
                                    pack.slot_mask.numpy(), rng)
            pack = _pack_to(pack, dev)
            pos_d = torch.from_numpy(pos).to(dev)
            neg_d = torch.from_numpy(neg).to(dev)
            packing += time.time() - t
            loss, e = host_step(pack, pack.batch_ids.long(),
                                pos_pairs=pos_d, neg_pairs=neg_d)
            ls.append(loss)
            es.append(e)

    hist, t0 = [], time.time()
    losses, errs, epoch_s, pack_s = [], [], [], []
    vq_errs = None
    for ep in range(epochs):
        te = time.time()
        if use_epoch:
            ids, smask = (batch_fn(rng) if batch_fn is not None else
                          epoch_slices(rng.permutation(np.arange(g.n)),
                                       batch_size))
            ids_d = torch.from_numpy(ids.astype(np.int32)).to(dev)
            smask_d = torch.from_numpy(smask).to(dev)
            if sstate is not None:
                params, vq, ost, ls, es = vq_train_epoch_sharded(
                    sstate, params, vq, ost, ids_d, smask_d, cfg, opt)
            elif mesh is not None:
                params, vq, ost, ls, es = vq_train_epoch_dp(
                    mesh, params, vq, ost, plan, ids_d, smask_d, x, labels,
                    tm, ops.degrees, cfg, opt)
            else:
                params, vq, ost, ls, es = vq_train_epoch(
                    params, vq, ost, plan, ids_d, smask_d, x, labels, tm,
                    ops.degrees, cfg, opt)
        else:
            ls, es, packing = host_epoch()
            pack_s.append(packing)
            ls = torch.stack(ls) if ls else torch.zeros(0, device=dev)
            es = torch.stack(es) if es \
                else torch.zeros((0, cfg.n_layers), device=dev)
        losses.append(ls.cpu().numpy())
        errs.append(es.cpu().numpy())
        epoch_s.append(time.time() - te)
        if es.shape[0]:
            vq_errs = errs[-1][-1]
        if (ep + 1) % eval_every == 0 or ep == epochs - 1:
            m = _evaluate(params, g, cfg, x, ops)
            # whitened-space VQ relative error of the last batch, emitted
            # by the fused update kernel (no extra distance computation)
            if vq_errs is not None:
                m["vq_err"] = float(np.mean(vq_errs))
            hist.append({"epoch": ep + 1, "time": time.time() - t0, **m})
    deg = deg_cap or g.max_degree()
    fi0, fo0 = _layer_out_dims(cfg)[0]
    f_grad = backbone(cfg.backbone).f_grad(fi0, fo0, heads=cfg.heads)
    return {"history": hist, "final": hist[-1], "params": params,
            "vq_states": vq, "opt_state": ost,
            "mem_bytes": vq_batch_bytes(
                batch_size, deg, cfg.hidden, cfg.n_layers, cfg.codebook.k,
                f_prod=cfg.layer_codebook_cfg().f_prod, f_grad=f_grad,
                precision=kops.kernel_precision()),
            "messages": messages_per_batch_vq(g, batch_size),
            "step_losses": np.concatenate(losses),
            "step_vq_errs": np.concatenate(errs), "epoch_s": epoch_s,
            **({} if use_epoch else {"pack_s": pack_s})}


SAMPLER_MAX_PAIRS = 4096      # a link step's static pair-list size


def _subgraph_pairs(g: Graph, nodes: np.ndarray, rng: np.random.Generator,
                    dev: torch.device) -> Optional[dict]:
    """A sampled subgraph's link pairs, as the reference mines them: the
    message edges with both ends in the subgraph (local positions), the
    first SAMPLER_MAX_PAIRS of them padded to that size under a pair mask,
    and as many negatives drawn uniformly over the subgraph's nodes; None
    below two positive pairs (the step is skipped)."""
    n_real = len(nodes)
    pos = _positive_pairs(g, nodes, np.arange(n_real))
    if len(pos) < 2:
        return None
    pos = pos[:SAMPLER_MAX_PAIRS]
    pmask = np.zeros(SAMPLER_MAX_PAIRS, np.float32)
    pmask[:len(pos)] = 1.0
    pos = np.concatenate(
        [pos, np.zeros((SAMPLER_MAX_PAIRS - len(pos), 2), np.int64)])
    neg = rng.integers(0, n_real, pos.shape)

    def put(a):
        return torch.from_numpy(a).to(dev)
    return {"neg_pairs": put(neg), "pos_pairs": put(pos),
            "pair_mask": put(pmask)}


def train_sampler(g: Graph, cfg: GNNConfig, method: str, *, epochs: int,
                  batch_size: int, lr: float = 1e-3, seed: int = 0,
                  eval_every: int = 10, fanout: int = 5,
                  walk_length: int = 3, n_parts: int = 32,
                  fanouts: Optional[list] = None,
                  parts_per_batch: Optional[int] = None,
                  device: str | torch.device = "cuda") -> dict:
    """Sampling-baseline training (Adam); ``method`` in ``SAMPLER_METHODS``
    (ns-sage / labor / cluster-gcn / graphsaint-rw).

    Every epoch is pre-sampled on the host into one batch list
    (``sample_epoch``, numpy ``rng`` from ``seed``: the reference's
    stream), stacked into a padded [S, P, ...] plan on the device
    (``pack_sampler_epoch``) and run by ``sampler_train_epoch``.
    ``REPRO_SAMPLER_EXECUTOR=0`` runs the same batches one by one from the
    host instead, each padded to its own ``pad_bucket``; padding rows are
    message- and loss-neutral, so both give the same losses.  The link
    task always takes the host loop: each subgraph's pairs are mined there
    (``_subgraph_pairs``: at most SAMPLER_MAX_PAIRS, a subgraph with fewer
    than two skipped).  ``fanouts``
    overrides the uniform ``fanout``; ``parts_per_batch`` the Cluster-GCN
    default ``max(1, n_parts // 8)``.

    Besides the reference's keys the result holds ``opt_state`` and, per
    epoch, ``sample_s`` (host sampling), ``pack_s`` (stacking the epoch and
    copying it to the device), ``train_s`` (the steps, up to their losses
    reaching the host) and ``subgraph_rows`` (the padded rows of its
    largest subgraph: the source rows of its SpMMs)."""
    if method not in SAMPLER_METHODS:
        raise ValueError(f"unknown sampler {method!r}; expected one of "
                         f"{SAMPLER_METHODS}")
    dev = resolve_device(device)
    ops = full_operands(g, device=dev, stripe_index=True)
    x = torch.from_numpy(g.features).to(dev)
    labels_np = np.asarray(g.labels)
    labels = _labels(g, dev)
    params = init_gnn(cfg, torch.Generator().manual_seed(seed), device=dev)
    opt = adam(lr)
    ost = opt.init(params)
    rng = np.random.default_rng(seed)
    part = partition_graph(g, n_parts, rng) if method == "cluster-gcn" \
        else None
    fanouts = list(fanouts) if fanouts is not None \
        else [fanout] * cfg.n_layers
    ppb = parts_per_batch if parts_per_batch is not None \
        else max(1, n_parts // 8)
    deg_cap = g.max_degree()
    use_exec = (cfg.task == "node"
                and os.environ.get("REPRO_SAMPLER_EXECUTOR", "1") != "0")
    hist, t0 = [], time.time()
    losses_tr: list = []
    sample_s, pack_s, train_s, rows = [], [], [], []
    max_sub, max_msg = 0, 0
    for ep in range(epochs):
        t = time.time()
        batches = sample_epoch(g, method, batch_size=batch_size, rng=rng,
                               fanouts=fanouts, walk_length=walk_length,
                               partition=part, parts_per_batch=ppb)
        sample_s.append(time.time() - t)
        for src, _, nodes, _, _ in batches:
            max_sub = max(max_sub, len(nodes))
            max_msg = max(max_msg, len(src))
        t = time.time()
        if use_exec:
            splan = pack_sampler_epoch(batches, deg_cap, device=dev)
            rows.append(splan.p)
            pack_s.append(time.time() - t)
            t = time.time()
            params, ost, losses = sampler_train_epoch(
                params, ost, splan, x, labels, cfg, opt)
            losses_tr.append(losses.cpu().numpy())
            train_s.append(time.time() - t)
        else:
            ep_losses, packing = [], 0.0
            for src, dst, nodes, seed_pos, seed_w in batches:
                tp = time.time()
                n_real = len(nodes)
                n_pad = pad_bucket(n_real)
                sub_ops = subgraph_operands(src, dst, n_pad, deg_cap,
                                            device=dev)
                xs = torch.zeros((n_pad, g.f), dtype=torch.float32,
                                 device=dev)
                xs[:n_real] = x[torch.from_numpy(nodes).to(dev)]
                lpad = np.zeros((n_pad,) + labels_np.shape[1:],
                                labels_np.dtype)
                lpad[:n_real] = labels_np[nodes]
                mask = np.zeros(n_pad, np.float32)
                mask[seed_pos] = seed_w
                pairs = {}
                if cfg.task == "link":
                    pairs = _subgraph_pairs(g, nodes, rng, dev)
                    if pairs is None:    # fewer than two positive pairs
                        packing += time.time() - tp
                        continue
                packing += time.time() - tp
                params, ost, loss = full_train_step(
                    params, ost, xs, sub_ops, torch.from_numpy(lpad).to(dev),
                    torch.from_numpy(mask).to(dev), cfg, opt, **pairs)
                ep_losses.append(float(loss))
            losses_tr.append(np.asarray(ep_losses, np.float32))
            rows.append(max(pad_bucket(len(b[2])) for b in batches))
            pack_s.append(packing)
            train_s.append(time.time() - t - packing)
        if (ep + 1) % eval_every == 0 or ep == epochs - 1:
            m = _evaluate(params, g, cfg, x, ops)
            hist.append({"epoch": ep + 1, "time": time.time() - t0, **m})
    return {"history": hist, "final": hist[-1], "params": params,
            "opt_state": ost, "losses": losses_tr,
            "mem_bytes": subgraph_batch_bytes(max_sub, max_msg, cfg.hidden,
                                              cfg.n_layers),
            "messages": max_msg * cfg.n_layers, "sample_s": sample_s,
            "pack_s": pack_s, "train_s": train_s, "subgraph_rows": rows}


def train_hybrid(g: Graph, cfg: GNNConfig, *, epochs: int, batch_size: int,
                 lr: float = 3e-3, seed: int = 0, eval_every: int = 10,
                 deg_cap: Optional[int] = None, fanout: int = 5,
                 fanouts: Optional[list] = None,
                 n_ctx: Optional[int] = None,
                 device: str | torch.device = "cuda") -> dict:
    """VQ/sampling hybrid: ``train_vq`` over LABOR-widened batches.

    Each batch is ``batch_size`` loss-bearing seeds plus up to ``n_ctx``
    of their sampled neighbours as loss-masked context slots
    (``hybrid_epoch_batches``); ``vq_apply`` then passes the messages from
    in-batch neighbours through the exact intra-batch SpMM and only the
    rest through the codeword context.  ``n_ctx=0`` is plain ``train_vq``
    bit for bit."""
    if cfg.task != "node":
        raise ValueError("train_hybrid is node-task only (the hybrid is a "
                         "batch-construction strategy for Alg. 1)")
    fo = list(fanouts) if fanouts is not None else [fanout] * cfg.n_layers
    return train_vq(
        g, cfg, epochs=epochs, batch_size=batch_size, lr=lr, seed=seed,
        eval_every=eval_every, deg_cap=deg_cap, device=device,
        batch_fn=lambda rng: hybrid_epoch_batches(g, batch_size, fo, rng,
                                                  n_ctx=n_ctx))


SCALE_METHODS = ("full", "vq", "ns_sage", "labor", "cluster", "saint",
                 "hybrid")

_SAMPLER_OF = {"ns_sage": "ns-sage", "labor": "labor",
               "cluster": "cluster-gcn", "saint": "graphsaint-rw"}


def train_scenario(g: Graph, cfg: GNNConfig, method: Optional[str] = None,
                   *, epochs: int, batch_size: int, seed: int = 0,
                   eval_every: int = 10, lr: Optional[float] = None,
                   device: str | torch.device = "cuda", **knobs) -> dict:
    """One front for every scale method of the scenario matrix.

    ``method`` is one of ``SCALE_METHODS`` (full / vq / ns_sage / labor /
    cluster / saint / hybrid); when None it comes from
    ``REPRO_SCALE_METHOD`` (default "vq").  Knobs not passed are read from
    ``REPRO_SAMPLER_FANOUT`` (5), ``REPRO_WALK_LENGTH`` (3),
    ``REPRO_N_PARTS`` (32) and ``REPRO_HYBRID_CTX`` (``batch_size``);
    other ``knobs`` go to the trainer.  The link task runs every method
    but the hybrid, which raises (node-task only, as in the
    reference)."""
    method = method or os.environ.get("REPRO_SCALE_METHOD", "vq")
    if method not in SCALE_METHODS:
        raise ValueError(f"unknown scale method {method!r}; expected one "
                         f"of {SCALE_METHODS}")

    def env_int(name, default):
        return int(os.environ.get(name, default))

    common = dict(epochs=epochs, seed=seed, eval_every=eval_every,
                  device=device)
    if method == "full":
        return train_full(g, cfg, lr=lr or 1e-2, **common, **knobs)
    if method == "vq":
        return train_vq(g, cfg, batch_size=batch_size, lr=lr or 3e-3,
                        **common, **knobs)
    if method == "hybrid":
        knobs.setdefault("fanout", env_int("REPRO_SAMPLER_FANOUT", 5))
        knobs.setdefault("n_ctx", env_int("REPRO_HYBRID_CTX", batch_size))
        return train_hybrid(g, cfg, batch_size=batch_size, lr=lr or 3e-3,
                            **common, **knobs)
    knobs.setdefault("fanout", env_int("REPRO_SAMPLER_FANOUT", 5))
    knobs.setdefault("walk_length", env_int("REPRO_WALK_LENGTH", 3))
    knobs.setdefault("n_parts", env_int("REPRO_N_PARTS", 32))
    return train_sampler(g, cfg, _SAMPLER_OF[method], batch_size=batch_size,
                         lr=lr or 1e-3, **common, **knobs)


def vq_inference(params, vq_states, g: Graph, cfg: GNNConfig,
                 batch_size: int, *, inductive: bool = False) -> np.ndarray:
    """Layer-synchronous mini-batched inference using codeword context,
    on the device the params live on: the graph packed once into an
    ``EpochPlan``, the nodes split into static wrap-padded batches
    (``inference_slices``), every layer one sweep of ``vq_infer_epoch``.
    With ``inductive`` each layer first re-assigns every node from the
    feature half of its codebook (paper Sec. 6).  Returns [n, f_out].
    ``REPRO_INFER_EXECUTOR=0`` runs ``eager_inference_loop`` over the same
    batches instead; both write only real slots and agree to float
    tolerance."""
    dev = next(iter(params[0].values())).device
    ops = full_operands(g, device=dev)
    x = torch.from_numpy(g.features).to(dev)
    plan = build_epoch_plan(g, full_ops=ops, device=dev)
    ids, smask = inference_slices(g.n, batch_size)
    if os.environ.get("REPRO_INFER_EXECUTOR", "1") == "0":
        return eager_inference_loop(params, vq_states, plan, ids, smask, x,
                                    ops.degrees, cfg, inductive=inductive)
    acts, _ = vq_infer_epoch(
        params, vq_states, plan,
        torch.from_numpy(ids.astype(np.int32)).to(dev),
        torch.from_numpy(smask).to(dev), x, ops.degrees, cfg,
        inductive=inductive)
    return acts.cpu().numpy()


@torch.no_grad()
def eager_inference_loop(params, vq_states, plan, ids: np.ndarray,
                         smask: np.ndarray, x: torch.Tensor, degrees,
                         cfg: GNNConfig, *,
                         inductive: bool = False) -> np.ndarray:
    """The reference's pre-executor inference: one ``vq_apply`` per
    (batch, layer), each batch's output copied to a host table and the
    layer's table copied back to the device -- on the same wrap-padded
    batches (``ids`` / ``smask`` [S, b], numpy) with the same real-slot
    writes as ``vq_infer_epoch``.  Returns [n, f_out] (numpy)."""
    cb_cfg = cfg.layer_codebook_cfg()
    states = list(vq_states)
    bk = backbone(cfg.backbone)
    n, dev = plan.n, x.device
    acts = x
    for l, (fi, fo) in enumerate(_layer_out_dims(cfg)):
        st = states[l]
        if inductive:
            assign = cbm.assign_features_only(st.codebook, acts, fi, cb_cfg)
            st = refresh_assignment(
                st, torch.arange(n, dtype=torch.int32, device=dev), assign)
            states[l] = st
        out = np.zeros((n, fo), np.float32)
        for s in range(ids.shape[0]):
            bids = torch.from_numpy(ids[s].astype(np.int32)).to(dev)
            y = bk.vq_apply(params[l], acts[bids.long()], None,
                            plan_batch(plan, bids), st, degrees, cb_cfg,
                            _act_for_layer(cfg, l), fi, fo, inject=False)
            real = smask[s] > 0
            out[ids[s][real]] = y.cpu().numpy()[real]
        acts = torch.from_numpy(out).to(dev)
    return acts.cpu().numpy()
