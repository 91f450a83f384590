"""GNN training harness on one device: the full-graph oracle, VQ-GNN
training (Alg. 1) and mini-batched codeword inference.

Torch twin of the node-task, single-device half of
``repro.train.gnn_trainer``:

  train_full   -- the "Full-Graph" oracle rows of Table 4 (Adam);
  train_vq     -- VQ-GNN, mini-batched, streaming codebooks (RMSprop, lr
                  3e-3, App. F), one ``vq_train_epoch`` per epoch over the
                  reference's own batches: the same numpy
                  ``rng.permutation`` -> ``epoch_slices`` stream, so both
                  packages see the same batches for a seed;
  vq_inference -- layer-synchronous codeword inference over static
                  wrap-padded batches (``vq_infer_epoch``), optionally
                  inductive.

Each trainer returns the reference's result dict (history of val/test
metrics, params, VQ states, the Table 3 memory model) plus the per-step
losses and VQ errors and the per-epoch wall seconds.  Every entry point
runs on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import codebook as cbm
from repro_torch.distributed.quantization import dtype_nbits
from repro_torch.graph.batching import (build_epoch_plan, epoch_slices,
                                        full_operands, inference_slices)
from repro_torch.graph.structure import Graph
from repro_torch.models.gnn import (GNNConfig, _layer_out_dims, full_predict,
                                    full_train_step, init_gnn, init_vq_states,
                                    node_metric, vq_infer_epoch,
                                    vq_train_epoch)
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


def messages_per_batch_vq(g: Graph, b: int) -> float:
    """Paper Sec. 4: VQ preserves ALL messages to the batch: b*d of them."""
    return b * float(g.m) / g.n


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

def train_full(g: Graph, cfg: GNNConfig, *, epochs: int, lr: float = 1e-2,
               seed: int = 0, eval_every: int = 10,
               device: str | torch.device = "cuda") -> dict:
    """Exact message passing over the whole graph, Adam(lr)."""
    dev = resolve_device(device)
    ops = full_operands(g, device=dev)
    x = torch.from_numpy(g.features).to(dev)
    labels = _labels(g, dev)
    params = init_gnn(cfg, torch.Generator().manual_seed(seed), device=dev)
    opt = adam(lr)
    ost = opt.init(params)
    mask_np = np.zeros(g.n, np.float32)
    mask_np[g.train_idx] = 1.0
    mask = torch.from_numpy(mask_np).to(dev)
    hist, t0 = [], time.time()
    for ep in range(epochs):
        params, ost, _ = full_train_step(params, ost, x, ops, labels, mask,
                                         cfg, opt)
        if (ep + 1) % eval_every == 0 or ep == epochs - 1:
            m = _eval_full(params, g, cfg, x, ops)
            hist.append({"epoch": ep + 1, "time": time.time() - t0, **m})
    return {"history": hist, "final": hist[-1], "params": params,
            "mem_bytes": g.n * g.f * 4 * cfg.n_layers + g.m * 16}


def train_vq(g: Graph, cfg: GNNConfig, *, epochs: int, batch_size: int,
             lr: float = 3e-3, seed: int = 0, eval_every: int = 10,
             deg_cap: Optional[int] = None,
             device: str | torch.device = "cuda") -> dict:
    """VQ-GNN training (Alg. 1), node task, one device, in the active
    precision tier (``kops.configure_kernel_precision``): under a
    quantized tier the VQ states start in its storage (uint8 or packed
    tables, an int8 / fp8 codeword snapshot) and every step requantizes
    the snapshot after the codebook update.

    The graph is packed once into an ``EpochPlan``; each epoch draws one
    ``rng.permutation`` (numpy, ``seed``) and runs ``vq_train_epoch`` over
    its ``epoch_slices`` (wrap-padded tail slots are loss-masked).  Params
    come from ``seed``, the VQ states from ``seed + 1``.  Besides the
    reference's keys the result holds ``step_losses`` [epochs * S] and
    ``step_vq_errs`` [epochs * S, L] (numpy) and ``epoch_s``, each epoch's
    wall seconds up to its losses reaching the host."""
    dev = resolve_device(device)
    ops = full_operands(g, device=dev)
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
    plan = build_epoch_plan(g, deg_cap, full_ops=ops, device=dev)

    hist, t0 = [], time.time()
    losses, errs, epoch_s = [], [], []
    vq_errs = None
    for ep in range(epochs):
        te = time.time()
        ids, smask = epoch_slices(rng.permutation(np.arange(g.n)),
                                  batch_size)
        params, vq, ost, ls, es = vq_train_epoch(
            params, vq, ost, plan,
            torch.from_numpy(ids.astype(np.int32)).to(dev),
            torch.from_numpy(smask).to(dev), x, labels, tm, ops.degrees,
            cfg, opt)
        losses.append(ls.cpu().numpy())
        errs.append(es.cpu().numpy())
        epoch_s.append(time.time() - te)
        if es.shape[0]:
            vq_errs = errs[-1][-1]
        if (ep + 1) % eval_every == 0 or ep == epochs - 1:
            m = _eval_full(params, g, cfg, x, ops)
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
            "step_vq_errs": np.concatenate(errs), "epoch_s": epoch_s}


def vq_inference(params, vq_states, g: Graph, cfg: GNNConfig,
                 batch_size: int, *, inductive: bool = False) -> np.ndarray:
    """Layer-synchronous mini-batched inference using codeword context,
    on the device the params live on: the graph packed once into an
    ``EpochPlan``, the nodes split into static wrap-padded batches
    (``inference_slices``), every layer one sweep of ``vq_infer_epoch``.
    With ``inductive`` each layer first re-assigns every node from the
    feature half of its codebook (paper Sec. 6).  Returns [n, f_out]."""
    dev = next(iter(params[0].values())).device
    ops = full_operands(g, device=dev)
    x = torch.from_numpy(g.features).to(dev)
    plan = build_epoch_plan(g, full_ops=ops, device=dev)
    ids, smask = inference_slices(g.n, batch_size)
    acts, _ = vq_infer_epoch(
        params, vq_states, plan,
        torch.from_numpy(ids.astype(np.int32)).to(dev),
        torch.from_numpy(smask).to(dev), x, ops.degrees, cfg,
        inductive=inductive)
    return acts.cpu().numpy()
