"""The program under test, as the benchmark drives it: the PyTorch port
``repro_torch`` built from the raw inputs through its own entry points
(``build_graph``, ``build_epoch_plan``, ``GNNConfig``, ``rmsprop``), with
the weights and VQ state the benchmark drew put into its containers."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.codebook import CodebookConfig, CodebookState
from repro_torch.core.conv import LayerVQState
from repro_torch.graph.batching import build_epoch_plan
from repro_torch.graph.structure import build_graph
from repro_torch.kernels import ops as kops
from repro_torch.models import gnn
from repro_torch.train.optimizer import rmsprop


class Program(NamedTuple):
    cfg: gnn.GNNConfig
    plan: object                 # EpochPlan
    x: torch.Tensor
    labels: torch.Tensor
    train_mask: torch.Tensor
    degrees: torch.Tensor
    opt: object                  # Optimizer


def gnn_config(cfg: dict) -> gnn.GNNConfig:
    m, g, cb = cfg["model"], cfg["graph"], cfg["codebook"]
    return gnn.GNNConfig(
        backbone=m["backbone"], f_in=g["f_in"], hidden=m["hidden"],
        n_out=g["n_classes"], n_layers=m["n_layers"],
        heads=m.get("heads", 4), task="node", multilabel=False,
        grad_inject=m["grad_inject"],
        codebook=CodebookConfig(k=cb["k"], f_prod=cb["f_prod"],
                                gamma=cb["gamma"], beta=cb["beta"],
                                eps=cb["eps"], whiten=True,
                                revive_threshold=cb["revive_threshold"]))


def build(cfg: dict, raw, device) -> Program:
    """The program's graph tables and optimizer for a raw graph."""
    if cfg["precision"] != "fp32":
        raise ValueError(f"unsupported precision {cfg['precision']!r}")
    kops.configure_kernel_precision("fp32", reset=True)
    g = build_graph(raw.src, raw.dst, raw.n, raw.features, raw.labels,
                    (raw.train_idx, raw.val_idx, raw.test_idx))
    plan = build_epoch_plan(g, cfg["graph"]["deg_cap"], device=device)
    mask = np.zeros(raw.n, np.float32)
    mask[raw.train_idx] = 1.0
    opt = cfg["optimizer"]
    return Program(
        gnn_config(cfg), plan, torch.from_numpy(raw.features).to(device),
        torch.from_numpy(raw.labels).to(device),
        torch.from_numpy(mask).to(device),
        torch.from_numpy(g.degrees()).to(device),
        rmsprop(opt["lr"], alpha=opt["alpha"], eps=opt["eps"]))


def vq_states(states: list[dict], k: int) -> list[LayerVQState]:
    """The benchmark's VQ states in the program's containers (the
    histogram of each table counted here)."""
    out = []
    for st in states:
        nb, n = st["table"].shape
        flat = st["table"].long() \
            + k * torch.arange(nb, device=st["table"].device)[:, None]
        counts = torch.bincount(flat.reshape(-1), minlength=nb * k)
        out.append(LayerVQState(
            CodebookState(st["codewords_w"].clone(),
                          st["cluster_size"].clone(),
                          st["cluster_sum"].clone(), st["mean"].clone(),
                          st["var"].clone(),
                          torch.zeros((), dtype=torch.int32,
                                      device=st["table"].device)),
            st["table"].clone(), counts.float().reshape(nb, k)))
    return out


def train_epoch(prog: Program, params, states, opt_state, ids, slot_mask):
    return gnn.vq_train_epoch(params, states, opt_state, prog.plan, ids,
                              slot_mask, prog.x, prog.labels,
                              prog.train_mask, prog.degrees, prog.cfg,
                              prog.opt)


def infer_pass(prog: Program, params, states, ids, slot_mask):
    return gnn.vq_infer_epoch(params, states, prog.plan, ids, slot_mask,
                              prog.x, prog.degrees, prog.cfg, inductive=True)
