"""VQ-GNN training steps (Alg. 1) and inductive whole-graph inference.

A step: the mini-batch forward through every layer with a zero probe at
each layer's output, the masked cross-entropy, one gradient of the loss
for the parameters and the probes (the probe gradients are the G rows),
RMSprop on the parameters, then each layer's codebook update from
(layer input || G) and the batch's new assignments written into the
layer's table.
"""
from __future__ import annotations

import importlib
from typing import NamedTuple

import torch

from bench.reference import graph as rgraph
from bench.reference import vq as vqm
from bench.reference.precision import Precision


class Problem(NamedTuple):
    """The inputs both sides receive, on the reference's device."""
    tables: rgraph.Tables
    x: torch.Tensor            # [n, f]
    labels: torch.Tensor       # [n]
    train_mask: torch.Tensor   # [n] f32


def problem(raw, deg_cap: int, device) -> Problem:
    """The reference's inputs from the raw graph."""
    mask = torch.zeros(raw.n, device=device)
    mask[torch.from_numpy(raw.train_idx).to(device)] = 1.0
    return Problem(rgraph.tables(raw.src, raw.dst, raw.n, deg_cap, device),
                   torch.from_numpy(raw.features).to(device),
                   torch.from_numpy(raw.labels).to(device), mask)


def backbone(name: str):
    """The reference module of backbone ``name``
    (``bench/reference/<name>.py``: ``forward``, ``probe_width``,
    ``layer_flops``)."""
    try:
        return importlib.import_module(f"bench.reference.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"bench.reference.{name}":
            raise
        raise ValueError(f"no reference for backbone {name!r}: "
                         f"bench/reference/{name}.py is missing") from e


def _forward(cfg, shapes, params, states, prob, bt, probes, prec,
             inject: bool):
    m = cfg["model"]
    bk = backbone(m["backbone"])
    h, acts = prob.x[bt.ids], []
    for l, (p, st, sh) in enumerate(zip(params, states, shapes)):
        acts.append(h)
        h = bk.forward(p, h, None if probes is None else probes[l], bt, st,
                       prob.tables.degrees, sh, cfg["codebook"],
                       l < len(shapes) - 1, inject, m.get("heads", 1), prec)
    return h, acts


def loss_and_grads(cfg, shapes, params, states, prob, bt, slot_mask, prec):
    """(loss, parameter gradients, probe gradients, layer inputs)."""
    bk = backbone(cfg["model"]["backbone"])
    heads = cfg["model"].get("heads", 1)
    b = bt.ids.shape[0]
    leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
              for p in params]
    probes = [torch.zeros((b, bk.probe_width(sh, heads)),
                          device=prob.x.device, requires_grad=True)
              for sh in shapes]
    with torch.enable_grad():
        out, acts = _forward(cfg, shapes, leaves, states, prob, bt, probes,
                             prec, cfg["model"]["grad_inject"])
        mask = prob.train_mask[bt.ids] * slot_mask
        per = -torch.log_softmax(out, -1).gather(
            1, prob.labels[bt.ids][:, None])[:, 0]
        loss = (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        flat = [v for p in leaves for v in p.values()]
        got = torch.autograd.grad(loss, flat + probes, allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g
           for t, g in zip(flat + probes, got)]
    it = iter(got[:len(flat)])
    grads = [{k: next(it) for k in p} for p in params]
    return (loss.detach(), grads, got[len(flat):],
            [a.detach() for a in acts])


def rmsprop(params, grads, nu, opt: dict):
    lr, alpha, eps = opt["lr"], opt["alpha"], opt["eps"]
    new_p, new_nu = [], []
    for p, g, v in zip(params, grads, nu):
        v2 = {k: alpha * v[k] + (1 - alpha) * g[k] * g[k] for k in p}
        new_p.append({k: p[k] - lr * g[k] / (torch.sqrt(v2[k]) + eps)
                      for k in p})
        new_nu.append(v2)
    return new_p, new_nu


def train_step(cfg, shapes, params, nu, states, prob, ids, slot_mask,
               prec: Precision, chosen: list | None = None,
               vq_rows: torch.Tensor | None = None):
    """One step on the batch ``ids``: returns (params, nu, states, loss,
    each layer's codeword ids for the batch, each layer's excess of the
    ``chosen`` ones as (``vq.excess``, ``vq.row_excess``)).  ``chosen``
    (per layer [nb, b]: another computation's choices, judged here)
    replaces the nearest codewords in the EMA and the table, so the rest
    of the step is compared on the same choices: one near-tie settled the
    other way does not move the steps after it.  ``vq_rows`` (a [b] bool
    mask; a planted fault) leaves the other rows out of the codebook
    update and the table."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bt = rgraph.batch(prob.tables, ids)
    loss, grads, gprobe, acts = loss_and_grads(cfg, shapes, params, states,
                                               prob, bt, slot_mask, prec)
    params, nu = rmsprop(params, grads, nu, cfg["optimizer"])
    n = prob.x.shape[0]
    keep = rgraph.last_slots(bt.ids, n)
    rows = slice(None) if vq_rows is None else vq_rows
    if vq_rows is not None:
        keep = keep & vq_rows
    new_states, used, gaps = [], [], []
    with torch.no_grad():
        for l, (st, a, g) in enumerate(zip(states, acts, gprobe)):
            st2, c, e = vqm.update(
                st, a[rows], g.reshape(a.shape[0], -1)[rows],
                cfg["codebook"], prec,
                None if chosen is None else chosen[l][:, rows])
            if vq_rows is not None:      # back to [nb, b]; others unused
                full = torch.zeros((c.shape[0], a.shape[0]), dtype=c.dtype,
                                   device=c.device)
                full[:, vq_rows] = c
                c = full
            table = st.table.clone()
            table[:, bt.ids[keep]] = c[:, keep]
            new_states.append(st2._replace(table=table))
            used.append(c)
            gaps.append(e)
    return params, nu, new_states, loss, used, gaps


@torch.no_grad()
def infer_pass(cfg, shapes, params, states, prob, perm: torch.Tensor,
               batch: int, prec: Precision, tables: list | None = None):
    """Inductive layer-synchronous inference over the batches of ``perm``
    (wrap-padded to whole batches): per layer, every node's assignments
    from its input features, then each batch's layer output.  Returns the
    [n, f_out] output, every layer's table and, with ``tables`` (another
    computation's per-layer choices, judged here), the largest
    ``vq.assignment_gap`` of those choices.  The layers then read the
    given tables, so the outputs are compared on the same choices: one
    near-tie settled the other way does not move every row that reads
    it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m = cfg["model"]
    bk = backbone(m["backbone"])
    eps = cfg["codebook"]["eps"]
    n = prob.x.shape[0]
    s = -(-n // batch)
    ids = torch.cat([perm, perm[:s * batch - n]]).long()
    real = torch.arange(s * batch, device=ids.device) < n
    acts, used, gap = prob.x, [], 0.0
    for l, (p, st, sh) in enumerate(zip(params, states, shapes)):
        if tables is None:
            table = vqm.assign_features(st, acts, sh.fb, eps, prec)
        else:
            table = tables[l].long().to(acts.device)
            gap = max(gap, vqm.assignment_gap(st, acts, sh.fb, eps, table))
        st = st._replace(table=table)
        used.append(table)
        out = torch.zeros((n, sh.f_out), device=acts.device)
        for i in range(s):
            bids = ids[i * batch:(i + 1) * batch]
            bt = rgraph.batch(prob.tables, bids)
            y = bk.forward(p, acts[bt.ids], None, bt, st,
                           prob.tables.degrees, sh, cfg["codebook"],
                           l < len(shapes) - 1, False, m.get("heads", 1),
                           prec)
            r = real[i * batch:(i + 1) * batch]
            out[bids[r]] = y[r]
        acts = out
    return acts, used, gap
