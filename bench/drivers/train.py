"""Training traffic: ``vq_train_epoch`` over fresh seeded permutations of
every node, split into batches of ``batch`` (the tail batch wrap-padded,
its padding masked out of the loss), with one synchronisation at each
epoch's end, as a training loop that dispatches an epoch ahead runs.

Set-up builds the program once from the raw inputs and drives that same
state through the first epoch in two calls (step 1, the rest, the padded
tail batch included), reading after step 1 the gradient norms from
RMSprop's second moment, the parameters, the VQ state and step 1's
codeword choices, and after the epoch the parameters, the VQ state and
the other steps' choices; then
one more epoch warms every shape up.  The window continues from there.
The check runs the reference over that first epoch from the same
weights, VQ state and batches.
"""
from __future__ import annotations

import statistics
import time
from typing import NamedTuple

import torch

from bench import compare, graphgen, inputs, port, roofline
from bench import work as counting
from bench.harness import Window, free, sync
from bench.reference import graph as rgraph
from bench.reference import steps as rsteps
from bench.reference import vq as rvq
from bench.reference.precision import Precision

VQ_LEAVES = ("codewords_w", "mean", "var")


class Record(NamedTuple):
    """One side's readings of the first epoch."""
    losses: list          # each step's loss
    grad_norms: list      # each parameter leaf's step-1 gradient norm
    changes: list         # each leaf's |params after the epoch - initial|
    vq_changes: list      # each VQ leaf's change over the epoch
    choices: list         # each step's codeword ids for its batch, by layer
    changes1: list        # the same two after step 1
    vq_changes1: list


def _grad_norms(nu: list[dict], alpha: float) -> list[float]:
    """Step 1's gradient norms from RMSprop's second moment after one
    step, nu = (1 - alpha) g^2."""
    return [float(torch.sqrt(v.sum() / (1 - alpha)))
            for d in nu for v in d.values()]


def _changes(after: list[dict], before: list[dict]) -> list[float]:
    return [float((after[i][k] - before[i][k]).norm())
            for i in range(len(before)) for k in before[i]]


def _choices(tables: list, ids: torch.Tensor) -> list:
    """Each layer's table entries of the nodes ``ids``."""
    return [t[:, ids.long()].long() for t in tables]


def _vq_changes(vq: list[dict], states0: list[dict]) -> list[float]:
    return [float((a[k] - b[k]).norm()) for a, b in zip(vq, states0)
            for k in VQ_LEAVES]


def _record(cfg, losses, nu1, params, params0, vq: list[dict],
            states0: list[dict], choices: list, step1: tuple) -> Record:
    """``step1``: (params, VQ state) after step 1."""
    return Record(
        [float(v) for v in losses],
        _grad_norms(nu1, cfg["optimizer"]["alpha"]),
        _changes(params, params0), _vq_changes(vq, states0), choices,
        _changes(step1[0], params0), _vq_changes(step1[1], states0))


def _port_vq(states) -> list[dict]:
    return [{"codewords_w": s.codebook.codewords_w, "mean": s.codebook.mean,
             "var": s.codebook.var, "table": s.assignment} for s in states]


def setup(ctx) -> dict:
    cfg, dev, seed = ctx.cfg, ctx.device, ctx.seed
    raw = graphgen.generate(cfg["graph"], seed)
    prog = port.build(cfg, raw, dev)
    params0, states0 = inputs.model_state(cfg, ctx.shapes, raw.n, seed, dev)
    params = [{k: v.clone() for k, v in p.items()} for p in params0]
    vq = port.vq_states(states0, cfg["codebook"]["k"])
    ost = prog.opt.init(params)
    b = ctx.traffic["batch"]
    perm = torch.randperm(raw.n, generator=inputs.generator(seed, "first",
                                                            dev), device=dev)
    ids, smask = inputs.epoch_ids(perm, b)
    params, vq, ost, l1, _ = port.train_epoch(prog, params, vq, ost,
                                              ids[:1], smask[:1])
    nu1 = ost.nu
    first = _choices([s.assignment for s in vq], ids[0])
    step1 = (params, _port_vq(vq))
    params, vq, ost, rest, _ = port.train_epoch(prog, params, vq, ost,
                                                ids[1:], smask[1:])
    # batches 2.. are disjoint (the tail's padding repeats batch 1's
    # nodes), so the tables after the epoch hold each one's choices
    record = _record(cfg, torch.cat([l1, rest]), nu1, params, params0,
                     _port_vq(vq), states0,
                     [first] + [_choices([s.assignment for s in vq], ids[i])
                                for i in range(1, ids.shape[0])], step1)
    warm = torch.randperm(raw.n, generator=inputs.generator(seed, "warm",
                                                            dev), device=dev)
    params, vq, ost, _, _ = port.train_epoch(prog, params, vq, ost,
                                             *inputs.epoch_ids(warm, b))
    return {"raw": raw, "prog": prog, "params": params, "vq": vq,
            "ost": ost, "params0": params0, "states0": states0,
            "first": (ids, smask), "record": record,
            "trace_gen": inputs.generator(seed, "trace", dev),
            "trace_ids": []}


def _epoch(ctx, state, gen) -> tuple[torch.Tensor, torch.Tensor]:
    perm = torch.randperm(state["raw"].n, generator=gen, device=ctx.device)
    return inputs.epoch_ids(perm, ctx.traffic["batch"])


def _train(state, ids, smask) -> torch.Tensor:
    state["params"], state["vq"], state["ost"], losses, _ = port.train_epoch(
        state["prog"], state["params"], state["vq"], state["ost"], ids,
        smask)
    return losses


def window(ctx, state, seconds: float) -> Window:
    gen = inputs.generator(ctx.seed, "window", ctx.device)
    calls, bad, epochs = [], torch.zeros((), device=ctx.device), 0
    n = state["raw"].n
    sync(ctx.device)
    t0 = time.perf_counter()
    while True:
        ids, smask = _epoch(ctx, state, gen)
        tc = time.perf_counter()
        losses = _train(state, ids, smask)
        calls.append(time.perf_counter() - tc)
        bad += (~torch.isfinite(losses)).sum()
        sync(ctx.device)
        epochs += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    steps = ids.shape[0]
    return Window({"train_nodes_per_s": epochs * n / elapsed},
                  epochs * steps, int(bad), elapsed, epochs, calls, steps)


def trace_iteration(ctx, state, i: int) -> None:
    ids, smask = _epoch(ctx, state, state["trace_gen"])
    state["trace_ids"].append(ids)
    _train(state, ids, smask)


def work(ctx, state) -> dict:
    """Least time of the traced VQ update launches (the kernels named
    ``vq_kernels``) and, where the backbone has them, its message
    kernels', and the model FLOPs of a traced epoch, from the traced
    batches' own counts."""
    cfg, k = ctx.cfg, ctx.cfg["codebook"]["k"]
    raw = state["raw"]
    tables = rgraph.tables(raw.src, raw.dst, raw.n, cfg["graph"]["deg_cap"],
                           ctx.device)
    bk = rsteps.backbone(cfg["model"]["backbone"])
    messages = getattr(bk, "message_least_s", None)
    vq_s = msg_s = flops = 0.0
    for ids in state["trace_ids"]:
        for s in range(ids.shape[0]):
            c = counting.batch_counts(tables, ids[s])
            for l, sh in enumerate(ctx.shapes):
                w = roofline.vq_update(sh.nb, c.b, sh.f_blk, k)
                vq_s += w.least_s()
                flops += w.flops + bk.layer_flops(c, sh, cfg, train=True,
                                                  first=l == 0)
                if messages:
                    msg_s += messages(c, sh, cfg, train=True, first=l == 0)
    return {"vq_least_s": vq_s,
            "message_least_s": msg_s if messages else None,
            "vq_kernels": ("vq_update", "vq_wide"),
            "model_flops_per_iteration": flops / len(state["trace_ids"]),
            "steps_per_iteration": state["trace_ids"][0].shape[0]}


def reference_record(ctx, state, prec: Precision, half_batch: bool = False,
                     chosen: list | None = None,
                     padding_out: bool = False) -> tuple[Record, list]:
    """The reference's readings of the first epoch, and each step's
    largest excess of the ``chosen`` codewords as (``vq.excess``,
    ``vq.row_excess``) (a Record's choices, judged here and used in place
    of the nearest ones).  Planted faults: ``half_batch`` drops the second
    half of every batch from the loss; ``padding_out`` leaves the tail
    batch's padding out of the codebook update and the table."""
    cfg, dev, raw = ctx.cfg, ctx.device, state["raw"]
    prob = rsteps.problem(raw, cfg["graph"]["deg_cap"], dev)
    rst = [rvq.VQState(s["codewords_w"], s["cluster_size"], s["cluster_sum"],
                       s["mean"], s["var"], s["table"].long())
           for s in state["states0"]]
    params = state["params0"]
    nu = [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
    ids, smask = state["first"]
    losses, gaps, choices = [], [], []
    for s in range(ids.shape[0]):
        sm = smask[s]
        if half_batch:
            sm = sm * (torch.arange(sm.shape[0], device=dev)
                       < sm.shape[0] // 2)
        params, nu, rst, loss, _, e = rsteps.train_step(
            cfg, ctx.shapes, params, nu, rst, prob, ids[s], sm, prec,
            None if chosen is None else chosen[s],
            smask[s] > 0 if padding_out else None)
        losses.append(loss)
        gaps.append(e)
        if s == 0:
            nu1 = nu
            choices.append(_choices([t.table for t in rst], ids[0]))
            step1 = (params, [{"codewords_w": t.codewords_w, "mean": t.mean,
                               "var": t.var} for t in rst])
    choices += [_choices([t.table for t in rst], ids[i])
                for i in range(1, ids.shape[0])]
    vq = [{"codewords_w": s.codewords_w, "mean": s.mean, "var": s.var}
          for s in rst]
    return _record(cfg, losses, nu1, params, state["params0"], vq,
                   state["states0"], choices, step1), gaps


def detail(ctx, state, side: Record) -> dict:
    """A side's readings against the float32 reference run on the same
    inputs with the side's own codeword choices, leaf by leaf and step by
    step, and those choices against the nearest codewords."""
    ref, gaps = reference_record(ctx, state, Precision(),
                                 chosen=side.choices)
    moved = compare.moved(ref.grad_norms)
    return {
        "loss": compare.rel_gaps(side.losses, ref.losses),
        "grad": compare.norm_gaps(side.grad_norms, ref.grad_norms),
        "param": compare.norm_gaps(side.changes, ref.changes, moved),
        "codebook": compare.norm_gaps(side.vq_changes, ref.vq_changes),
        "param1": compare.norm_gaps(side.changes1, ref.changes1, moved),
        "codebook1": compare.norm_gaps(side.vq_changes1, ref.vq_changes1),
        "moved": moved,
        "choices": gaps}


def numbers(d: dict) -> dict:
    """The numbers compared, from a side's ``detail``.  Two sound runs
    part after step 1: RMSprop's first step is a sign step (lr g /
    (|g| sqrt(1 - alpha) + eps)), so a weight whose gradient sums to
    about 0 moves by +-lr / sqrt(1 - alpha) as rounding and the ReLU
    ties of the backward decide, and the deeper layers' rows follow.
    So the gradients are taken by the median leaf, the losses over the
    first three steps, the codebook over step 1, and the choices where
    both sides' rows agree: the first layer's (the input features) at
    every step, the padded tail's included, and the last layer's at step
    1; the first layer's codebook and every leaf's parameter change over
    the whole epoch."""
    ch = d["choices"]
    return {
        "loss_gap": max(d["loss"][:3]),
        "grad_norm_gap": statistics.median(d["grad"]),
        "param_change_gap": max(d["param"]),
        "codebook_change_gap": max(d["codebook1"]),
        "first_layer_codebook_change_gap":
            max(d["codebook"][:len(VQ_LEAVES)]),
        "assignment_gap": max(step[0][0] for step in ch),
        "last_layer_assignment_gap": ch[0][-1][0]}


def judge(ctx, state, side: Record) -> dict:
    return numbers(detail(ctx, state, side))


def check(ctx, state) -> dict:
    free(state, "prog", "params", "vq", "ost", "trace_ids")
    return judge(ctx, state, state["record"])


def calibrate(ctx, state, faults: bool = True) -> dict:
    """The readings that set the limits: the program's, the control's (the
    reference in TF32 in the program's place) and, with ``faults``, the
    planted faults' (half of every batch out of the loss; a step that
    leaves the state unchanged; the tail batch's padding left out of the
    codebook update and the table; the tail's padding left unwritten in
    the program's tables), each judged by the float32 reference, with
    their details and the seconds the program's check took."""
    prog = state["record"]
    free(state, "prog", "params", "vq", "ost", "trace_ids")
    t0 = time.perf_counter()
    details = {"program": detail(ctx, state, prog)}
    check_s = time.perf_counter() - t0
    control, _ = reference_record(ctx, state, Precision(tf32=True))
    cases = {"control": control}
    if faults:
        ids, smask = state["first"]
        initial = [st["table"] for st in state["states0"]]
        cases["unchanged"] = prog._replace(
            changes=[0.0] * len(prog.changes),
            vq_changes=[0.0] * len(prog.vq_changes),
            changes1=[0.0] * len(prog.changes1),
            vq_changes1=[0.0] * len(prog.vq_changes1),
            choices=[_choices(initial, ids[i]) for i in range(ids.shape[0])])
        # the padding's nodes are batch 1's: unwritten, they keep step 1's
        pad = smask[-1] == 0
        stale = [c.clone() for c in prog.choices[-1]]
        for c, c1 in zip(stale, prog.choices[0]):
            c[:, pad] = c1[:, :int(pad.sum())]
        cases["padding_unwritten"] = prog._replace(
            choices=prog.choices[:-1] + [stale])
        cases["half_batch"], _ = reference_record(ctx, state, Precision(),
                                                  half_batch=True)
        cases["padding_out"], _ = reference_record(ctx, state, Precision(),
                                                   padding_out=True)
    details.update({k: detail(ctx, state, v) for k, v in cases.items()})
    return {**{k: numbers(d) for k, d in details.items()},
            "details": details, "check_s": check_s}
