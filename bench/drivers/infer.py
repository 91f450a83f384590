"""Whole-graph inference traffic: inductive ``vq_infer_epoch`` passes
back to back, each over a fresh seeded permutation of every node split
into batches of ``batch`` (offline scoring of every node: per layer, every
node's codewords refreshed from its features, then each batch's output
rows), one synchronisation at each pass's end.

The window keeps the outputs and refreshed tables of its first pass and
of one later pass drawn from the seed; the check recomputes both with the
reference from the same weights, VQ state and permutations.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import compare, graphgen, inputs, port, roofline
from bench import work as counting
from bench.harness import Window, free, sync
from bench.reference import graph as rgraph
from bench.reference import steps as rsteps
from bench.reference import vq as rvq
from bench.reference.precision import Precision


def _perm(ctx, n: int, tag: str) -> torch.Tensor:
    return torch.randperm(n, generator=inputs.generator(ctx.seed, tag,
                                                        ctx.device),
                          device=ctx.device)


def setup(ctx) -> dict:
    cfg, dev = ctx.cfg, ctx.device
    raw = graphgen.generate(cfg["graph"], ctx.seed)
    prog = port.build(cfg, raw, dev)
    params0, states0 = inputs.model_state(cfg, ctx.shapes, raw.n, ctx.seed,
                                          dev)
    state = {"raw": raw, "prog": prog, "params0": params0,
             "states0": states0,
             "vq": port.vq_states(states0, cfg["codebook"]["k"]),
             "kept": {}, "trace_ids": []}
    _pass(ctx, state, _perm(ctx, raw.n, "warm"))
    return state


def _pass(ctx, state, perm):
    ids, smask = inputs.epoch_ids(perm, ctx.traffic["batch"])
    out, states = port.infer_pass(state["prog"], state["params0"],
                                  state["vq"], ids, smask)
    return out, [s.assignment for s in states]


def window(ctx, state, seconds: float) -> Window:
    n = state["raw"].n
    rng = np.random.default_rng(inputs.sub_seed(ctx.seed, "sample"))
    calls, bad, passes = [], torch.zeros((), device=ctx.device), 0
    kept = state["kept"]
    sync(ctx.device)
    t0 = time.perf_counter()
    while True:
        perm = _perm(ctx, n, f"pass{passes}")
        tc = time.perf_counter()
        out, tables = _pass(ctx, state, perm)
        calls.append(time.perf_counter() - tc)
        bad += (~torch.isfinite(out)).any()
        # the first pass, and one later pass drawn uniformly (reservoir)
        if passes == 0 or rng.random() < 1.0 / passes:
            kept[0 if passes == 0 else "later"] = (passes, out, tables)
        sync(ctx.device)
        passes += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    return Window({"infer_nodes_per_s": passes * n / elapsed}, passes,
                  int(bad), elapsed, passes, calls, 1)


def trace_iteration(ctx, state, i: int) -> None:
    perm = _perm(ctx, state["raw"].n, f"trace{i}")
    state["trace_ids"].append(perm)
    _pass(ctx, state, perm)


def work(ctx, state) -> dict:
    """Least time of the traced VQ assignment launches (the kernels named
    ``vq_kernels``) and, where the backbone has them, its message
    kernels', and the model FLOPs of a traced pass, from the traced
    batches' own counts."""
    cfg, k = ctx.cfg, ctx.cfg["codebook"]["k"]
    raw, b = state["raw"], ctx.traffic["batch"]
    tables = rgraph.tables(raw.src, raw.dst, raw.n, cfg["graph"]["deg_cap"],
                           ctx.device)
    bk = rsteps.backbone(cfg["model"]["backbone"])
    messages = getattr(bk, "message_least_s", None)
    vq_s = msg_s = flops = 0.0
    for perm in state["trace_ids"]:
        ids, _ = inputs.epoch_ids(perm, b)
        counts = [counting.batch_counts(tables, ids[s])
                  for s in range(ids.shape[0])]
        for l, sh in enumerate(ctx.shapes):
            w = roofline.vq_assign(sh.nb, raw.n, sh.fb, k)
            vq_s += w.least_s()
            flops += w.flops + sum(
                bk.layer_flops(c, sh, cfg, train=False, first=l == 0)
                for c in counts)
            if messages:
                msg_s += sum(messages(c, sh, cfg, train=False, first=l == 0)
                             for c in counts)
    return {"vq_least_s": vq_s,
            "message_least_s": msg_s if messages else None,
            "vq_kernels": ("vq_assign", "vq_wide"),
            "model_flops_per_iteration": flops / len(state["trace_ids"]),
            "steps_per_iteration": 1}


def reference_pass(ctx, state, prob, p: int, prec: Precision,
                   tables: list | None = None):
    """The reference's pass ``p`` of the window: (output, tables, gap of
    the given tables' choices), see ``reference.steps.infer_pass``."""
    rst = [rvq.VQState(s["codewords_w"], s["cluster_size"], s["cluster_sum"],
                       s["mean"], s["var"], s["table"].long())
           for s in state["states0"]]
    return rsteps.infer_pass(ctx.cfg, ctx.shapes, state["params0"], rst, prob,
                             _perm(ctx, state["raw"].n, f"pass{p}"),
                             ctx.traffic["batch"], prec, tables)


def judge(ctx, state, prob, kept: dict) -> dict:
    """The kept passes' outputs against the float32 reference run on the
    same passes with the same per-layer choices, and those choices
    against the nearest codewords."""
    out_gap = assign_gap = 0.0
    for p, out, tables in kept.values():
        r_out, _, gap = reference_pass(ctx, state, prob, p, Precision(),
                                       tables)
        out_gap = max(out_gap, compare.frobenius_gap(out, r_out))
        assign_gap = max(assign_gap, gap)
    return {"output_gap": out_gap, "assignment_gap": assign_gap}


def _prepare(ctx, state):
    kept = state["kept"]
    free(state, "prog", "vq", "trace_ids")
    return kept, rsteps.problem(state["raw"], ctx.cfg["graph"]["deg_cap"],
                                ctx.device)


def check(ctx, state) -> dict:
    kept, prob = _prepare(ctx, state)
    return judge(ctx, state, prob, kept)


def calibrate(ctx, state, faults: bool = True) -> dict:
    """The readings that set the limits: the program's, the control's (the
    reference in TF32 in the program's place: its own choices and
    outputs) and, with ``faults``, a planted fault's (one output row of
    each kept pass doubled), each judged by the float32 reference."""
    kept, prob = _prepare(ctx, state)
    control = {}
    for key, (p, _, _) in kept.items():
        out, tables, _ = reference_pass(ctx, state, prob, p,
                                        Precision(tf32=True))
        control[key] = (p, out, tables)
    out = {"program": judge(ctx, state, prob, kept),
           "control": judge(ctx, state, prob, control)}
    if faults:
        altered = {}
        for key, (p, o, tables) in kept.items():
            o = o.clone()
            o[0] *= 2.0
            altered[key] = (p, o, tables)
        out["altered_row"] = judge(ctx, state, prob, altered)
    return out
