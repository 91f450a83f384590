#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s transformer-train parity on one CUDA card
and locate the element that limits it.

    python3 tools/transformer_parity_repeat.py [--runs 24] [--out DIR]

Each run trains the Graph Transformer as ``chip_smoke.py``'s
"transformer-train without Eq. 7" phase does (n 20,000, 10 epochs, depth
3, from seed 0: the card's steps add in no fixed order, so every run ends
in a slightly different state), then runs ``phase_train_parity`` on it
(one step at batch 1,024, card vs CPU, with the attention backbones'
split step check: the gradients, each side's RMSprop of the card's
gradients, and the params where RMSprop's gain does not carry a
gradient difference past STEP_TOL -- ``chip_smoke.split_step_check``).
Beside the check's verdict each run prints, for every param, its worst
element of the direct card-vs-CPU comparison as a share of STEP_TOL
(|card - CPU| / (atol + rtol |CPU|)) with the element's state: the param
and RMSprop's v before the step, the gradients of both devices, the two
updates.  A run whose check fails (or whose worst direct share passes 1)
saves its trained state, the batch's ids and both devices' gradients
under ``--out`` (``torch.save``) for a rerun off the card
(``tools/transformer_parity_clip_probe.py``), and the run with the
largest worst share is saved as ``worst.pt`` too.  The last line is a
JSON summary.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _grads(m, params, vq, bids):
    """Loss and param gradients of the parity's batch on ``m``'s
    device."""
    loss, _, _, grads, _ = cs._loss_grads(m, params, vq,
                                          m.batch_inputs(bids))
    return float(loss), grads


def _worst(tag, p0, nu0, gg, gc, pg, pc, lr, alpha, eps):
    """The worst element of one param leaf as a share of STEP_TOL, and
    its state."""
    import torch
    tol = cs.STEP_TOL["atol"] + cs.STEP_TOL["rtol"] * pc.abs()
    share = (pg - pc).abs() / tol
    i = int(torch.argmax(share))
    idx = np.unravel_index(i, tuple(share.shape))
    f = lambda t: float(t.reshape(-1)[i])   # noqa: E731
    v_g = alpha * f(nu0) + (1 - alpha) * f(gg) ** 2
    v_c = alpha * f(nu0) + (1 - alpha) * f(gc) ** 2
    return {"param": tag, "share": float(share.reshape(-1)[i]),
            "index": [int(x) for x in idx], "p0": f(p0), "nu0": f(nu0),
            "grad_card": f(gg), "grad_cpu": f(gc),
            "update_card": lr * f(gg) / (v_g ** 0.5 + eps),
            "update_cpu": lr * f(gc) / (v_c ** 0.5 + eps),
            "p_card": f(pg), "p_cpu": f(pc)}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=24)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "transformer_parity"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("transformer_parity_repeat: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs.vq_gnn_paper import (PAPER_LR,
                                                  paper_batch_size,
                                                  paper_config)
    from repro_torch.convert import to_device
    from repro_torch.graph.datasets import synthetic_arxiv
    from repro_torch.models.gnn import vq_train_step
    from repro_torch.train.optimizer import rmsprop
    cs.phase_card()
    cs.phase_build()
    g = synthetic_arxiv(n=cs.TRANSFORMER_N, seed=cs.SEED)
    cfg = paper_config(g, full_scale=True)._replace(
        backbone="transformer", heads=cs.ATTN_HEADS)
    batch = paper_batch_size(g)
    m = cs.Model(g, cfg, batch, torch.device(cs.DEVICE))
    cpu = cs.Model(g, cfg, cs.TRANSFORMER_PARITY_BATCH, "cpu")
    opt = rmsprop(PAPER_LR)
    alpha, eps = 0.99, 1e-8
    os.makedirs(args.out, exist_ok=True)
    runs, t0 = [], time.time()
    for run in range(args.runs):
        r, _ = cs.phase_attention_train(
            g, cfg._replace(grad_inject=False), batch,
            f"repeat {run}: transformer-train without Eq. 7")
        params, vq, ost = r["params"], r["vq_states"], r["opt_state"]
        verdict = "pass"
        try:
            cs.phase_train_parity(m, params, vq, ost, cpu,
                                  f"repeat {run}: transformer-train parity",
                                  False, cs.TRANSFORMER_PARITY_BATCH, True,
                                  True)
        except SystemExit as e:
            verdict = f"fail: {e}"
        # the parity's own batch and step, taken apart element by element
        rng = np.random.default_rng(cs.SEED + 3)
        bids = rng.choice(g.n, cs.TRANSFORMER_PARITY_BATCH, replace=False)
        state_c = to_device((params, vq, ost), "cpu")
        outs = {}
        for side, mm, (p, v, o) in (("cuda", m, (params, vq, ost)),
                                    ("cpu", cpu, state_c)):
            pack, x_b, y_b, lmask = mm.batch_inputs(bids)
            out = vq_train_step(p, v, o, pack, x_b, y_b, mm.ops.degrees,
                                cfg, opt, loss_mask=lmask)
            outs[side] = to_device(out, "cpu")
        _, gg = _grads(m, params, vq, bids)
        _, gc = _grads(cpu, state_c[0], state_c[1], bids)
        gg = to_device(gg, "cpu")
        pg, pc = outs["cuda"][0], outs["cpu"][0]
        worst = []
        for l in range(len(pg)):
            for k in pg[l]:
                worst.append(_worst(f"{l}.{k}", state_c[0][l][k],
                                    state_c[2].nu[l][k], gg[l][k], gc[l][k],
                                    pg[l][k], pc[l][k], PAPER_LR, alpha,
                                    eps))
        worst.sort(key=lambda w: -w["share"])
        rec = {"run": run, "verdict": verdict, "worst": worst[:3]}
        saved = {"params": state_c[0], "vq_states": state_c[1],
                 "opt_state": state_c[2], "bids": bids, "n": g.n,
                 "grads_card": gg, "grads_cpu": gc}
        if verdict != "pass" or worst[0]["share"] > 1.0:
            path = os.path.join(args.out, f"run{run}.pt")
            torch.save(saved, path)
            rec["saved"] = os.path.relpath(path, ROOT)
        if worst[0]["share"] >= max((r["worst"][0]["share"] for r in runs),
                                    default=0.0):
            torch.save(saved, os.path.join(args.out, "worst.pt"))
            rec["saved_as_worst"] = True
        cs.log(json.dumps({"repeat": rec}))
        runs.append(rec)
        del r, params, vq, ost, state_c, outs
        torch.cuda.empty_cache()
    shares = [r["worst"][0]["share"] for r in runs]
    summary = {"runs": len(runs),
               "failed": sum(r["verdict"] != "pass" for r in runs),
               "worst_share_max": max(shares),
               "worst_share_median": float(np.median(shares)),
               "worst_params": sorted({r["worst"][0]["param"]
                                       for r in runs}),
               "seconds": time.time() - t0}
    cs.log(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
