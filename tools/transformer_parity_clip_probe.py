#!/usr/bin/env python3
"""Take apart a failing transformer-train parity step off the card.

    PYTHONPATH=src python3 tools/transformer_parity_clip_probe.py RUN.pt

``RUN.pt`` is a state that ``tools/transformer_parity_repeat.py`` saved
on the card for a run whose card-vs-CPU step missed STEP_TOL: the
trained params, VQ and RMSprop states, the parity batch's ids and both
devices' gradients.  On the CPU this recomputes the step's gradients and
prints, per call of the Graph Transformer's score clip (``torch.clamp``
to +-SCORE_CLIP), how many scores lie within 1e-6 / 1e-5 / 1e-4 of the
boundary (relative); the gradient of the worst elements with the score
products rounded once from f64 instead (another rounding of the same
scores); and with the boundary moved by a few f32 ulps, which flips the
clamp's derivative for exactly the scores that close to it.  A card
gradient that one of the moved boundaries reproduces comes from scores
that the card's summation order put on the other side of the clip.

Then it runs ``chip_smoke.split_step_check`` -- the parity's split of
the step into its gradients, each side's RMSprop of the same gradients,
and the params where RMSprop's gain does not magnify a gradient
difference past STEP_TOL -- with each moved boundary's gradients (and the
saved card gradients) standing for the card's, beside the direct
comparison of the two steps' params; and, as a control, with the largest
gradient leaf of the CPU's scaled by 1.001, which the split check must
refuse.  It exits 1 if the saved card gradients fail the split check or
the control passes it.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run", help="a state saved by transformer_parity_repeat")
    ap.add_argument("--elements", nargs="*", default=[],
                    help="param[i,j,k] elements to print, e.g. "
                         "0.wq[53,0,25] (default: the worst of 0.wq, 0.wk)")
    args = ap.parse_args()
    from repro_torch.configs.vq_gnn_paper import paper_config
    from repro_torch.graph.datasets import synthetic_arxiv
    from repro_torch.nn import gnn_layers as gl
    d = torch.load(args.run, weights_only=False)
    g = synthetic_arxiv(n=d.get("n", cs.TRANSFORMER_N), seed=cs.SEED)
    cfg = paper_config(g, full_scale=True)._replace(
        backbone="transformer", heads=cs.ATTN_HEADS)
    cpu = cs.Model(g, cfg, cs.TRANSFORMER_PARITY_BATCH, "cpu")
    gg, gc = d["grads_card"], d["grads_cpu"]
    clip0 = gl.SCORE_CLIP

    def grads():
        return cs._loss_grads(cpu, d["params"], d["vq_states"],
                              cpu.batch_inputs(d["bids"]))[3]

    elements = []
    for spec in args.elements:
        name, idx = spec.rstrip("]").split("[")
        elements.append((name, tuple(int(i) for i in idx.split(","))))
    if not elements:
        for name in ("0.wq", "0.wk"):
            l, k = name.split(".")
            diff = (gg[int(l)][k] - gc[int(l)][k]).abs()
            i = int(torch.argmax(diff))
            elements.append((name, tuple(int(x) for x in torch.unravel_index(
                torch.tensor(i), diff.shape))))

    def show(tag, gs):
        parts = []
        for name, idx in elements:
            l, k = name.split(".")
            parts.append(f"{name}{list(idx)} {float(gs[int(l)][k][idx]):.6e}")
        worst = max(float((gs[l][k] - gg[l][k]).abs().max())
                    for l in range(len(gg)) for k in gg[l])
        print(f"{tag}: {'; '.join(parts)}; max |grad - card grad| over "
              f"every leaf {worst:.3e}")

    show("card (saved)", gg)
    show("CPU (saved)", gc)
    scores = []
    orig_clamp = torch.clamp

    def clamp(x, *a, **k):
        lo = a[0] if a else k.get("min")
        hi = a[1] if len(a) > 1 else k.get("max")
        if lo == -gl.SCORE_CLIP and hi == gl.SCORE_CLIP:
            scores.append(x.detach().clone())
        return orig_clamp(x, *a, **k)
    gl.torch.clamp = clamp
    try:
        show("CPU (recomputed)", grads())
    finally:
        gl.torch.clamp = orig_clamp
    for i, s in enumerate(scores):
        near = [int(((s.abs() - clip0).abs() <= rel * clip0).sum())
                for rel in (1e-6, 1e-5, 1e-4)]
        print(f"clip call {i} {tuple(s.shape)}: share beyond the clip "
              f"{float((s.abs() > clip0).float().mean()):.4f}, within 1e-6 "
              f"/ 1e-5 / 1e-4 of it: {near}")
    orig_einsum = torch.einsum

    def einsum(eq, *ops):
        if eq in ("hbe,hue->hbu", "hbe,hke->hbk") \
                and ops[0].dtype == torch.float32:
            return orig_einsum(eq, *(o.double() for o in ops)).float()
        return orig_einsum(eq, *ops)
    gl.torch.einsum = einsum
    try:
        show("CPU, score products rounded once from f64", grads())
    finally:
        gl.torch.einsum = orig_einsum
    shifted = {}
    try:
        for rel in (-4e-7, 4e-7, -1e-6, 1e-6):
            gl.SCORE_CLIP = clip0 * (1 + rel)
            shifted[rel] = grads()
            show(f"CPU, clip at {clip0} x (1 {rel:+g})", shifted[rel])
    finally:
        gl.SCORE_CLIP = clip0
    return split_checks(d, gg, gc, shifted)


def split_checks(d, gg, gc, shifted) -> int:
    """``chip_smoke.split_step_check`` with each set of gradients standing
    for the card's against the CPU's, the direct param comparison beside
    it, then the 1.001 control."""
    from repro_torch.configs.vq_gnn_paper import PAPER_LR
    from repro_torch.train.optimizer import rmsprop
    opt = rmsprop(PAPER_LR)
    p0, o0 = d["params"], d["opt_state"]
    step_b = opt.update(gc, o0, p0)

    def run(tag, ga) -> bool:
        step_a = opt.update(ga, o0, p0)
        at, rt = cs.STEP_TOL["atol"], cs.STEP_TOL["rtol"]
        direct = sum(int(((step_a[0][l][k] - step_b[0][l][k]).abs()
                          > at + rt * step_b[0][l][k].abs()).sum())
                     for l in range(len(gc)) for k in gc[l])
        try:
            rep = cs.split_step_check(tag, p0, o0, ga, gc, step_a,
                                      step_a[0], step_b[0], opt, PAPER_LR)
            verdict = f"passes ({rep['ill_conditioned']} of " \
                f"{rep['elements']} elements ill-conditioned)"
        except SystemExit as e:
            rep, verdict = None, f"fails: {e}"
        print(f"split check, {tag}: {verdict}; the direct comparison of "
              f"the two steps' params: {direct} elements beyond STEP_TOL")
        return rep is not None

    ok = run("saved card gradients", gg)
    for rel, gs in shifted.items():
        run(f"clip x (1 {rel:+g})", gs)
    l, k = max(((l, k) for l in range(len(gc)) for k in gc[l]),
               key=lambda lk: float(gc[lk[0]][lk[1]].abs().max()))
    bad = [{n: (t * 1.001 if (i, n) == (l, k) else t)
            for n, t in layer.items()} for i, layer in enumerate(gc)]
    caught = not run(f"control: the CPU's gradients with leaf {l}.{k} "
                     f"(max |g| {float(gc[l][k].abs().max()):.4g}) x 1.001",
                     bad)
    if not ok or not caught:
        print("transformer_parity_clip_probe: the saved card gradients fail "
              "the split check, or the control passes it")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
