#!/usr/bin/env python3
"""The JAX reference's link-task learning curve at the paper's full width,
on the CPU: the basis of ``chip_smoke.py``'s link-train gate.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/reference_link_curve.py \
        [--n 4000] [--epochs 10]

Runs ``repro.train.gnn_trainer.train_vq`` (the reference, not the port) on
``synthetic_collab(n, seed=4)`` with ``paper_config(g, "sage",
full_scale=True)`` (hidden 128, 3 layers, k 1024, f_prod 4, RMSprop 3e-3)
at ``paper_batch_size``, with the Eq. 7 injection on and off, and prints
one JSON line a setting: each epoch's mean step loss (the steps' losses
recorded by a wrapper of the trainer's ``vq_train_step``), the final val /
test Hits@50, and chance (50 / the val negatives).  The link step
recompiles for every batch's pair count, so the default size takes a few
minutes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro.configs.vq_gnn_paper import paper_batch_size, paper_config  # noqa
from repro.graph.datasets import synthetic_collab                    # noqa
from repro.train import gnn_trainer                                  # noqa


def curve(g, cfg, epochs: int) -> dict:
    """Mean step loss per epoch and the final metrics of one run."""
    losses, step = [], gnn_trainer.vq_train_step

    def recorded(*a, **k):
        out = step(*a, **k)
        losses.append(float(out[3]))
        return out
    gnn_trainer.vq_train_step = recorded
    try:
        r = gnn_trainer.train_vq(g, cfg, epochs=epochs,
                                 batch_size=paper_batch_size(g),
                                 eval_every=epochs)
    finally:
        gnn_trainer.vq_train_step = step
    return {"grad_inject": cfg.grad_inject,
            "epoch_loss": np.asarray(losses).reshape(epochs, -1)
            .mean(1).tolist(),
            "final": r["final"], "chance": 50 / len(g.val_neg_edges)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    g = synthetic_collab(n=args.n, seed=4)
    cfg = paper_config(g, "sage", full_scale=True)
    for inject in (True, False):
        print(json.dumps(curve(g, cfg._replace(grad_inject=inject),
                               args.epochs)), flush=True)


if __name__ == "__main__":
    main()
