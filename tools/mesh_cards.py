#!/usr/bin/env python3
"""The multi-device GNN paths on several CUDA cards of one host, NCCL.

    python3 tools/mesh_cards.py [--ranks 4]

The twin of ``chip_smoke.py``'s mesh phase (b) with a card a rank: the
kernels built once, then ``--ranks`` NCCL ranks (``run_ranks``, one
process a card) on the 169,343-node arxiv look-alike at the paper's width
(GCN, hidden 128, 3 layers, k 1024) run one data-parallel epoch and one
row-sharded epoch of batch 42,336 in lockstep (each rank's step timed,
with its collectives; the sharded step within STEP_TOL of the
data-parallel one), then the inductive sharded inference at batch 42,335
and the sharded serving of 48 ids, held to the unsharded executors run in
this process on card 0.  Prints each rank's epoch seconds, step p50, the
collectives' share of the step time and its launches, the card's name and
power limit, and a ``{"mesh_cards": ...}`` line.  It needs as many cards
as ranks, and exits non-zero on any failed check.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    import chip_smoke as smoke
    if not torch.cuda.is_available():
        print("mesh_cards: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs.vq_gnn_paper import paper_batch_size
    from repro_torch.graph.datasets import synthetic_arxiv
    smoke.phase_card()
    smoke.phase_build()
    g = synthetic_arxiv(n=smoke.N_NODES, seed=smoke.SEED)
    rep, counts = smoke.phase_mesh_ranks(g, paper_batch_size(g),
                                         ranks=args.ranks, backend="nccl")
    rep["launches"] = {k: v for k, v in counts.items()
                       if k not in smoke.KEYED and v}
    smoke.log(json.dumps({"mesh_cards": rep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
