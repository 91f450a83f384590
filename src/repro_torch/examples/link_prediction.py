"""Link prediction on the port (paper Table 4, the ogbl-collab setting):
VQ-GNN vs full-graph training on the synthetic collab look-alike, scored
by Hits@50 -- the twin of the reference's ``examples/link_prediction.py``,
printing the same lines.

    PYTHONPATH=src python -m repro_torch.examples.link_prediction \\
        [--device cuda|cpu] [--n 2000] [--epochs 40]
"""
from __future__ import annotations

import argparse
from typing import Sequence

from repro_torch.core.codebook import CodebookConfig
from repro_torch.graph.datasets import synthetic_collab
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.gnn_trainer import train_full, train_vq


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the CUDA kernels; cpu their plain "
                    "PyTorch versions")
    args = ap.parse_args(argv)

    g = synthetic_collab(n=args.n)
    print(f"graph: {g.n} nodes, {g.m} message edges, "
          f"{len(g.val_edges)} val / {len(g.test_edges)} test positives")
    cfg = GNNConfig(backbone="sage", f_in=g.f, hidden=64, n_out=64,
                    n_layers=2, task="link",
                    codebook=CodebookConfig(k=256, f_prod=4))
    rf = train_full(g, cfg, epochs=args.epochs, eval_every=args.epochs,
                    device=args.device)
    rv = train_vq(g, cfg, epochs=args.epochs, batch_size=500,
                  eval_every=args.epochs, device=args.device)
    print(f"full-graph Hits@50: val {rf['final']['val']:.4f} "
          f"test {rf['final']['test']:.4f}")
    print(f"VQ-GNN     Hits@50: val {rv['final']['val']:.4f} "
          f"test {rv['final']['test']:.4f}")
    return {"full": rf["final"], "vq": rv["final"]}


if __name__ == "__main__":
    main()
