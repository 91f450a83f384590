"""Graph Transformer with global attention scaled by VQ (paper App. G), on
the port -- the twin of the reference's ``examples/graph_transformer.py``,
printing the same lines.

Every node attends to every node (a dense learnable convolution, O(n^2)
messages), which no sampling method can scale.  VQ-GNN reduces each
mini-batch row to b in-batch keys and k codeword keys; this example trains
it mini-batched beside the full-graph oracle.

    PYTHONPATH=src python -m repro_torch.examples.graph_transformer \\
        [--device cuda|cpu] [--n 1200] [--epochs 30]
"""
from __future__ import annotations

import argparse
from typing import Sequence

from repro_torch.core.codebook import CodebookConfig
from repro_torch.graph.datasets import synthetic_arxiv
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.gnn_trainer import train_full, train_vq


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1200)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the CUDA kernels; cpu their plain "
                    "PyTorch versions")
    args = ap.parse_args(argv)

    g = synthetic_arxiv(n=args.n)
    cfg = GNNConfig(backbone="transformer", f_in=g.f, hidden=64,
                    n_out=g.num_classes, n_layers=2, heads=4,
                    codebook=CodebookConfig(k=128))
    print(f"global attention: {g.n}^2 = {g.n**2:,} messages per layer "
          f"full-graph; VQ mini-batch: b*(b+k) per batch")
    rf = train_full(g, cfg, epochs=args.epochs, eval_every=args.epochs,
                    device=args.device)
    rv = train_vq(g, cfg, epochs=args.epochs, batch_size=300,
                  eval_every=args.epochs, device=args.device)
    print(f"full-graph  val acc: {rf['final']['val']:.4f}")
    print(f"VQ-GNN      val acc: {rv['final']['val']:.4f}")
    return {"full": rf["final"], "vq": rv["final"]}


if __name__ == "__main__":
    main()
