"""Quickstart on the port: VQ-GNN (paper Alg. 1) vs full-graph training on
a synthetic ogbn-arxiv look-alike, then mini-batched codeword inference --
the twin of the reference's ``examples/quickstart.py``, printing the same
lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--device cuda|cpu] [--n 2000] [--epochs 60]
"""
from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np

from repro_torch.core.codebook import CodebookConfig
from repro_torch.graph.datasets import synthetic_arxiv
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.gnn_trainer import train_full, train_vq, vq_inference


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--backbone", default="gcn",
                    choices=["gcn", "sage", "gat", "gin", "transformer"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the CUDA kernels; cpu their plain "
                    "PyTorch versions")
    args = ap.parse_args(argv)

    g = synthetic_arxiv(n=args.n)
    print(f"graph: {g.n} nodes, {g.m} edges, {g.num_classes} classes")
    cfg = GNNConfig(backbone=args.backbone, f_in=g.f, hidden=64,
                    n_out=g.num_classes, n_layers=2,
                    codebook=CodebookConfig(k=256, f_prod=4))

    print("\n-- full-graph oracle --")
    rf = train_full(g, cfg, epochs=args.epochs, eval_every=20,
                    device=args.device)
    for h in rf["history"]:
        print(f"  epoch {h['epoch']:4d}  val {h['val']:.4f}  "
              f"({h['time']:.1f}s)")

    print("\n-- VQ-GNN (mini-batched, streaming codebooks) --")
    rv = train_vq(g, cfg, epochs=args.epochs, batch_size=400, eval_every=20,
                  device=args.device)
    for h in rv["history"]:
        print(f"  epoch {h['epoch']:4d}  val {h['val']:.4f}  "
              f"({h['time']:.1f}s)")

    print(f"\nfull-graph test acc: {rf['final']['test']:.4f}")
    print(f"VQ-GNN     test acc: {rv['final']['test']:.4f}")
    print(f"VQ-GNN per-batch memory model: "
          f"{rv['mem_bytes']/2**20:.1f} MB "
          f"(all {rv['messages']:.0f} messages preserved)")

    emb = vq_inference(rv["params"], rv["vq_states"], g, cfg, 400)
    acc = float((np.argmax(emb[g.test_idx], -1)
                 == g.labels[g.test_idx]).mean())
    print(f"VQ mini-batched inference test acc: {acc:.4f}")
    return {"full": rf["final"], "vq": rv["final"], "inference_acc": acc}


if __name__ == "__main__":
    main()
