"""The paper's own experimental configuration (App. F hyper-parameters) as a
GNNConfig preset -- twin of ``repro.configs.vq_gnn_paper``.

Paper setup: 3 layers, hidden 128, codebook 1024, f_prod=4 product VQ,
batch 40K on ogbn-arxiv's 169K nodes (~n/4).  ``full_scale=False`` scales k
and the widths down for the small synthetic graphs of the tests.
"""
from __future__ import annotations

from repro_torch.core.codebook import CodebookConfig
from repro_torch.graph.structure import Graph
from repro_torch.models.gnn import GNNConfig

PAPER_HIDDEN = 128
PAPER_LAYERS = 3
PAPER_F_PROD = 4
PAPER_LR = 3e-3           # RMSprop, App. F


def paper_config(g: Graph, backbone: str = "gcn",
                 full_scale: bool = False) -> GNNConfig:
    """GNNConfig matching the paper's App. F setup, scaled to the graph."""
    if full_scale:
        k, hidden, layers = 1024, PAPER_HIDDEN, PAPER_LAYERS
    else:
        k = max(64, min(1024, g.n // 8))
        hidden, layers = 64, 2
    task = "link" if g.train_edges is not None else "node"
    return GNNConfig(
        backbone=backbone, f_in=g.f, hidden=hidden,
        n_out=(hidden if task == "link" else g.num_classes),
        n_layers=layers, task=task, multilabel=g.multilabel,
        codebook=CodebookConfig(k=k, f_prod=PAPER_F_PROD))


def paper_batch_size(g: Graph) -> int:
    """40K of 169K nodes ~ n/4 (App. F)."""
    return max(64, g.n // 4)
