"""Layer widths and product-VQ branch layouts of a configuration.

Worked out from the configuration file alone (the published widths and
the paper's product-VQ rule), so the inputs the benchmark makes, the
reference and the operation counts share one account of the shapes and
none of them asks the program under test.
"""
from __future__ import annotations

import math
from typing import NamedTuple


class LayerShape(NamedTuple):
    f_in: int       # layer input width
    f_out: int      # layer output width (GAT: a multiple of the heads)
    nb: int         # product-VQ branches
    fb: int         # feature columns a branch
    gb: int         # gradient columns a branch

    @property
    def f_blk(self) -> int:
        return self.fb + self.gb


def branch_layout(f_feat: int, f_grad: int, f_prod: int) -> tuple[int, int, int]:
    """(branches, feature block, gradient block): the largest divisor of
    gcd(f_feat, f_grad) that keeps both blocks at least ``f_prod`` wide
    (VQ-GNN, App. E: feature block i pairs with gradient block i)."""
    cap = min(max(1, f_feat // f_prod), max(1, f_grad // f_prod))
    g = math.gcd(f_feat, f_grad)
    nb = max(d for d in range(1, g + 1) if g % d == 0 and d <= cap)
    return nb, f_feat // nb, f_grad // nb


def layers(cfg: dict) -> list[LayerShape]:
    """Every layer's shapes for a configuration file's ``model``,
    ``codebook`` and ``graph`` groups."""
    m, g = cfg["model"], cfg["graph"]
    heads = m.get("heads", 1)
    attention = m["backbone"] == "gat"
    out = []
    f = g["f_in"]
    for l in range(m["n_layers"]):
        fo = g["n_classes"] if l == m["n_layers"] - 1 else m["hidden"]
        if attention:
            fo = -(-fo // heads) * heads
        # the gradient half: GAT's probe sits at the per-head augmented
        # message [numerator, denominator], fo + heads wide
        f_grad = fo + heads if attention else fo
        nb, fb, gb = branch_layout(f, f_grad, cfg["codebook"]["f_prod"])
        out.append(LayerShape(f, fo, nb, fb, gb))
        f = fo
    return out
