"""The data-dependent counts of a mini-batch that the operation and byte
counts of ``roofline`` need: live edges by kind, distinct source rows
and distinct out-of-batch neighbours, counted on the benchmark's own
neighbour tables (``reference.graph``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench.reference import graph as rgraph


class BatchCounts(NamedTuple):
    b: int
    deg: int
    e_in: int        # live in-edges from batch rows
    e_out: int       # live in-edges from out-of-batch nodes
    e_rev: int       # live out-edges to out-of-batch nodes
    rows: int        # distinct source positions the in-batch gather reads
    nodes_out: int   # distinct out-of-batch in-neighbours
    nodes_rev: int   # distinct out-of-batch out-neighbours


def batch_counts(tables: rgraph.Tables, ids: torch.Tensor) -> BatchCounts:
    bt = rgraph.batch(tables, ids)
    live_in = bt.nmask > 0
    inb = live_in & (bt.npos >= 0)
    outb = live_in & (bt.npos < 0)
    revb = (bt.rmask > 0) & (bt.rpos < 0)
    return BatchCounts(
        bt.ids.shape[0], bt.nbr.shape[1], int(inb.sum()), int(outb.sum()),
        int(revb.sum()), int(torch.unique(torch.clamp(bt.npos, min=0)).numel()),
        int(torch.unique(bt.nbr[outb]).numel()),
        int(torch.unique(bt.rev[revb]).numel()))
