"""Graph containers: CSR adjacency (both directions), features, labels, splits.

numpy twin of ``repro.graph.structure`` (the port keeps its own copy so it
never imports the JAX package).  Host-side structures feeding the device
pipeline; max degree is tracked so every mini-batch packs neighbors into a
static ELLPACK layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CSR:
    indptr: np.ndarray   # [n+1] int64
    indices: np.ndarray  # [m]   int32

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def m(self) -> int:
        return len(self.indices)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.float32)

    def neighbors(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i]:self.indptr[i + 1]]

    def max_degree(self) -> int:
        return int(np.diff(self.indptr).max(initial=0))


def csr_from_coo(src: np.ndarray, dst: np.ndarray, n: int) -> CSR:
    """Build CSR of in-edges: row i lists the sources j of edges j -> i."""
    order = np.argsort(dst, kind='stable')
    dst_s, src_s = dst[order], src[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, dst_s + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(indptr=indptr, indices=src_s.astype(np.int32))


@dataclasses.dataclass
class Graph:
    """A (possibly directed) graph with node features and task labels."""
    in_csr: CSR                   # in-edges: messages INTO node i
    out_csr: CSR                  # out-edges: messages FROM node i
    features: np.ndarray          # [n, f] float32
    labels: np.ndarray            # [n] int64 or [n, c] float32 (multilabel)
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray
    multilabel: bool = False
    name: str = "graph"
    # link prediction extras (carried for parity with the reference)
    train_edges: Optional[np.ndarray] = None   # [e, 2]
    val_edges: Optional[np.ndarray] = None
    val_neg_edges: Optional[np.ndarray] = None
    test_edges: Optional[np.ndarray] = None
    test_neg_edges: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return self.in_csr.n

    @property
    def m(self) -> int:
        return self.in_csr.m

    @property
    def f(self) -> int:
        return self.features.shape[1]

    @property
    def num_classes(self) -> int:
        if self.multilabel:
            return self.labels.shape[1]
        return int(self.labels.max()) + 1

    def degrees(self) -> np.ndarray:
        return self.in_csr.degrees()

    def max_degree(self) -> int:
        return max(self.in_csr.max_degree(), self.out_csr.max_degree())


def build_graph(src: np.ndarray, dst: np.ndarray, n: int,
                features: np.ndarray, labels: np.ndarray,
                splits: tuple[np.ndarray, np.ndarray, np.ndarray],
                multilabel: bool = False, name: str = "graph",
                **link_kwargs) -> Graph:
    """Deduplicate edges, build both CSR directions."""
    eid = src.astype(np.int64) * n + dst.astype(np.int64)
    keep = np.unique(eid, return_index=True)[1]
    src, dst = src[keep], dst[keep]
    return Graph(
        in_csr=csr_from_coo(src, dst, n),
        out_csr=csr_from_coo(dst, src, n),
        features=features.astype(np.float32),
        labels=labels,
        train_idx=splits[0], val_idx=splits[1], test_idx=splits[2],
        multilabel=multilabel, name=name, **link_kwargs)


def induced_subgraph(g: Graph, nodes: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Edges of the induced subgraph, relabeled.  Returns (src, dst, nodes).

    The reference walks the nodes one by one; this gathers every node's
    in-neighbour segment at once, in the same order (node by node, CSR
    order within a node), so the arrays are equal to the reference's."""
    nodes = np.unique(nodes)
    inv = np.full(g.n, -1, np.int64)
    inv[nodes] = np.arange(len(nodes))
    csr = g.in_csr
    starts = csr.indptr[nodes]
    lens = csr.indptr[nodes + 1] - starts
    total = int(lens.sum())
    seg0 = np.cumsum(lens) - lens                   # each segment's offset
    pos = np.arange(total, dtype=np.int64) - np.repeat(seg0 - starts, lens)
    loc = inv[csr.indices[pos]]
    rows = np.repeat(np.arange(len(nodes), dtype=np.int64), lens)
    sel = loc >= 0
    return loc[sel], rows[sel], nodes
