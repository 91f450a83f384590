"""Synthetic ogbn-arxiv look-alike (no network access).

numpy twin of ``repro.graph.datasets`` (``_sbm_edges``, ``_features``,
``_splits``, ``_node_classification``, ``synthetic_arxiv``): for the same
seed it draws the same random numbers in the same order and returns
array-equal graphs, so both packages serve the very same data.

The one change is the degree cap in :func:`_sbm_edges`: the reference keeps
the first ``max_degree`` in-edges of every node with a Python loop over all
edges; here the same rule is a stable sort by target plus a rank within
each target's run.  It consumes no random numbers, so the outputs stay
array-equal, without a Python loop over the ~1M edges of ogbn-arxiv's
169,343 nodes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph, build_graph


def _first_per_target(dst: np.ndarray, cap: int) -> np.ndarray:
    """Mask keeping, for every target id, its first ``cap`` occurrences in
    array order (the reference's sequential counting loop, vectorized)."""
    m = len(dst)
    if m == 0:
        return np.zeros(0, bool)
    order = np.argsort(dst, kind='stable')
    sd = dst[order]
    starts = np.flatnonzero(np.r_[True, sd[1:] != sd[:-1]])
    run_len = np.diff(np.r_[starts, m])
    rank = np.empty(m, np.int64)
    rank[order] = np.arange(m) - np.repeat(starts, run_len)
    return rank < cap


def _sbm_edges(rng: np.random.Generator, labels: np.ndarray, avg_deg: float,
               homophily: float, max_degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Degree-capped stochastic block model edges (undirected, symmetrized)."""
    n = len(labels)
    n_classes = labels.max() + 1
    by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    half = max(1, int(avg_deg) // 2)
    degs = np.clip(rng.poisson(half, n), 1, max_degree // 2)
    total = int(degs.sum())
    srcs = np.repeat(np.arange(n), degs)
    same = rng.random(total) < homophily
    # homophilous endpoints: uniform within own class; else uniform global
    dst = rng.integers(0, n, total)
    for c in range(n_classes):
        sel = same & (labels[srcs] == c)
        if sel.any():
            dst[sel] = rng.choice(by_class[c], size=int(sel.sum()))
    # drop self loops, symmetrize
    keep = srcs != dst
    s, d = srcs[keep], dst[keep]
    src_all = np.concatenate([s, d])
    dst_all = np.concatenate([d, s])
    # degree cap: keep first max_degree in-edges per node
    order = rng.permutation(len(src_all))
    src_all, dst_all = src_all[order], dst_all[order]
    keep = _first_per_target(dst_all, max_degree)
    return src_all[keep], dst_all[keep]


def _features(rng: np.random.Generator, labels: np.ndarray, f: int,
              noise: float, src: np.ndarray, dst: np.ndarray,
              mix: float = 0.3, sub_clusters: int = 6) -> np.ndarray:
    """Class-conditioned features with sub-cluster structure plus one hop
    of neighbor averaging (so message passing is genuinely useful)."""
    n_classes = labels.max() + 1
    centers = rng.normal(0, 1, (n_classes, f)).astype(np.float32)
    subs = centers[:, None, :] + 0.6 * rng.normal(
        0, 1, (n_classes, sub_clusters, f)).astype(np.float32)
    sub_of = rng.integers(0, sub_clusters, len(labels))
    x = subs[labels, sub_of] + (0.35 * noise) * rng.normal(
        0, 1, (len(labels), f)).astype(np.float32)
    agg = np.zeros_like(x)
    cnt = np.zeros(len(labels), np.float32)
    # np.add.at sums in edge order -- the reference's exact f32 rounding
    np.add.at(agg, dst, x[src])
    np.add.at(cnt, dst, 1.0)
    agg /= np.maximum(cnt, 1.0)[:, None]
    return ((1 - mix) * x + mix * agg).astype(np.float32)


def _splits(rng: np.random.Generator, n: int,
            train_frac: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    perm = rng.permutation(n)
    n_tr = int(train_frac * n)
    n_val = int(0.15 * n)
    return perm[:n_tr], perm[n_tr:n_tr + n_val], perm[n_tr + n_val:]


def _node_classification(name: str, n: int, f: int, n_classes: int,
                         avg_deg: float, homophily: float, noise: float,
                         train_frac: float, max_degree: int,
                         seed: int) -> Graph:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n)
    src, dst = _sbm_edges(rng, labels, avg_deg, homophily, max_degree)
    x = _features(rng, labels, f, noise, src, dst)
    return build_graph(src, dst, n, x, labels.astype(np.int64),
                       _splits(rng, n, train_frac), name=name)


def synthetic_arxiv(n: int = 6000, seed: int = 0) -> Graph:
    """ogbn-arxiv look-alike: citation graph, 40 classes, deg ~ 7, f = 128."""
    return _node_classification("arxiv-syn", n, 128, 40, avg_deg=7.0,
                                homophily=0.65, noise=0.8, train_frac=0.54,
                                max_degree=32, seed=seed)
