"""Synthetic look-alikes of the paper's benchmarks (no network access).

numpy twin of ``repro.graph.datasets``: the ogbn-arxiv, Reddit, Flickr,
PPI (inductive, multilabel) and ogbl-collab (link prediction, with its
held-out positive and negative edges) look-alikes and ``DATASETS``.  For
the same ``n`` and seed every generator draws the same random numbers in
the same order and returns array-equal graphs, so both packages serve the
very same data.

The one change is the degree cap in :func:`_sbm_edges`: the reference keeps
the first ``max_degree`` in-edges of every node with a Python loop over all
edges; here the same rule is a stable sort by target plus a rank within
each target's run.  It consumes no random numbers, so the outputs stay
array-equal, without a Python loop over the ~1.9M edges of ogbl-collab's
235,868 nodes.
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


def synthetic_reddit(n: int = 4000, seed: int = 1) -> Graph:
    """Reddit look-alike: dense social graph, 41 classes, deg ~ 25 (capped),
    f = 64 (stands in for 602; dense-degree is the stressor, Table 6)."""
    return _node_classification("reddit-syn", n, 64, 41, avg_deg=25.0,
                                homophily=0.7, noise=0.7, train_frac=0.66,
                                max_degree=48, seed=seed)


def synthetic_flickr(n: int = 5000, seed: int = 2) -> Graph:
    """Flickr look-alike: 7 classes, deg ~ 10, f = 100."""
    return _node_classification("flickr-syn", n, 100, 7, avg_deg=10.0,
                                homophily=0.55, noise=1.0, train_frac=0.50,
                                max_degree=32, seed=seed)


def synthetic_ppi(n: int = 4000, n_labels: int = 24, seed: int = 3) -> Graph:
    """PPI look-alike: inductive, multi-label (121 -> 24), deg ~ 14.  The
    training view without the val / test nodes' edges is
    ``graph.batching.inductive_view``."""
    rng = np.random.default_rng(seed)
    # latent communities drive both edges and the multilabel targets
    z = rng.integers(0, 12, n)
    src, dst = _sbm_edges(rng, z, 14.0, 0.6, max_degree=40)
    proto = rng.random((12, n_labels)) < 0.3
    flip = rng.random((n, n_labels)) < 0.1
    y = np.logical_xor(proto[z], flip).astype(np.float32)
    x = _features(rng, z, 50, 1.0, src, dst)
    return build_graph(src, dst, n, x, y, _splits(rng, n, 0.79),
                       multilabel=True, name="ppi-syn")


def synthetic_collab(n: int = 5000, seed: int = 4) -> Graph:
    """ogbl-collab look-alike: link prediction, deg ~ 5, f = 128.

    The undirected edges are split into message-passing (``train_edges``,
    both directions in the graph), val and test positives (a tenth each,
    at least 64); the val / test negatives are uniform node pairs.
    Metric: Hits@50 (``models.gnn.hits_at_k``)."""
    rng = np.random.default_rng(seed)
    z = rng.integers(0, 30, n)
    src, dst = _sbm_edges(rng, z, 8.0, 0.7, max_degree=32)
    x = _features(rng, z, 128, 0.9, src, dst)

    und = src < dst
    edges = np.stack([src[und], dst[und]], 1)
    perm = rng.permutation(len(edges))
    n_val = n_test = max(64, len(edges) // 10)
    val_e = edges[perm[:n_val]]
    test_e = edges[perm[n_val:n_val + n_test]]
    msg_e = edges[perm[n_val + n_test:]]

    def negs(count):
        return np.stack([rng.integers(0, n, count),
                         rng.integers(0, n, count)], 1)

    s2, d2 = msg_e[:, 0], msg_e[:, 1]
    # keyword arguments are evaluated in order: the val negatives are
    # drawn before the test negatives, as in the reference
    return build_graph(np.concatenate([s2, d2]), np.concatenate([d2, s2]), n,
                       x, z.astype(np.int64), _splits(rng, n, 0.8),
                       name="collab-syn",
                       train_edges=msg_e, val_edges=val_e,
                       val_neg_edges=negs(len(val_e)), test_edges=test_e,
                       test_neg_edges=negs(len(test_e)))


DATASETS = {
    "arxiv": synthetic_arxiv,
    "reddit": synthetic_reddit,
    "flickr": synthetic_flickr,
    "ppi": synthetic_ppi,
    "collab": synthetic_collab,
}
