"""The benchmark's graph: a degree-capped stochastic block model with
class-conditioned features, drawn on the host from the run's seed.

A frozen copy of the numpy generator behind ``synthetic_arxiv`` (the
program's ``graph/datasets.py``), kept here so that a change to the
program cannot change the data it is measured on.  The parameters come
from the configuration's ``graph`` group: ogbn-arxiv's node count,
feature width, class count and mean degree.  The result is the raw data
the program and the reference both receive: the edge list as drawn
(duplicates included), features, labels and the train / val / test split.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RawGraph(NamedTuple):
    n: int
    src: np.ndarray        # [m] int64, edges src -> dst, duplicates kept
    dst: np.ndarray
    features: np.ndarray   # [n, f] float32
    labels: np.ndarray     # [n] int64
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray


def _first_per_target(dst: np.ndarray, cap: int) -> np.ndarray:
    """Mask keeping, for every target id, its first ``cap`` occurrences in
    array order."""
    m = len(dst)
    order = np.argsort(dst, kind="stable")
    sd = dst[order]
    starts = np.flatnonzero(np.r_[True, sd[1:] != sd[:-1]])
    run_len = np.diff(np.r_[starts, m])
    rank = np.empty(m, np.int64)
    rank[order] = np.arange(m) - np.repeat(starts, run_len)
    return rank < cap


def _sbm_edges(rng, labels, avg_deg, homophily, max_degree):
    n = len(labels)
    by_class = [np.where(labels == c)[0] for c in range(labels.max() + 1)]
    half = max(1, int(avg_deg) // 2)
    degs = np.clip(rng.poisson(half, n), 1, max_degree // 2)
    total = int(degs.sum())
    srcs = np.repeat(np.arange(n), degs)
    same = rng.random(total) < homophily
    dst = rng.integers(0, n, total)
    for c, members in enumerate(by_class):
        sel = same & (labels[srcs] == c)
        if sel.any():
            dst[sel] = rng.choice(members, size=int(sel.sum()))
    keep = srcs != dst
    s, d = srcs[keep], dst[keep]
    src_all = np.concatenate([s, d])
    dst_all = np.concatenate([d, s])
    order = rng.permutation(len(src_all))
    src_all, dst_all = src_all[order], dst_all[order]
    keep = _first_per_target(dst_all, max_degree)
    return src_all[keep], dst_all[keep]


def _features(rng, labels, f, noise, src, dst, mix=0.3, sub_clusters=6):
    n_classes = labels.max() + 1
    centers = rng.normal(0, 1, (n_classes, f)).astype(np.float32)
    subs = centers[:, None, :] + 0.6 * rng.normal(
        0, 1, (n_classes, sub_clusters, f)).astype(np.float32)
    sub_of = rng.integers(0, sub_clusters, len(labels))
    x = subs[labels, sub_of] + (0.35 * noise) * rng.normal(
        0, 1, (len(labels), f)).astype(np.float32)
    agg = np.zeros_like(x)
    cnt = np.zeros(len(labels), np.float32)
    np.add.at(agg, dst, x[src])
    np.add.at(cnt, dst, 1.0)
    agg /= np.maximum(cnt, 1.0)[:, None]
    return ((1 - mix) * x + mix * agg).astype(np.float32)


def generate(graph: dict, seed: int) -> RawGraph:
    """The raw graph of a configuration's ``graph`` group for ``seed``."""
    n = graph["n_nodes"]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, graph["n_classes"], n)
    src, dst = _sbm_edges(rng, labels, graph["avg_degree"],
                          graph["homophily"], graph["max_degree"])
    x = _features(rng, labels, graph["f_in"], graph["noise"], src, dst)
    perm = rng.permutation(n)
    n_tr = int(graph["train_frac"] * n)
    n_val = int(0.15 * n)
    return RawGraph(n, src.astype(np.int64), dst.astype(np.int64), x,
                    labels.astype(np.int64), perm[:n_tr],
                    perm[n_tr:n_tr + n_val], perm[n_tr + n_val:])
