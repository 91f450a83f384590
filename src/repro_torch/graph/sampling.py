"""The paper's sampling baselines (Sec. 5 / Table 2), LABOR, and the
VQ/sampling hybrid's batches.

numpy twin of ``repro.graph.sampling``: for the same ``rng`` state every
function makes the same draws in the same order and returns arrays equal
to the reference's, so both packages train on the very same subgraphs.

Every sampler yields the same 5-tuple

    (src, dst, nodes, seed_pos, seed_weight)

``src`` / ``dst`` the local edge endpoints of the induced subgraph,
``nodes`` its sorted global node ids, ``seed_pos`` the in-subgraph
positions of the batch's seeds and ``seed_weight`` a float per seed (0.0
on the wrap-padded tail seeds of ``epoch_slices``: every pool id is a
loss-bearing seed exactly once per epoch).  The baseline trainer runs
exact message passing on the sampled subgraph; inference is over the full
neighbourhood.

``hybrid_epoch_batches`` feeds the VQ epoch executor: a seed partition
widened with LABOR-sampled multi-hop neighbours, whose messages become
exact while VQ covers the rest.
"""
from __future__ import annotations

from collections import deque
from typing import Iterator, Optional

import numpy as np

from repro_torch.graph.batching import epoch_slices
from repro_torch.graph.structure import Graph, induced_subgraph

SamplerBatch = tuple


def _labor_select(csr, frontier: np.ndarray, fanout: int,
                  rvals: np.ndarray) -> list[np.ndarray]:
    """LABOR's pick: seed i keeps its (at most) ``fanout`` in-neighbours
    with the smallest of ``rvals`` -- one uniform per graph node, drawn
    once per layer and shared by every seed, so seeds that share
    neighbours make correlated picks."""
    out = []
    for i in frontier:
        ns = csr.neighbors(i)
        if len(ns) > fanout:
            ns = ns[np.argsort(rvals[ns], kind="stable")[:fanout]]
        out.append(ns)
    return out


def _ns_select(csr, frontier: np.ndarray, fanout: int,
               rng: np.random.Generator) -> list[np.ndarray]:
    """NS-SAGE's pick: an independent uniform subset of ``fanout``."""
    out = []
    for i in frontier:
        ns = csr.neighbors(i)
        if len(ns) > fanout:
            ns = rng.choice(ns, fanout, replace=False)
        out.append(ns)
    return out


def _expand_batch(g: Graph, seeds: np.ndarray, fanouts: list[int],
                  rng: np.random.Generator, *, labor: bool
                  ) -> tuple[set, list[list[np.ndarray]]]:
    """Union of the sampled L-hop neighbourhoods around ``seeds``: (node
    set, per-layer list of the frontier's picks)."""
    frontier = np.asarray(seeds, np.int64)
    nodes = set(frontier.tolist())
    layers = []
    for r in fanouts:
        if labor:
            picks = _labor_select(g.in_csr, frontier, r, rng.random(g.n))
        else:
            picks = _ns_select(g.in_csr, frontier, r, rng)
        layers.append(picks)
        nxt = set()
        for ns in picks:
            nxt.update(int(t) for t in ns)
        frontier = np.array(sorted(nxt - nodes), np.int64)
        nodes.update(nxt)
    return nodes, layers


def _neighborhood_batches(g: Graph, batch_size: int, fanouts: list[int],
                          rng: np.random.Generator, idx_pool: np.ndarray,
                          *, labor: bool) -> Iterator[SamplerBatch]:
    """NS-SAGE / LABOR: wrap-padded seed batches, L rounds of neighbour
    expansion, the induced subgraph, loss on the real seeds only."""
    ids, smask = epoch_slices(rng.permutation(idx_pool), batch_size)
    for s in range(ids.shape[0]):
        seeds = ids[s]
        nodes, _ = _expand_batch(g, seeds, fanouts, rng, labor=labor)
        sub = np.array(sorted(nodes), np.int64)
        src, dst, sub = induced_subgraph(g, sub)
        seed_pos = np.searchsorted(sub, seeds)
        yield src, dst, sub, seed_pos, smask[s].astype(np.float32)


def ns_sage_batches(g: Graph, batch_size: int, fanouts: list[int],
                    rng: np.random.Generator,
                    idx_pool: np.ndarray) -> Iterator[SamplerBatch]:
    """NS-SAGE: per-layer fixed-fanout independent neighbour sampling."""
    return _neighborhood_batches(g, batch_size, fanouts, rng, idx_pool,
                                 labor=False)


def labor_batches(g: Graph, batch_size: int, fanouts: list[int],
                  rng: np.random.Generator,
                  idx_pool: np.ndarray) -> Iterator[SamplerBatch]:
    """LABOR (Layer-Neighbor Sampling): NS-SAGE's contract with one
    shared uniform per node and layer ranking the candidates."""
    return _neighborhood_batches(g, batch_size, fanouts, rng, idx_pool,
                                 labor=True)


def partition_graph(g: Graph, n_parts: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Cluster-GCN's partition (a METIS stand-in): multi-source BFS from
    ``n_parts`` random seeds, 64 steps a part per round; nodes no BFS
    reaches get a random part."""
    part = np.full(g.n, -1, np.int64)
    seeds = rng.choice(g.n, n_parts, replace=False)
    queues = [deque([s]) for s in seeds]
    part[seeds] = np.arange(n_parts)
    active = True
    while active:
        active = False
        for p in range(n_parts):
            q = queues[p]
            steps = 0
            while q and steps < 64:
                i = q.popleft()
                for j in g.in_csr.neighbors(i):
                    if part[j] < 0:
                        part[j] = p
                        q.append(int(j))
                        steps += 1
                active = active or steps > 0
    unassigned = np.where(part < 0)[0]
    if len(unassigned):
        part[unassigned] = rng.integers(0, n_parts, len(unassigned))
    return part


def cluster_gcn_batches(g: Graph, partition: np.ndarray,
                        parts_per_batch: int,
                        rng: np.random.Generator) -> Iterator[SamplerBatch]:
    """Cluster-GCN: the union subgraph of ``parts_per_batch`` random
    partitions a batch; the tail batch keeps the remaining partitions."""
    n_parts = int(partition.max()) + 1
    order = rng.permutation(n_parts)
    for s in range(0, n_parts, parts_per_batch):
        chosen = order[s:s + parts_per_batch]
        nodes = np.where(np.isin(partition, chosen))[0]
        src, dst, nodes = induced_subgraph(g, nodes)
        yield (src, dst, nodes, np.arange(len(nodes)),
               np.ones(len(nodes), np.float32))


def graphsaint_rw_batches(g: Graph, roots: int, walk_length: int,
                          rng: np.random.Generator,
                          idx_pool: np.ndarray) -> Iterator[SamplerBatch]:
    """GraphSAINT-RW: random-walk induced subgraphs from wrap-padded
    roots; the loss covers every subgraph node."""
    ids, _ = epoch_slices(rng.permutation(idx_pool), roots)
    for s in range(ids.shape[0]):
        cur = ids[s].copy()
        nodes = set(cur.tolist())
        for _ in range(walk_length):
            for t in range(len(cur)):
                ns = g.in_csr.neighbors(cur[t])
                if len(ns):
                    cur[t] = ns[rng.integers(0, len(ns))]
                    nodes.add(int(cur[t]))
        sub_nodes = np.array(sorted(nodes), np.int64)
        src, dst, sub_nodes = induced_subgraph(g, sub_nodes)
        yield (src, dst, sub_nodes, np.arange(len(sub_nodes)),
               np.ones(len(sub_nodes), np.float32))


SAMPLER_METHODS = ("ns-sage", "labor", "cluster-gcn", "graphsaint-rw")


def sample_epoch(g: Graph, method: str, *, batch_size: int,
                 rng: np.random.Generator, fanouts: list[int] | None = None,
                 walk_length: int = 3,
                 partition: Optional[np.ndarray] = None,
                 parts_per_batch: int = 4,
                 idx_pool: Optional[np.ndarray] = None
                 ) -> list[SamplerBatch]:
    """One epoch of pre-sampled batches of any sampler, materialized: the
    one sampling front of the executor, the host loop and the tests."""
    pool = idx_pool if idx_pool is not None else g.train_idx
    if method == "ns-sage":
        it = ns_sage_batches(g, batch_size, fanouts or [5], rng, pool)
    elif method == "labor":
        it = labor_batches(g, batch_size, fanouts or [5], rng, pool)
    elif method == "cluster-gcn":
        if partition is None:
            raise ValueError("cluster-gcn needs a partition= array")
        it = cluster_gcn_batches(g, partition, parts_per_batch, rng)
    elif method == "graphsaint-rw":
        it = graphsaint_rw_batches(g, batch_size, walk_length, rng, pool)
    else:
        raise ValueError(
            f"unknown sampler {method!r}; expected one of {SAMPLER_METHODS}")
    return list(it)


# ---------------------------------------------------------------------------
# VQ/sampling hybrid batches
# ---------------------------------------------------------------------------

def hybrid_epoch_batches(g: Graph, batch_size: int, fanouts: list[int],
                         rng: np.random.Generator,
                         n_ctx: Optional[int] = None,
                         idx_pool: Optional[np.ndarray] = None
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Sampler-expanded [S, b + n_ctx] batches for the VQ epoch executor.

    Each row holds ``batch_size`` seed slots (an ``epoch_slices``
    partition of the pool) plus ``n_ctx`` context slots of LABOR-sampled
    multi-hop neighbours of the seeds (deduplicated; a shortfall is filled
    with out-of-batch nodes in id order), all ids of a row distinct.  The
    slot mask is 1.0 on the loss-bearing seed slots only.  ``n_ctx=0``
    gives the plain VQ batches bit for bit."""
    pool = idx_pool if idx_pool is not None else np.arange(g.n)
    ids, smask = epoch_slices(rng.permutation(pool), batch_size)
    if ids.size == 0:
        return ids, smask
    b = ids.shape[1]
    n_ctx = b if n_ctx is None else n_ctx
    n_ctx = min(n_ctx, g.n - b)
    if n_ctx <= 0:
        return ids, smask
    out_ids = np.zeros((ids.shape[0], b + n_ctx), np.int64)
    out_mask = np.zeros((ids.shape[0], b + n_ctx), np.float32)
    for s in range(ids.shape[0]):
        seeds = ids[s]
        in_batch = np.zeros(g.n, bool)
        in_batch[seeds] = True
        picked: list[int] = []
        frontier = seeds
        for r in fanouts:
            sel = _labor_select(g.in_csr, frontier, r, rng.random(g.n))
            fresh = []
            for ns in sel:
                for t in ns:
                    t = int(t)
                    if not in_batch[t]:
                        in_batch[t] = True
                        fresh.append(t)
            picked.extend(fresh)
            frontier = np.array(sorted(fresh), np.int64)
            if len(picked) >= n_ctx:
                break
        ctx = np.array(picked[:n_ctx], np.int64)
        if len(ctx) < n_ctx:
            free = np.where(~in_batch)[0]
            ctx = np.concatenate([ctx, free[:n_ctx - len(ctx)]])
        out_ids[s, :b] = seeds
        out_ids[s, b:] = ctx
        out_mask[s, :b] = smask[s]
    return out_ids, out_mask
