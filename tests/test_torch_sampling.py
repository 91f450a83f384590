"""The sampling front of the PyTorch port against the JAX reference on the
CPU: every sampler's batches, Cluster-GCN's partition, the hybrid's
widened batches, ``induced_subgraph``, ``subgraph_operands``,
``pad_bucket`` and ``pack_sampler_epoch``.

All of it is host-side numpy in both packages, so for the same numpy
``rng`` state the port must return arrays equal to the reference's
(values and dtypes; the device tables of ``subgraph_operands`` and
``pack_sampler_epoch`` equal as values) and raise the same errors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import batching as jb                       # noqa: E402
from repro.graph import sampling as js                       # noqa: E402
from repro.graph import structure as jst                     # noqa: E402
from repro.graph.datasets import synthetic_arxiv as j_arxiv  # noqa: E402
from repro_torch.graph import batching as tb                 # noqa: E402
from repro_torch.graph import sampling as ts                 # noqa: E402
from repro_torch.graph import structure as tst               # noqa: E402
from repro_torch.graph.datasets import synthetic_arxiv as t_arxiv  # noqa

CPU = "cpu"


@pytest.fixture(scope="module")
def graphs():
    return j_arxiv(n=1200, seed=0), t_arxiv(n=1200, seed=0)


def _assert_arrays_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for tg, jg in zip(got, want):
        assert len(tg) == len(jg) == 5
        for a, b in zip(tg, jg):
            _assert_arrays_equal(a, b)


def _epoch(mod, g, method, seed, partition=None, **kw):
    return mod.sample_epoch(g, method, rng=np.random.default_rng(seed),
                            partition=partition, **kw)


@pytest.mark.parametrize("method", js.SAMPLER_METHODS)
@pytest.mark.parametrize("kw", [dict(batch_size=300, fanouts=[5, 5]),
                                dict(batch_size=128, fanouts=[3, 4, 2],
                                     walk_length=2, parts_per_batch=3),
                                dict(batch_size=5000, fanouts=[8])])
def test_sample_epoch_matches_reference(graphs, method, kw):
    jg, tg = graphs
    jp = tp = None
    if method == "cluster-gcn":
        jp = js.partition_graph(jg, 16, np.random.default_rng(9))
        tp = ts.partition_graph(tg, 16, np.random.default_rng(9))
        _assert_arrays_equal(tp, jp)
    want = _epoch(js, jg, method, 3, jp, **kw)
    got = _epoch(ts, tg, method, 3, tp, **kw)
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("labor", [False, True])
def test_neighborhood_batches_on_a_pool_match_reference(graphs, labor):
    """A caller's seed pool (the whole node set, not the train split) and
    a second epoch from the same generator."""
    jg, tg = graphs
    pool = np.arange(jg.n)
    jr, tr = np.random.default_rng(4), np.random.default_rng(4)
    fn = "labor_batches" if labor else "ns_sage_batches"
    for _ in range(2):
        want = list(getattr(js, fn)(jg, 400, [4, 4], jr, pool))
        got = list(getattr(ts, fn)(tg, 400, [4, 4], tr, pool))
        _assert_batches_equal(got, want)


@pytest.mark.parametrize("n_parts", [1, 7, 32])
def test_partition_graph_matches_reference(graphs, n_parts):
    jg, tg = graphs
    for seed in (0, 5):
        _assert_arrays_equal(
            ts.partition_graph(tg, n_parts, np.random.default_rng(seed)),
            js.partition_graph(jg, n_parts, np.random.default_rng(seed)))


@pytest.mark.parametrize("n_ctx", [None, 0, 50, 10**6])
@pytest.mark.parametrize("pool", [False, True])
def test_hybrid_epoch_batches_match_reference(graphs, n_ctx, pool):
    jg, tg = graphs
    idx_pool = jg.train_idx if pool else None
    want = js.hybrid_epoch_batches(jg, 256, [3, 3],
                                   np.random.default_rng(2), n_ctx=n_ctx,
                                   idx_pool=idx_pool)
    got = ts.hybrid_epoch_batches(tg, 256, [3, 3], np.random.default_rng(2),
                                  n_ctx=n_ctx, idx_pool=idx_pool)
    for a, b in zip(got, want):
        _assert_arrays_equal(a, b)
    for row in got[0]:
        assert len(np.unique(row)) == len(row)


def test_induced_subgraph_matches_reference(graphs):
    jg, tg = graphs
    rng = np.random.default_rng(0)
    cases = [np.zeros(0, np.int64), np.arange(jg.n),
             rng.choice(jg.n, 300, replace=False),      # unsorted
             rng.integers(0, jg.n, 500),                # duplicates
             np.array([7], np.int64), rng.choice(jg.n, 40).astype(np.int32)]
    for nodes in cases:
        want = jst.induced_subgraph(jg, nodes)
        got = tst.induced_subgraph(tg, nodes)
        for a, b in zip(got, want):
            _assert_arrays_equal(a, b)


@pytest.mark.parametrize("n_pad", [None, 2048])
def test_subgraph_operands_and_sampler_plan_match_reference(graphs, n_pad):
    jg, tg = graphs
    deg_cap = jg.max_degree()
    batches = js.sample_epoch(jg, "labor", batch_size=300,
                              rng=np.random.default_rng(1), fanouts=[4, 4])
    for src, dst, nodes, _, _ in batches[:2]:
        p = jb.pad_bucket(len(nodes))
        jo = jb.subgraph_operands(src, dst, p, deg_cap)
        to = tb.subgraph_operands(src, dst, p, deg_cap, device=CPU)
        for name in ("nbr_ids", "nbr_mask", "degrees"):
            assert np.array_equal(getattr(to, name).numpy(),
                                  np.asarray(getattr(jo, name)))
        assert to.stripe_index is None
    jp = jb.pack_sampler_epoch(batches, deg_cap, n_pad)
    tp = tb.pack_sampler_epoch(batches, deg_cap, n_pad, device=CPU)
    assert (tp.s, tp.p) == (jp.s, jp.p)
    for name in jp._fields:
        got, want = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert got.shape == want.shape
        assert np.array_equal(got, want), name


def test_pad_bucket_and_plan_errors_match_reference(graphs):
    for n in (0, 1, 255, 256, 257, 5000, 1 << 21, (1 << 22) - 1, 1 << 22):
        assert tb.pad_bucket(n) == jb.pad_bucket(n)
    for n, cap in ((900, 1000), (300, 512), (600, 600)):
        assert tb.pad_bucket(n, cap) == jb.pad_bucket(n, cap)
    assert tb.PAD_BUCKET_CAP == jb.PAD_BUCKET_CAP
    for mod in (jb, tb):
        with pytest.raises(ValueError, match="pad-bucket cap"):
            mod.pad_bucket((1 << 22) + 1)
    jg, _ = graphs
    batches = js.sample_epoch(jg, "graphsaint-rw", batch_size=200,
                              rng=np.random.default_rng(0))
    for mod, kw in ((jb, {}), (tb, {"device": CPU})):
        with pytest.raises(ValueError, match="at least one batch"):
            mod.pack_sampler_epoch([], 8, **kw)
        with pytest.raises(ValueError, match="exceeds n_pad"):
            mod.pack_sampler_epoch(batches, 8, n_pad=16, **kw)


def test_sample_epoch_errors_match_reference(graphs):
    jg, tg = graphs
    for mod, g in ((js, jg), (ts, tg)):
        with pytest.raises(ValueError, match="unknown sampler"):
            mod.sample_epoch(g, "metropolis", batch_size=64,
                             rng=np.random.default_rng(0))
        with pytest.raises(ValueError, match="partition"):
            mod.sample_epoch(g, "cluster-gcn", batch_size=64,
                             rng=np.random.default_rng(0))
    assert ts.SAMPLER_METHODS == js.SAMPLER_METHODS
