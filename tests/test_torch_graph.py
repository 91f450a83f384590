"""Graph host layer of the PyTorch port vs the JAX reference: the numpy
twins of ``graph/structure.py`` and ``graph/datasets.py`` are array-equal
for the same seed, and the torch ``graph/batching.py`` (ELL packing, the
wrap-padded slicers, the epoch plan and the on-device ``plan_batch``)
produces the reference's tables, tail padding and duplicate ids
included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import batching as jb                       # noqa: E402
from repro.graph import datasets as jd                       # noqa: E402
from repro.graph import structure as js                      # noqa: E402
from repro_torch.graph import batching as tb                 # noqa: E402
from repro_torch.graph import datasets as td                 # noqa: E402
from repro_torch.graph import structure as ts                # noqa: E402

import jax.numpy as jnp                                      # noqa: E402

CPU = "cpu"


def _graph_equal(a, b):
    for f in ("features", "labels", "train_idx", "val_idx", "test_idx"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    for d in ("in_csr", "out_csr"):
        for f in ("indptr", "indices"):
            x, y = getattr(getattr(a, d), f), getattr(getattr(b, d), f)
            assert np.array_equal(x, y) and x.dtype == y.dtype, (d, f)
    assert (a.n, a.m, a.f, a.num_classes, a.max_degree(), a.name) == \
        (b.n, b.m, b.f, b.num_classes, b.max_degree(), b.name)


@pytest.fixture(scope="module")
def graphs():
    return jd.synthetic_arxiv(n=300, seed=0), td.synthetic_arxiv(n=300, seed=0)


@pytest.mark.parametrize("n,seed", [(300, 0), (300, 5), (2000, 1)])
def test_synthetic_arxiv_array_equal(n, seed):
    _graph_equal(jd.synthetic_arxiv(n=n, seed=seed),
                 td.synthetic_arxiv(n=n, seed=seed))


def test_degree_cap_matches_sequential_loop():
    """The vectorized cap keeps exactly the first ``cap`` occurrences of
    every target in array order -- the reference's counting loop."""
    rng = np.random.default_rng(3)
    dst = rng.integers(0, 50, 4000)
    count = np.zeros(50, np.int64)
    want = np.zeros(len(dst), bool)
    for i, t in enumerate(dst):
        if count[t] < 7:
            count[t] += 1
            want[i] = True
    assert np.array_equal(td._first_per_target(dst, 7), want)
    assert td._first_per_target(np.zeros(0, np.int64), 3).shape == (0,)


def test_csr_and_build_graph_equal():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 40, 300), rng.integers(0, 40, 300)
    a, b = js.csr_from_coo(src, dst, 40), ts.csr_from_coo(src, dst, 40)
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.degrees(), b.degrees())
    assert a.max_degree() == b.max_degree()
    assert np.array_equal(a.neighbors(7), b.neighbors(7))
    x = rng.normal(size=(40, 3)).astype(np.float32)
    lab = rng.integers(0, 4, 40)
    splits = (np.arange(10), np.arange(10, 20), np.arange(20, 40))
    _graph_equal(js.build_graph(src, dst, 40, x, lab, splits),
                 ts.build_graph(src, dst, 40, x, lab, splits))


@pytest.mark.parametrize("n,b", [(10, 4), (300, 128), (300, 100), (5, 9),
                                 (0, 4)])
def test_slicers_equal(n, b):
    perm = np.random.default_rng(n).permutation(n)
    for want, got in [(jb.epoch_slices(perm, b), tb.epoch_slices(perm, b)),
                      (jb.inference_slices(n, b),
                       tb.inference_slices(n, b))]:
        for w, g in zip(want, got):
            assert np.array_equal(w, g) and w.dtype == g.dtype


def test_pack_rows_full_operands_and_plan_equal(graphs):
    jg, tg = graphs
    ids = np.random.default_rng(1).choice(jg.n, 50, replace=False)
    inv = np.full(jg.n, -1, np.int32)
    inv[ids] = np.arange(50, dtype=np.int32)
    for w, g in zip(jb._pack_rows(jg.in_csr, ids, 12, inv),
                    tb._pack_rows(tg.in_csr, ids, 12, inv)):
        assert np.array_equal(w, g) and w.dtype == g.dtype
    jops, tops = jb.full_operands(jg), tb.full_operands(tg, device=CPU)
    for f in ("nbr_ids", "nbr_mask", "degrees"):
        w, g = np.asarray(getattr(jops, f)), getattr(tops, f).numpy()
        assert np.array_equal(w, g) and w.dtype == g.dtype, f
    jplan = jb.build_epoch_plan(jg, full_ops=jops)
    tplan = tb.build_epoch_plan(tg, full_ops=tops)
    assert tplan.nbr_ids is tops.nbr_ids          # aliases, no second copy
    assert tplan.n == jplan.n == jg.n
    for f in ("nbr_ids", "nbr_mask", "rev_ids", "rev_mask"):
        assert np.array_equal(np.asarray(getattr(jplan, f)),
                              getattr(tplan, f).numpy()), f
    # an explicit deg_cap different from the operands' packs anew
    tplan2 = tb.build_epoch_plan(tg, deg_cap=4, full_ops=tops, device=CPU)
    jplan2 = jb.build_epoch_plan(jg, deg_cap=4, full_ops=jops)
    assert np.array_equal(np.asarray(jplan2.nbr_ids), tplan2.nbr_ids.numpy())


def _plan_pair(graphs):
    jg, tg = graphs
    return (jb.build_epoch_plan(jg), tb.build_epoch_plan(tg, device=CPU))


@pytest.mark.parametrize("case", ["distinct", "tail", "duplicates"])
def test_plan_batch_equal(graphs, case):
    """Distinct ids, the wrap-padded tail batch of a non-divisible
    inference sweep, and serve-style duplicate ids (padding repeats id 0,
    requests repeat ids): every field array-equal to the reference."""
    jplan, tplan = _plan_pair(graphs)
    n = graphs[0].n
    smask = None
    if case == "distinct":
        bids = np.random.default_rng(2).choice(n, 64, replace=False)
    elif case == "tail":
        ids, sm = jb.inference_slices(n, 128)
        bids, smask = ids[-1], sm[-1]
        assert (sm[-1] == 0).any()
    else:
        bids = np.concatenate([np.arange(64) % 40, np.zeros(20, np.int64)])
    jpack = jb.plan_batch(jplan, jnp.asarray(bids.astype(np.int32)),
                          None if smask is None else jnp.asarray(smask))
    tpack = tb.plan_batch(tplan, torch.from_numpy(bids.astype(np.int32)),
                          None if smask is None else torch.from_numpy(smask))
    for f in ("batch_ids", "nbr_ids", "nbr_mask", "nbr_pos", "rev_ids",
              "rev_mask", "rev_pos"):
        w, g = np.asarray(getattr(jpack, f)), getattr(tpack, f).numpy()
        assert np.array_equal(w, g) and w.dtype == g.dtype, f
    assert tpack.b == len(bids)
    if smask is not None:
        assert np.array_equal(tpack.slot_mask.numpy(), smask)
    # every in-batch position points at a slot holding that very node
    pos, nbr = tpack.nbr_pos.numpy(), tpack.nbr_ids.numpy()
    hit = pos >= 0
    assert np.array_equal(bids[pos[hit]], nbr[hit])
