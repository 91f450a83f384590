"""The link task of the PyTorch port against the JAX reference on the CPU,
with the host-stepped batch loops and the remaining datasets: the four
dataset look-alikes (Reddit, Flickr, PPI, ogbl-collab) and the inductive
view array-equal, the host packer (``make_pack``, ``minibatch_stream``)
equal to the reference's and to ``plan_batch``, ``link_loss`` and its
gradient, ``hits_at_k`` bit for bit, one link ``vq_train_step`` from
carried state, the link task through ``train_vq``, ``train_full`` and
``train_sampler`` (NS-SAGE, Cluster-GCN), the reference's own link
system test, PPI's inductive training and inference, and the example --
at a small size (n 300-800, 2 layers, hidden <= 48, k <= 64).  Both
packages start from the same weights and VQ states (the port's initial
ones copied into the reference; trained ones copied into the port with
``repro_torch.convert``); the reference runs its oracle path
(``REPRO_FORCE_PALLAS`` unset).

Tolerances: ``link_loss`` and its gradient ``rtol=1e-5, atol=1e-6``; a
step and the trainers' per-step losses ``rtol=1e-4, atol=1e-5`` (fp32
matmuls and reductions in another order, through the backward pass and
an optimizer step); Hits@50 within 2 / len(val_edges), because the
port scores the pairs with torch and the reference with numpy, whose
sums round differently, so a score at the threshold may move a pair.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.core import codebook as jcb                        # noqa: E402
from repro.core import conv as jconv                         # noqa: E402
from repro.core.codebook import CodebookConfig as JCodebookConfig  # noqa
from repro.graph import batching as jb                       # noqa: E402
from repro.graph import datasets as jd                       # noqa: E402
from repro.models import gnn as jgnn                         # noqa: E402
from repro.train import gnn_trainer as jtrain                # noqa: E402
from repro.train import optimizer as jopt                    # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.core.codebook import CodebookConfig         # noqa: E402
from repro_torch.graph import batching as tb                 # noqa: E402
from repro_torch.graph import datasets as td                 # noqa: E402
from repro_torch.models import gnn as tgnn                   # noqa: E402
from repro_torch.train import gnn_trainer as ttrain          # noqa: E402
from repro_torch.train import optimizer as topt              # noqa: E402

STEP = dict(rtol=1e-4, atol=1e-5)
ONE = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu"
N, HIDDEN, K, BATCH = 400, 32, 32, 160
GRAPH_FIELDS = ("features", "labels", "train_idx", "val_idx", "test_idx",
                "train_edges", "val_edges", "val_neg_edges", "test_edges",
                "test_neg_edges")
PACK_FIELDS = ("batch_ids", "nbr_ids", "nbr_mask", "nbr_pos", "rev_ids",
               "rev_mask", "rev_pos", "slot_mask")


def _np_tree(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _assert_graphs_equal(a, b):
    for f in GRAPH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    for c in ("in_csr", "out_csr"):
        for f in ("indptr", "indices"):
            x, y = getattr(getattr(a, c), f), getattr(getattr(b, c), f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (c, f)
    assert (a.name, a.multilabel, a.n) == (b.name, b.multilabel, b.n)


def _assert_packs_equal(tp, jp):
    for f in PACK_FIELDS:
        a, b = getattr(tp, f), getattr(jp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def _cfgs(backbone="sage", task="link", **kw):
    base = dict(backbone=backbone, f_in=128, hidden=HIDDEN,
                n_out=HIDDEN if task == "link" else 40, n_layers=2,
                task=task)
    base.update(kw)
    return (jgnn.GNNConfig(codebook=JCodebookConfig(k=K, f_prod=4), **base),
            tgnn.GNNConfig(codebook=CodebookConfig(k=K, f_prod=4), **base))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread: these small shapes run
    tens of times slower on a thread pool that shares the cores with
    other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def collab():
    return jd.synthetic_collab(n=N, seed=4), td.synthetic_collab(n=N, seed=4)


class _Init:
    """The port's initial params and VQ states of one config (seeds 0 and
    1) and the reference's copies of them, built without the reference's
    own random draws, whose compilations would take most of this file's
    time."""

    def __init__(self, tcfg, n):
        self.tparams = tgnn.init_gnn(tcfg, torch.Generator().manual_seed(0),
                                     device=CPU)
        self.tvq = tgnn.init_vq_states(
            tcfg, n, torch.Generator().manual_seed(1), device=CPU)
        self.jparams = [{k: jnp.asarray(v.numpy()) for k, v in p.items()}
                        for p in self.tparams]
        self.jvq = [jconv.LayerVQState(
            jcb.CodebookState(*(jnp.asarray(f.numpy()) for f in st.codebook)),
            jnp.asarray(st.assignment.contiguous().numpy()),
            jnp.asarray(st.counts.numpy()), None) for st in self.tvq]

    def patch(self, monkeypatch):
        for module, params, vq in ((ttrain, self.tparams, self.tvq),
                                   (jtrain, self.jparams, self.jvq)):
            monkeypatch.setattr(module, "init_gnn",
                                lambda *a, p=params, **k: p)
            monkeypatch.setattr(module, "init_vq_states",
                                lambda *a, v=vq, **k: v)


def _recorded(monkeypatch, module, name, at):
    """Wrap ``module.name`` (a train step or epoch) so that the losses in
    its output ``at`` are recorded, in order."""
    losses, step = [], getattr(module, name)

    def wrapped(*a, **k):
        out = step(*a, **k)
        losses.extend(np.ravel(np.asarray(out[at])).tolist())
        return out
    monkeypatch.setattr(module, name, wrapped)
    return losses


_JOPTS: dict = {}


def _jopt(name, lr):
    """One reference optimizer object per (name, lr): the reference's jit
    caches its steps by the optimizer's identity, so sharing the object
    lets tests of the same shapes reuse one compilation."""
    key = (name, lr)
    if key not in _JOPTS:
        _JOPTS[key] = jopt.OPTIMIZERS[name](lr)
    return _JOPTS[key]


def _share_optimizers(monkeypatch):
    monkeypatch.setattr(jtrain, "rmsprop", lambda lr: _jopt("rmsprop", lr))
    monkeypatch.setattr(jtrain, "adam", lambda lr: _jopt("adam", lr))


# ---------------------------------------------------------------------------
# datasets and packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["reddit", "flickr", "ppi", "collab"])
@pytest.mark.parametrize("n", [300, 800])
def test_datasets_array_equal(name, n):
    assert td.DATASETS.keys() == jd.DATASETS.keys()
    _assert_graphs_equal(td.DATASETS[name](n=n), jd.DATASETS[name](n=n))


@pytest.mark.parametrize("name", ["ppi", "flickr"])
def test_inductive_view_array_equal(name):
    jg, tg = jd.DATASETS[name](n=500), td.DATASETS[name](n=500)
    tv = tb.inductive_view(tg)
    _assert_graphs_equal(tv, jb.inductive_view(jg))
    visible = np.zeros(tg.n, bool)
    visible[tg.train_idx] = True
    src = np.repeat(np.arange(tv.n), np.diff(tv.in_csr.indptr))
    assert visible[src].all() and visible[tv.in_csr.indices].all()


@pytest.mark.parametrize("stripe_index", [False, True])
def test_make_pack_equals_reference_and_plan_batch(collab, stripe_index):
    jg, tg = collab
    ids, smask = jb.epoch_slices(np.random.default_rng(3).permutation(N),
                                 150)
    tops = tb.full_operands(tg, device=CPU)
    plan = tb.build_epoch_plan(tg, full_ops=tops, device=CPU)
    for s in range(ids.shape[0]):
        kw = dict(stripe_index=stripe_index, stripe_bb=32, stripe=64,
                  slot_mask=smask[s])
        tp = tb.make_pack(tg, ids[s], device=CPU, **kw)
        _assert_packs_equal(tp, jb.make_pack(jg, ids[s], **kw))
        pp = tb.plan_batch(plan, torch.from_numpy(ids[s].astype(np.int32)),
                           torch.from_numpy(smask[s]))
        for f in PACK_FIELDS:
            assert torch.equal(getattr(tp, f), getattr(pp, f)), f
        if stripe_index:
            js = jb.make_pack(jg, ids[s], **kw).stripe_index
            assert (tp.stripe_index.bb, tp.stripe_index.stripe,
                    tp.stripe_index.n_src) == (js.bb, js.stripe, js.n_src)
            assert np.array_equal(tp.stripe_index.ids.numpy(),
                                  np.asarray(js.ids))
            assert np.array_equal(tp.stripe_index.counts.numpy(),
                                  np.asarray(js.counts))
        else:
            assert tp.stripe_index is None


def test_minibatch_stream_yields_reference_packs(collab):
    jg, tg = collab
    pool = np.arange(0, N, 3)
    tpacks = list(tb.minibatch_stream(tg, 60, np.random.default_rng(5),
                                      idx_pool=pool, device=CPU))
    jpacks = list(jb.minibatch_stream(jg, 60, np.random.default_rng(5),
                                      idx_pool=pool))
    assert len(tpacks) == len(jpacks) == 3
    for tp, jp in zip(tpacks, jpacks):
        _assert_packs_equal(tp, jp)
    assert float(tpacks[-1].slot_mask.sum()) == len(pool) - 120


# ---------------------------------------------------------------------------
# link loss and Hits@K
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_link_loss_and_gradient_match_reference(masked):
    rng = np.random.default_rng(11)
    emb = (3.0 * rng.normal(size=(50, 16))).astype(np.float32)
    pos = rng.integers(0, 50, (40, 2))
    neg = rng.integers(0, 50, (40, 2))
    pm = (rng.random(40) < 0.6).astype(np.float32) if masked else None

    def jloss(e):
        return jgnn.link_loss(e, jnp.asarray(pos), jnp.asarray(neg),
                              None if pm is None else jnp.asarray(pm))
    jl, jg_ = jax.value_and_grad(jloss)(jnp.asarray(emb))
    te = torch.from_numpy(emb).requires_grad_(True)
    tl = tgnn.link_loss(te, torch.from_numpy(pos), torch.from_numpy(neg),
                        None if pm is None else torch.from_numpy(pm))
    (tg_,) = torch.autograd.grad(tl, te)
    assert_allclose(float(tl), float(jl), **ONE)
    assert_allclose(tg_.numpy(), np.asarray(jg_), **ONE)


@pytest.mark.parametrize("case", ["random", "no_positives", "few_negatives",
                                  "no_negatives", "ties"])
@pytest.mark.parametrize("k", [1, 5, 50])
def test_hits_at_k_bit_equal(case, k):
    rng = np.random.default_rng(k)
    pos = rng.normal(size=300).astype(np.float32)
    neg = rng.normal(size=200).astype(np.float32)
    if case == "no_positives":
        pos = pos[:0]
    elif case == "few_negatives":
        neg = neg[:k - 1] if k > 1 else neg[:0]
    elif case == "no_negatives":
        neg = neg[:0]
    elif case == "ties":            # positives on the threshold miss it
        neg = np.round(neg, 1)
        pos = np.round(pos, 1)
    got, want = tgnn.hits_at_k(pos, neg, k), jgnn.hits_at_k(pos, neg, k)
    assert type(got) is float and got == want


# ---------------------------------------------------------------------------
# one step and the trainers
# ---------------------------------------------------------------------------

def test_link_vq_train_step_from_carried_state(collab):
    """One reference step from the initial state, its outputs carried into
    the port, then a second step in both packages on the next batch and
    its pairs: loss, output, VQ errors, params, RMSprop state and the
    layers' VQ states.  The batches and pairs are those of ``train_vq``'s
    first two epochs at batch N, seed 0."""
    jg, tg = collab
    jcfg, tcfg = _cfgs()
    init = _Init(tcfg, N)
    jo, to = _jopt("rmsprop", 3e-3), topt.rmsprop(3e-3)
    rng = np.random.default_rng(0)
    degrees = jnp.asarray(jg.degrees())
    tdeg = torch.from_numpy(tg.degrees())
    state = (init.jparams, init.jvq, jo.init(init.jparams))
    for s in range(2):
        ids, smask = jb.epoch_slices(rng.permutation(np.arange(N)), N)
        pos, neg = ttrain._batch_pairs(tg, ids[0], smask[0], rng)
        assert len(pos) == len(tg.train_edges)
        jpack = jb.make_pack(jg, ids[0], slot_mask=smask[0])
        jout = jgnn.vq_train_step(
            *state, jpack, jnp.asarray(jg.features)[ids[0]],
            jnp.asarray(jg.labels)[ids[0]], degrees, jcfg, jo,
            pos_pairs=jnp.asarray(pos), neg_pairs=jnp.asarray(neg))
        if s == 0:
            state = jout[:3]
            continue
        tstate = (convert.params_from_numpy(_np_tree(state[0]), CPU),
                  convert.vq_states_from_numpy(state[1], CPU),
                  convert.opt_state_from_numpy(state[2], CPU))
        tpack = tb.make_pack(tg, ids[0], slot_mask=smask[0], device=CPU)
        tout = tgnn.vq_train_step(
            *tstate, tpack, torch.from_numpy(tg.features[ids[0]]),
            torch.from_numpy(tg.labels[ids[0]]), tdeg, tcfg, to,
            pos_pairs=torch.from_numpy(pos), neg_pairs=torch.from_numpy(neg))
    (tp, tv, tos, tl, ty, te), (jp, jv, jos, jl, jy, je) = tout, jout
    assert_allclose(float(tl), float(jl), **STEP)
    assert_allclose(ty.numpy(), np.asarray(jy), **STEP)
    assert_allclose(te.numpy(), np.asarray(je), **STEP)
    for a, b in zip(tp + tos.nu, list(jp) + list(jos.nu)):
        for name in a:
            assert_allclose(a[name].numpy(), np.asarray(b[name]), **STEP)
    for a, b in zip(tv, jv):
        assert np.array_equal(a.assignment.numpy(), np.asarray(b.assignment))
        assert np.array_equal(a.counts.numpy(), np.asarray(b.counts))
        for fa, fb in zip(a.codebook, b.codebook):
            assert_allclose(fa.numpy(), np.asarray(fb), **STEP)


def _hits_close(tr, jr, g):
    for split in ("val", "test"):
        assert abs(tr["final"][split] - jr["final"][split]) \
            <= 2 / len(g.val_edges), split


def _stub_steps(monkeypatch, module, to_numpy, zeros):
    """Replace ``module.vq_train_step`` by a recorder of each step's batch
    pack and pairs that leaves the state as it is, and ``module._evaluate``
    by a constant: the host loop's batches and pairs without a step."""
    seen = []

    def step(params, vq, ost, pack, *a, pos_pairs=None, neg_pairs=None,
             **k):
        seen.append([to_numpy(t) for t in (pack.batch_ids, pack.nbr_pos,
                                           pack.slot_mask, pos_pairs,
                                           neg_pairs)])
        return params, vq, ost, zeros(()), None, zeros(2)
    monkeypatch.setattr(module, "vq_train_step", step)
    monkeypatch.setattr(module, "_evaluate",
                        lambda *a: {"val": 0.0, "test": 0.0})
    return seen


def test_train_vq_link_mines_the_reference_pairs(collab, monkeypatch):
    """The link task's host loop packs the reference's batches and mines
    its pairs from one rng stream -- the epoch's permutation, then one
    negative draw per batch; only the real slots of the wrap-padded tail
    -- over 2 epochs of 3 batches, the steps themselves stubbed out."""
    jg, tg = collab
    jcfg, tcfg = _cfgs()
    init = _Init(tcfg, N)
    init.patch(monkeypatch)
    jseen = _stub_steps(monkeypatch, jtrain, np.asarray, jnp.zeros)
    tseen = _stub_steps(monkeypatch, ttrain, lambda t: t.numpy(),
                        torch.zeros)
    jtrain.train_vq(jg, jcfg, epochs=2, batch_size=BATCH)
    tr = ttrain.train_vq(tg, tcfg, epochs=2, batch_size=BATCH, device=CPU)
    assert len(tseen) == len(jseen) == 6 and len(tr["pack_s"]) == 2
    for t, j in zip(tseen, jseen):
        for a, b in zip(t, j):
            assert np.array_equal(a, b)
    tail_pos = tseen[2][3]
    assert tail_pos.max() < N - 2 * BATCH        # real tail slots only


def test_train_vq_link_tracks_reference(collab, monkeypatch):
    """``train_vq`` on the link task in both packages from the reference's
    initial state, at batch N (every message edge a positive pair): each
    step's loss, then Hits@50 and the VQ error."""
    jg, tg = collab
    jcfg, tcfg = _cfgs()
    init = _Init(tcfg, N)
    init.patch(monkeypatch)
    _share_optimizers(monkeypatch)
    jl = _recorded(monkeypatch, jtrain, "vq_train_step", 3)
    jr = jtrain.train_vq(jg, jcfg, epochs=2, batch_size=N, eval_every=2)
    tr = ttrain.train_vq(tg, tcfg, epochs=2, batch_size=N, eval_every=2,
                         device=CPU)
    assert tr["step_losses"].shape == (2,) and len(tr["pack_s"]) == 2
    assert tr["step_vq_errs"].shape == (2, 2)
    assert_allclose(tr["step_losses"], jl, **STEP)
    _hits_close(tr, jr, tg)
    assert_allclose(tr["final"]["vq_err"], jr["final"]["vq_err"], **STEP)
    with pytest.raises(ValueError, match="node-task batch-construction"):
        ttrain.train_vq(tg, tcfg, epochs=1, batch_size=BATCH, device=CPU,
                        batch_fn=lambda rng: None)


def test_train_full_link_tracks_reference(collab, monkeypatch):
    jg, tg = collab
    jcfg, tcfg = _cfgs()
    init = _Init(tcfg, N)
    init.patch(monkeypatch)
    _share_optimizers(monkeypatch)
    jl = _recorded(monkeypatch, jtrain, "full_train_step", 2)
    tl = _recorded(monkeypatch, ttrain, "full_train_step", 2)
    jr = jtrain.train_full(jg, jcfg, epochs=3, eval_every=3)
    tr = ttrain.train_full(tg, tcfg, epochs=3, eval_every=3, device=CPU)
    assert len(tl) == 3
    assert_allclose(tl, jl, **STEP)
    _hits_close(tr, jr, tg)


@pytest.mark.parametrize("method", ["ns-sage", "cluster-gcn"])
def test_train_sampler_link_tracks_reference(collab, monkeypatch, method):
    """The sampling baselines on the link task (the host loop: pairs mined
    per subgraph, at most 4,096 under a pair mask, a subgraph with fewer
    than two skipped): each step's loss, then Hits@50."""
    jg, tg = collab
    jcfg, tcfg = _cfgs()
    init = _Init(tcfg, N)
    init.patch(monkeypatch)
    _share_optimizers(monkeypatch)
    jl = _recorded(monkeypatch, jtrain, "full_train_step", 2)
    kw = dict(epochs=1, batch_size=160, eval_every=1, n_parts=4,
              parts_per_batch=2)
    jr = jtrain.train_sampler(jg, jcfg, method, **kw)
    tr = ttrain.train_sampler(tg, tcfg, method, device=CPU, **kw)
    assert len(jl) > 0
    assert_allclose(tr["losses"][0], jl, **STEP)
    _hits_close(tr, jr, tg)


def test_link_prediction_path():
    """Twin of the reference's system test (``tests/test_system.py``):
    VQ-GNN's val Hits@50 well above random."""
    g = td.synthetic_collab(n=800)
    cfg = tgnn.GNNConfig(backbone="sage", f_in=g.f, hidden=48, n_out=48,
                         n_layers=2, task="link",
                         codebook=CodebookConfig(k=64, f_prod=4))
    r = ttrain.train_vq(g, cfg, epochs=15, batch_size=400, eval_every=15,
                        device=CPU)
    assert r["final"]["val"] > 0.1


def test_ppi_inductive_training_and_inference(monkeypatch):
    """PPI's inductive setting (multilabel): ``train_vq`` on the training
    view and ``vq_inference(inductive=True)`` on the whole graph, from the
    reference's initial state: the step losses, then inference of the
    reference's trained state in both packages, and the micro-F1 of each
    package's own trained model.  Both train on their host-stepped loop
    (``REPRO_EPOCH_EXECUTOR=0``), whose step the reference compiles in a
    fraction of its epoch executor's time, and the trainers' own
    evaluation is left out of the reference's run."""
    jg, tg = jd.synthetic_ppi(n=N), td.synthetic_ppi(n=N)
    jv, tv = jb.inductive_view(jg), tb.inductive_view(tg)
    jcfg, tcfg = _cfgs("gcn", "node", f_in=jg.f, n_out=24, multilabel=True)
    init = _Init(tcfg, N)
    init.patch(monkeypatch)
    _share_optimizers(monkeypatch)
    monkeypatch.setattr(jtrain, "_evaluate",
                        lambda *a: {"val": 0.0, "test": 0.0})
    monkeypatch.setenv("REPRO_EPOCH_EXECUTOR", "0")
    jl = _recorded(monkeypatch, jtrain, "vq_train_step", 3)
    jr = jtrain.train_vq(jv, jcfg, epochs=1, batch_size=BATCH)
    tr = ttrain.train_vq(tv, tcfg, epochs=1, batch_size=BATCH, device=CPU)
    assert_allclose(tr["step_losses"], jl, **STEP)
    assert len(jl) == 3 and len(tr["pack_s"]) == 1
    jemb = jtrain.vq_inference(jr["params"], jr["vq_states"], jg, jcfg, N,
                               inductive=True)
    temb = ttrain.vq_inference(
        convert.params_from_numpy(_np_tree(jr["params"]), CPU),
        convert.vq_states_from_numpy(jr["vq_states"], CPU), tg, tcfg, N,
        inductive=True)
    assert_allclose(temb, jemb, **STEP)
    own = ttrain.vq_inference(tr["params"], tr["vq_states"], tg, tcfg, N,
                              inductive=True)

    def f1(emb):
        idx = tg.test_idx
        return float(tgnn.node_metric(torch.from_numpy(emb[idx]),
                                      torch.from_numpy(tg.labels[idx]),
                                      True))
    assert abs(f1(own) - f1(jemb)) <= 0.05


def test_link_example_on_cpu(capsys):
    from repro_torch.examples import link_prediction
    out = link_prediction.main(["--n", "300", "--epochs", "2", "--device",
                                "cpu"])
    lines = capsys.readouterr().out.splitlines()
    g = jd.synthetic_collab(n=300)
    assert lines[0] == (f"graph: {g.n} nodes, {g.m} message edges, "
                        f"{len(g.val_edges)} val / {len(g.test_edges)} "
                        f"test positives")
    assert lines[1].startswith("full-graph Hits@50: val ")
    assert lines[2].startswith("VQ-GNN     Hits@50: val ")
    for r in out.values():
        assert 0.0 <= r["val"] <= 1.0 and 0.0 <= r["test"] <= 1.0
