"""The training slice of the PyTorch port against the JAX reference on the
CPU: the streaming codebook update (Alg. 2, forced revival included), the
optimizers, the Eq. 7 injection's gradients, one ``vq_train_step`` for
GCN / SAGE / GIN, two epochs of ``vq_train_epoch`` with a wrap-padded
tail, the full-graph step, ``train_vq`` end to end, ``vq_inference``,
the quickstart twin and ``serve_gnn --train-epochs`` -- at a small size
(``synthetic_arxiv(n=600)``, hidden 32, 2 layers, k 32).  Inputs come
from numpy seeds; weights, VQ states and optimizer states are built in
``repro`` and carried across with ``repro_torch.convert``.  The reference
runs with ``REPRO_FORCE_PALLAS`` unset (its oracle path).

Tolerances: one step ``rtol=1e-4, atol=1e-5`` (fp32 matmuls and
reductions in another order, through the backward pass and an RMSprop
step whose first update divides by ``sqrt(v)``); the codebook update
alone ``rtol=1e-5, atol=1e-6`` with counts exact; several steps, where a
near-tie assignment may flip and move one row between two codewords, the
losses and VQ errors ``rtol=1e-3`` (``rtol=1e-2`` at the paper's full
width, k = 1024, where flips are likelier and the early loss rises);
``train_vq`` test accuracy within 0.05 of the reference's from the same
initial state.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.core import codebook as jcb                       # noqa: E402
from repro.core import message_passing as jmp                # noqa: E402
from repro.core.codebook import CodebookConfig as JCodebookConfig  # noqa
from repro.graph import batching as jb                       # noqa: E402
from repro.graph.datasets import synthetic_arxiv as j_arxiv  # noqa: E402
from repro.models import gnn as jgnn                         # noqa: E402
from repro.train import optimizer as jopt                    # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.core import codebook as tcb                 # noqa: E402
from repro_torch.core import conv as tconv                   # noqa: E402
from repro_torch.core import message_passing as tmp          # noqa: E402
from repro_torch.core.codebook import CodebookConfig         # noqa: E402
from repro_torch.graph import batching as tb                 # noqa: E402
from repro_torch.graph.datasets import synthetic_arxiv as t_arxiv  # noqa
from repro_torch.models import gnn as tgnn                   # noqa: E402
from repro_torch.nn import gnn_layers as tlayers             # noqa: E402
from repro_torch.train import gnn_trainer as ttrain          # noqa: E402
from repro_torch.train import optimizer as topt              # noqa: E402

STEP = dict(rtol=1e-4, atol=1e-5)
ONE = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu"
N, HIDDEN, K = 600, 32, 32


def _cfgs(backbone):
    kw = dict(backbone=backbone, f_in=128, hidden=HIDDEN, n_out=40,
              n_layers=2)
    return (jgnn.GNNConfig(codebook=JCodebookConfig(k=K, f_prod=4), **kw),
            tgnn.GNNConfig(codebook=CodebookConfig(k=K, f_prod=4), **kw))


def _np_tree(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _cb(state):
    """CodebookState -> list of numpy fields (either package)."""
    return [np.asarray(f) for f in state]


@pytest.fixture(scope="module")
def graphs():
    return j_arxiv(n=N, seed=0), t_arxiv(n=N, seed=0)


class _World:
    """One backbone's reference state and its port twin, on the CPU."""

    def __init__(self, jg, tg, backbone):
        self.jcfg, self.tcfg = _cfgs(backbone)
        self.jg, self.tg = jg, tg
        self.jops = jb.full_operands(jg)
        self.jplan = jb.build_epoch_plan(jg, full_ops=self.jops)
        self.tops = tb.full_operands(tg, device=CPU)
        self.tplan = tb.build_epoch_plan(tg, full_ops=self.tops, device=CPU)
        self.jparams = jgnn.init_gnn(jax.random.PRNGKey(0), self.jcfg)
        self.jvq = jgnn.init_vq_states(jax.random.PRNGKey(1), self.jcfg,
                                       jg.n)
        self.tparams = convert.params_from_numpy(_np_tree(self.jparams), CPU)
        self.tvq = convert.vq_states_from_numpy(self.jvq, CPU)
        mask = np.zeros(jg.n, np.float32)
        mask[jg.train_idx] = 1.0
        self.train_mask = mask


@pytest.fixture(scope="module", params=["gcn", "sage", "gin"])
def world(request, graphs):
    return _World(*graphs, request.param)


def _assert_states_close(tst, jst, tol):
    for a, b in zip(tst, jst):
        assert np.array_equal(a.assignment.numpy(), np.asarray(b.assignment))
        assert np.array_equal(a.counts.numpy(), np.asarray(b.counts))
        for fa, fb in zip(_cb(a.codebook), _cb(b.codebook)):
            assert_allclose(fa, fb, **tol)


def _assert_params_close(tp, jp, tol):
    for a, b in zip(tp, jp):
        assert a.keys() == b.keys()
        for name in a:
            assert_allclose(a[name].numpy(), np.asarray(b[name]), **tol)


# ---------------------------------------------------------------------------
# the codebook update (Alg. 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["fresh", "revival", "no_whiten"])
def test_codebook_update_matches_reference(case):
    """One update of every CodebookState field and the UpdateStats.  The
    revival case forces half the cluster sizes under the threshold and
    uses a wrap-padded batch (duplicate rows: their tied qerr values pick
    identical replacement rows in any order)."""
    rng = np.random.default_rng({"fresh": 0, "revival": 1,
                                 "no_whiten": 2}[case])
    cfg_kw = dict(k=48, f_prod=4, whiten=case != "no_whiten")
    jcfg, tcfg = JCodebookConfig(**cfg_kw), CodebookConfig(**cfg_kw)
    st = jcb.init_codebook(jax.random.PRNGKey(3), 32, 12, jcfg)
    if case == "revival":
        size = rng.uniform(0.0, 2.0, st.cluster_size.shape)
        size[:, ::2] = 0.01                         # under 0.05: dead
        st = st._replace(cluster_size=jnp.asarray(size, jnp.float32),
                         mean=jnp.asarray(rng.normal(size=st.mean.shape),
                                          jnp.float32),
                         var=jnp.asarray(rng.uniform(0.5, 2.0,
                                                     st.var.shape),
                                         jnp.float32))
    feats = rng.normal(size=(200, 32)).astype(np.float32)
    grads = (1e-3 * rng.normal(size=(200, 12))).astype(np.float32)
    if case == "revival":
        feats[150:], grads[150:] = feats[:50], grads[:50]   # wrap-padding
    jst, jstats = jcb.update(st, jnp.asarray(feats), jnp.asarray(grads),
                             jcfg)
    tst, tstats = tcb.update(tcb.CodebookState(*(
        torch.from_numpy(np.array(f)) for f in st)),
        torch.from_numpy(feats), torch.from_numpy(grads), tcfg)
    assert np.array_equal(tstats.assignment.numpy(),
                          np.asarray(jstats.assignment))
    assert_allclose(tstats.qerr.numpy(), np.asarray(jstats.qerr), **ONE)
    assert_allclose(tstats.vnorm2.numpy(), np.asarray(jstats.vnorm2), **ONE)
    assert_allclose(float(tstats.relative_error()),
                    float(jstats.relative_error()), **ONE)
    for name, a, b in zip(tcb.CodebookState._fields, _cb(tst), _cb(jst)):
        assert a.dtype == b.dtype, name
        assert_allclose(a, b, err_msg=name, **ONE)
    if case == "revival":       # most forced-dead codewords were revived
        revived = np.asarray(jst.cluster_size)[:, ::2] == 1.0
        assert revived.mean() > 0.5


def test_update_stats_relative_error():
    stats = tcb.UpdateStats(torch.zeros((2, 3), dtype=torch.int32),
                            torch.full((2, 3), 4.0), torch.full((2, 3), 16.0))
    assert_allclose(float(stats.relative_error()), 0.5, rtol=1e-6)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rmsprop", "adam"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_optimizer_three_updates_match_reference(name, weight_decay):
    """Three updates from the reference's initial state, with the
    reference's eps placement, bias correction and ndim >= 2 decay."""
    rng = np.random.default_rng(7)
    params = [{"w": rng.normal(size=(6, 4)).astype(np.float32),
               "b": rng.normal(size=(4,)).astype(np.float32),
               "eps": np.float32(0.3)}]
    grads = [[{k: (rng.normal(size=np.shape(v)) * 10.0 ** -i)
               .astype(np.float32) for k, v in params[0].items()}]
             for i in range(3)]
    kw = dict(lr=1e-2, weight_decay=weight_decay, clip_norm=5.0)
    jo, to = jopt.OPTIMIZERS[name](**kw), topt.OPTIMIZERS[name](**kw)
    jp = [{k: jnp.asarray(v) for k, v in params[0].items()}]
    js = jo.init(jp)
    tp = convert.params_from_numpy(params, CPU)
    ts = convert.opt_state_from_numpy(js, CPU)
    for g in grads:
        jp, js = jo.update([{k: jnp.asarray(v) for k, v in g[0].items()}],
                           js, jp)
        tp, ts = to.update(convert.params_from_numpy(g, CPU), ts, tp)
    _assert_params_close(tp, jp, ONE)
    assert int(ts.step) == int(js.step) == 3
    _assert_params_close(ts.nu, js.nu, ONE)
    _assert_params_close(ts.mu, js.mu, ONE)


def test_schedules_and_clipping_match_reference():
    steps = [0, 1, 5, 50, 99, 200]
    js, ts = jopt.warmup_cosine(0.1, 10, 100), topt.warmup_cosine(0.1, 10,
                                                                   100)
    for s in steps:
        assert_allclose(float(ts(torch.tensor(s, dtype=torch.int32))),
                        float(js(jnp.asarray(s, jnp.int32))), rtol=1e-6)
    assert float(topt.constant_lr(0.3)(torch.tensor(4))) == \
        pytest.approx(0.3)
    tree = [{"a": np.arange(6, dtype=np.float32).reshape(2, 3)},
            {"b": -np.ones(4, np.float32)}]
    jt = [{k: jnp.asarray(v) for k, v in d.items()} for d in tree]
    tt = convert.params_from_numpy(tree, CPU)
    assert_allclose(float(topt.global_norm(tt)), float(jopt.global_norm(jt)),
                    rtol=1e-6)
    _assert_params_close(topt.clip_by_global_norm(tt, 2.0),
                         jopt.clip_by_global_norm(jt, 2.0), ONE)


# ---------------------------------------------------------------------------
# the Eq. 7 injection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_w", [True, False])
def test_inject_context_grad_gradients_match_jax(with_w):
    """Gradients of a scalar loss through ``approx_message_passing(inject=
    True)`` -- intra SpMM backward plus the injected D_out G~ W^T term --
    against ``jax.grad`` of the reference; no gradient reaches the
    codewords or W through the injection."""
    rng = np.random.default_rng(11)
    b, deg, n, nb, k, fb = 24, 5, 80, 4, 16, 3
    gb = 2 if with_w else fb     # w=None: gradient codewords at x's width
    f_in, f_out = nb * fb, nb * gb
    in_pos = rng.integers(-1, b, (b, deg)).astype(np.int32)
    in_vals = np.where(in_pos >= 0, rng.normal(size=(b, deg)),
                       0).astype(np.float32)
    out_ids = rng.integers(0, n, (b, deg)).astype(np.int32)
    out_vals = np.where(in_pos < 0, rng.normal(size=(b, deg)),
                        0).astype(np.float32)
    rev_ids = rng.integers(0, n, (b, deg)).astype(np.int32)
    rev_vals = rng.normal(size=(b, deg)).astype(np.float32)
    rev_vals[:, -1] = 0.0
    fcw = rng.normal(size=(nb, k, fb)).astype(np.float32)
    gcw = rng.normal(size=(nb, k, gb)).astype(np.float32)
    assign = rng.integers(0, k, (nb, n)).astype(np.int32)
    w = rng.normal(size=(f_in, f_out)).astype(np.float32)
    x = rng.normal(size=(b, f_in)).astype(np.float32)
    y = rng.normal(size=(b, f_out)).astype(np.float32)
    arrs = (in_pos, in_vals, out_ids, out_vals, rev_ids, rev_vals)

    def jloss(xx, ww, gc):
        ops_ = jmp.ConvOperands(*map(jnp.asarray, arrs))
        m = jmp.approx_message_passing(ops_, xx, jnp.asarray(fcw), gc,
                                       jnp.asarray(assign),
                                       ww if with_w else None, inject=True)
        return jnp.sum((m @ ww) * y)
    jgx, jgw, jgc = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gcw))

    ops_ = tmp.ConvOperands(*map(torch.from_numpy, arrs))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    gct = torch.from_numpy(gcw).requires_grad_(True)
    m = tmp.approx_message_passing(ops_, xt, torch.from_numpy(fcw), gct,
                                   torch.from_numpy(assign),
                                   wt if with_w else None, inject=True)
    gx, gw = torch.autograd.grad((m @ wt * torch.from_numpy(y)).sum(),
                                 (xt, wt))
    assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-5)
    assert not np.asarray(jgc).any() and gct.grad is None
    # without the injection the gradient differs by the phantom term
    m0 = tmp.approx_message_passing(ops_, xt, torch.from_numpy(fcw), gct,
                                    torch.from_numpy(assign), wt,
                                    inject=False)
    (gx0,) = torch.autograd.grad((m0 @ wt * torch.from_numpy(y)).sum(), xt)
    assert not torch.allclose(gx0, gx)


# ---------------------------------------------------------------------------
# losses, probes, the train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multilabel", [False, True])
def test_node_loss_and_metric_match_reference(multilabel):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(50, 7)).astype(np.float32)
    labels = (rng.random((50, 7)) < 0.3).astype(np.float32) if multilabel \
        else rng.integers(0, 7, 50)
    mask = (rng.random(50) < 0.6).astype(np.float32)
    jl = jgnn.node_loss(jnp.asarray(logits), jnp.asarray(labels), multilabel,
                        jnp.asarray(mask))
    tl = tgnn.node_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        multilabel, torch.from_numpy(mask))
    assert_allclose(float(tl), float(jl), **ONE)
    assert_allclose(float(tgnn.node_metric(
        torch.from_numpy(logits), torch.from_numpy(labels), multilabel)),
        float(jgnn.node_metric(jnp.asarray(logits), jnp.asarray(labels),
                               multilabel)), **ONE)


def test_probe_shapes_match_reference():
    for backbone in ("gcn", "sage", "gin"):
        jcfg, tcfg = _cfgs(backbone)
        assert tgnn.probe_shapes(tcfg, 77) == jgnn.probe_shapes(jcfg, 77)


def test_vq_train_step_matches_reference(world):
    """One Alg. 1 step from the same state and batch: loss, output, every
    parameter, every VQ state field and the per-layer VQ errors."""
    w = world
    bids = np.random.default_rng(5).choice(N, 150, replace=False)
    jp = jb.plan_batch(w.jplan, jnp.asarray(bids.astype(np.int32)))
    tp = tb.plan_batch(w.tplan, torch.from_numpy(bids.astype(np.int32)))
    jo, to = jopt.rmsprop(3e-3), topt.rmsprop(3e-3)
    jost = jo.init(w.jparams)
    lm = w.train_mask[bids]
    jres = jgnn.vq_train_step(
        w.jparams, w.jvq, jost, jp, jnp.asarray(w.jg.features[bids]),
        jnp.asarray(w.jg.labels[bids]), w.jops.degrees, w.jcfg, jo,
        loss_mask=jnp.asarray(lm))
    tres = tgnn.vq_train_step(
        w.tparams, w.tvq, convert.opt_state_from_numpy(jost, CPU), tp,
        torch.from_numpy(w.tg.features[bids]),
        torch.from_numpy(w.tg.labels[bids]), w.tops.degrees, w.tcfg, to,
        loss_mask=torch.from_numpy(lm))
    assert_allclose(float(tres[3]), float(jres[3]), **STEP)
    assert_allclose(tres[4].numpy(), np.asarray(jres[4]), **STEP)
    _assert_params_close(tres[0], jres[0], STEP)
    _assert_states_close(tres[1], jres[1], STEP)
    _assert_params_close(tres[2].nu, jres[2].nu, STEP)
    assert int(tres[2].step) == 1
    assert_allclose(tres[5].numpy(), np.asarray(jres[5]), **STEP)
    # the probe-free, injection-free evaluation forward of the new state
    assert_allclose(tgnn.vq_eval_batch(
        tres[0], tres[1], tp, torch.from_numpy(w.tg.features[bids]),
        w.tops.degrees, w.tcfg).numpy(), np.asarray(jgnn.vq_eval_batch(
            jres[0], jres[1], jp, jnp.asarray(w.jg.features[bids]),
            w.jops.degrees, w.jcfg)), **STEP)
    # functional: the inputs are untouched
    assert np.array_equal(w.tvq[0].assignment.numpy(),
                          np.asarray(w.jvq[0].assignment))
    _assert_params_close(w.tparams, w.jparams, dict(rtol=0, atol=0))


def test_vq_train_epoch_two_epochs_with_padded_tail(graphs):
    """Two epochs (3 batches of 256 over 600 nodes: a wrap-padded tail,
    loss-masked) from the same state: per-step losses and VQ errors track
    the reference."""
    w = _World(*graphs, "gcn")
    jo, to = jopt.rmsprop(3e-3), topt.rmsprop(3e-3)
    jst = (w.jparams, w.jvq, jo.init(w.jparams))
    tst = (w.tparams, w.tvq, to.init(w.tparams))
    rng = np.random.default_rng(0)
    tm_j, tm_t = jnp.asarray(w.train_mask), torch.from_numpy(w.train_mask)
    jl, tl, je, te = [], [], [], []
    for _ in range(2):
        ids, sm = tb.epoch_slices(rng.permutation(np.arange(N)), 256)
        assert ids.shape == (3, 256) and sm[-1].sum() == N - 512
        *jst, l, e = jgnn.vq_train_epoch(
            *jst, w.jplan, jnp.asarray(ids.astype(np.int32)),
            jnp.asarray(sm), jnp.asarray(w.jg.features),
            jnp.asarray(w.jg.labels), tm_j, w.jops.degrees, w.jcfg, jo)
        jl.append(np.asarray(l))
        je.append(np.asarray(e))
        *tst, l, e = tgnn.vq_train_epoch(
            *tst, w.tplan, torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(sm), torch.from_numpy(w.tg.features),
            torch.from_numpy(w.tg.labels), tm_t, w.tops.degrees, w.tcfg, to)
        tl.append(l.numpy())
        te.append(e.numpy())
    assert np.concatenate(tl).shape == (6,)
    assert_allclose(np.concatenate(tl), np.concatenate(jl), rtol=1e-3)
    assert_allclose(np.concatenate(te), np.concatenate(je), rtol=1e-3)
    agree = np.mean([np.mean(a.assignment.numpy() == np.asarray(b.assignment))
                     for a, b in zip(tst[1], jst[1])])
    assert agree >= 0.99


def test_full_train_step_and_predict_match_reference(graphs):
    w = _World(*graphs, "gcn")
    jo, to = jopt.adam(1e-2), topt.adam(1e-2)
    jps, jos, jl = jgnn.full_train_step(
        w.jparams, jo.init(w.jparams), jnp.asarray(w.jg.features), w.jops,
        jnp.asarray(w.jg.labels), jnp.asarray(w.train_mask), w.jcfg, jo)
    tps, tos, tl = tgnn.full_train_step(
        w.tparams, to.init(w.tparams), torch.from_numpy(w.tg.features),
        w.tops, torch.from_numpy(w.tg.labels),
        torch.from_numpy(w.train_mask), w.tcfg, to)
    assert_allclose(float(tl), float(jl), **STEP)
    _assert_params_close(tps, jps, STEP)
    _assert_params_close(tos.mu, jos.mu, STEP)
    assert_allclose(tgnn.full_predict(tps, torch.from_numpy(w.tg.features),
                                      w.tops, w.tcfg).numpy(),
                    np.asarray(jgnn.full_predict(
                        jps, jnp.asarray(w.jg.features), w.jops, w.jcfg)),
                    **STEP)


# ---------------------------------------------------------------------------
# the trainer end to end
# ---------------------------------------------------------------------------

def test_train_vq_end_to_end_tracks_reference(graphs, monkeypatch):
    """``train_vq`` for 10 epochs in both packages from the reference's
    initial state (the port's init functions are pointed at it; both
    trainers draw the same numpy batch stream): test accuracy within 0.05,
    then codeword inference of the trained models."""
    from repro.train import gnn_trainer as jtrain
    w = _World(*graphs, "gcn")
    monkeypatch.setattr(ttrain, "init_gnn", lambda *a, **k: w.tparams)
    monkeypatch.setattr(ttrain, "init_vq_states", lambda *a, **k: w.tvq)
    jr = jtrain.train_vq(w.jg, w.jcfg, epochs=10, batch_size=150,
                         eval_every=5)
    tr = ttrain.train_vq(w.tg, w.tcfg, epochs=10, batch_size=150,
                         eval_every=5, device=CPU)
    assert [h["epoch"] for h in tr["history"]] == [5, 10]
    assert abs(tr["final"]["test"] - jr["final"]["test"]) <= 0.05
    assert abs(tr["final"]["vq_err"] - jr["final"]["vq_err"]) <= 0.05
    assert tr["step_losses"].shape == (40,)
    assert tr["step_vq_errs"].shape == (40, 2)
    assert np.all(np.isfinite(tr["step_losses"]))
    assert tr["mem_bytes"] == jr["mem_bytes"]
    assert tr["messages"] == jr["messages"]
    assert len(tr["epoch_s"]) == 10
    emb = ttrain.vq_inference(tr["params"], tr["vq_states"], w.tg, w.tcfg,
                              128)
    jemb = jtrain.vq_inference(jr["params"], jr["vq_states"], w.jg, w.jcfg,
                               128)
    acc = (np.argmax(emb[w.tg.test_idx], -1) == w.tg.labels[w.tg.test_idx])
    jacc = (np.argmax(jemb[w.jg.test_idx], -1)
            == w.jg.labels[w.jg.test_idx])
    assert abs(acc.mean() - jacc.mean()) <= 0.05


@pytest.mark.parametrize("n", [800, 4000])
def test_train_vq_full_width_first_steps_track_reference(monkeypatch, n):
    """The paper's full-width config (hidden 128, 3 layers, k 1024) at
    batch n/4: the port's per-step losses and VQ errors over the first
    two epochs follow the reference's from the same initial state --
    including the rise of the loss while the injected gradient codewords
    are still their random initial draws, and the collapse of the last
    layer's codebook that comes with it (after the second epoch every
    node of some branch sits on one codeword, in both packages)."""
    from repro.configs import vq_gnn_paper as jpaper
    from repro.train import gnn_trainer as jtrain
    from repro_torch.configs import vq_gnn_paper as tpaper
    jg, tg = j_arxiv(n=n, seed=0), t_arxiv(n=n, seed=0)
    jcfg, tcfg = jpaper.paper_config(jg, full_scale=True), \
        tpaper.paper_config(tg, full_scale=True)
    b = tpaper.paper_batch_size(tg)
    jparams = jgnn.init_gnn(jax.random.PRNGKey(0), jcfg)
    jvq = jgnn.init_vq_states(jax.random.PRNGKey(1), jcfg, jg.n)
    losses, shares = [], {"ref": [], "port": []}

    def largest_cluster_share(vq_states):
        """Per layer: the largest share of the nodes one codeword of one
        branch holds."""
        out = []
        for st in vq_states:
            a = np.asarray(st.assignment)
            out.append(max(np.bincount(r).max() for r in a) / a.shape[1])
        return out

    def recorded(epoch_fn, tag, loss_list=None):
        def run(*a, **k):
            out = epoch_fn(*a, **k)
            if loss_list is not None:
                loss_list.append(np.asarray(out[3]))
            shares[tag].append(largest_cluster_share(out[1]))
            return out
        return run
    monkeypatch.setattr(jtrain, "vq_train_epoch",
                        recorded(jgnn.vq_train_epoch, "ref", losses))
    monkeypatch.setattr(ttrain, "vq_train_epoch",
                        recorded(tgnn.vq_train_epoch, "port"))
    monkeypatch.setattr(jtrain, "init_gnn", lambda *a, **k: jparams)
    monkeypatch.setattr(jtrain, "init_vq_states", lambda *a, **k: jvq)
    # converted before the reference runs: its epoch donates the buffers
    tparams = convert.params_from_numpy(_np_tree(jparams), CPU)
    tvq = convert.vq_states_from_numpy(jvq, CPU)
    monkeypatch.setattr(ttrain, "init_gnn", lambda *a, **k: tparams)
    monkeypatch.setattr(ttrain, "init_vq_states", lambda *a, **k: tvq)
    jr = jtrain.train_vq(jg, jcfg, epochs=2, batch_size=b, eval_every=2)
    tr = ttrain.train_vq(tg, tcfg, epochs=2, batch_size=b, eval_every=2,
                         device=CPU)
    # k = 1024 codewords make near-tie flips likely, and the rising loss
    # amplifies what a flip moves: rtol 1e-2 over the eight steps
    assert_allclose(tr["step_losses"], np.concatenate(losses), rtol=1e-2)
    assert_allclose(tr["final"]["vq_err"], jr["final"]["vq_err"], rtol=1e-2)
    assert tr["step_losses"][-1] > tr["step_losses"][0]
    assert_allclose(shares["port"], shares["ref"], atol=0.01)
    assert shares["ref"][-1][-1] == 1.0 and shares["port"][-1][-1] == 1.0


# ---------------------------------------------------------------------------
# training under the precision tiers
# ---------------------------------------------------------------------------

def _assert_snapshots_close(tst, jst):
    """Quantize-on-update snapshots of codebooks that agree to f32
    rounding: scales within ``rtol=1e-4``, and every value within one
    quantum of the reference's (a codeword on a rounding boundary may
    round either way): 1 for int8, 2^-3 of the value (2^-9 near zero)
    for fp8 e4m3."""
    for a, b in zip(tst, jst):
        for qa, qb in ((a.qcw.feat, b.qcw.feat), (a.qcw.grad, b.qcw.grad)):
            assert str(qa.q.dtype) == "torch." + np.asarray(qb.q).dtype.name
            assert_allclose(qa.scale.numpy(), np.asarray(qb.scale),
                            rtol=1e-4)
            va = qa.q.float().numpy()
            vb = np.asarray(qb.q).astype(np.float32)
            quantum = 1.0 if qa.q.dtype == torch.int8 \
                else np.maximum(np.abs(va), np.abs(vb)) / 8 + 2.0 ** -9
            assert np.all(np.abs(va - vb) <= quantum * 1.0001)
            assert (va != vb).mean() < 0.01


def _train_both_under_tier(monkeypatch, jg, tg, jcfg, tcfg, tier, epochs, b):
    """``train_vq`` in both packages under ``tier`` from the reference's
    initial state (built under the tier, carried across); returns the
    port's result, the reference's and its per-step losses."""
    from repro.kernels import ops as jops
    from repro.train import gnn_trainer as jtrain
    from repro_torch.kernels import ops as tops
    losses = []

    def recorded(*a, **k):
        out = jgnn.vq_train_epoch(*a, **k)
        losses.append(np.asarray(out[3]))
        return out
    jops.configure_kernel_precision(tier)
    tops.configure_kernel_precision(tier)
    try:
        jparams = jgnn.init_gnn(jax.random.PRNGKey(0), jcfg)
        jvq = jgnn.init_vq_states(jax.random.PRNGKey(1), jcfg, jg.n)
        tparams = convert.params_from_numpy(_np_tree(jparams), CPU)
        tvq = convert.vq_states_from_numpy(jvq, CPU)
        monkeypatch.setattr(jtrain, "vq_train_epoch", recorded)
        monkeypatch.setattr(jtrain, "init_gnn", lambda *a, **k: jparams)
        monkeypatch.setattr(jtrain, "init_vq_states", lambda *a, **k: jvq)
        monkeypatch.setattr(ttrain, "init_gnn", lambda *a, **k: tparams)
        monkeypatch.setattr(ttrain, "init_vq_states", lambda *a, **k: tvq)
        jr = jtrain.train_vq(jg, jcfg, epochs=epochs, batch_size=b,
                             eval_every=epochs)
        tr = ttrain.train_vq(tg, tcfg, epochs=epochs, batch_size=b,
                             eval_every=epochs, device=CPU)
    finally:
        jops.configure_kernel_precision(reset=True)
        tops.configure_kernel_precision(reset=True)
    return tr, jr, np.concatenate(losses)


@pytest.mark.parametrize("tier,k", [("int8", 32), ("fp8", 16),
                                    ("fp8+a4", 16)])
def test_train_vq_under_tier_tracks_reference(monkeypatch, tier, k):
    """The reference's tier training smoke (n 300, hidden 16, 2 layers,
    batch 100, 2 epochs) in both packages from the same state: per-step
    losses within ``rtol=1e-3``, the states ending in the tier's storage
    (uint8 or packed tables, int8 / fp8 snapshots requantized every step),
    tables agreeing but for near-tie flips, snapshots within a quantum,
    and the tier's memory accounting."""
    jg, tg = j_arxiv(n=300, seed=0), t_arxiv(n=300, seed=0)
    kw = dict(backbone="gcn", f_in=jg.f, hidden=16, n_out=jg.num_classes,
              n_layers=2)
    jcfg = jgnn.GNNConfig(codebook=JCodebookConfig(k=k, f_prod=4), **kw)
    tcfg = tgnn.GNNConfig(codebook=CodebookConfig(k=k, f_prod=4), **kw)
    tr, jr, jlosses = _train_both_under_tier(monkeypatch, jg, tg, jcfg, tcfg,
                                             tier, 2, 100)
    assert_allclose(tr["step_losses"], jlosses, rtol=1e-3)
    assert np.isfinite(tr["final"]["val"])
    assert abs(tr["final"]["val"] - jr["final"]["val"]) <= 0.05
    assert tr["mem_bytes"] == jr["mem_bytes"]
    for a, b in zip(tr["vq_states"], jr["vq_states"]):
        packed = hasattr(b.assignment, "packed")
        assert hasattr(a.assignment, "packed") == packed == \
            tier.endswith("+a4")
        ta = a.assignment.unpack() if packed else a.assignment
        ja = b.assignment.unpack() if packed else b.assignment
        assert ta.dtype == torch.uint8
        assert (ta.numpy() == np.asarray(ja)).mean() > 0.99
    _assert_snapshots_close(tr["vq_states"], jr["vq_states"])


def test_train_vq_int8_full_width_first_steps_track_reference(monkeypatch):
    """The tier at the paper's full width with k = 256 (GCN, hidden 128, 3
    layers, f_prod 4, batch n/4) on 800 nodes: the first 8 per-step
    losses under int8 follow the reference's within ``rtol=1e-2`` (the
    full-width fp32 test's tolerance)."""
    from repro.configs import vq_gnn_paper as jpaper
    from repro_torch.configs import vq_gnn_paper as tpaper
    jg, tg = j_arxiv(n=800, seed=0), t_arxiv(n=800, seed=0)
    jcfg = jpaper.paper_config(jg, full_scale=True)
    jcfg = jcfg._replace(codebook=jcfg.codebook._replace(k=256))
    tcfg = tpaper.paper_config(tg, full_scale=True)
    tcfg = tcfg._replace(codebook=tcfg.codebook._replace(k=256))
    b = tpaper.paper_batch_size(tg)
    tr, jr, jlosses = _train_both_under_tier(monkeypatch, jg, tg, jcfg, tcfg,
                                             "int8", 2, b)
    assert tr["step_losses"].shape == (8,)
    assert_allclose(tr["step_losses"], jlosses, rtol=1e-2)
    assert all(st.assignment.dtype == torch.uint8 for st in tr["vq_states"])


def test_vq_inference_matches_reference(graphs):
    from repro.train import gnn_trainer as jtrain
    w = _World(*graphs, "gcn")
    for inductive in (False, True):
        got = ttrain.vq_inference(w.tparams, w.tvq, w.tg, w.tcfg, 256,
                                  inductive=inductive)
        want = jtrain.vq_inference(w.jparams, w.jvq, w.jg, w.jcfg, 256,
                                   inductive=inductive)
        assert got.shape == (N, 40)
        assert_allclose(got, want, **STEP)


def test_train_full_and_accounting_match_reference(graphs):
    from repro.train import gnn_trainer as jtrain
    _, tg = graphs
    _, tcfg = _cfgs("gcn")
    r = ttrain.train_full(tg, tcfg, epochs=4, eval_every=2, device=CPU)
    assert [h["epoch"] for h in r["history"]] == [2, 4]
    assert 0.0 <= r["final"]["test"] <= 1.0
    for args in [(256, 18, 128, 3, 1024), (150, 11, 32, 2, 32, 4, 40)]:
        assert ttrain.vq_batch_bytes(*args) == jtrain.vq_batch_bytes(*args)
    assert ttrain.messages_per_batch_vq(tg, 150) == \
        jtrain.messages_per_batch_vq(graphs[0], 150)


def test_quickstart_twin_runs_on_cpu(capsys):
    from repro_torch.examples import quickstart
    res = quickstart.main(["--device", "cpu", "--n", "300", "--epochs", "3"])
    out = capsys.readouterr().out
    for line in ("full-graph test acc", "VQ-GNN     test acc",
                 "VQ mini-batched inference test acc"):
        assert line in out
    assert 0.0 <= res["inference_acc"] <= 1.0


def test_serve_gnn_train_epochs_on_cpu(capsys):
    from repro_torch.launch import serve_gnn
    rep = serve_gnn.main(["--n", "300", "--hidden", "16", "--k", "16",
                          "--batch", "64", "--requests", "8",
                          "--train-epochs", "1", "--device", "cpu"])
    assert rep["requests"] == 8 and rep["nodes_per_s"] > 0
    assert "nodes/s" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the sampling baselines, the hybrid and the scenario front
# ---------------------------------------------------------------------------

SAMPLER_KW = {"ns-sage": {}, "labor": {}, "cluster-gcn": {"n_parts": 8},
              "graphsaint-rw": {}}


def _sampler_epoch_batches(jg, method, seed):
    from repro.graph import sampling as js
    part = js.partition_graph(jg, 8, np.random.default_rng(seed)) \
        if method == "cluster-gcn" else None
    return js.sample_epoch(jg, method, batch_size=150,
                           rng=np.random.default_rng(seed), fanouts=[3, 3],
                           partition=part, parts_per_batch=2)


@pytest.mark.parametrize("method", ["ns-sage", "labor", "cluster-gcn",
                                    "graphsaint-rw"])
def test_sampler_train_epoch_matches_reference(graphs, method):
    """One epoch plan of each sampler through ``sampler_train_epoch`` in
    both packages, from a state the reference reached after one epoch of
    its own (params and Adam moments carried across with ``convert``):
    per-step losses, params and Adam moments at ``rtol=1e-4, atol=1e-5``."""
    w = _World(*graphs, "gcn")
    jo, to = jopt.adam(1e-2), topt.adam(1e-2)
    deg_cap = w.jg.max_degree()
    x_j, y_j = jnp.asarray(w.jg.features), jnp.asarray(w.jg.labels)
    first = jb.pack_sampler_epoch(_sampler_epoch_batches(w.jg, method, 0),
                                  deg_cap)
    jp, jos, _ = jgnn.sampler_train_epoch(
        w.jparams, jo.init(w.jparams), first, x_j, y_j, w.jcfg, jo)
    tp = convert.params_from_numpy(_np_tree(jp), CPU)
    tos = convert.opt_state_from_numpy(jos, CPU)
    batches = _sampler_epoch_batches(w.jg, method, 1)
    jplan = jb.pack_sampler_epoch(batches, deg_cap)
    tplan = tb.pack_sampler_epoch(batches, deg_cap, device=CPU)
    jp2, jos2, jl = jgnn.sampler_train_epoch(jp, jos, jplan, x_j, y_j,
                                             w.jcfg, jo)
    tp2, tos2, tl = tgnn.sampler_train_epoch(
        tp, tos, tplan, torch.from_numpy(w.tg.features),
        torch.from_numpy(w.tg.labels), w.tcfg, to)
    assert tl.shape == (jplan.s,)
    assert_allclose(tl.numpy(), np.asarray(jl), **STEP)
    _assert_params_close(tp2, jp2, STEP)
    _assert_params_close(tos2.mu, jos2.mu, STEP)
    _assert_params_close(tos2.nu, jos2.nu, STEP)
    assert int(tos2.step) == int(jos2.step)


@pytest.mark.parametrize("method", ["ns-sage", "labor", "cluster-gcn",
                                    "graphsaint-rw"])
def test_sampler_executor_matches_host_loop(graphs, method, monkeypatch):
    """The stacked epoch and the ``REPRO_SAMPLER_EXECUTOR=0`` host loop
    over the same batches (each padded to its own bucket): the same losses
    and params (the reference's own tolerance for this check)."""
    _, tg = graphs
    _, tcfg = _cfgs("gcn")
    kw = dict(epochs=2, batch_size=150, eval_every=2, seed=5, device=CPU,
              **SAMPLER_KW[method])
    monkeypatch.setenv("REPRO_SAMPLER_EXECUTOR", "1")
    r_exec = ttrain.train_sampler(tg, tcfg, method, **kw)
    monkeypatch.setenv("REPRO_SAMPLER_EXECUTOR", "0")
    r_loop = ttrain.train_sampler(tg, tcfg, method, **kw)
    for le, ll in zip(r_exec["losses"], r_loop["losses"]):
        assert le.shape == ll.shape
        assert_allclose(le, ll, rtol=2e-4, atol=1e-6)
    _assert_params_close(r_exec["params"], [
        {k: v.numpy() for k, v in p.items()} for p in r_loop["params"]],
        dict(rtol=2e-4, atol=1e-5))
    assert len(r_exec["sample_s"]) == len(r_exec["train_s"]) == 2


@pytest.mark.parametrize("method", ["labor", "graphsaint-rw"])
def test_train_sampler_tracks_reference(graphs, method, monkeypatch):
    """``train_sampler`` end to end in both packages from the reference's
    initial params (the same numpy sampling stream): per-step losses of
    two epochs at ``rtol=1e-4, atol=1e-5``, the same accounting, and the
    final metrics within 0.05."""
    from repro.train import gnn_trainer as jtrain
    w = _World(*graphs, "gcn")
    monkeypatch.setattr(jtrain, "init_gnn", lambda *a, **k: w.jparams)
    monkeypatch.setattr(ttrain, "init_gnn", lambda *a, **k: w.tparams)
    kw = dict(epochs=2, batch_size=150, eval_every=1, seed=2,
              fanouts=[3, 3])
    jr = jtrain.train_sampler(w.jg, w.jcfg, method, **kw)
    tr = ttrain.train_sampler(w.tg, w.tcfg, method, device=CPU, **kw)
    for a, b in zip(tr["losses"], jr["losses"]):
        assert_allclose(a, np.asarray(b), **STEP)
    assert (tr["mem_bytes"], tr["messages"]) == \
        (jr["mem_bytes"], jr["messages"])
    assert [h["epoch"] for h in tr["history"]] == [1, 2]
    for split in ("val", "test"):
        assert abs(tr["final"][split] - jr["final"][split]) <= 0.05


def test_train_hybrid_nctx_zero_is_plain_vq(graphs):
    """``n_ctx=0`` gives plain VQ training bit for bit: the same batches,
    the same rng draws, the same params."""
    _, tg = graphs
    _, tcfg = _cfgs("gcn")
    kw = dict(epochs=2, batch_size=150, eval_every=2, seed=3, device=CPU)
    rv = ttrain.train_vq(tg, tcfg, **kw)
    rh = ttrain.train_hybrid(tg, tcfg, n_ctx=0, **kw)
    for a, b in zip(rv["params"], rh["params"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert np.array_equal(rv["step_losses"], rh["step_losses"])
    assert rv["final"] == {**rh["final"], "time": rv["final"]["time"]}


def test_train_hybrid_tracks_reference(graphs, monkeypatch):
    """The hybrid (LABOR-widened batches on ``train_vq``) in both packages
    from the reference's initial state: the batches are wider than
    ``batch_size``, and the test accuracy and VQ error agree within 0.05
    (as ``train_vq``'s own end-to-end check)."""
    from repro.train import gnn_trainer as jtrain
    w = _World(*graphs, "gcn")
    monkeypatch.setattr(jtrain, "init_gnn", lambda *a, **k: w.jparams)
    monkeypatch.setattr(jtrain, "init_vq_states", lambda *a, **k: w.jvq)
    monkeypatch.setattr(ttrain, "init_gnn", lambda *a, **k: w.tparams)
    monkeypatch.setattr(ttrain, "init_vq_states", lambda *a, **k: w.tvq)
    kw = dict(epochs=4, batch_size=150, eval_every=4, seed=1, n_ctx=100,
              fanouts=[3, 3])
    jr = jtrain.train_hybrid(w.jg, w.jcfg, **kw)
    tr = ttrain.train_hybrid(w.tg, w.tcfg, device=CPU, **kw)
    assert tr["step_losses"].shape == (16,)       # 4 batches of 250 a epoch
    assert abs(tr["final"]["test"] - jr["final"]["test"]) <= 0.05
    assert abs(tr["final"]["vq_err"] - jr["final"]["vq_err"]) <= 0.05


@pytest.mark.parametrize("backbone", ["gcn", "sage", "gin"])
def test_train_scenario_runs_every_scale_method(graphs, backbone):
    """Every method of ``SCALE_METHODS`` through the front on the CPU plain
    path, each reaching its trainer."""
    _, tg = graphs
    _, tcfg = _cfgs(backbone)
    for method in ttrain.SCALE_METHODS:
        knobs = {"n_parts": 8} if method == "cluster" else {}
        r = ttrain.train_scenario(tg, tcfg, method, epochs=1,
                                  batch_size=150, eval_every=1, device=CPU,
                                  **knobs)
        assert 0.0 <= r["final"]["test"] <= 1.0, method
        assert ("losses" in r) == (method in ttrain._SAMPLER_OF), method
        assert ("vq_states" in r) == (method in ("vq", "hybrid")), method
        if method in ("vq", "hybrid"):            # 4 seed batches of 150
            assert r["step_losses"].shape == (4,)


def test_train_scenario_env_default_and_refusals(graphs, monkeypatch):
    from repro_torch.graph.datasets import synthetic_collab
    _, tg = graphs
    _, tcfg = _cfgs("gcn")
    monkeypatch.setenv("REPRO_SCALE_METHOD", "labor")
    monkeypatch.setenv("REPRO_SAMPLER_FANOUT", "2")
    r = ttrain.train_scenario(tg, tcfg, epochs=1, batch_size=150,
                              eval_every=1, device=CPU)
    assert "losses" in r
    monkeypatch.setenv("REPRO_SCALE_METHOD", "warp")
    with pytest.raises(ValueError, match="unknown scale method"):
        ttrain.train_scenario(tg, tcfg, epochs=1, batch_size=150,
                              device=CPU)
    # the link task runs through every scale method but the hybrid
    cg = synthetic_collab(n=300, seed=4)
    link = tcfg._replace(task="link")
    for method in ttrain.SCALE_METHODS:
        if method == "hybrid":        # node-task only, as in the reference
            with pytest.raises(ValueError, match="node-task only"):
                ttrain.train_scenario(cg, link, method, epochs=1,
                                      batch_size=150, device=CPU)
            continue
        r = ttrain.train_scenario(cg, link, method, epochs=1,
                                  batch_size=150, eval_every=1, device=CPU,
                                  **({"n_parts": 4} if method == "cluster"
                                     else {}))
        assert 0.0 <= r["final"]["val"] <= 1.0, method
        for ls in r.get("losses", []) + [r.get("step_losses", [])]:
            assert np.all(np.isfinite(ls)), method
    with pytest.raises(ValueError, match="unknown sampler"):
        ttrain.train_sampler(tg, tcfg, "metropolis", epochs=1,
                             batch_size=64, device=CPU)


@pytest.mark.parametrize("backbone", ["gat", "transformer"])
def test_train_scenario_trains_attention_backbones(graphs, backbone):
    """GAT and the Graph Transformer train one epoch through the front (the
    VQ trainer), with finite losses and a metric."""
    _, tg = graphs
    _, tcfg = _cfgs(backbone)
    r = ttrain.train_scenario(tg, tcfg._replace(heads=4), "vq", epochs=1,
                              batch_size=150, eval_every=1, device=CPU)
    assert r["step_losses"].shape == (4,)
    assert np.all(np.isfinite(r["step_losses"]))
    assert 0.0 <= r["final"]["test"] <= 1.0


def test_scenario_registry_and_accounting_match_reference():
    from repro.configs import scenarios as jsc
    from repro.train import gnn_trainer as jtrain
    from repro_torch.configs import scenarios as tsc
    assert tsc.MATRIX_BACKBONES == jsc.MATRIX_BACKBONES
    assert tsc.MATRIX_TASKS == jsc.MATRIX_TASKS
    assert tsc.SCENARIO_KNOBS == jsc.SCENARIO_KNOBS
    assert ttrain.SCALE_METHODS == jtrain.SCALE_METHODS
    assert ttrain._SAMPLER_OF == jtrain._SAMPLER_OF
    for tasks in (("node",), ("node", "link")):
        assert tsc.matrix_cells(tasks) == jsc.matrix_cells(tasks)
    tsc.assert_gnn_only(["gcn", "gin"])
    for names, what in ((["gcn", "llama3.2-3b"], "leaked"),
                        (["gcn", "mlp"], "unknown backbones")):
        for mod in (jsc, tsc):
            with pytest.raises(ValueError, match=what):
                mod.assert_gnn_only(names)
    for args in [(21090, 150000, 128, 3), (262144, 1, 40, 2)]:
        assert ttrain.subgraph_batch_bytes(*args) == \
            jtrain.subgraph_batch_bytes(*args)


# ---------------------------------------------------------------------------
# state conversion and device defaults
# ---------------------------------------------------------------------------

def test_opt_state_from_numpy(graphs):
    w = _World(*graphs, "sage")
    jo = jopt.adam(1e-3)
    js = jo.init(w.jparams)
    ts = convert.opt_state_from_numpy(js, CPU)
    assert isinstance(ts, topt.OptState)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    assert ts.mu[0].keys() == w.jparams[0].keys()
    moved = convert.to_device(ts, CPU)
    assert isinstance(moved, topt.OptState)


def test_builders_default_to_the_card():
    """init_codebook, init_layer_vq_state and the backbones' init run on
    the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA requests are honoured")
    cfg = CodebookConfig(k=8, f_prod=4)
    for call in (lambda: tcb.init_codebook(16, 8, cfg),
                 lambda: tconv.init_layer_vq_state(10, 16, 8, cfg),
                 lambda: tlayers.GCN.init(4, 3),
                 lambda: tlayers.SAGE.init(4, 3),
                 lambda: tlayers.GIN.init(4, 3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tcb.init_codebook(16, 8, cfg, device=CPU).codewords_w.device == \
        torch.device("cpu")
