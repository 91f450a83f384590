"""The training slice of the PyTorch port against the JAX reference on the
CPU, its first half: the streaming codebook update (Alg. 2, forced revival
included), the optimizers, the Eq. 7 injection's gradients, the losses,
one ``vq_train_step`` for GCN / SAGE / GIN, two epochs of
``vq_train_epoch`` with a wrap-padded tail and the full-graph step -- at a
small size (``synthetic_arxiv(n=600)``, hidden 32, 2 layers, k 32).  The
trainers, the samplers and the scenarios are in
``tests/test_torch_train_loops.py``; the fixtures both files share in
``tests/torch_train_common.py``.  Inputs come from numpy seeds; weights,
VQ states and optimizer states are built in ``repro`` and carried across
with ``repro_torch.convert``.  The reference runs with
``REPRO_FORCE_PALLAS`` unset (its oracle path).

Tolerances: one step ``rtol=1e-4, atol=1e-5`` (fp32 matmuls and
reductions in another order, through the backward pass and an RMSprop
step whose first update divides by ``sqrt(v)``); the codebook update
alone ``rtol=1e-5, atol=1e-6`` with counts exact; several steps, where a
near-tie assignment may flip and move one row between two codewords, the
losses and VQ errors ``rtol=1e-3``.
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
from repro.models import gnn as jgnn                         # noqa: E402
from repro.train import optimizer as jopt                    # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.core import codebook as tcb                 # noqa: E402
from repro_torch.core import message_passing as tmp          # noqa: E402
from repro_torch.core.codebook import CodebookConfig         # noqa: E402
from repro_torch.graph import batching as tb                 # noqa: E402
from repro_torch.models import gnn as tgnn                   # noqa: E402
from repro_torch.train import optimizer as topt              # noqa: E402
from torch_train_common import (CPU, N, ONE, STEP, _World,  # noqa: E402
                                _assert_params_close, _assert_states_close,
                                _cb, _cfgs, graphs, world)


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
