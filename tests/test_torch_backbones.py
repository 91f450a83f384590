"""The learnable and dense backbones of the PyTorch port -- GAT and the
Graph Transformer -- against the JAX reference on the CPU: one layer's
``full_apply`` and ``vq_apply`` (with and without the probe), their
gradients through the Eq. 7 injection, the dense codeword reads, the
out-of-batch cluster masses and ``reconstruct`` on every table storage,
the two materialized injections, the head widening, one ``vq_train_step``
and ``train_vq`` / ``train_full`` / ``vq_inference`` end to end, and the
scenario front -- at a small size (``synthetic_arxiv(n=400)``, hidden 32,
heads 4, k 32).  Weights and VQ states are built in ``repro`` and carried
across with ``repro_torch.convert``; the reference runs with
``REPRO_FORCE_PALLAS`` unset (its plain path).

Tolerances: one layer's forward ``rtol=1e-5, atol=1e-6``; gradients and
one step ``rtol=1e-4, atol=1e-5`` (fp32 einsums in another summation
order through the softmax / the clipped scores and an RMSprop step);
several steps, where a near-tie assignment may flip, the losses
``rtol=1e-3``; the table reads exact.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.core import conv as jconv                         # noqa: E402
from repro.core import message_passing as jmp                # noqa: E402
from repro.core.codebook import CodebookConfig as JCodebookConfig  # noqa
from repro.distributed import quantization as jq             # noqa: E402
from repro.graph import batching as jb                       # noqa: E402
from repro.graph.datasets import synthetic_arxiv as j_arxiv  # noqa: E402
from repro.models import gnn as jgnn                         # noqa: E402
from repro.nn import gnn_layers as jlayers                   # noqa: E402
from repro.train import optimizer as jopt                    # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.core import conv as tconv                   # noqa: E402
from repro_torch.core import message_passing as tmp          # noqa: E402
from repro_torch.core.codebook import CodebookConfig         # noqa: E402
from repro_torch.graph import batching as tb                 # noqa: E402
from repro_torch.graph.datasets import synthetic_arxiv as t_arxiv  # noqa
from repro_torch.models import gnn as tgnn                   # noqa: E402
from repro_torch.nn import gnn_layers as tlayers             # noqa: E402
from repro_torch.train import gnn_trainer as ttrain          # noqa: E402
from repro_torch.train import optimizer as topt              # noqa: E402

ONE = dict(rtol=1e-5, atol=1e-6)
STEP = dict(rtol=1e-4, atol=1e-5)
CPU = "cpu"
N, HIDDEN, K = 400, 32, 32
ATTENTION = ["gat", "transformer"]


def _cfgs(backbone, n_out=40, hidden=HIDDEN):
    kw = dict(backbone=backbone, f_in=128, hidden=hidden, n_out=n_out,
              n_layers=2, heads=4)
    return (jgnn.GNNConfig(codebook=JCodebookConfig(k=K, f_prod=4), **kw),
            tgnn.GNNConfig(codebook=CodebookConfig(k=K, f_prod=4), **kw))


def _np_tree(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


@pytest.fixture(scope="module")
def graphs():
    return j_arxiv(n=N, seed=0), t_arxiv(n=N, seed=0)


class _World:
    """One backbone's reference state and its port twin, on the CPU."""

    def __init__(self, jg, tg, backbone):
        self.backbone = backbone
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

    def packs(self, bids):
        ids = bids.astype(np.int32)
        return (jb.plan_batch(self.jplan, jnp.asarray(ids)),
                tb.plan_batch(self.tplan, torch.from_numpy(ids)))


@pytest.fixture(scope="module", params=ATTENTION)
def world(request, graphs):
    return _World(*graphs, request.param)


def _layer_call(w, layer, bids, probe, inject):
    """(reference fn, port fn) of ``vq_apply`` at ``layer`` on the batch
    ``bids``, each taking (params, x_b, probe)."""
    jp, tp = w.packs(bids)
    fi, fo = jgnn._layer_out_dims(w.jcfg)[layer]
    last = layer == w.jcfg.n_layers - 1
    jbk = jlayers.BACKBONES[w.backbone]
    tbk = tlayers.BACKBONES[w.backbone]
    jcb, tcb = w.jcfg.layer_codebook_cfg(), w.tcfg.layer_codebook_cfg()

    def jfn(p, x, pr):
        return jbk.vq_apply(p, x, pr, jp, w.jvq[layer], w.jops.degrees, jcb,
                            (lambda z: z) if last else jax.nn.relu, fi, fo,
                            inject=inject)

    def tfn(p, x, pr):
        return tbk.vq_apply(p, x, pr, tp, w.tvq[layer], w.tops.degrees, tcb,
                            (lambda z: z) if last else torch.relu, fi, fo,
                            inject=inject)
    return jfn, tfn, fi


def _layer_inputs(w, layer, bids, seed):
    rng = np.random.default_rng(seed)
    fi, fo = jgnn._layer_out_dims(w.jcfg)[layer]
    x = w.jg.features[bids] if layer == 0 else \
        rng.normal(size=(len(bids), fi)).astype(np.float32)
    shape = jlayers.BACKBONES[w.backbone].probe_shape(
        len(bids), fi, fo, heads=w.jcfg.heads)
    probe = (0.1 * rng.normal(size=shape)).astype(np.float32)
    return np.ascontiguousarray(x, np.float32), probe


# ---------------------------------------------------------------------------
# one layer, forward and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("with_probe", [False, True])
def test_vq_apply_forward(world, layer, with_probe):
    w = world
    bids = np.random.default_rng(layer).choice(N, 96, replace=False)
    x, probe = _layer_inputs(w, layer, bids, seed=7 + layer)
    jfn, tfn, _ = _layer_call(w, layer, bids, None, inject=False)
    want = jfn(w.jparams[layer], jnp.asarray(x),
               jnp.asarray(probe) if with_probe else None)
    got = tfn(w.tparams[layer], torch.from_numpy(x),
              torch.from_numpy(probe) if with_probe else None)
    assert_allclose(got.numpy(), np.asarray(want), **ONE)


@pytest.mark.parametrize("layer", [0, 1])
def test_full_apply_forward(world, layer):
    w = world
    fi = jgnn._layer_out_dims(w.jcfg)[layer][0]
    x = w.jg.features if layer == 0 else np.random.default_rng(3).normal(
        size=(N, fi)).astype(np.float32)
    want = jlayers.BACKBONES[w.backbone].full_apply(
        w.jparams[layer], jnp.asarray(x), w.jops, jax.nn.relu)
    got = tlayers.BACKBONES[w.backbone].full_apply(
        w.tparams[layer], torch.from_numpy(x), w.tops, torch.relu)
    assert_allclose(got.numpy(), np.asarray(want), **ONE)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("inject", [True, False])
def test_vq_apply_gradients(world, layer, inject):
    """d sum(out * y) / d (params, x_b, probe): ``jax.grad`` of the
    reference against ``torch.autograd``, the Eq. 7 injection on and off
    (with it, the injected term moves x_b's gradient)."""
    w = world
    bids = np.random.default_rng(10 + layer).choice(N, 96, replace=False)
    x, probe = _layer_inputs(w, layer, bids, seed=20 + layer)
    jfn, tfn, _ = _layer_call(w, layer, bids, None, inject=inject)
    fo = jgnn._layer_out_dims(w.jcfg)[layer][1]
    y = np.random.default_rng(30).normal(size=(96, fo)).astype(np.float32)
    jg_p, jg_x, jg_pr = jax.grad(
        lambda p, xx, pr: jnp.sum(jfn(p, xx, pr) * y), argnums=(0, 1, 2))(
        w.jparams[layer], jnp.asarray(x), jnp.asarray(probe))
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in w.tparams[layer].items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = torch.from_numpy(probe).requires_grad_(True)
    out = tfn(leaves, xt, pt)
    names = list(leaves)
    grads = torch.autograd.grad((out * torch.from_numpy(y)).sum(),
                                [leaves[k] for k in names] + [xt, pt])
    for name, g in zip(names, grads):
        assert_allclose(g.numpy(), np.asarray(jg_p[name]), **STEP,
                        err_msg=name)
    assert_allclose(grads[-2].numpy(), np.asarray(jg_x), **STEP)
    assert_allclose(grads[-1].numpy(), np.asarray(jg_pr), **STEP)


def test_injection_moves_only_the_input_gradient(world):
    """With and without the injection the forward is the same and only
    x_b's gradient differs (by the phantom Eq. 7 term)."""
    w = world
    bids = np.random.default_rng(40).choice(N, 96, replace=False)
    x, probe = _layer_inputs(w, 0, bids, seed=41)
    outs, gx = [], []
    for inject in (True, False):
        _, tfn, _ = _layer_call(w, 0, bids, None, inject=inject)
        xt = torch.from_numpy(x).requires_grad_(True)
        out = tfn(w.tparams[0], xt, torch.from_numpy(probe))
        outs.append(out.detach())
        gx.append(torch.autograd.grad(out.sum(), xt)[0])
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(gx[0], gx[1])


# ---------------------------------------------------------------------------
# the dense reads, the cluster masses, reconstruct
# ---------------------------------------------------------------------------

def _tier_states(storage):
    """A reference layer state with its table in ``storage`` (int32, uint8
    or nibble-packed), k 16, and an int8 codeword snapshot, + its twin."""
    cfg = JCodebookConfig(k=16, f_prod=4)
    st = jconv.init_layer_vq_state(jax.random.PRNGKey(5), 300, 32, 12, cfg)
    a = np.asarray(st.assignment)
    if storage == "uint8":
        st = st._replace(assignment=jnp.asarray(a.astype(np.uint8)))
    elif storage == "packed":
        st = st._replace(assignment=jq.PackedAssignment.pack(
            jnp.asarray(a.astype(np.uint8))))
    st = jconv.quantize_layer_state(st, 32, cfg)
    return st, convert.vq_states_from_numpy([st], CPU)[0], cfg


@pytest.mark.parametrize("storage", ["int32", "uint8", "packed"])
def test_dense_reads_masses_and_reconstruct_exact(storage):
    jst, tst, cfg = _tier_states(storage)
    tcfg = CodebookConfig(k=16, f_prod=4)
    for dense in (True, False):
        jf, jgc = jconv.layer_codewords(jst, 32, cfg, dense=dense)
        tf, tg = tconv.layer_codewords(tst, 32, tcfg, dense=dense)
        if dense:
            assert tf.dtype == torch.float32 and tg.dtype == torch.float32
            assert np.array_equal(tf.numpy(), np.asarray(jf))
            assert np.array_equal(tg.numpy(), np.asarray(jgc))
        else:                      # the snapshot, as the kernels read it
            assert np.array_equal(tf.q.numpy(), np.asarray(jf.q))
            assert np.array_equal(tg.scale.numpy(), np.asarray(jgc.scale))
    rng = np.random.default_rng(6)
    bids = rng.choice(300, 50, replace=False).astype(np.int32)
    assert np.array_equal(
        tconv.out_of_batch_cluster_mass(tst, torch.from_numpy(bids)).numpy(),
        np.asarray(jconv.out_of_batch_cluster_mass(jst, jnp.asarray(bids))))
    ids = rng.integers(0, 300, (40, 7)).astype(np.int32)
    jf, _ = jconv.layer_codewords(jst, 32, cfg, dense=True)
    tf, _ = tconv.layer_codewords(tst, 32, tcfg, dense=True)
    got = tmp.reconstruct(tf, tst.assignment, torch.from_numpy(ids))
    want = jmp.reconstruct(jf, jst.assignment, jnp.asarray(ids))
    assert got.shape == (40, 7, 32)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["materialized", "table"])
@pytest.mark.parametrize("with_w", [False, True])
def test_materialized_injections_backward(form, with_w):
    """Identity forward; the backward adds the reference's phantom term
    (with the optional ``@ W^T``); nothing reaches the residuals."""
    rng = np.random.default_rng(8)
    b, d, f, fo = 20, 6, 12, 5
    x = rng.normal(size=(b, f)).astype(np.float32)
    rev = rng.normal(size=(b, d)).astype(np.float32)
    res = rng.normal(size=(b, d, f) if form == "materialized"
                     else (d, f)).astype(np.float32)
    wmat = rng.normal(size=(f, fo)).astype(np.float32)   # [f_in, f_out]
    y = rng.normal(size=(b, f)).astype(np.float32)
    jfn = jmp.inject_context_grad_materialized if form == "materialized" \
        else jmp.inject_context_grad_table
    tfn = tmp.inject_context_grad_materialized if form == "materialized" \
        else tmp.inject_context_grad_table
    if with_w:   # the residual then lives in W's output width
        res = res[..., :fo].copy()
    jw = jnp.asarray(wmat) if with_w else None
    jgx, jgres = jax.grad(lambda xx, rr: jnp.sum(
        jfn(xx, jnp.asarray(rev), rr, jw) * y), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(res))
    xt = torch.from_numpy(x).requires_grad_(True)
    rt = torch.from_numpy(res).requires_grad_(True)
    out = tfn(xt, torch.from_numpy(rev), rt,
              torch.from_numpy(wmat) if with_w else None)
    assert torch.equal(out.detach(), xt.detach())
    (gx,) = torch.autograd.grad((out * torch.from_numpy(y)).sum(), [xt])
    assert_allclose(gx.numpy(), np.asarray(jgx), **ONE)
    assert not np.asarray(jgres).any()
    assert not np.allclose(gx.numpy(), y)


# ---------------------------------------------------------------------------
# the model: widening, one step, the trainers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", ATTENTION)
def test_head_widening_matches_reference(backbone):
    """n_out 10 with 4 heads: the last layer emits 12 logits, as in the
    reference (no extra head); its VQ state and probe follow."""
    jcfg, tcfg = _cfgs(backbone, n_out=10)
    jparams = jgnn.init_gnn(jax.random.PRNGKey(0), jcfg)
    tparams = tgnn.init_gnn(tcfg, torch.Generator().manual_seed(0),
                            device=CPU)
    assert [{k: v.shape for k, v in p.items()} for p in tparams] == \
        [{k: tuple(v.shape) for k, v in p.items()} for p in jparams]
    assert tgnn._layer_out_dims(tcfg) == jgnn._layer_out_dims(jcfg) \
        == [(128, 32), (32, 12)]
    assert tgnn.probe_shapes(tcfg, 7) == jgnn.probe_shapes(jcfg, 7)
    tvq = tgnn.init_vq_states(tcfg, 50, torch.Generator().manual_seed(1),
                              device=CPU)
    jvq = jgnn.init_vq_states(jax.random.PRNGKey(1), jcfg, 50)
    assert [tuple(s.codebook.codewords_w.shape) for s in tvq] == \
        [tuple(s.codebook.codewords_w.shape) for s in jvq]
    assert tcfg.layer_codebook_cfg() == tuple(jcfg.layer_codebook_cfg())


def test_backbones_registry():
    assert list(tlayers.BACKBONES) == list(jlayers.BACKBONES)
    assert tlayers.backbone("gat") is tlayers.GAT
    assert tlayers.backbone("transformer") is tlayers.GraphTransformer
    with pytest.raises(ValueError, match="unknown backbone"):
        tlayers.backbone("gcn2")
    assert tlayers.SCORE_CLIP == jlayers.SCORE_CLIP


def test_vq_train_step_matches_reference(world):
    """One Alg. 1 step from the same state and batch: loss, output, every
    parameter, every VQ state field and the per-layer VQ errors."""
    w = world
    bids = np.random.default_rng(5).choice(N, 100, replace=False)
    jp, tp = w.packs(bids)
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
    for a, b in zip(tres[0], jres[0]):
        for name in a:
            assert_allclose(a[name].numpy(), np.asarray(b[name]), **STEP,
                            err_msg=name)
    for a, b in zip(tres[1], jres[1]):
        assert np.array_equal(a.assignment.numpy(), np.asarray(b.assignment))
        assert np.array_equal(a.counts.numpy(), np.asarray(b.counts))
        for fa, fb in zip(a.codebook, b.codebook):
            assert_allclose(np.asarray(fa), np.asarray(fb), **STEP)
    assert_allclose(tres[5].numpy(), np.asarray(jres[5]), **STEP)


def test_train_vq_tracks_reference(world, monkeypatch):
    """``train_vq`` for 2 epochs of 4 batches from the reference's initial
    state (both trainers draw the same numpy batch stream): per-step
    losses, the final params, assignments, counts and codebooks track the
    reference, and so does codeword inference of the trained models.
    (Longer runs amplify the fp32 rounding: the Transformer's outputs grow
    ~50x over 3 epochs in both packages, and its params then part by
    ~1e-2 with every assignment still equal.)"""
    from repro.train import gnn_trainer as jtrain
    w = world
    losses = []

    def recorded(*a, **k):
        out = jgnn.vq_train_epoch(*a, **k)
        losses.append(np.asarray(out[3]))
        return out
    monkeypatch.setattr(jtrain, "vq_train_epoch", recorded)
    monkeypatch.setattr(ttrain, "init_gnn", lambda *a, **k: w.tparams)
    monkeypatch.setattr(ttrain, "init_vq_states", lambda *a, **k: w.tvq)
    jr = jtrain.train_vq(w.jg, w.jcfg, epochs=2, batch_size=100,
                         eval_every=2)
    tr = ttrain.train_vq(w.tg, w.tcfg, epochs=2, batch_size=100,
                         eval_every=2, device=CPU)
    many = dict(rtol=1e-3, atol=1e-4)
    assert tr["step_losses"].shape == (8,)
    assert_allclose(tr["step_losses"], np.concatenate(losses), rtol=1e-3)
    assert_allclose(tr["final"]["vq_err"], jr["final"]["vq_err"], rtol=1e-3)
    assert abs(tr["final"]["test"] - jr["final"]["test"]) <= 0.05
    assert tr["mem_bytes"] == jr["mem_bytes"]
    for a, b in zip(tr["params"], jr["params"]):
        for name in a:
            assert_allclose(a[name].numpy(), np.asarray(b[name]), **many,
                            err_msg=name)
    for a, b in zip(tr["vq_states"], jr["vq_states"]):
        assert np.array_equal(a.assignment.numpy(), np.asarray(b.assignment))
        assert np.array_equal(a.counts.numpy(), np.asarray(b.counts))
        for fa, fb in zip(a.codebook, b.codebook):
            assert_allclose(np.asarray(fa), np.asarray(fb), **many)
    emb = ttrain.vq_inference(tr["params"], tr["vq_states"], w.tg, w.tcfg,
                              128)
    jemb = jtrain.vq_inference(jr["params"], jr["vq_states"], w.jg, w.jcfg,
                               128)
    assert emb.shape == (N, 40)
    assert_allclose(emb, jemb, rtol=1e-3, atol=1e-3 * np.abs(jemb).max())


def test_full_train_step_and_predict_match_reference(world):
    w = world
    jo, to = jopt.adam(1e-2), topt.adam(1e-2)
    jps, jos, jl = jgnn.full_train_step(
        w.jparams, jo.init(w.jparams), jnp.asarray(w.jg.features), w.jops,
        jnp.asarray(w.jg.labels), jnp.asarray(w.train_mask), w.jcfg, jo)
    tps, tos, tl = tgnn.full_train_step(
        w.tparams, to.init(w.tparams), torch.from_numpy(w.tg.features),
        w.tops, torch.from_numpy(w.tg.labels),
        torch.from_numpy(w.train_mask), w.tcfg, to)
    assert_allclose(float(tl), float(jl), **STEP)
    for a, b in zip(tps, jps):
        for name in a:
            assert_allclose(a[name].numpy(), np.asarray(b[name]), **STEP,
                            err_msg=name)
    assert_allclose(tgnn.full_predict(tps, torch.from_numpy(w.tg.features),
                                      w.tops, w.tcfg).numpy(),
                    np.asarray(jgnn.full_predict(
                        jps, jnp.asarray(w.jg.features), w.jops, w.jcfg)),
                    **STEP)


def test_train_scenario_every_scale_method_for_gat(graphs):
    """GAT through every method of ``SCALE_METHODS`` on the CPU plain
    path: each reaches its trainer and returns a metric."""
    _, tg = graphs
    _, tcfg = _cfgs("gat")
    for method in ttrain.SCALE_METHODS:
        knobs = {"n_parts": 8} if method == "cluster" else {}
        r = ttrain.train_scenario(tg, tcfg, method, epochs=1,
                                  batch_size=100, eval_every=1, device=CPU,
                                  **knobs)
        assert 0.0 <= r["final"]["test"] <= 1.0, method
        assert ("vq_states" in r) == (method in ("vq", "hybrid")), method


def test_full_width_reference_curves(monkeypatch):
    """The reference's curves behind ``chip_smoke.py``'s gat-train and
    transformer-train gates, at the paper's full width (hidden 128, k 1024,
    f_prod 4, heads 4) for 10 epochs at batch n/4 (here n 2,000): every
    run's epoch losses are finite and printed (``-s``), and the two
    settings the card's learning gates use learn here: GAT with Eq. 7 off
    and the Transformer at depth 1.  The other runs' curves are recorded,
    not judged.  (The port tracks the reference step for step:
    ``test_train_vq_tracks_reference`` and
    ``test_vq_train_step_matches_reference``.)"""
    from repro.configs import vq_gnn_paper as jpaper
    from repro.train import gnn_trainer as jtrain
    g = j_arxiv(n=2000, seed=0)
    b = jpaper.paper_batch_size(g)
    losses = []

    def recorded(*a, **k):
        out = jgnn.vq_train_epoch(*a, **k)
        losses.append(float(np.mean(np.asarray(out[3]))))
        return out
    monkeypatch.setattr(jtrain, "vq_train_epoch", recorded)
    runs = {}
    for backbone, inject, layers in (("gat", True, 3), ("gat", False, 3),
                                     ("transformer", True, 3),
                                     ("transformer", False, 3),
                                     ("transformer", True, 1)):
        losses.clear()
        cfg = jpaper.paper_config(g, full_scale=True)._replace(
            backbone=backbone, grad_inject=inject, n_layers=layers)
        r = jtrain.train_vq(g, cfg, epochs=10, batch_size=b, eval_every=10)
        runs[backbone, inject, layers] = (list(losses), r["final"]["val"])
        print(backbone, "Eq. 7", "on" if inject else "off", "depth", layers,
              "epoch losses", [round(v, 4) for v in losses], "val",
              r["final"]["val"])
        assert len(losses) == 10 and np.all(np.isfinite(losses))
    for key in (("gat", False, 3), ("transformer", True, 1)):
        ep, val = runs[key]
        assert ep[-1] < 0.5 * ep[0] and val > 0.5, key


@pytest.mark.parametrize("script", ["graph_transformer", "quickstart"])
def test_examples_run_attention_backbones_on_cpu(capsys, script):
    """The graph-transformer twin, and the quickstart twin with
    ``--backbone gat``, end to end on the CPU plain path."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{script}")
    argv = ["--device", "cpu", "--n", "300", "--epochs", "2"]
    res = mod.main(argv if script == "graph_transformer"
                   else argv + ["--backbone", "gat"])
    assert 0.0 <= res["vq"]["val"] <= 1.0
    out = capsys.readouterr().out
    assert "VQ-GNN" in out
