"""The training slice of the PyTorch port against the JAX reference on the
CPU, its second half: ``train_vq`` end to end (and at the paper's full
width, and under the precision tiers), ``vq_inference``, ``train_full``,
the quickstart twin and ``serve_gnn --train-epochs``, the samplers'
epochs and trainers, the hybrid, and the scenario front -- at a small
size (``synthetic_arxiv(n=600)``, hidden 32, 2 layers, k 32).  The step,
optimizer and codebook tests are in ``tests/test_torch_train.py``; the
fixtures both files share in ``tests/torch_train_common.py``.  Inputs
come from numpy seeds; weights, VQ states and optimizer states are built
in ``repro`` and carried across with ``repro_torch.convert``.  The
reference runs with ``REPRO_FORCE_PALLAS`` unset (its oracle path).

Tolerances: several steps, where a near-tie assignment may flip and move
one row between two codewords, the losses and VQ errors ``rtol=1e-3``
(``rtol=1e-2`` at the paper's full width, k = 1024, where flips are
likelier and the early loss rises); ``train_vq`` test accuracy within
0.05 of the reference's from the same initial state.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.core.codebook import CodebookConfig as JCodebookConfig  # noqa
from repro.graph import batching as jb                       # noqa: E402
from repro.graph.datasets import synthetic_arxiv as j_arxiv  # noqa: E402
from repro.models import gnn as jgnn                         # noqa: E402
from repro.train import optimizer as jopt                    # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.core import codebook as tcb                 # noqa: E402
from repro_torch.core import conv as tconv                   # noqa: E402
from repro_torch.core.codebook import CodebookConfig         # noqa: E402
from repro_torch.graph import batching as tb                 # noqa: E402
from repro_torch.graph.datasets import synthetic_arxiv as t_arxiv  # noqa
from repro_torch.models import gnn as tgnn                   # noqa: E402
from repro_torch.nn import gnn_layers as tlayers             # noqa: E402
from repro_torch.train import gnn_trainer as ttrain          # noqa: E402
from repro_torch.train import optimizer as topt              # noqa: E402
from torch_train_common import (CPU, N, STEP, _World,  # noqa: E402
                                _assert_params_close, _cfgs, _np_tree,
                                graphs)


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
