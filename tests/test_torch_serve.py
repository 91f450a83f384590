"""The serving slice of the PyTorch port against the JAX reference on the
CPU: one-layer ``vq_apply`` of GCN/SAGE/GIN, ``full_apply``, the
inductive inference executor (activations, assignments, counts), the
serving step with duplicate ids, and ``GNNServer.serve`` /
``drain_requests`` -- at a small size (``synthetic_arxiv(n=300)``, hidden
32, 2 layers, k 32).  Inputs and initial state are built in ``repro`` and
carried across as numpy arrays.

Tolerances: one layer ``rtol=1e-5, atol=1e-6``; several layers
``rtol=1e-4, atol=1e-5`` (fp32 matmuls in another summation order,
compounded through relu layers).  Assignments are equal except at
near-ties (``1e-5 * (1 + |d|)``), and counts exactly equal wherever the
assignments are.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.core.codebook import CodebookConfig as JCodebookConfig  # noqa
from repro.distributed import quantization as jq             # noqa: E402
from repro.graph import batching as jb                       # noqa: E402
from repro.graph.datasets import synthetic_arxiv as j_arxiv  # noqa: E402
from repro.models import gnn as jgnn                         # noqa: E402
from repro.nn import gnn_layers as jlayers                   # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.core import codebook as tcb                 # noqa: E402
from repro_torch.core.codebook import CodebookConfig         # noqa: E402
from repro_torch.distributed import quantization as tq       # noqa: E402
from repro_torch.graph import batching as tb                 # noqa: E402
from repro_torch.graph.datasets import synthetic_arxiv as t_arxiv  # noqa
from repro_torch.models import gnn as tgnn                   # noqa: E402
from repro_torch.nn import gnn_layers as tlayers             # noqa: E402

ONE = dict(rtol=1e-5, atol=1e-6)
MULTI = dict(rtol=1e-4, atol=1e-5)
CPU = "cpu"


def _cfgs(backbone):
    kw = dict(backbone=backbone, f_in=128, hidden=32, n_out=40, n_layers=2)
    return (jgnn.GNNConfig(codebook=JCodebookConfig(k=32, f_prod=4), **kw),
            tgnn.GNNConfig(codebook=CodebookConfig(k=32, f_prod=4), **kw))


def _np_params(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


class _World:
    """One backbone's reference state and its port twin, on a CPU."""

    def __init__(self, jg, tg, backbone):
        self.jcfg, self.tcfg = _cfgs(backbone)
        self.jg, self.tg = jg, tg
        self.jops = jb.full_operands(jg)
        self.jplan = jb.build_epoch_plan(jg, full_ops=self.jops)
        self.tops = tb.full_operands(tg, device=CPU)
        self.tplan = tb.build_epoch_plan(tg, full_ops=self.tops)
        self.jx = jnp.asarray(jg.features)
        self.tx = torch.from_numpy(tg.features)
        self.jparams = jgnn.init_gnn(jax.random.PRNGKey(0), self.jcfg)
        self.jvq = jgnn.init_vq_states(jax.random.PRNGKey(1), self.jcfg,
                                       jg.n)
        self.tparams = convert.params_from_numpy(_np_params(self.jparams),
                                                 CPU)
        self.tvq = convert.vq_states_from_numpy(self.jvq, CPU)

    def packs(self, bids, smask=None):
        jp = jb.plan_batch(self.jplan, jnp.asarray(bids.astype(np.int32)),
                           None if smask is None else jnp.asarray(smask))
        tp = tb.plan_batch(self.tplan,
                           torch.from_numpy(bids.astype(np.int32)),
                           None if smask is None
                           else torch.from_numpy(smask))
        return jp, tp


@pytest.fixture(scope="module")
def graphs():
    return j_arxiv(n=300, seed=0), t_arxiv(n=300, seed=0)


@pytest.fixture(scope="module")
def gcn(graphs):
    return _World(*graphs, "gcn")


def _whitened_feature_dists(state, feats, f_feat, eps):
    """Reference-space distances [nb, n, k] (float64) of the feature-half
    assignment, for the near-tie rule."""
    cb = state.codebook
    nb = np.asarray(cb.codewords_w).shape[0]
    fb = f_feat // nb
    v = np.asarray(feats, np.float64).reshape(len(feats), nb, fb)
    v = (v - np.asarray(cb.mean)[:, :fb]) / np.sqrt(
        np.asarray(cb.var)[:, :fb] + eps)
    c = np.asarray(cb.codewords_w, np.float64)[:, :, :fb]
    return (c * c).sum(-1)[:, None, :] - 2 * np.einsum('bnf,nkf->nbk', v, c)


def _assert_assign_near_ties(got, want, dist):
    got, want = np.asarray(got), np.asarray(want)
    d_got = np.take_along_axis(dist, got[..., None].astype(np.int64), 2)
    d_want = np.take_along_axis(dist, want[..., None].astype(np.int64), 2)
    diff = got != want
    near = (np.abs(d_got - d_want) <= 1e-5 * (1 + np.abs(d_want)))[..., 0]
    assert np.all(near[diff]), f"{diff.sum()} non-tie assignment mismatches"
    return diff


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("case", ["distinct", "duplicates"])
def test_vq_apply_one_layer(graphs, backbone, case):
    w = _World(*graphs, backbone)
    rng = np.random.default_rng(4)
    bids = rng.choice(w.jg.n, 64, replace=False) if case == "distinct" \
        else np.concatenate([np.arange(48) % 20, np.zeros(16, np.int64)])
    jp, tp = w.packs(bids)
    fi, fo = w.jcfg.layer_dims()[0]
    jbk, tbk = jlayers.BACKBONES[backbone], tlayers.BACKBONES[backbone]
    want = jbk.vq_apply(w.jparams[0], w.jx[bids], None, jp, w.jvq[0],
                        w.jops.degrees, w.jcfg.codebook, jax.nn.relu, fi, fo,
                        inject=False)
    got = tbk.vq_apply(w.tparams[0], w.tx[torch.from_numpy(bids)], None, tp,
                       w.tvq[0], w.tops.degrees, w.tcfg.codebook, torch.relu,
                       fi, fo, inject=False)
    assert got.shape == (64, fo)
    assert_allclose(got.numpy(), np.asarray(want), **ONE)


@pytest.mark.parametrize("backbone", ["gcn", "sage", "gin"])
def test_full_apply_one_layer(graphs, backbone):
    """Exact message passing over the whole graph.  GIN's layer is an
    unnormalised neighbor sum (rows ~10x larger) through a two-matmul MLP,
    so it is held to the several-layer tolerance."""
    w = _World(*graphs, backbone)
    want = jlayers.BACKBONES[backbone].full_apply(
        w.jparams[0], w.jx, w.jops, jax.nn.relu)
    got = tlayers.BACKBONES[backbone].full_apply(
        w.tparams[0], w.tx, w.tops, torch.relu)
    assert_allclose(got.numpy(), np.asarray(want),
                    **(MULTI if backbone == "gin" else ONE))


def test_codeword_reads_and_layout(gcn):
    from repro.core import codebook as jcb
    fi = gcn.jcfg.layer_dims()[0][0]
    for jfn, tfn in [(jcb.feature_codewords, tcb.feature_codewords),
                     (jcb.gradient_codewords, tcb.gradient_codewords)]:
        want = jfn(gcn.jvq[0].codebook, fi, gcn.jcfg.codebook)
        got = tfn(gcn.tvq[0].codebook, fi, gcn.tcfg.codebook)
        assert got.is_contiguous()
        assert_allclose(got.numpy(), np.asarray(want), **ONE)
    for args in [(128, 32, 4), (128, 128, 4), (128, 40, 4), (16, 4, 4)]:
        assert tcb.branch_layout(*args) == jcb.branch_layout(*args)


# ---------------------------------------------------------------------------
# the inductive inference executor (the server's refresh)
# ---------------------------------------------------------------------------

def test_vq_infer_layer_inductive_per_layer(gcn):
    """Each layer fed the reference's own input activations and pre-refresh
    state: refreshed assignments equal but near-ties, counts exactly equal
    where the assignments are, outputs within the one-layer tolerance."""
    w = gcn
    ids, sm = jb.inference_slices(w.jg.n, 128)
    jperm, jsm = jnp.asarray(ids.astype(np.int32)), jnp.asarray(sm)
    tperm, tsm = torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(sm)
    jacts = w.jx
    for l in range(w.jcfg.n_layers):
        jout, jst = jgnn.vq_infer_layer(
            w.jparams[l], w.jvq[l], w.jplan, jperm, jsm, jacts,
            w.jops.degrees, w.jcfg, l, True)
        tout, tst = tgnn.vq_infer_layer(
            w.tparams[l], convert.vq_states_from_numpy([w.jvq[l]], CPU)[0],
            w.tplan, tperm, tsm, torch.from_numpy(np.array(jacts)),
            w.tops.degrees, w.tcfg, l, True)
        fi = w.jcfg.layer_dims()[l][0]
        dist = _whitened_feature_dists(w.jvq[l], np.asarray(jacts), fi,
                                       w.jcfg.codebook.eps)
        diff = _assert_assign_near_ties(tst.assignment.numpy(),
                                        np.asarray(jst.assignment), dist)
        if not diff.any():
            assert np.array_equal(tst.counts.numpy(), np.asarray(jst.counts))
            assert_allclose(tout.numpy(), np.asarray(jout), **ONE)
        assert tst.assignment.dtype == torch.int32
        assert_allclose(tst.counts.numpy().sum(-1),
                        np.asarray(w.jvq[l].counts).sum(-1))
        jacts = jout


def test_vq_infer_epoch_inductive(gcn):
    """The whole refresh, end to end from the same initial state."""
    w = gcn
    ids, sm = jb.inference_slices(w.jg.n, 128)
    jout, jst = jgnn.vq_infer_epoch(
        w.jparams, w.jvq, w.jplan, jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(sm), w.jx, w.jops.degrees, w.jcfg, inductive=True)
    tout, tst = tgnn.vq_infer_epoch(
        w.tparams, w.tvq, w.tplan, torch.from_numpy(ids.astype(np.int32)),
        torch.from_numpy(sm), w.tx, w.tops.degrees, w.tcfg, inductive=True)
    assert tout.shape == (w.jg.n, w.jcfg.n_out)
    assert_allclose(tout.numpy(), np.asarray(jout), **MULTI)
    for a, b in zip(tst, jst):
        assert np.array_equal(a.assignment.numpy(), np.asarray(b.assignment))
        assert np.array_equal(a.counts.numpy(), np.asarray(b.counts))
    # the refresh left the initial state untouched (functional update)
    assert np.array_equal(w.tvq[0].assignment.numpy(),
                          np.asarray(w.jvq[0].assignment))


@pytest.mark.parametrize("batch", [128, 100, 300])
def test_vq_infer_epoch_tail_padding_keeps_real_slot(gcn, batch):
    """Nodes duplicated by the wrap-padding keep their real-slot output
    (the padded slot's write goes to the sacrificial row n): the sweep
    matches the reference on every node, the duplicated ones included."""
    w = gcn
    ids, sm = tb.inference_slices(w.tg.n, batch)
    dup = ids[-1][sm[-1] == 0]
    assert (len(dup) > 0) == (w.tg.n % batch != 0)
    jout, _ = jgnn.vq_infer_epoch(
        w.jparams, w.jvq, w.jplan, jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(sm), w.jx, w.jops.degrees, w.jcfg)
    out, st = tgnn.vq_infer_epoch(
        w.tparams, w.tvq, w.tplan, torch.from_numpy(ids.astype(np.int32)),
        torch.from_numpy(sm), w.tx, w.tops.degrees, w.tcfg)
    assert st[0] is w.tvq[0]                 # not inductive: state kept
    assert_allclose(out.numpy(), np.asarray(jout), **MULTI)
    assert_allclose(out.numpy()[dup], np.asarray(jout)[dup], **MULTI)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def refreshed(gcn):
    """The reference's post-refresh state, carried across."""
    w = gcn
    ids, sm = jb.inference_slices(w.jg.n, 128)
    _, jst = jgnn.vq_infer_epoch(
        w.jparams, w.jvq, w.jplan, jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(sm), w.jx, w.jops.degrees, w.jcfg, inductive=True)
    return jst, convert.vq_states_from_numpy(jst, CPU)


@pytest.mark.parametrize("case", ["distinct", "duplicates", "all"])
def test_vq_serve_batch(gcn, refreshed, case):
    w = gcn
    jst, tst = refreshed
    if case == "distinct":
        bids = np.random.default_rng(9).choice(w.jg.n, 64, replace=False)
    elif case == "duplicates":
        bids = np.arange(64) % 40             # ids 0..23 appear twice
    else:
        bids = np.arange(w.jg.n)
    want = jgnn.vq_serve_batch(w.jparams, jst, w.jplan,
                               jnp.asarray(bids.astype(np.int32)), w.jx,
                               w.jops.degrees, w.jcfg)
    got = tgnn.vq_serve_batch(w.tparams, tst, w.tplan,
                              torch.from_numpy(bids.astype(np.int32)), w.tx,
                              w.tops.degrees, w.tcfg)
    assert_allclose(got.numpy(), np.asarray(want), **MULTI)
    if case == "duplicates":
        assert_allclose(got[:24].numpy(), got[40:].numpy(), rtol=1e-6,
                        atol=1e-7)


def test_gnn_server_serve_and_drain(gcn, refreshed):
    from repro.launch.serve_gnn import GNNServer as JServer
    from repro_torch.launch.serve_gnn import GNNServer, drain_requests
    w = gcn
    jst, tst = refreshed
    jserver = JServer(w.jg, w.jcfg, w.jparams, jst, batch=64)
    server = GNNServer(w.tg, w.tcfg, w.tparams, tst, batch=64, device=CPU)
    assert server.warmup() >= 0
    req = np.arange(100) % w.jg.n               # spans two steps (padding)
    out = server.serve(req)
    assert out.shape == (100, w.tcfg.n_out)
    assert_allclose(out, jserver.serve(req), **MULTI)
    assert server.serve(np.zeros(0, np.int64)).shape == (0, w.tcfg.n_out)
    assert_allclose(out[:64], server.serve(req[:64]), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="exactly 64"):
        server.step(np.zeros(3, np.int64))
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, w.jg.n, sz) for sz in (3, 64, 7, 130)]
    rep = drain_requests(server, requests)
    assert rep["nodes"] == sum(len(r) for r in requests)
    assert rep["requests"] == len(requests)
    assert rep["steps"] >= 4 and rep["nodes_per_s"] > 0
    assert rep["request_p99_ms"] >= rep["request_p50_ms"]
    assert server.graph_state_bytes_per_device() == \
        jserver.graph_state_bytes_per_device()


def test_gnn_server_refresh_matches_reference(gcn):
    from repro.launch.serve_gnn import GNNServer as JServer
    from repro_torch.launch.serve_gnn import GNNServer
    w = gcn
    jserver = JServer(w.jg, w.jcfg, w.jparams, w.jvq, batch=128)
    server = GNNServer(w.tg, w.tcfg, w.tparams, w.tvq, batch=128, device=CPU)
    jserver.refresh()
    assert server.refresh() > 0
    for a, b in zip(server.vq, jserver.vq):
        assert np.array_equal(a.assignment.numpy(), np.asarray(b.assignment))
    req = np.random.default_rng(1).integers(0, w.jg.n, 90)
    assert_allclose(server.serve(req), jserver.serve(req), **MULTI)


def test_serve_main_cpu_and_request_stream(capsys):
    from repro_torch.launch import serve_gnn
    rep = serve_gnn.main(["--n", "300", "--hidden", "16", "--k", "16",
                          "--batch", "64", "--requests", "12",
                          "--device", "cpu"])
    assert rep["requests"] == 12 and rep["device"] == "cpu"
    assert rep["refresh_s"] > 0 and rep["nodes_per_s"] > 0
    assert "nodes/s" in capsys.readouterr().out
    # the port draws the reference's request stream
    rng = np.random.default_rng(3)
    sizes = rng.integers(1, 65, 10)
    want = [rng.integers(0, 300, sz) for sz in sizes]
    got = serve_gnn.make_requests(300, 10, 64, 3)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_paper_config_matches_reference(graphs):
    from repro.configs import vq_gnn_paper as jp
    from repro_torch.configs import vq_gnn_paper as tp
    jg, tg = graphs
    for full in (False, True):
        a, b = jp.paper_config(jg, full_scale=full), \
            tp.paper_config(tg, full_scale=full)
        assert a._asdict().keys() == b._asdict().keys()
        assert all(getattr(a, f) == getattr(b, f) for f in a._fields
                   if f != "codebook")
        assert tuple(a.codebook) == tuple(b.codebook)
    assert tp.paper_batch_size(tg) == jp.paper_batch_size(jg)
    full = tp.paper_config(tg, full_scale=True)
    assert [tcb.branch_layout(fi, fo, 4) for fi, fo in full.layer_dims()] \
        == [(32, 4, 4), (32, 4, 4), (8, 16, 5)]


# ---------------------------------------------------------------------------
# --mesh N and --shard-graph
# ---------------------------------------------------------------------------

def test_unported_options_raise():
    """``--mesh N`` and ``--shard-graph`` serve (the test keeps the name it
    had while they raised).  On gloo ranks of the CPU, ``--mesh 2`` (the
    throughput mode: each rank computes b/2 rows of every layer from the
    whole batch's activations) and ``--mesh 2 --shard-graph`` serve the
    rows of ``--mesh 1`` bit for bit (equal ``rows_sha256``; all equal the
    unsharded server's), the sharded state from at most 0.6x the graph
    state bytes a rank; ``--shard-graph`` without ``--mesh`` raises."""
    from repro_torch.launch import serve_gnn
    base = ["--n", "300", "--device", "cpu"]
    runs = {"1": ["--mesh", "1"], "2": ["--mesh", "2"],
            "2s": ["--mesh", "2", "--shard-graph"]}
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {k: pool.submit(serve_gnn.main, base + argv)
                   for k, argv in runs.items()}
        reps = {k: f.result() for k, f in futures.items()}
    args = serve_gnn.parser().parse_args(base)
    server = serve_gnn.build_server(args)
    server.refresh()
    requests = serve_gnn.make_requests(300, args.requests, args.max_request,
                                       args.seed)
    whole = []
    serve_gnn.drain_requests(server, requests, whole)
    assert reps["1"]["rows_sha256"] == reps["2"]["rows_sha256"] == \
        reps["2s"]["rows_sha256"] == serve_gnn.rows_digest(whole)
    for k, rep in reps.items():
        assert rep["mesh"] == int(k[0]) and rep["shard_graph"] == (k == "2s")
        assert rep["nodes"] == reps["1"]["nodes"] and rep["batch"] == 256
    assert reps["2"]["graph_state_bytes_per_device"] == \
        reps["1"]["graph_state_bytes_per_device"]
    assert reps["2s"]["graph_state_bytes_per_device"] <= \
        0.6 * reps["1"]["graph_state_bytes_per_device"]
    with pytest.raises(ValueError, match="--mesh"):
        serve_gnn.main(base + ["--shard-graph"])


@pytest.mark.parametrize("backbone", ["gat", "transformer"])
def test_serve_attention_backbones_on_cpu(graphs, backbone):
    """GAT and the Graph Transformer serve: the refresh and the served rows
    of the port's server against the reference's, from the same state,
    then ``serve_gnn --backbone`` end to end on the CPU."""
    from repro.launch.serve_gnn import GNNServer as JServer
    from repro_torch.launch import serve_gnn
    w = _World(*graphs, backbone)
    jserver = JServer(w.jg, w.jcfg, w.jparams, w.jvq, batch=64)
    server = serve_gnn.GNNServer(w.tg, w.tcfg, w.tparams, w.tvq, batch=64,
                                 device=CPU)
    jserver.refresh()
    assert server.refresh() > 0
    for a, b in zip(server.vq, jserver.vq):
        assert np.array_equal(a.assignment.numpy(), np.asarray(b.assignment))
    req = np.random.default_rng(2).integers(0, w.jg.n, 90)
    out = server.serve(req)
    assert out.shape == (90, w.tcfg.n_out)
    assert_allclose(out, jserver.serve(req), **MULTI)
    rep = serve_gnn.main(["--n", "300", "--hidden", "16", "--k", "16",
                          "--batch", "64", "--requests", "6", "--backbone",
                          backbone, "--device", "cpu"])
    assert rep["backbone"] == backbone and rep["requests"] == 6


# ---------------------------------------------------------------------------
# the precision tiers in serving
# ---------------------------------------------------------------------------

TIERS = ["int8", "fp8", "int8+a4", "fp8+a4"]


@pytest.fixture(scope="module")
def gcn16(graphs):
    """A GCN world at k = 16, where every tier (the '+a4' ones too)
    applies."""
    w = _World.__new__(_World)
    jg, tg = graphs
    kw = dict(backbone="gcn", f_in=128, hidden=32, n_out=40, n_layers=2)
    w.jcfg = jgnn.GNNConfig(codebook=JCodebookConfig(k=16, f_prod=4), **kw)
    w.tcfg = tgnn.GNNConfig(codebook=CodebookConfig(k=16, f_prod=4), **kw)
    w.jg, w.tg = jg, tg
    w.jops = jb.full_operands(jg)
    w.jplan = jb.build_epoch_plan(jg, full_ops=w.jops)
    w.tops = tb.full_operands(tg, device=CPU)
    w.tplan = tb.build_epoch_plan(tg, full_ops=w.tops)
    w.jx = jnp.asarray(jg.features)
    w.tx = torch.from_numpy(tg.features)
    w.jparams = jgnn.init_gnn(jax.random.PRNGKey(0), w.jcfg)
    w.jvq = jgnn.init_vq_states(jax.random.PRNGKey(1), w.jcfg, jg.n)
    w.tparams = convert.params_from_numpy(_np_params(w.jparams), CPU)
    w.tvq = convert.vq_states_from_numpy(w.jvq, CPU)
    return w


def _table(a):
    """A table of either package as an int32 numpy array."""
    if isinstance(a, (tq.PackedAssignment, jq.PackedAssignment)):
        a = a.unpack()
    return np.asarray(a).astype(np.int32)


@pytest.mark.parametrize("tier", TIERS)
def test_serving_rows_under_each_tier(gcn16, tier):
    """A tier's serving state (``quantize_vq_states``), refreshed by both
    servers: the same tables in the tier's storage, and served rows
    within the multi-layer tolerance of the reference's -- with duplicate
    ids in the batch and the padded tail of a request.  ``vq_state_bytes``
    counts what the reference's report counts."""
    from repro.launch.serve_gnn import GNNServer as JServer
    from repro_torch.launch.serve_gnn import GNNServer, vq_state_bytes
    w = gcn16
    jvq = jgnn.quantize_vq_states(w.jvq, w.jcfg, precision=tier)
    tvq = tgnn.quantize_vq_states(w.tvq, w.tcfg, precision=tier)
    jserver = JServer(w.jg, w.jcfg, w.jparams, jvq, batch=128)
    server = GNNServer(w.tg, w.tcfg, w.tparams, tvq, batch=128, device=CPU)
    jserver.refresh()
    server.refresh()
    for a, b in zip(server.vq, jserver.vq):
        assert isinstance(a.assignment, tq.PackedAssignment) \
            == isinstance(b.assignment, jq.PackedAssignment)
        assert np.array_equal(_table(a.assignment), _table(b.assignment))
        assert np.array_equal(a.counts.numpy(), np.asarray(b.counts))
        for qa, qb in ((a.qcw.feat, b.qcw.feat), (a.qcw.grad, b.qcw.grad)):
            assert np.array_equal(qa.q.view(torch.uint8).numpy(),
                                  np.asarray(qb.q).view(np.uint8))
    req = np.concatenate([np.arange(64) % 40,
                          np.random.default_rng(1).integers(0, w.jg.n, 90)])
    assert_allclose(server.serve(req), jserver.serve(req), **MULTI)
    want = sum(jq.tree_bytes((s.assignment,) if s.qcw is None
                             else (s.assignment, s.qcw)) for s in jserver.vq)
    assert vq_state_bytes(server.vq) == want


@pytest.mark.parametrize("tier", ["fp32", "int8", "int8+a4"])
def test_serve_refresh_keeps_a_node_major_table(gcn16, tier):
    """The serve refresh writes a node-major table (int32, uint8 or packed
    bytes: the layout ``hold_table`` holds a tier state's table in on the
    card) along its storage rows: after it every layer's table is node-major
    again and equals the row-major server's table, the served rows are
    bit-equal, and ``vq_state_bytes`` is the same (no second copy)."""
    from repro_torch.kernels.context_ell import is_node_major
    from repro_torch.launch.serve_gnn import GNNServer, vq_state_bytes
    w = gcn16
    tvq = w.tvq if tier == "fp32" else \
        tgnn.quantize_vq_states(w.tvq, w.tcfg, precision=tier)

    def node_major(table):
        if isinstance(table, tq.PackedAssignment):
            return tq.PackedAssignment(table.packed.t().contiguous().t(),
                                       table.n)
        return table.t().contiguous().t()

    def buf(table):
        return table.packed if isinstance(table, tq.PackedAssignment) \
            else table

    rows = GNNServer(w.tg, w.tcfg, w.tparams, tvq, batch=128, device=CPU)
    cols = GNNServer(w.tg, w.tcfg, w.tparams,
                     [st._replace(assignment=node_major(st.assignment))
                      for st in tvq], batch=128, device=CPU)
    rows.refresh()
    cols.refresh()
    for r, c in zip(rows.vq, cols.vq):
        assert buf(r.assignment).is_contiguous()
        assert is_node_major(buf(c.assignment))
        assert torch.equal(buf(c.assignment), buf(r.assignment))
        assert torch.equal(c.counts, r.counts)
    req = np.arange(0, w.tg.n, 3)
    assert np.array_equal(cols.serve(req), rows.serve(req))
    assert vq_state_bytes(cols.vq) == vq_state_bytes(rows.vq)


def test_tier_inference_agrees_with_fp32(gcn16):
    """Codeword inference under each tier against the fp32 inference of
    the same codebooks and weights: argmax agreement >= 0.95 (the
    reference's own gate), and the '+a4' tiers give the rows of their
    unpacked tiers bit for bit (packing changes storage only)."""
    from repro_torch.train.gnn_trainer import vq_inference
    w = gcn16
    y32 = vq_inference(w.tparams, w.tvq, w.tg, w.tcfg, 100)
    rows = {}
    for tier in TIERS:
        rows[tier] = vq_inference(
            w.tparams, tgnn.quantize_vq_states(w.tvq, w.tcfg, precision=tier),
            w.tg, w.tcfg, 100)
        agree = (np.argmax(rows[tier], -1) == np.argmax(y32, -1)).mean()
        assert agree >= 0.95, (tier, agree)
    assert np.array_equal(rows["int8+a4"], rows["int8"])
    assert np.array_equal(rows["fp8+a4"], rows["fp8"])


@pytest.mark.parametrize("tier,k", [("int8", 32), ("fp8", 32),
                                    ("int8+a4", 16), ("fp8+a4", 16)])
def test_serve_main_under_each_tier(tier, k, capsys):
    """``--precision`` runs: the states are built, trained and served in
    the tier's storage, and the tier setting does not outlive the
    build."""
    from repro_torch.kernels import ops as tops
    from repro_torch.launch import serve_gnn
    server, rep = serve_gnn.run(serve_gnn.parser().parse_args([
        "--n", "300", "--hidden", "16", "--k", str(k), "--batch", "64",
        "--requests", "8", "--train-epochs", "1", "--precision", tier,
        "--device", "cpu"]))
    assert rep["precision"] == tier and rep["nodes_per_s"] > 0
    assert tops.kernel_precision() == "fp32"
    for st in server.vq:
        assert isinstance(st.assignment, tq.PackedAssignment) \
            == tier.endswith("+a4")
        assert st.qcw.feat.q.dtype == (torch.float8_e4m3fn
                                       if tier.startswith("fp8")
                                       else torch.int8)
    assert rep["vq_state_bytes"] == serve_gnn.vq_state_bytes(server.vq)
    out = serve_gnn.main(["--n", "300", "--hidden", "16", "--k", str(k),
                          "--batch", "64", "--requests", "4",
                          "--precision", tier, "--device", "cpu"])
    assert out["vq_state_bytes"] < 300 * 2 * 8 * 4    # under int32 tables
    assert f"precision={tier}" in capsys.readouterr().out


@pytest.mark.parametrize("tier", ["fp32"] + TIERS)
def test_convert_carries_quantized_states(gcn16, tier):
    """``convert.vq_states_from_numpy`` takes the reference's states in
    every tier -- uint8 and nibble-packed tables, int8 and fp8 snapshots
    (fp8 crossing as its bytes) -- and ``to_device`` moves them."""
    w = gcn16
    jq_states = jgnn.quantize_vq_states(w.jvq, w.jcfg, precision=tier)
    got = convert.vq_states_from_numpy(jq_states, CPU)
    for a, b in zip(got, jq_states):
        if isinstance(b.assignment, jq.PackedAssignment):
            assert isinstance(a.assignment, tq.PackedAssignment)
            assert a.assignment.n == b.assignment.n
            assert np.array_equal(a.assignment.packed.numpy(),
                                  np.asarray(b.assignment.packed))
        else:
            assert np.array_equal(a.assignment.numpy(),
                                  np.asarray(b.assignment))
            assert str(a.assignment.dtype) == "torch." + str(
                np.asarray(b.assignment).dtype)
        if b.qcw is None:
            assert a.qcw is None
            continue
        for qa, qb in ((a.qcw.feat, b.qcw.feat), (a.qcw.grad, b.qcw.grad)):
            assert str(qa.q.dtype) == "torch." + np.asarray(qb.q).dtype.name
            assert np.array_equal(qa.q.view(torch.uint8).numpy(),
                                  np.asarray(qb.q).view(np.uint8))
            assert np.array_equal(qa.scale.numpy(), np.asarray(qb.scale))
    moved = convert.to_device(got, CPU)
    assert type(moved[0].assignment) is type(got[0].assignment)
    with pytest.raises(TypeError, match="int64"):
        convert.vq_states_from_numpy(
            [jq_states[0]._replace(assignment=np.zeros((2, 3), np.int64))],
            CPU)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA requests are honoured")
    from repro_torch.launch.serve_gnn import GNNServer
    g = t_arxiv(n=50, seed=0)
    _, cfg = _cfgs("gcn")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GNNServer(g, cfg, [], [], batch=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.init_gnn(cfg)


def test_convert_to_device_roundtrip(gcn):
    moved = convert.to_device(gcn.tvq, CPU)
    assert isinstance(moved[0], type(gcn.tvq[0]))
    assert torch.equal(moved[1].codebook.codewords_w,
                       gcn.tvq[1].codebook.codewords_w)
    params = convert.to_device(gcn.tparams, CPU)
    assert params[0].keys() == gcn.tparams[0].keys()
    with pytest.raises(TypeError):
        convert.to_device(object(), CPU)
