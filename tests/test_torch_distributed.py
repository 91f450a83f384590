"""The multi-device slice of the PyTorch port against the JAX reference on
the CPU: the id maps, the collectives, ``codebook.update(mesh=)``, the
data-parallel and row-sharded epochs, the row-sharded inference and
serving, and ``train_vq(mesh=, shard_graph=)``.

The port's side runs on gloo ranks of the port's own spawner
(``repro_torch.distributed.ranks.run_ranks``), spawned once per world size
for the whole module: the ``ranks`` fixture runs every rank-side job
(``repro_torch.distributed.parity_jobs``, so the ranks never import jax)
in one spawn and returns numpy arrays.  The reference's side is its own
collective-free oracle: the same body under ``jax.vmap(...,
axis_name=...)`` over the per-lane operands.  Graph: the n 301 arxiv
look-alike (every mesh pads its rows), GCN hidden 32, 2 layers, k 32,
batch 64 (divisible by 2 and 4).  Each test states its tolerance.
"""
import functools
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.core import codebook as jcb                       # noqa: E402
from repro.core.codebook import CodebookConfig as JCodebookConfig  # noqa
from repro.distributed import collectives as jcol            # noqa: E402
from repro.distributed import sharding as jshd               # noqa: E402
from repro.graph import batching as jb                       # noqa: E402
from repro.graph.datasets import synthetic_arxiv as j_arxiv  # noqa: E402
from repro.models import gnn as jgnn                         # noqa: E402
from repro.train import gnn_trainer as jtrainer              # noqa: E402
from repro.train import optimizer as jopt                    # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.core.codebook import CodebookConfig         # noqa: E402
from repro_torch.distributed import parity_jobs as pj        # noqa: E402
from repro_torch.distributed import sharding as tshd         # noqa: E402
from repro_torch.distributed.ranks import run_ranks          # noqa: E402
from repro_torch.graph import batching as tb                 # noqa: E402
from repro_torch.graph.datasets import synthetic_arxiv as t_arxiv  # noqa
from repro_torch.models import gnn as tgnn                   # noqa: E402
from repro_torch.train import gnn_trainer as ttrainer        # noqa: E402
from repro_torch.train import optimizer as topt              # noqa: E402

N, HIDDEN, LAYERS, K, BATCH, LR = 301, 32, 2, 32, 64, 3e-3
CPU = "cpu"
WORLDS = (2, 4)
# the reference's own tolerances for these checks
DP_TOL = dict(rtol=5e-4, atol=1e-5)           # mesh vs its vmap oracle
ONE_RANK_TOL = dict(rtol=1e-6, atol=1e-7)     # one rank vs vq_train_epoch
SHARDED_TOL = dict(rtol=2e-6, atol=2e-7)      # sharded vs replicated DP
SHARDED_VQ_TOL = dict(rtol=2e-6, atol=1e-6)
CODEBOOK_TOL = dict(rtol=2e-6, atol=1e-6)
MULTI = dict(rtol=1e-4, atol=1e-5)            # tests/test_torch_serve.py
SERVE_BACKBONES = ("gcn", "sage", "gin", "gat", "transformer")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state_ns(vq):
    return [pj.state_namespace(
        {f: np.asarray(getattr(s.codebook, f))
         for f in s.codebook._fields}, s.assignment, s.counts) for s in vq]


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: a.copy(), tree)


# ---------------------------------------------------------------------------
# the reference's setup and the carried state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The reference's model, graph and a state carried through one epoch
    (so the RMSprop moments and codebooks are not at their init), the
    next epoch's batches, the inference batches and 48 serving ids (40
    strided, 8 repeats of id 0)."""
    g = j_arxiv(n=N, seed=0)
    cfg = jgnn.GNNConfig(backbone="gcn", f_in=g.f, hidden=HIDDEN,
                         n_out=g.num_classes, n_layers=LAYERS,
                         codebook=JCodebookConfig(k=K, f_prod=4))
    ops = jb.full_operands(g)
    plan = jb.build_epoch_plan(g, full_ops=ops)
    tm = np.zeros(g.n, np.float32)
    tm[g.train_idx] = 1.0
    opt = jopt.rmsprop(LR)
    params = jgnn.init_gnn(jax.random.PRNGKey(0), cfg)
    vq = jgnn.init_vq_states(jax.random.PRNGKey(1), cfg, g.n)
    x, labels, tmj = (jnp.asarray(g.features), jnp.asarray(g.labels),
                      jnp.asarray(tm))
    ids0, sm0 = jb.epoch_slices(np.random.default_rng(0).permutation(N),
                                BATCH)
    params, vq, ost, _, _ = jgnn.vq_train_epoch(
        params, vq, opt.init(params), plan,
        jnp.asarray(ids0.astype(np.int32)), jnp.asarray(sm0), x, labels,
        tmj, ops.degrees, cfg, opt)
    ids, sm = jb.epoch_slices(np.random.default_rng(7).permutation(N), BATCH)
    iids, ism = jb.inference_slices(N, BATCH)
    bids = np.concatenate([(np.arange(40) * 7) % N,
                           np.zeros(8, int)]).astype(np.int32)
    spec = dict(n=N, graph_seed=0, lr=LR,
                model=dict(backbone="gcn", hidden=HIDDEN, n_layers=LAYERS),
                codebook=dict(k=K, f_prod=4),
                params=[{k: np.asarray(v) for k, v in p.items()}
                        for p in params],
                states=_state_ns(vq),
                opt=dict(step=int(ost.step), mu=_np(ost.mu),
                         nu=_np(ost.nu)),
                perm=ids.astype(np.int32), smask=sm,
                infer_perm=iids.astype(np.int32), infer_smask=ism,
                serve_ids=bids)
    return SimpleNamespace(g=g, cfg=cfg, ops=ops, plan=plan, x=x,
                           labels=labels, tm=tmj, opt=opt, params=params,
                           vq=vq, ost=ost, spec=spec)


@pytest.fixture(scope="module")
def port(ref):
    """The port's unsharded side in this process, from the same state."""
    g = t_arxiv(n=N, seed=0)
    cfg = tgnn.GNNConfig(backbone="gcn", f_in=g.f, hidden=HIDDEN,
                         n_out=g.num_classes, n_layers=LAYERS,
                         codebook=CodebookConfig(k=K, f_prod=4))
    ops = tb.full_operands(g, device=CPU)
    s = ref.spec
    return SimpleNamespace(
        g=g, cfg=cfg, ops=ops, plan=tb.build_epoch_plan(g, full_ops=ops),
        x=torch.from_numpy(g.features), labels=torch.from_numpy(g.labels),
        tm=torch.from_numpy(np.asarray(ref.tm)), opt=topt.rmsprop(LR),
        state=lambda: (convert.params_from_numpy(s["params"], CPU),
                       convert.vq_states_from_numpy(s["states"], CPU),
                       convert.opt_state_from_numpy(
                           SimpleNamespace(**s["opt"]), CPU)))


# ---------------------------------------------------------------------------
# the collectives' inputs, made once with numpy
# ---------------------------------------------------------------------------

def _collective_inputs(ndev: int) -> dict:
    rng = np.random.default_rng(ndev)
    gathers, scatters, psums = {}, {}, {}
    n = 13
    n_pad = tshd.shard_padded_rows(n, ndev)
    gathers["float"] = (rng.standard_normal((n_pad, 5)).astype(np.float32),
                        rng.integers(0, n, (ndev, 6)).astype(np.int32),
                        False)
    # every shard edge (last row of shard s, first of s + 1), the
    # sacrificial row n and the last pad row
    n = 21
    n_pad = tshd.shard_padded_rows(n, ndev)
    n_loc = n_pad // ndev
    edge = [r for s in range(ndev) for r in (s * n_loc, (s + 1) * n_loc - 1)]
    edge += [n, n_pad - 1]
    gathers["boundary"] = (
        rng.standard_normal((n_pad, 3)).astype(np.float32),
        np.tile(np.asarray(edge, np.int32), (ndev, 1)), False)
    n = 10
    n_pad = tshd.shard_padded_rows(n, ndev)
    gathers["int"] = (rng.integers(-5000, 5000, (n_pad, 4)).astype(np.int32),
                      rng.integers(0, n, (ndev, 7)).astype(np.int32), False)
    fp8 = np.asarray(jnp.asarray(rng.standard_normal((n_pad, 4)) * 3,
                                 jnp.float8_e4m3fn)).view(np.uint8)
    gathers["fp8"] = ((fp8, "fp8"),
                      rng.integers(0, n_pad, (ndev, 7)).astype(np.int32),
                      False)
    n = 17
    n_pad = tshd.shard_padded_rows(n, ndev)
    gathers["compress"] = (
        rng.standard_normal((n_pad, 8)).astype(np.float32),
        rng.integers(0, n, (ndev, 9)).astype(np.int32), True)
    # globally distinct real targets, and every rank parking one write on
    # the sacrificial row n (the wrap-pad diversion)
    n, b = 19, 5
    n_pad = tshd.shard_padded_rows(n, ndev)
    real = rng.permutation(n)[: ndev * (b - 1)].reshape(ndev, b - 1)
    scatters["rows"] = (
        rng.standard_normal((n_pad, 4)).astype(np.float32),
        np.concatenate([real, np.full((ndev, 1), n)], 1).astype(np.int32),
        rng.standard_normal((ndev, b, 4)).astype(np.float32))
    psums["plain"] = (rng.standard_normal((ndev, 6, 5)).astype(np.float32),
                      None)
    psums["feedback"] = (
        rng.standard_normal((ndev, 3, 7)).astype(np.float32),
        (0.01 * rng.standard_normal((ndev, 3, 7))).astype(np.float32))
    return dict(gathers=gathers, scatters=scatters, psums=psums)


CODEBOOK_CASES = {
    # every codeword dead: revival must pick its rows from the global batch
    "revive": dict(k=8, f_prod=4, revive_threshold=2.0),
    "default": dict(k=8, f_prod=4),
}


def _codebook_inputs(ndev: int) -> dict:
    rng = np.random.default_rng(10 + ndev)
    cases = {}
    for name, kw in CODEBOOK_CASES.items():
        state = jcb.init_codebook(jax.random.PRNGKey(0), 8, 8,
                                  JCodebookConfig(**kw))
        cases[name] = dict(
            codebook={f: np.asarray(getattr(state, f))
                      for f in state._fields},
            feats=rng.standard_normal((ndev, 16, 8)).astype(np.float32),
            grads=rng.standard_normal((ndev, 16, 8)).astype(np.float32),
            cfg=kw)
    return cases


@pytest.fixture(scope="module")
def ranks(ref):
    """Every rank-side job, one spawn a world size, the three spawns at
    once: {ndev: [rank outputs]}.  Each group's collectives and the wait
    for its ranks time out after 240 s."""
    spec = ref.spec
    jobs = {1: {"epoch": ("epoch", dict(spec=spec))}}
    for ndev in WORLDS:
        jobs[ndev] = {
            "collectives": ("collectives", _collective_inputs(ndev)),
            "epoch": ("epoch", dict(spec=spec, sharded=ndev == 2)),
            "infer_serve": ("infer_serve", dict(spec=spec))}
        jobs[ndev].update({
            f"serve_rows/{bk}": ("serve_rows", dict(spec=spec, backbone=bk))
            for bk in SERVE_BACKBONES})
    jobs[2].update({f"codebook/{name}": ("codebook", case)
                    for name, case in _codebook_inputs(2).items()})
    jobs[2]["train"] = ("train", dict(spec=spec, epochs=2, batch=BATCH))
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {ndev: pool.submit(run_ranks, pj.run_jobs, ndev, "gloo",
                                     CPU, j, timeout_s=240)
                   for ndev, j in jobs.items()}
        return {ndev: f.result() for ndev, f in futures.items()}


# ---------------------------------------------------------------------------
# id maps (array-equal to the reference's)
# ---------------------------------------------------------------------------

def test_id_maps_match_reference():
    for n in (1, 7, 300, 301):
        for nd in (1, 2, 3, 4):
            assert tshd.shard_padded_rows(n, nd) == \
                jshd.shard_padded_rows(n, nd)
    with pytest.raises(ValueError, match="positive"):
        tshd.shard_padded_rows(10, 0)
    n, ndev = 301, 4
    n_pad = tshd.shard_padded_rows(n, ndev)
    n_loc = n_pad // ndev
    gids = np.arange(n_pad)
    shards = tshd.node_to_shard(gids, n_loc)
    np.testing.assert_array_equal(shards, jshd.node_to_shard(gids, n_loc))
    loc = tshd.global_to_local(gids, shards, n_loc)
    np.testing.assert_array_equal(
        loc, jshd.global_to_local(gids, shards, n_loc))
    np.testing.assert_array_equal(tshd.local_to_global(loc, shards, n_loc),
                                  gids)
    # pad rows (the sacrificial row n included) all on the last rank
    assert (tshd.node_to_shard(np.arange(n, n_pad), n_loc) == ndev - 1).all()
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    np.testing.assert_array_equal(tshd.pad_rows(x, 12, fill=-1),
                                  jshd.pad_rows(x, 12, fill=-1))
    np.testing.assert_array_equal(
        tshd.pad_rows(torch.from_numpy(x), 12).numpy(), jshd.pad_rows(x, 12))
    with pytest.raises(ValueError, match="rows"):
        tshd.pad_rows(x, 9)


def test_split_helpers_and_row_blocks():
    """The batch-, scan- and serving-axis cuts and ``shard_rows`` on a
    stand-in mesh of each rank: the pieces put back in rank order are the
    whole, as the reference's specs place them."""
    a = np.arange(6 * 8).reshape(6, 8)
    x = np.arange(301 * 2, dtype=np.float32).reshape(301, 2)
    for ndev in (1, 2):
        meshes = [tshd.GraphMesh(None, r, ndev, torch.device(CPU), "gloo")
                  for r in range(ndev)]
        np.testing.assert_array_equal(np.concatenate(
            [tshd.epoch_batch_shard(a, m) for m in meshes], 1), a)
        np.testing.assert_array_equal(np.concatenate(
            [tshd.scan_shard(a, m) for m in meshes]), a)
        np.testing.assert_array_equal(np.concatenate(
            [a[0][tshd.serve_rows(a.shape[1], m)] for m in meshes]), a[0])
        blocks = [tshd.shard_rows(x, m) for m in meshes]
        n_pad = tshd.shard_padded_rows(300, ndev) if 301 % ndev else 301
        np.testing.assert_array_equal(
            torch.cat(blocks).numpy(), jshd.pad_rows(x, n_pad))
    with pytest.raises(ValueError, match="not divisible"):
        tshd.epoch_batch_shard(a[:, :7], meshes[0])


def test_ranks_default_to_the_card(tmp_path):
    """The spawner and the mesh default to the card, as the port's entry
    points do: without a card ``run_ranks`` and ``graph_dp_mesh`` raise
    unless the caller asks for the CPU; the default backend follows the
    device (NCCL on the card, gloo on the CPU or a shared card)."""
    import torch.distributed as dist
    from repro_torch.distributed.ranks import default_backend
    assert default_backend("cuda") == "nccl"
    assert default_backend("cuda", share_device=True) == "gloo"
    assert default_backend(CPU) == "gloo"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_ranks(pj.run_jobs, 2)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tshd.graph_dp_mesh(1)
        mesh = tshd.graph_dp_mesh(1, device=CPU)
        assert mesh.device.type == CPU and mesh.backend == "gloo"
    finally:
        dist.destroy_process_group()


def test_mesh_refusals(monkeypatch):
    """No group, a CUDA request without a card, more ranks than cards,
    NCCL off the card and a shared card off gloo all raise before any
    process starts."""
    with pytest.raises(RuntimeError, match="initialised process group"):
        tshd.graph_dp_mesh(2)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_ranks(pj.run_jobs, 2, "gloo", "cuda", {})
    with pytest.raises(ValueError, match="nccl"):
        run_ranks(pj.run_jobs, 2, "nccl", CPU, {})
    with pytest.raises(ValueError, match="share_device"):
        run_ranks(pj.run_jobs, 2, "gloo", CPU, {}, share_device=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for backend in ("nccl", "gloo"):
        with pytest.raises(ValueError, match="only 1 card"):
            run_ranks(pj.run_jobs, 2, backend, "cuda", {})
    with pytest.raises(ValueError, match="share_device"):
        run_ranks(pj.run_jobs, 2, "nccl", "cuda", {}, share_device=True)


# ---------------------------------------------------------------------------
# cross-shard gather / scatter and the compressed all-reduce
# ---------------------------------------------------------------------------

def _lanes(table_pad, ndev):
    return jnp.asarray(table_pad).reshape((ndev, -1) + table_pad.shape[1:])


@pytest.mark.parametrize("ndev", WORLDS)
@pytest.mark.parametrize("case", ["float", "boundary", "int", "fp8"])
def test_gather_from_shards_matches_reference(ranks, ndev, case):
    """float, int and fp8 payloads, shard-boundary and pad ids: every
    rank's rows array-equal to the reference's lane and to the table's."""
    table, ids, _ = _collective_inputs(ndev)["gathers"][case]
    if case == "fp8":
        table = table[0].view(jnp.float8_e4m3fn)
    want = jax.vmap(lambda t, i: jcol.gather_from_shards(t, i, "d"),
                    axis_name="d")(_lanes(table, ndev), jnp.asarray(ids))
    for r in range(ndev):
        got = ranks[ndev][r]["collectives"][f"gather/{case}"]
        lane = np.asarray(want[r])
        if case == "fp8":
            lane = lane.view(np.uint8)
            assert np.array_equal(got, table[ids[r]].view(np.uint8))
        else:
            assert np.array_equal(got, table[ids[r]])
        assert got.dtype == lane.dtype and np.array_equal(got, lane)


@pytest.mark.parametrize("ndev", WORLDS)
def test_gather_from_shards_compressed(ranks, ndev):
    """int8 payload against one MAX-shared scale: within max|table| / 254
    of the rows, and of the reference's lane."""
    table, ids, _ = _collective_inputs(ndev)["gathers"]["compress"]
    want = jax.vmap(
        lambda t, i: jcol.gather_from_shards(t, i, "d", compress=True),
        axis_name="d")(_lanes(table, ndev), jnp.asarray(ids))
    half = float(np.abs(table).max()) / 254
    for r in range(ndev):
        got = ranks[ndev][r]["collectives"]["gather/compress"]
        assert_allclose(got, table[ids[r]], rtol=0, atol=half * 1.0001)
        assert_allclose(got, np.asarray(want[r]), rtol=0, atol=half * 1.0001)


@pytest.mark.parametrize("ndev", WORLDS)
def test_shard_scatter_rows_matches_reference(ranks, ndev):
    """Every row but the sacrificial one array-equal to the reference's
    scatter under vmap and to the global ``set``."""
    table, ids, rows = _collective_inputs(ndev)["scatters"]["rows"]
    want = jax.vmap(lambda t, i, r: jcol.shard_scatter_rows(t, i, r, "d"),
                    axis_name="d")(_lanes(table, ndev), jnp.asarray(ids),
                                   jnp.asarray(rows))
    want = np.asarray(want).reshape(table.shape)
    expect = table.copy()
    for s in range(ndev):
        expect[ids[s, :-1]] = rows[s, :-1]
    keep = np.arange(table.shape[0]) != 19
    for r in range(ndev):
        got = ranks[ndev][r]["collectives"]["scatter/rows"]
        np.testing.assert_array_equal(got[keep], want[keep])
        np.testing.assert_array_equal(got[keep], expect[keep])


@pytest.mark.parametrize("ndev", WORLDS)
def test_compressed_psum_matches_reference(ranks, ndev):
    """``compressed_psum`` (with and without error feedback) and its tree
    form: sums and residuals equal to the reference's lanes up to f32
    rounding (rtol 1e-6, atol 1e-7); ``psum_tree`` the exact sums."""
    psums = _collective_inputs(ndev)["psums"]
    for i, (name, (x, res)) in enumerate(psums.items()):
        want_s, want_r = jax.vmap(
            lambda a, b: jcol.compressed_psum(a, "d", b), axis_name="d")(
            jnp.asarray(x), None if res is None else jnp.asarray(res))
        for r in range(ndev):
            out = ranks[ndev][r]["collectives"]
            s, nr = out[f"psum/{name}"]
            assert_allclose(s, np.asarray(want_s[r]), rtol=1e-6, atol=1e-7)
            assert_allclose(nr, np.asarray(want_r[r]), rtol=1e-6, atol=1e-7)
            assert_allclose(out["psum_tree"][i], x.sum(0), rtol=1e-6,
                            atol=1e-6)
    # the tree form gets its residuals as a tree, all present or none
    tree = {str(i): jnp.asarray(x) for i, (x, _) in enumerate(psums.values())}
    want_s, want_r = jax.vmap(
        lambda t: jcol.compressed_grad_allreduce(t, "d"), axis_name="d")(
        tree)
    for r in range(ndev):
        sums, news = ranks[ndev][r]["collectives"]["tree"]
        for i in range(len(psums)):
            assert_allclose(sums[i], np.asarray(want_s[str(i)][r]),
                            rtol=1e-6, atol=1e-7)
            assert_allclose(news[i], np.asarray(want_r[str(i)][r]),
                            rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# codebook.update(mesh=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CODEBOOK_CASES))
def test_codebook_update_mesh_matches_reference(ranks, case):
    """Two ranks against the reference's update under vmap (rtol 2e-6,
    atol 1e-6), assignments equal, and the new state bit-equal on every
    rank -- with every codeword dead ("revive"), the replacement rows
    come from the global batch (the twin of
    test_dp_codebook_revival_identical_across_replicas)."""
    inp = _codebook_inputs(2)[case]
    cfg = JCodebookConfig(**inp["cfg"])
    state = jcb.CodebookState(*(jnp.asarray(inp["codebook"][f])
                                for f in jcb.CodebookState._fields))
    new, stats = jax.vmap(
        lambda f, g: jcb.update(state, f, g, cfg, axis_name="i"),
        axis_name="i")(jnp.asarray(inp["feats"]), jnp.asarray(inp["grads"]))
    outs = [ranks[2][r][f"codebook/{case}"] for r in range(2)]
    for r, out in enumerate(outs):
        for f in jcb.CodebookState._fields:
            assert_allclose(out["state"][f], np.asarray(getattr(new, f))[r],
                            **CODEBOOK_TOL)
            assert np.array_equal(out["state"][f], outs[0]["state"][f])
        assert np.array_equal(out["assignment"],
                              np.asarray(stats.assignment)[r])
    if case == "revive":
        assert (outs[0]["state"]["cluster_size"] == 1.0).all()


# ---------------------------------------------------------------------------
# the data-parallel and row-sharded epochs
# ---------------------------------------------------------------------------

def _assert_epoch_close(got: dict, want, tol, vq_tol=None):
    """An epoch output (``parity_jobs`` dict) against (params, vq, opt,
    losses, errs) of the other side (numpy-convertible)."""
    params, vq, ost, losses, errs = want
    vq_tol = vq_tol or tol
    for a, b in zip(got["params"], params):
        for name in a:
            assert_allclose(a[name], np.asarray(b[name]), **tol)
    for a, b in zip(got["opt"]["nu"], ost.nu):
        for name in a:
            assert_allclose(a[name], np.asarray(b[name]), **tol)
    for a, b in zip(got["states"], vq):
        assert np.array_equal(a["assignment"], np.asarray(b.assignment))
        assert np.array_equal(a["counts"], np.asarray(b.counts))
        for f in jcb.CodebookState._fields:
            assert_allclose(a[f], np.asarray(getattr(b.codebook, f)),
                            **vq_tol)
    assert_allclose(got["losses"], np.asarray(losses), **tol)
    assert_allclose(got["errs"], np.asarray(errs), **tol)


def _lane(tree, i):
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[i], tree)


def _ranks_bit_equal(outs: list):
    for out in outs[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(out),
                        jax.tree_util.tree_leaves(outs[0])):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("ndev", WORLDS)
def test_dp_epoch_matches_vmap_oracle(ref, ranks, ndev):
    """``vq_train_epoch_dp`` from the carried params, states and RMSprop
    state against the reference's ``_vq_epoch_body(axis_name="data")``
    under vmap over the ranks' columns, at the reference's rtol 5e-4 /
    atol 1e-5 (assignments and counts equal); every rank's output
    bit-equal."""
    s = ref.spec
    S, b = s["perm"].shape
    bl = b // ndev
    perm = jnp.asarray(s["perm"].reshape(S, ndev, bl).transpose(1, 0, 2))
    smask = jnp.asarray(s["smask"].reshape(S, ndev, bl).transpose(1, 0, 2))
    body = functools.partial(jgnn._vq_epoch_body, cfg=ref.cfg, opt=ref.opt,
                             axis_name="data")
    want = jax.vmap(body, in_axes=(None, None, None, None, 0, 0, None, None,
                                   None, None), axis_name="data")(
        *_copy((ref.params, ref.vq, ref.ost)), ref.plan, perm, smask,
        ref.x, ref.labels, ref.tm, ref.ops.degrees)
    outs = [ranks[ndev][r]["epoch"]["dp"] for r in range(ndev)]
    _ranks_bit_equal(outs)
    _assert_epoch_close(outs[0], _lane(want, 0), DP_TOL)


def test_dp_epoch_one_rank_is_the_epoch(ref, ranks, port):
    """At one rank the data-parallel (and the row-sharded) epoch is
    ``vq_train_epoch`` of the port, rtol 1e-6 / atol 1e-7 (1e-6 absolute
    on the codebook fields, as the reference's twin)."""
    p = port
    want = tgnn.vq_train_epoch(
        *p.state(), p.plan, torch.from_numpy(ref.spec["perm"]),
        torch.from_numpy(ref.spec["smask"]), p.x, p.labels, p.tm,
        p.ops.degrees, p.cfg, p.opt)
    want = (pj.np_params(want[0]), _states_ns(pj.np_states(want[1])),
            SimpleNamespace(nu=pj.np_params(want[2].nu)), want[3].numpy(),
            want[4].numpy())
    for kind in ("dp", "sharded"):
        _assert_epoch_close(ranks[1][0]["epoch"][kind], want, ONE_RANK_TOL,
                            dict(rtol=1e-6, atol=1e-6))


def test_sharded_epoch_compressed_payload_trains(ranks):
    """The int8 feature-row payload (``compress=True``) is lossy, but the
    epoch stays finite and close to the exact one: step losses within 1 %
    (the twin of the reference's
    test_sharded_epoch_compress_payload_trains, which checks finiteness)."""
    for ndev in (1, 2):
        out = ranks[ndev][0]["epoch"]
        comp, exact = out["compressed"], out["sharded"]
        assert np.isfinite(comp["losses"]).all()
        assert np.isfinite(comp["errs"]).all()
        assert_allclose(comp["losses"], exact["losses"], rtol=1e-2)


def _states_ns(dicts):
    """``parity_jobs.np_states`` dicts as objects with the reference's
    attribute names."""
    return [SimpleNamespace(
        codebook=SimpleNamespace(**{f: d[f] for f in
                                    jcb.CodebookState._fields}),
        assignment=d["assignment"], counts=d["counts"]) for d in dicts]


def test_sharded_epoch_matches_dp(ranks):
    """Two ranks: ``vq_train_epoch_sharded`` against the replicated DP
    epoch at the same mesh size, at the reference's rtol 2e-6 / atol 2e-7
    (2e-6 / 1e-6 on the codebook fields).  It turns out bit-equal on the
    CPU: the cross-shard gathers move each row exactly (one owner, zeros
    elsewhere), so the steps see the same bits."""
    for r in range(2):
        dp_, sh = (ranks[2][r]["epoch"][k] for k in ("dp", "sharded"))
        want = (dp_["params"], _states_ns(dp_["states"]),
                SimpleNamespace(nu=dp_["opt"]["nu"]), dp_["losses"],
                dp_["errs"])
        _assert_epoch_close(sh, want, SHARDED_TOL, SHARDED_VQ_TOL)
        for a, b in zip(jax.tree_util.tree_leaves(sh),
                        jax.tree_util.tree_leaves(dp_)):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# row-sharded inference and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", WORLDS)
def test_sharded_inference_and_serving(ref, ranks, port, ndev):
    """The inductive ``vq_infer_epoch_sharded`` and
    ``vq_serve_batch_sharded`` (48 ids, 8 of them repeats of id 0):
    array-equal to the port's unsharded executors (the [n, f_out] table,
    every refreshed state field, the served rows), and within the
    port-vs-reference tolerance of tests/test_torch_serve.py (rtol 1e-4,
    atol 1e-5) of the reference's; every rank holds the same; at two
    ranks the graph state takes at most 0.6x the replicated bytes."""
    s = ref.spec
    params, states, _ = port.state()
    acts, new_states = tgnn.vq_infer_epoch(
        params, states, port.plan, torch.from_numpy(s["infer_perm"]),
        torch.from_numpy(s["infer_smask"]), port.x, port.ops.degrees,
        port.cfg, inductive=True)
    rows = tgnn.vq_serve_batch(params, states, port.plan,
                               torch.from_numpy(s["serve_ids"]), port.x,
                               port.ops.degrees, port.cfg)
    jacts, _ = jgnn.vq_infer_epoch(
        ref.params, ref.vq, ref.plan, jnp.asarray(s["infer_perm"]),
        jnp.asarray(s["infer_smask"]), ref.x, ref.ops.degrees, ref.cfg,
        inductive=True)
    jrows = jgnn.vq_serve_batch(ref.params, ref.vq, ref.plan,
                                jnp.asarray(s["serve_ids"]), ref.x,
                                ref.ops.degrees, ref.cfg)
    outs = [ranks[ndev][r]["infer_serve"] for r in range(ndev)]
    _ranks_bit_equal(outs)
    out = outs[0]
    np.testing.assert_array_equal(out["acts"], acts.numpy())
    for a, b in zip(out["states"], pj.np_states(new_states)):
        for f in b:
            np.testing.assert_array_equal(a[f], b[f])
    np.testing.assert_array_equal(out["serve"], rows.numpy())
    assert_allclose(out["acts"], np.asarray(jacts), **MULTI)
    assert_allclose(out["serve"], np.asarray(jrows), **MULTI)
    replicated = tshd.per_device_bytes([port.plan, port.x, port.ops.degrees])
    assert out["n_local"] == tshd.shard_padded_rows(N, ndev) // ndev
    if ndev == 2:
        assert out["bytes"] <= 0.6 * replicated


@pytest.mark.parametrize("ndev", WORLDS)
@pytest.mark.parametrize("backbone", SERVE_BACKBONES)
def test_serve_rows_equal_unsharded(ref, ranks, ndev, backbone):
    """The serving mesh's throughput mode (``vq_serve_batch_rows``: each
    rank computes b/ndev rows of every layer from the whole batch's
    activations, then all-gathers them) serves the 48 ids, 8 of them
    repeats of id 0, array-equal to ``vq_serve_batch`` on one process,
    for every backbone; every rank holds the same rows."""
    g = t_arxiv(n=N, seed=0)
    cfg = tgnn.GNNConfig(backbone=backbone, f_in=g.f, hidden=HIDDEN,
                         n_out=g.num_classes, n_layers=LAYERS,
                         codebook=CodebookConfig(k=K, f_prod=4))
    ops = tb.full_operands(g, device=CPU)
    params, states = pj.seeded_model(cfg, g.n, CPU)
    want = tgnn.vq_serve_batch(
        params, states, tb.build_epoch_plan(g, full_ops=ops),
        torch.from_numpy(ref.spec["serve_ids"]),
        torch.from_numpy(g.features), ops.degrees, cfg).numpy()
    outs = [ranks[ndev][r][f"serve_rows/{backbone}"] for r in range(ndev)]
    for out in outs:
        np.testing.assert_array_equal(out, want)


# ---------------------------------------------------------------------------
# train_vq(mesh=, shard_graph=)
# ---------------------------------------------------------------------------

class _StubMesh:
    """A stand-in two-rank mesh for the refusals (raised before any
    collective) in either package's terms."""
    shape = {"data": 2}
    world_size = 2
    device = torch.device(CPU)


def test_train_vq_refusals_match_reference(ref, port, monkeypatch):
    """``train_vq``'s four refusals, each raised by both packages with the
    same words: ``batch_fn`` with ``mesh``; ``mesh`` off the epoch
    executor (``REPRO_EPOCH_EXECUTOR=0``, or the link task);
    ``shard_graph`` without ``mesh``; and a clamped batch the mesh does
    not divide."""
    jg, tg = ref.g, port.g
    jcfg = jgnn.GNNConfig(backbone="gcn", f_in=jg.f, hidden=16,
                          n_out=jg.num_classes, n_layers=2,
                          codebook=JCodebookConfig(k=16, f_prod=4))
    tcfg = tgnn.GNNConfig(backbone="gcn", f_in=tg.f, hidden=16,
                          n_out=tg.num_classes, n_layers=2,
                          codebook=CodebookConfig(k=16, f_prod=4))

    def both(match, jcfg=jcfg, tcfg=tcfg, **kw):
        for train, g, cfg, extra in (
                (jtrainer.train_vq, jg, jcfg, {}),
                (ttrainer.train_vq, tg, tcfg, {"device": CPU})):
            with pytest.raises(ValueError, match=match):
                train(g, cfg, epochs=1, **kw, **extra)

    both("mutually exclusive", batch_size=64, mesh=_StubMesh(),
         batch_fn=lambda rng: None)
    both("requires the epoch executor", jcfg=jcfg._replace(task="link"),
         tcfg=tcfg._replace(task="link"), batch_size=64, mesh=_StubMesh())
    both("pass mesh=", batch_size=64, shard_graph=True)
    both("clamped to the 301-node pool", batch_size=333, mesh=_StubMesh())
    both("shard_graph", batch_size=333, mesh=_StubMesh(), shard_graph=True)
    # the same refusal through the environment, on the port (the
    # reference raises it in the same words, as the link task shows)
    monkeypatch.setenv("REPRO_EPOCH_EXECUTOR", "0")
    with pytest.raises(ValueError, match="requires the epoch executor"):
        ttrainer.train_vq(tg, tcfg, epochs=1, batch_size=64,
                          mesh=_StubMesh(), device=CPU)


def test_train_vq_sharded_matches_dp(ranks):
    """``train_vq(mesh=2 ranks, shard_graph=True)`` against ``mesh=2
    ranks`` over 2 epochs: step losses, VQ errors, params and states at
    the sharded executor's rtol 2e-6 / atol 2e-7 (they turn out
    bit-equal), the same on both ranks, finite, with val/test metrics."""
    outs = [ranks[2][r]["train"] for r in range(2)]
    _ranks_bit_equal(outs)
    dp_, sh = outs[0]["dp"], outs[0]["sharded"]
    assert dp_["losses"].shape == (2 * -(-N // BATCH),)
    assert np.isfinite(dp_["losses"]).all()
    for key in ("losses", "errs"):
        assert_allclose(sh[key], dp_[key], **SHARDED_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(sh["params"]),
                    jax.tree_util.tree_leaves(dp_["params"])):
        assert_allclose(a, b, **SHARDED_TOL)
    for a, b in zip(sh["states"], dp_["states"]):
        for f in a:
            assert_allclose(a[f], b[f], **SHARDED_VQ_TOL)
    assert set(sh["final"]) >= {"val", "test"}
