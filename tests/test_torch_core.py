"""The rest of the VQ core in the PyTorch port against the JAX reference on
the CPU: ``codebook.assign`` (array-equal at 1, 4 and 32 branches, with
whitening on and off), ``kmeanspp_init`` (its deterministic part fed the
reference's own ``jax.random`` draws), the module-level
``relative_error``, the Theorem 2 / Corollary 3 checks of
``core/bounds.py`` (and a hypothesis test of the two inequalities on the
port), ``context_messages_sketch``, the re-exports of ``repro_torch.core``
and the weight quantizer (``quantize_tensor`` / ``quantize_tree`` and
their inverses, byte-equal for int8 and fp8).

Inputs come from numpy with a seed.  Tolerances: assignments and
quantized bytes exact; every float result ``rtol=1e-6`` (``atol=1e-7``
where a value may be zero; the sketch's sums also the
``2 k 2^-24 sum |term|`` that adding their k products in another order
may move them); the hypothesis inequalities hold within
``1e-5`` of their right-hand side, as the reference's test allows.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st    # noqa: E402

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.core as jcore                                   # noqa: E402
from repro.core import bounds as jb                          # noqa: E402
from repro.core import codebook as jcb                       # noqa: E402
from repro.core import message_passing as jmp                # noqa: E402
from repro.distributed import quantization as jq             # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
from repro_torch.core import bounds as tb                    # noqa: E402
from repro_torch.core import codebook as tcb                 # noqa: E402
from repro_torch.core import message_passing as tmp         # noqa: E402
from repro_torch.distributed import quantization as tq       # noqa: E402

RTOL = dict(rtol=1e-6, atol=1e-7)
# (f_feat, f_grad, f_prod) -> 1, 4 and 32 branches
LAYOUTS = {1: (4, 4, 4), 4: (32, 16, 4), 32: (128, 128, 4)}


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    """The reference on its plain path (no interpret-mode Pallas)."""
    monkeypatch.delenv("REPRO_FORCE_PALLAS", raising=False)


def _state(nb: int, k: int, seed: int):
    """The same random codebook state in both packages."""
    f_feat, f_grad, f_prod = LAYOUTS[nb]
    n, fb, gb = jcb.branch_layout(f_feat, f_grad, f_prod)
    assert n == nb
    rng = np.random.default_rng(seed)
    f_blk = fb + gb
    arrs = dict(
        codewords_w=rng.normal(size=(nb, k, f_blk)).astype(np.float32),
        cluster_size=rng.uniform(0.5, 3, (nb, k)).astype(np.float32),
        cluster_sum=rng.normal(size=(nb, k, f_blk)).astype(np.float32),
        mean=(0.3 * rng.normal(size=(nb, f_blk))).astype(np.float32),
        var=rng.uniform(0.2, 4, (nb, f_blk)).astype(np.float32))
    js = jcb.CodebookState(**{k_: jnp.asarray(v) for k_, v in arrs.items()},
                           step=jnp.asarray(3, jnp.int32))
    ts = tcb.CodebookState(**{k_: torch.from_numpy(v)
                              for k_, v in arrs.items()},
                           step=torch.tensor(3, dtype=torch.int32))
    return js, ts, f_feat, f_grad, f_prod


def _batch(b: int, f_feat: int, f_grad: int, seed: int):
    rng = np.random.default_rng(seed)
    feats = (1.5 * rng.normal(size=(b, f_feat))).astype(np.float32)
    grads = (0.1 * rng.normal(size=(b, f_grad))).astype(np.float32)
    return feats, grads


def _cfgs(k: int, f_prod: int, whiten: bool):
    return (jcb.CodebookConfig(k=k, f_prod=f_prod, whiten=whiten),
            tcb.CodebookConfig(k=k, f_prod=f_prod, whiten=whiten))


# ---------------------------------------------------------------------------
# assign
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [1, 4, 32])
@pytest.mark.parametrize("whiten", [True, False])
def test_assign_array_equal(nb, whiten):
    js, ts, f_feat, f_grad, f_prod = _state(nb, 64, seed=nb)
    feats, grads = _batch(300, f_feat, f_grad, seed=nb + 1)
    jcfg, tcfg = _cfgs(64, f_prod, whiten)
    want = np.asarray(jcb.assign(js, jnp.asarray(feats), jnp.asarray(grads),
                                 jcfg))
    got = tcb.assign(ts, torch.from_numpy(feats), torch.from_numpy(grads),
                     tcfg)
    assert got.dtype == torch.int32 and got.shape == (nb, 300)
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# kmeanspp_init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [1, 4, 32])
@pytest.mark.parametrize("whiten", [True, False])
def test_kmeanspp_seed_on_the_references_draws(nb, whiten):
    """The deterministic part fed the reference's own draws from the same
    key gives the reference's state."""
    k, b = 32, 200
    js, ts, f_feat, f_grad, f_prod = _state(nb, k, seed=10 + nb)
    feats, grads = _batch(b, f_feat, f_grad, seed=20 + nb)
    jcfg, tcfg = _cfgs(k, f_prod, whiten)
    key = jax.random.PRNGKey(nb)
    want = jcb.kmeanspp_init(key, js, jnp.asarray(feats), jnp.asarray(grads),
                             jcfg)
    # the reference's draws, as kmeanspp_init makes them
    kidx, knoise = jax.random.split(key)
    f_blk = ts.f_blk
    rows = np.array(jax.random.randint(kidx, (nb, k), 0, b))
    noise = np.array(jax.random.normal(knoise, (nb, k, f_blk),
                                         jnp.float32))
    v = tcb._concat_rows(ts, torch.from_numpy(feats), torch.from_numpy(grads))
    got = tcb._kmeanspp_seed(ts, v, torch.from_numpy(rows),
                             torch.from_numpy(noise), tcfg)
    for name in ("codewords_w", "cluster_sum", "mean", "var"):
        assert_allclose(getattr(got, name).numpy(),
                        np.asarray(getattr(want, name)), **RTOL, err_msg=name)
    assert torch.equal(got.cluster_size, torch.ones_like(ts.cluster_size))
    assert int(got.step) == int(want.step) == 3


def test_kmeanspp_init_draws_rows_in_range():
    """The public function draws from its generator: rows in [0, b) and
    jitter, then the deterministic part on them."""
    k, b = 64, 50
    _, ts, f_feat, f_grad, f_prod = _state(4, k, seed=7)
    feats, grads = _batch(b, f_feat, f_grad, seed=8)
    cfg = tcb.CodebookConfig(k=k, f_prod=f_prod)
    got = tcb.kmeanspp_init(ts, torch.from_numpy(feats),
                            torch.from_numpy(grads), cfg,
                            generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    rows = torch.randint(0, b, (4, k), generator=gen)
    noise = torch.randn((4, k, ts.f_blk), generator=gen)
    assert int(rows.min()) >= 0 and int(rows.max()) < b
    v = tcb._concat_rows(ts, torch.from_numpy(feats), torch.from_numpy(grads))
    want = tcb._kmeanspp_seed(ts, v, rows, noise, cfg)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    # every seed is its drawn row of the whitened batch plus the jitter
    vw = tcb._whiten(v, got.mean[:, None, :], got.var[:, None, :], cfg.eps)
    beta = torch.arange(4)[:, None]
    assert torch.equal(got.codewords_w, vw[beta, rows] + 0.01 * noise)


# ---------------------------------------------------------------------------
# relative_error and the bounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [1, 4, 32])
def test_relative_error_matches_reference(nb):
    k, b = 64, 257
    js, ts, f_feat, f_grad, f_prod = _state(nb, k, seed=30 + nb)
    feats, grads = _batch(b, f_feat, f_grad, seed=40 + nb)
    jcfg, tcfg = _cfgs(k, f_prod, True)
    a = np.random.default_rng(nb).integers(0, k, (nb, b)).astype(np.int32)
    want = jcb.relative_error(js, jnp.asarray(feats), jnp.asarray(grads),
                              jnp.asarray(a), f_feat, jcfg)
    got = tcb.relative_error(ts, torch.from_numpy(feats),
                             torch.from_numpy(grads), torch.from_numpy(a),
                             f_feat, tcfg)
    assert_allclose(float(got), float(want), **RTOL)


def test_bounds_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 16)).astype(np.float32)
    xr = (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    w = rng.normal(size=(8, 4, 6)).astype(np.float32)
    a = rng.normal(size=(12,)).astype(np.float32)
    tx, txr = torch.from_numpy(x), torch.from_numpy(xr)
    pairs = [
        (tb.fro(tx), jb.fro(jnp.asarray(x))),
        (tb.vq_relative_error(tx, txr),
         jb.vq_relative_error(jnp.asarray(x), jnp.asarray(xr))),
        (tb.vq_relative_error(torch.zeros(3, 2), torch.ones(3, 2)),
         jb.vq_relative_error(jnp.zeros((3, 2)), jnp.ones((3, 2)))),
        (tb.gat_h_lipschitz(torch.from_numpy(w), torch.from_numpy(a)),
         jb.gat_h_lipschitz(jnp.asarray(w), jnp.asarray(a))),
        (tb.gat_h_lipschitz(torch.from_numpy(w[0]), torch.from_numpy(a),
                            0.3, 2.0),
         jb.gat_h_lipschitz(jnp.asarray(w[0]), jnp.asarray(a), 0.3, 2.0))]
    eps, c, xf, wf = 0.125, 3.5, 11.0, 0.75
    for lip in ({}, dict(lip_h=0.5)):
        pairs.append((tb.feature_error_bound(eps, c, xf, wf, 1.5, **lip),
                      jb.feature_error_bound(eps, c, xf, wf, 1.5, **lip)))
        pairs.append((tb.gradient_error_bound(eps, c, xf, wf, 2.0, **lip),
                      jb.gradient_error_bound(eps, c, xf, wf, 2.0, **lip)))
    for got, want in pairs:
        assert_allclose(float(got), float(want), **RTOL)
    for slope in (0.2, 1.0, 3.0):
        assert tb.lipschitz_leaky_relu(slope) == jb.lipschitz_leaky_relu(slope)


def _cluster_recon(x: torch.Tensor, assign: torch.Tensor, k: int):
    """Each row replaced by its cluster's mean (the codebook of a converged
    k-means on these rows)."""
    onehot = torch.nn.functional.one_hot(assign, k).float()
    cw = (onehot.t() @ x) / torch.clamp(onehot.sum(0)[:, None], min=1e-9)
    return cw[assign]


@settings(max_examples=10, deadline=None)
@given(n=st.integers(8, 40), f=st.sampled_from([4, 8, 16]),
       k=st.integers(2, 8), seed=st.integers(0, 1000))
def test_theorem2_and_corollary3_hold_on_the_port(n, f, k, seed):
    """Theorem 2: ||C X^ W - C X W||_F <= eps ||C|| ||X|| ||W|| for a
    fixed convolution (Lip(h) = 0, identity activation); Corollary 3 the
    same for the backward messages C^T G W^T with the gradients' eps."""
    gen = torch.Generator().manual_seed(seed)
    c = torch.randn((n, n), generator=gen) / np.sqrt(n)
    x = torch.randn((n, f), generator=gen)
    g = torch.randn((n, f), generator=gen)
    w = torch.randn((f, f), generator=gen) / np.sqrt(f)
    assign = torch.randint(0, k, (n,), generator=gen)
    x_hat = _cluster_recon(x, assign, k)
    g_hat = _cluster_recon(g, assign, k)
    eps = tb.vq_relative_error(x, x_hat)
    lhs = tb.fro(c @ x_hat @ w - c @ x @ w)
    rhs = tb.feature_error_bound(eps, tb.fro(c), tb.fro(x), tb.fro(w))
    assert float(lhs) <= float(rhs) * (1 + 1e-5)
    eps_g = tb.vq_relative_error(g, g_hat)
    lhs_g = tb.fro(c.t() @ g_hat @ w.t() - c.t() @ g @ w.t())
    rhs_g = tb.gradient_error_bound(eps_g, tb.fro(c), tb.fro(g), tb.fro(w))
    assert float(lhs_g) <= float(rhs_g) * (1 + 1e-5)


# ---------------------------------------------------------------------------
# the sketch form and the package's exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,b,k,fb", [(1, 5, 3, 7), (4, 33, 16, 4),
                                       (32, 64, 64, 4)])
def test_context_messages_sketch_matches_reference(nb, b, k, fb):
    rng = np.random.default_rng(nb * b)
    sk = rng.normal(size=(nb, b, k)).astype(np.float32)
    cw = rng.normal(size=(nb, k, fb)).astype(np.float32)
    want = np.asarray(jmp.context_messages_sketch(jnp.asarray(sk),
                                                  jnp.asarray(cw)))
    tcw = torch.from_numpy(cw).requires_grad_(True)
    got = tmp.context_messages_sketch(torch.from_numpy(sk), tcw)
    assert got.shape == (b, nb * fb) and not got.requires_grad
    # rtol 1e-6, plus what summing the k products in another order may move
    # a sum: 2 k 2^-24 sum |term|
    terms = np.einsum("nbk,nkf->bnf", np.abs(sk), np.abs(cw)).reshape(b, -1)
    err = np.abs(got.numpy() - want)
    assert np.all(err <= 1e-6 * np.abs(want) + 2 * k * 2.0 ** -24 * terms)


def test_core_reexports_the_references_names():
    names = [n for n in dir(jcore) if not n.startswith("_")
             and not isinstance(getattr(jcore, n), type(jcore))]
    assert sorted(names) == sorted(tcore.__all__)
    for name in names:
        assert callable(getattr(tcore, name)), name


# ---------------------------------------------------------------------------
# the weight quantizer
# ---------------------------------------------------------------------------

QDTYPES = [(jnp.int8, torch.int8), (jnp.float8_e4m3fn, torch.float8_e4m3fn)]


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("jdt,tdt", QDTYPES)
@pytest.mark.parametrize("shape", [(7,), (16, 24), (3, 8, 5), (2, 1, 4, 9)])
def test_quantize_tensor_byte_equal(jdt, tdt, shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    w = (rng.normal(size=shape) * rng.uniform(0.01, 20, shape[-1])
         ).astype(np.float32)
    w.reshape(-1, shape[-1])[:, 0] = 0.0         # an all-zero channel
    want = jq.quantize_tensor(jnp.asarray(w), jdt)
    got = tq.quantize_tensor(torch.from_numpy(w), tdt)
    assert got.q.dtype == tdt
    assert np.array_equal(_bytes(got.q), _bytes(want.q))
    assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))
    for dt_j, dt_t in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)):
        back_j = jq.dequantize_tensor(want, dt_j)
        back_t = tq.dequantize_tensor(got, dt_t)
        assert back_t.dtype == dt_t
        assert np.array_equal(_bytes(back_t), _bytes(back_j))


def _tree(rng):
    def f32(*s):
        return rng.normal(size=s).astype(np.float32)
    # keys in sorted order: the order jax flattens a dict in
    return {"bf": f32(5, 2),
            "embed": (f32(10, 4), np.arange(12, dtype=np.int32).reshape(3, 4)),
            "layers": [{"b": f32(6), "w": f32(8, 6)},
                       {"norm": f32(3), "w": f32(6, 3)}]}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def test_quantize_tree_byte_equal():
    """int8 (the reference's only tree tier) byte-equal, leaf for leaf:
    weights (>= 2-D, f32 or bf16) quantized, others untouched; fp8 trees
    leaf-equal to ``quantize_tensor``; QTensor leaves kept whole; the
    dequantized trees equal."""
    np_tree = _tree(np.random.default_rng(0))
    j_tree = _map(np_tree, jnp.asarray)
    t_tree = _map(np_tree, torch.from_numpy)
    t_tree["bf"] = t_tree["bf"].to(torch.bfloat16)
    j_tree["bf"] = j_tree["bf"].astype(jnp.bfloat16)
    want = jq.quantize_tree(j_tree)
    got = tq.quantize_tree(t_tree)
    jl = jax.tree_util.tree_leaves(want)
    tl = []

    def collect(t):
        if isinstance(t, tq.QTensor):
            tl.extend([t.q, t.scale])
        else:
            tl.append(t)
        return t
    tq._tree_map(collect, got)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert np.array_equal(_bytes(a), _bytes(b))
    assert isinstance(got["layers"][0]["w"], tq.QTensor)
    assert isinstance(got["embed"], tuple)
    assert torch.equal(got["layers"][0]["b"], t_tree["layers"][0]["b"])
    assert torch.equal(got["embed"][1], t_tree["embed"][1])
    # QTensor leaves stay whole when the tree is quantized again
    again = tq.quantize_tree(got)
    assert again["layers"][0]["w"] is got["layers"][0]["w"]
    fp8 = tq.quantize_tree(t_tree, torch.float8_e4m3fn)
    ref8 = tq.quantize_tensor(t_tree["embed"][0], torch.float8_e4m3fn)
    assert np.array_equal(_bytes(fp8["embed"][0].q), _bytes(ref8.q))
    dj = jax.tree_util.tree_leaves(jq.dequantize_tree(want))
    dt = []
    tq._tree_map(lambda t: dt.append(t), tq.dequantize_tree(got))
    for a, b in zip(dt, dj):
        assert np.array_equal(_bytes(a), _bytes(b))
