"""LM training and prefill of the PyTorch port against the JAX reference,
function by function: the token stream, ``gqa_attend`` with its per-chunk
rematerialisation, ``vq_attention_train`` (output, gradients, codebook
masses, the straight-through property), ``embed_lookup``, ``train_loss`` /
``prefill``, remat, ``make_train_step`` (accum 1 and 2) and Adam with
bf16 moments.  The reference's weights and states are carried across with
``repro_torch.convert``; the JAX side runs on its plain CPU path.  The
loop, checkpoints and entry points are ``tests/test_torch_lm_loop.py``;
card runs of the same functions are in ``tests/test_torch_cuda.py``.

Tolerances (f32 unless said):
  * the token stream: array-equal;
  * attention, VQ-Attention and losses: ``rtol=1e-5, atol=1e-6`` (f32
    sums of at most a few thousand products in another order); a model's
    logits and parameter gradients ``rtol=1e-5, atol=1e-5`` (a logit or
    an embedding row sums terms of order 0.1-1, which may cancel to
    1e-2: two layers' rounding then shows at ~2e-6); codebook
    masses exactly equal (the assignment argmin sees the same distances
    up to the last bits);
  * a ``make_train_step`` step: loss, gradient norm and moments
    ``rtol=1e-5, atol=1e-6``; params ``rtol=1e-5, atol=1e-6`` (at step 1
    Adam moves every param by lr_t * sign(g), so only a gradient within
    rounding of 0 could move a param the other way; none does here);
  * ``embed_lookup``: rows bit-equal; its bf16 gradient within one bf16
    ulp of the exact (float64) sum, and within the reference's own bf16
    accumulation bound of the reference's (the reference sums each
    512-token chunk of the one-hot product in bf16: at 1,024 tokens over
    48 rows its gradient is up to 87 ulps from the exact sum, the port's
    within half an ulp);
  * Adam with bf16 moments and no clipping: params and moments
    bit-equal; with clipping (the global norm summed in another order)
    within one bf16 ulp;
  * remat off, per layer and grouped: bit-equal to each other.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.configs import registry as jreg                   # noqa: E402
from repro.data import tokens as jtok                        # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.nn import attention as jattn                      # noqa: E402
from repro.nn import vq_attention as jvq                     # noqa: E402
from repro.train import loop as jloop                        # noqa: E402
from repro.train import optimizer as jopt                    # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.configs import registry as treg             # noqa: E402
from repro_torch.data import tokens as ttok                  # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.nn import attention as tattn                # noqa: E402
from repro_torch.nn import vq_attention as tvq               # noqa: E402
from repro_torch.train import checkpoint as tckpt            # noqa: E402
from repro_torch.train import loop as tloop                  # noqa: E402
from repro_torch.train import optimizer as topt              # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_U = 2.0 ** -8                 # bf16 unit roundoff


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread: these small shapes run
    many times slower on a thread pool that shares the cores with other
    test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _leaves_close(port, ref, tol, what):
    pl = topt.tree_leaves(port)
    rl = jax.tree_util.tree_leaves(ref)
    # the port's dicts keep insertion order, jax sorts their keys: compare
    # by checkpoint path
    pk = dict(tckpt._paths(port))
    rk = {"/".join(str(p) for p in path): leaf for path, leaf in
          jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert len(pl) == len(rl) and set(pk) == set(rk), what
    for key, leaf in pk.items():
        assert_allclose(_np(leaf), np.asarray(rk[key]).astype(np.float32),
                        err_msg=f"{what} {key}", **tol)


def _llama(vq: bool = False, **kw):
    """The llama smoke (d 48, 6 heads, 2 kv heads, hd 8, vocab 256) in
    f32, VQ-Attention at k 16, window 8 when ``vq``."""
    jc = jreg.get_smoke("llama3.2-3b")
    tc = treg.get_smoke("llama3.2-3b")
    if vq:
        jc, tc = jc.with_vq(k=16, window=8), tc.with_vq(k=16, window=8)
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's llama smoke weights (f32), shared by the cases."""
    jc, _ = _llama()
    return _init(jax.random.PRNGKey(3), jc)


def _init(key, cfg):
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(jlm.init_lm, static_argnums=1)(key, cfg))


def _vjp(fn, *args):
    """``fn(*args)`` and its VJP with a cotangent, through one jit."""
    def run(ct, *a):
        o, vjp = jax.vjp(fn, *a)
        return o, vjp(ct)
    return lambda ct: jax.jit(run)(ct, *args)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (7, 1, 2),
                                                 (13, 3, 4), (2, 0, 8)])
def test_token_stream_array_equal(step, shard, n_shards):
    for vocab, seq, batch, seed in [(97, 33, 8, 3), (256, 65, 8, 0)]:
        jc = jtok.TokenStreamConfig(vocab, seq, batch, seed)
        tc = ttok.TokenStreamConfig(vocab, seq, batch, seed)
        a = jtok.batch_shard(jc, step, shard, n_shards)
        b = ttok.batch_shard(tc, step, shard, n_shards)
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    js, ts = jtok.stream(jc, 5, 1, 2), ttok.stream(tc, 5, 1, 2)
    for _ in range(3):
        (sa, a), (sb, b) = next(js), next(ts)
        assert sa == sb and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# gqa_attend: forward, gradients, per-chunk rematerialisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [512, 2048])
def test_gqa_attend_forward_and_grads_match_reference(s):
    rng = np.random.default_rng(s)
    q = rng.normal(size=(1, s, 2, 8)).astype(np.float32)
    k, v = (rng.normal(size=(1, s, 1, 8)).astype(np.float32)
            for _ in range(2))
    ct = rng.normal(size=q.shape).astype(np.float32)
    o, grads = _vjp(lambda a, b, c: jattn.gqa_attend(a, b, c, causal=True),
                    q, k, v)(ct)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        to = tattn.gqa_attend(tq, tk, tv, causal=True)
    to.backward(_t(ct))
    assert_allclose(_np(to), np.asarray(o), **TOL)
    for got, want in zip((tq, tk, tv), grads):
        assert_allclose(_np(got.grad), np.asarray(want), **TOL)
    # chunked under grad: no [1024, skv] score block is stored
    if s > tattn._Q_CHUNK:
        assert max(saved) < 2 * tattn._Q_CHUNK * s, max(saved)


# ---------------------------------------------------------------------------
# vq_attention_train
# ---------------------------------------------------------------------------

def _ref_counts(k, cfg):
    """The reference's cluster masses at the end of a sequence, from its
    own ``_assign`` / ``_centroids`` composed as its fold composes them
    (``vq_attention_train`` returns only the output): block i folds block
    i - 1, seeding slots (argmin(count) + arange(W)) % k while a head's
    counts are all 0."""
    b, s, hkv, dh = k.shape
    w = min(cfg.window, s)
    kb = jnp.asarray(k).transpose(0, 2, 1, 3)
    sk = jnp.zeros((b, hkv, cfg.k, dh))
    ct = jnp.zeros((b, hkv, cfg.k))
    for i in range(1, s // w):
        pk = kb[:, :, (i - 1) * w:i * w]
        seed = (jnp.argmin(ct, -1)[..., None] + jnp.arange(w)) % cfg.k
        live = ct.max(-1, keepdims=True) > 0
        a = jnp.where(live, jvq._assign(pk, jvq._centroids(sk, sk, ct)[0],
                                        ct), seed)
        oh = jax.nn.one_hot(a, cfg.k)
        sk = sk + jnp.einsum('bhwk,bhwd->bhkd', oh, pk)
        ct = ct + oh.sum(2)
    return np.asarray(ct)


@pytest.mark.parametrize("kcb,w,nblk", [(4, 8, 1), (4, 8, 4), (16, 4, 2),
                                        (16, 4, 4)])
def test_vq_attention_train_matches_reference(kcb, w, nblk):
    """k < W and k > W at 1, 2 and 4 windows, B x Hkv = 4 (every head
    seeds on its own): output, q / k / v gradients, masses."""
    rng = np.random.default_rng(kcb * 10 + nblk)
    b, hq, hkv, dh, s = 2, 4, 2, 8, w * nblk
    q = rng.normal(size=(b, s, hq, dh)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
            for _ in range(2))
    ct = rng.normal(size=q.shape).astype(np.float32)
    jc = jvq.VQAttnConfig(k=kcb, window=w)
    o, grads = _vjp(lambda a, bb, c: jvq.vq_attention_train(a, bb, c, jc),
                    q, k, v)(ct)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    to, count = tvq.train_blocks(tq, tk, tv, tvq.VQAttnConfig(k=kcb,
                                                              window=w))
    to.backward(_t(ct))
    assert_allclose(_np(to), np.asarray(o), **TOL)
    for name, got, want in zip("qkv", (tq, tk, tv), grads):
        assert_allclose(_np(got.grad), np.asarray(want), err_msg=name,
                        **TOL)
    want_count = _ref_counts(k, jc)
    assert np.array_equal(_np(count), want_count)
    live = (want_count > 0).sum(-1)
    # one fold seeds min(W, k) slots; after it no dead codeword is chosen
    assert (live == (0 if nblk == 1 else min(w, kcb))).all(), live
    assert (_np(count).sum(-1) == w * (nblk - 1)).all()


def test_vq_attention_train_k_above_window_keeps_w_codewords_alive():
    """The reference behaviour ROADMAP queue 3 records: with k > W only W
    codewords of a head ever come alive, however long the sequence."""
    rng = np.random.default_rng(5)
    k = rng.normal(size=(2, 64, 2, 8)).astype(np.float32)
    jc = jvq.VQAttnConfig(k=32, window=4)
    want = _ref_counts(k, jc)
    _, count = tvq.train_blocks(_t(k).repeat(1, 1, 2, 1), _t(k), _t(k),
                                tvq.VQAttnConfig(k=32, window=4))
    assert np.array_equal(_np(count), want)
    assert ((want > 0).sum(-1) == 4).all() and want.sum(-1).max() == 60


def test_vq_attention_train_is_differentiable_through_codebook():
    """Twin of the reference's test: a loss on the last block only
    reaches the first tokens' k / v through the centroids."""
    rng = np.random.default_rng(7)
    q = _t(rng.normal(size=(2, 64, 4, 16)).astype(np.float32))
    k, v = (_t(rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
               ).requires_grad_() for _ in range(2))
    o = tvq.vq_attention_train(q, k, v, tvq.VQAttnConfig(k=8, window=8))
    torch.sum(o[:, -8:] ** 2).backward()
    assert float(k.grad[:, :16].abs().sum()) > 0
    assert float(v.grad[:, :16].abs().sum()) > 0


# ---------------------------------------------------------------------------
# the model: embed_lookup, train_loss, prefill, remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1024, 100])
def test_embed_lookup_rows_and_bf16_gradient(s):
    """vocab 8192: the chunked one-hot branch (S % 512 == 0) and the
    whole-sequence one (module docstring for the tolerances)."""
    rng = np.random.default_rng(s)
    vocab, d = 8192, 16
    emb = (0.02 * rng.normal(size=(vocab, d))).astype(ml_dtypes.bfloat16)
    tok = rng.integers(0, 48, (2, s)).astype(np.int32)   # many repeats
    ct = rng.normal(size=(2, s, d)).astype(ml_dtypes.bfloat16)
    o, (g_ref,) = _vjp(lambda e: jlm.embed_lookup(e, tok, vocab),
                       jnp.asarray(emb))(jnp.asarray(ct))
    te = _t(emb).requires_grad_()
    to = tlm.embed_lookup(te, _t(tok), vocab)
    to.backward(_t(ct))
    assert to.dtype == torch.bfloat16
    assert np.array_equal(_np(to), np.asarray(o).astype(np.float32))
    g_ref = np.asarray(g_ref).astype(np.float64)
    g = _np(te.grad).astype(np.float64)
    c64 = ct.astype(np.float64).reshape(-1, d)
    exact = np.zeros((vocab, d))
    np.add.at(exact, tok.reshape(-1), c64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(exact), 2.0 ** -40)))
                  - 7)
    assert (np.abs(g - exact) <= ulp).all()
    n = np.bincount(tok.reshape(-1), minlength=vocab)[:, None]
    mass = np.zeros((vocab, d))
    np.add.at(mass, tok.reshape(-1), np.abs(c64))
    bound = n * BF16_U * mass + ulp
    assert (np.abs(g_ref - exact) <= bound).all()
    assert (np.abs(g - g_ref) <= bound + ulp).all()


def _loss_grad(params, tok, cfg):
    return jax.jit(jax.value_and_grad(jlm.train_loss),
                   static_argnums=2)(params, tok, cfg)


@pytest.mark.parametrize("vq", [False, True])
def test_train_loss_and_prefill_match_reference(vq, ref_params):
    jc, tc = _llama(vq)
    tok = _tokens(jc.vocab, 2, 33)                 # S 32: 4 VQ windows
    loss, grads = _loss_grad(ref_params, tok, jc)
    params = convert.lm_params_from_numpy(ref_params, "cpu")
    tloss, tgrads = tloop.loss_and_grads(params, _t(tok), tc)
    assert_allclose(float(tloss), float(loss), **TOL)
    _leaves_close(tgrads, grads, MODEL_TOL, "grad")
    want = jax.jit(jlm.prefill, static_argnums=2)(ref_params, tok[:, :32],
                                                  jc)
    with torch.no_grad():
        got = tlm.prefill(params, _t(tok[:, :32]), tc)
    assert got.shape == (2, jc.vocab)
    assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)


def test_remat_variants_agree():
    """remat off, per layer, and grouped (2 groups of 2 layers, the
    reference's nested checkpoint) at 4 layers with VQ-Attention: the
    same loss and gradients bit for bit (the no-remat path is held to the
    reference by the train_loss test)."""
    _, tc = _llama(True, n_layers=4)
    params = tlm.init_lm(tc, torch.Generator().manual_seed(4), device="cpu")
    tok = _t(_tokens(tc.vocab, 2, 33, seed=1))
    out = []
    for remat, group in [(False, 0), (True, 0), (True, 2)]:
        _, cfg = _llama(True, n_layers=4, remat=remat, remat_group=group)
        out.append(tloop.loss_and_grads(params, tok, cfg))
    for l, g in out[1:]:
        assert torch.equal(l, out[0][0])
        for a, b in zip(topt.tree_leaves(g), topt.tree_leaves(out[0][1])):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# optimizer and train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [None, 1e-3])
def test_adam_bf16_moments_match_reference(clip):
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 40, 7), "b": (33,)}
    bf = ml_dtypes.bfloat16
    p = {n: rng.normal(size=s).astype(bf) for n, s in shapes.items()}
    gs = [{n: (1e-2 * rng.normal(size=s)).astype(bf)
           for n, s in shapes.items()} for _ in range(3)]
    jo = jopt.adam(jopt.warmup_cosine(1e-2, 2, 10), clip_norm=clip,
                   moment_dtype=jnp.bfloat16)
    to = topt.adam(topt.warmup_cosine(1e-2, 2, 10), clip_norm=clip,
                   moment_dtype=torch.bfloat16)
    jp, js = p, jo.init(p)
    tp = {n: _t(a) for n, a in p.items()}
    ts = to.init(tp)
    assert ts.mu["a"].dtype == torch.bfloat16
    for g in gs:
        jp, js = jo.update(g, js, jp)
        tp, ts = to.update({n: _t(a) for n, a in g.items()}, ts, tp)
    for name in shapes:
        for got, want in [(tp[name], jp[name]), (ts.mu[name], js.mu[name]),
                          (ts.nu[name], js.nu[name])]:
            assert got.dtype == torch.bfloat16
            w = np.asarray(want).astype(np.float32)
            if clip is None:
                assert np.array_equal(_np(got), w), name
            else:
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w),
                                                          1e-30))) - 7)
                assert (np.abs(_np(got) - w) <= ulp).all(), name
    assert int(ts.step) == 3


def _ref_state(params, opt):
    return jloop.TrainState(params, opt.init(params),
                            jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_matches_reference(accum, ref_params):
    """One step of each package from the same state: accum 2 splits the
    batch of 4 into the reference's strided microbatches."""
    jc, tc = _llama(True)
    jo = jopt.adam(jopt.warmup_cosine(1e-3, 2, 20), clip_norm=1.0)
    to = topt.adam(topt.warmup_cosine(1e-3, 2, 20), clip_norm=1.0)
    state = _ref_state(ref_params, jo)
    tok = _tokens(jc.vocab, 4, 33, seed=2)
    jstate, jm = jax.jit(jloop.make_train_step(jc, jo, accum))(state, tok)
    tstate, tm = tloop.make_train_step(tc, to, accum)(
        convert.train_state_from_numpy(state, "cpu"), _t(tok))
    assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **TOL)
    _leaves_close(tstate, jstate, TOL, f"accum {accum}")
    assert int(tstate.step) == 1 and int(tstate.opt.step) == 1
    if accum == 2:        # not the contiguous halves
        whole = tloop.make_train_step(tc, to, 1)(
            convert.train_state_from_numpy(state, "cpu"),
            _t(np.concatenate([tok[0::2], tok[1::2]])))[1]["loss"]
        assert_allclose(float(whole), float(tm["loss"]), rtol=1e-6)


def test_train_state_from_numpy_keeps_moment_dtype():
    jc, _ = _llama()
    jc = dataclasses.replace(jc, dtype="bfloat16")
    p = _init(jax.random.PRNGKey(0), jc)
    opt = jopt.adam(1e-3, moment_dtype=jnp.bfloat16)
    st = convert.train_state_from_numpy(_ref_state(p, opt), "cpu")
    assert st.params["blocks"]["attn"].wq.dtype == torch.bfloat16
    assert st.opt.mu["embed"].dtype == torch.bfloat16
    assert st.opt.step.dtype == st.step.dtype == torch.int32
