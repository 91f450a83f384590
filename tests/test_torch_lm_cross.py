"""The cross-attention LM families of the PyTorch port against the JAX
reference: whisper-tiny's encoder-decoder (audio) and
llama-3.2-vision-11b's gated image layers (vlm), at their smoke widths.

Covered: ``init_lm`` and ``init_serve_cache`` trees (names, shapes,
per-leaf dtypes, f32 and bf16), ``forward_train`` / ``train_loss`` /
gradients with the stub context (remat off and on; exact and
VQ-Attention), ``prefill`` with ``aux_embeds``, 24 teacher-forced
``serve_step``s (exact and VQ, f32 and bf16), one ``make_train_step``
with ``accum`` 2 whose microbatches split ``aux_embeds`` as the
reference's do, checkpoints written by each package and restored by the
other, both launchers, and a negative control.  The reference's weights
cross with ``repro_torch.convert``; its side runs on its plain CPU path.

At init every vlm ``gate`` is 0 (tanh(0) = 0) and a fresh cache's
``cross_k`` / ``cross_v`` are zeros, so a decode would see no cross
output at all and a port with a wrong cross path would pass.  Every
numerical test here therefore sets each gate to a nonzero value and fills
the cross caches from a seeded generator, the same arrays on both sides;
the negative control shows that a port whose gate is forced to 0, or
whose cross-attention reads another layer's keys and values, fails the
decode comparison.

Tolerances:
  * f32 losses ``rtol=1e-5, atol=1e-6``; hidden states, prefill logits and
    parameter gradients ``rtol=1e-5, atol=1e-5``
    (``tests/test_torch_lm_train.py``: f32 sums in another order);
  * f32 ``serve_step`` logits over 24 steps ``rtol=1e-4, atol=1e-4``,
    codebook counts equal at every step (``tests/test_torch_lm.py``);
  * bf16 ``serve_step`` logits (exact cache) within 6 bf16 ulps of the
    largest |logit| (``tests/test_torch_lm.py``: XLA rounds once per
    fusion, eager PyTorch after every op);
  * a ``make_train_step`` step (Adam, f32): loss, gradient norm and
    moments ``rtol=1e-5, atol=1e-6``; params the same where the gradient
    is at least 1e-6, and within Adam's step bound 2 lr_1 where it is
    smaller (step 1 moves an element by lr_1 g / (|g| + eps): near eps a
    gradient's rounding moves it by up to lr_1);
  * trees, converters and checkpoints: shapes, dtypes and every leaf
    equal.
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
from repro.models import lm as jlm                           # noqa: E402
from repro.train import checkpoint as jckpt                  # noqa: E402
from repro.train import loop as jloop                        # noqa: E402
from repro.train import optimizer as jopt                    # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.configs import registry as treg             # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.nn.attention import AttnParams              # noqa: E402
from repro_torch.train import checkpoint as tckpt            # noqa: E402
from repro_torch.train import loop as tloop                  # noqa: E402
from repro_torch.train import optimizer as topt              # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
ARCHS = ["whisper-tiny", "llama-3.2-vision-11b"]
DECODE_STEPS = 24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread (small shapes, shared
    cores)."""
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


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_paths(tree) -> dict:
    return {"/".join(str(p) for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaves_close(port, ref, tol, what):
    """Every leaf of two trees, matched by checkpoint path."""
    pk, rk = dict(tckpt._paths(port)), _ref_paths(ref)
    assert set(pk) == set(rk), what
    for key, leaf in pk.items():
        assert_allclose(_np(leaf), np.asarray(rk[key]).astype(np.float32),
                        err_msg=f"{what} {key}", **tol)


def _cfgs(arch: str, vq: bool = False, **kw):
    jc, tc = jreg.get_smoke(arch), treg.get_smoke(arch)
    if vq:
        jc, tc = jc.with_vq(k=4, window=8), tc.with_vq(k=4, window=8)
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _ctx_len(cfg) -> int:
    return cfg.enc_seq if cfg.family == "audio" else cfg.n_patches


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _aux(cfg, b, seed=0):
    """The stub context (f32): [B, enc_seq, d] frames or [B, n_patches,
    d] patches."""
    return np.random.default_rng(seed).normal(
        size=(b, _ctx_len(cfg), cfg.d_model)).astype(np.float32)


def _gated(params, seed=1):
    """The vlm's gates set to nonzero values (0 at init), one a cross
    block; the audio tree has none."""
    if "cross_blocks" not in params:
        return params
    cb = dict(params["cross_blocks"])
    g = cb["gate"]
    cb["gate"] = np.random.default_rng(seed).uniform(
        0.4, 1.2, size=g.shape).astype(g.dtype)
    return dict(params, cross_blocks=cb)


class _Ref:
    """The reference's smoke weights and jitted functions, each made once
    for the module (its compilations take most of the file's time)."""

    def __init__(self):
        self._memo = {}

    def _get(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def params(self, arch: str, dtype: str = "float32"):
        """The f32 smoke weights (every vlm gate nonzero); bf16: the same
        weights rounded, the tree of a bf16 ``init_lm`` (these families
        keep no f32 leaf in a bf16 model)."""
        jc = _cfgs(arch)[0]
        p = _gated(self._get(("init", jc), lambda: _numpy(jax.jit(
            jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(5), jc))))
        if dtype == "float32":
            return p
        return jax.tree_util.tree_map(
            lambda a: a.astype(ml_dtypes.bfloat16), p)

    def loss_grad(self, cfg):
        return self._get(("loss_grad", cfg), lambda: jax.jit(
            jax.value_and_grad(jlm.train_loss), static_argnums=2))

    def serve(self, cfg):
        return self._get(("serve", cfg), lambda: jax.jit(
            lambda p, t, c: jlm.serve_step(p, t, c, cfg)))


@pytest.fixture(scope="module")
def ref() -> _Ref:
    return _Ref()


def _filled_cache(jc, batch, context, seed=3):
    """The reference's fresh cache with ``cross_k`` / ``cross_v`` drawn
    from a seeded generator (numpy leaves)."""
    cache = _numpy(jlm.init_serve_cache(jc, batch, context))
    rng = np.random.default_rng(seed)
    for name in ("cross_k", "cross_v"):
        a = cache[name]
        cache[name] = rng.normal(size=a.shape).astype(np.float32).astype(
            a.dtype)
    return cache


# ---------------------------------------------------------------------------
# trees: params and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_tree_matches_reference(arch, dtype, ref):
    """Names (checkpoint paths), shapes and per-leaf dtypes (the vlm's 0-d
    gates, whisper's ``ln_x`` / ``cross`` / ``enc_ln_f``), the gates 0 at
    init, and the converter's copy of the reference's tree."""
    jc, tc = _cfgs(arch, dtype=dtype)
    want = {k: (tuple(a.shape), a.dtype.name) for k, a in _ref_paths(
        jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jc))
        ).items()}
    p = tlm.init_lm(tc, torch.Generator().manual_seed(0), device=CPU)
    got = {k: (tuple(t.shape), str(t.dtype)[6:])
           for k, t in tckpt._paths(p)}
    assert got == want
    assert abs(float(p["embed"].float().std()) - 0.02) < 0.003
    if tc.family == "vlm":
        cb = p["cross_blocks"]
        assert cb["gate"].shape == (tc.n_layers // tc.cross_attn_period,)
        assert not bool(cb["gate"].any())
        assert isinstance(cb["attn"], AttnParams)
    else:
        assert p["enc_blocks"]["ln1"].shape == (tc.enc_layers, tc.d_model)
        assert isinstance(p["blocks"]["cross"], AttnParams)
        assert torch.equal(p["blocks"]["ln_x"],
                           torch.ones_like(p["blocks"]["ln_x"]))
    conv = convert.lm_params_from_numpy(ref.params(arch, dtype), CPU)
    assert {k: (tuple(t.shape), t.dtype) for k, t in tckpt._paths(conv)} \
        == {k: (tuple(t.shape), t.dtype) for k, t in tckpt._paths(p)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("vq", [False, True])
def test_init_serve_cache_matches_reference(arch, vq):
    """The decode state (the self-attention caches, exact or VQ, and the
    plain-tensor ``cross_k`` / ``cross_v`` of zeros), the converter's
    copy equal, and the serve launcher's byte count the reference's."""
    jc, tc = _cfgs(arch, vq, dtype="bfloat16")
    jcache = _numpy(jlm.init_serve_cache(jc, 2, 16))
    want = {k: (tuple(a.shape), a.dtype.name)
            for k, a in _ref_paths(jcache).items()}
    tcache = tlm.init_serve_cache(tc, 2, 16, device=CPU)
    assert {k: (tuple(t.shape), str(t.dtype)[6:])
            for k, t in tckpt._paths(tcache)} == want
    n = tc.n_layers // tc.cross_attn_period if tc.family == "vlm" \
        else tc.n_layers
    assert tuple(tcache["cross_k"].shape) == (n, 2, _ctx_len(tc),
                                              tc.n_kv_heads, tc.hd)
    conv = convert.serve_cache_from_numpy(jcache, CPU)
    assert isinstance(conv["cross_v"], torch.Tensor)
    for (k, a), (k2, b) in zip(tckpt._paths(conv), tckpt._paths(tcache)):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k
    assert tserve.cache_bytes(tcache) == sum(
        a.nbytes for a in jax.tree_util.tree_leaves(jcache))


# ---------------------------------------------------------------------------
# training forward, loss, gradients, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,vq", [("whisper-tiny", False),
                                     ("whisper-tiny", True),
                                     ("llama-3.2-vision-11b", False)])
def test_train_loss_grads_and_prefill_match_reference(arch, vq, ref):
    """Loss and every parameter's gradient with the stub context (the
    encoder's and the cross blocks' weights reached through it), remat
    off and on; then ``prefill`` with ``aux_embeds``.  The vlm's text
    blocks train VQ-Attention through the dense family's code
    (``tests/test_torch_lm_train.py``); whisper's decoder holds it here."""
    jc, tc = _cfgs(arch, vq)
    jp = ref.params(arch)
    tok, aux = _tokens(jc.vocab, 2, 33, seed=3), _aux(jc, 2, seed=4)
    loss, grads = ref.loss_grad(jc)(jp, tok, jc, aux)
    params = convert.lm_params_from_numpy(jp, CPU)
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat)
        tloss, tgrads = tloop.loss_and_grads(params, _t(tok), cfg, _t(aux))
        assert_allclose(float(tloss), float(loss), **TOL)
        _leaves_close(tgrads, grads, MODEL_TOL, f"{arch} remat {remat}")
    # the cross path is live: its weights get gradients
    gx = tgrads["cross_blocks"]["attn"].wk if tc.family == "vlm" \
        else tgrads["blocks"]["cross"].wk
    assert float(gx.abs().max()) > 0
    want = jax.jit(jlm.prefill, static_argnums=2)(jp, tok[:, :32], jc, aux)
    with torch.no_grad():
        got = tlm.prefill(params, _t(tok[:, :32]), tc, _t(aux))
    assert got.shape == (2, jc.vocab)
    assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_without_aux_embeds_raises(arch):
    """The reference fails with an AttributeError on None; the port names
    the stub input it needs."""
    _, tc = _cfgs(arch)
    p = tlm.init_lm(tc, torch.Generator().manual_seed(0), device=CPU)
    word = "frame" if tc.family == "audio" else "patch"
    with pytest.raises(ValueError, match=f"aux_embeds, the stub {word}"):
        tlm.train_loss(p, _t(_tokens(tc.vocab, 1, 9)), tc)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _decode(ref, arch, vq, dtype="float32", fault=None, batch=3,
            context=40):
    """DECODE_STEPS teacher-forced steps through both packages from the
    same gated params and filled cross caches: the per-step logits of
    both and the two caches.  ``fault`` corrupts the port's side: "gate0"
    forces every gate to 0, "cross_layer" has the second cross layer read
    the first one's keys and values."""
    jc, tc = _cfgs(arch, vq, dtype=dtype)
    jp = ref.params(arch, dtype)
    jcache = _filled_cache(jc, batch, context)
    tp = convert.lm_params_from_numpy(jp, CPU)
    tcache = convert.serve_cache_from_numpy(jcache, CPU)
    if fault == "gate0":
        tp["cross_blocks"]["gate"].zero_()
    elif fault == "cross_layer":
        for name in ("cross_k", "cross_v"):
            tcache[name][1].copy_(tcache[name][0])
    step = ref.serve(jc)
    tokens = np.random.default_rng(12).integers(
        0, jc.vocab, (DECODE_STEPS, batch, 1)).astype(np.int32)
    out = []
    for s in range(DECODE_STEPS):
        jl, jcache = step(jp, tokens[s], jcache)
        tl, tcache = tlm.serve_step(tp, _t(tokens[s]).long(), tcache, tc)
        out.append((np.asarray(jl, np.float32), _np(tl)))
        if vq and dtype == "float32":
            assert np.array_equal(tcache["kv"].count.numpy(),
                                  np.asarray(jcache["kv"].count)), s
    return out, jcache, tcache


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("vq", [False, True])
def test_serve_step_logits_match_reference(arch, vq, ref):
    """24 teacher-forced steps at batch 3 (VQ: past the 8-token window,
    counts equal at every step), nonzero gates, filled cross caches."""
    out, jcache, tcache = _decode(ref, arch, vq)
    for s, (want, got) in enumerate(out):
        assert_allclose(got, want, err_msg=f"step {s}", **STEP_TOL)
    _leaves_close(tcache, jcache, STEP_TOL, f"{arch} cache")
    assert np.array_equal(tcache["kv"].pos.numpy(),
                          np.asarray(jcache["kv"].pos))
    if vq:
        assert np.asarray(jcache["kv"].count).max() > 1


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_logits_match_reference_bf16(arch, ref):
    out, _, tcache = _decode(ref, arch, False, "bfloat16")
    assert tcache["cross_k"].dtype == torch.bfloat16
    for s, (want, got) in enumerate(out):
        assert np.isfinite(got).all()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert_allclose(got, want, rtol=0, atol=6 * ulp, err_msg=f"step {s}")


@pytest.mark.parametrize("arch,fault", [
    ("llama-3.2-vision-11b", "gate0"),
    ("llama-3.2-vision-11b", "cross_layer"),
    ("whisper-tiny", "cross_layer")])
def test_decode_negative_control_fails(arch, fault, ref):
    """A port with its gate forced to 0, or reading another layer's cross
    keys and values, fails the decode test's tolerance."""
    out, _, _ = _decode(ref, arch, False, fault=fault)
    with pytest.raises(AssertionError):
        for s, (want, got) in enumerate(out):
            assert_allclose(got, want, err_msg=f"step {s}", **STEP_TOL)


# ---------------------------------------------------------------------------
# the training step, checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b"])
def test_make_train_step_accum_splits_aux_embeds(arch, ref):
    """One step of each package from the same state at accum 2: the batch
    of 4 and its context split into the reference's strided
    microbatches (rows 0, 2 and rows 1, 3); the loss, gradient norm,
    moments and params."""
    jc, tc = _cfgs(arch)
    jo = jopt.adam(jopt.warmup_cosine(1e-3, 2, 20), clip_norm=1.0)
    to = topt.adam(topt.warmup_cosine(1e-3, 2, 20), clip_norm=1.0)
    jp = ref.params(arch)
    state = jloop.TrainState(jp, _numpy(jo.init(jp)), np.zeros((), np.int32))
    tok, aux = _tokens(jc.vocab, 4, 17, seed=2), _aux(jc, 4, seed=6)
    jstate, jm = jax.jit(jloop.make_train_step(jc, jo, 2))(state, tok, aux)
    step = tloop.make_train_step(tc, to, 2)
    tstate, tm = step(convert.train_state_from_numpy(state, CPU), _t(tok),
                      _t(aux))
    assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **TOL)
    _leaves_close((tstate.opt.mu, tstate.opt.nu),
                  (jstate.opt.mu, jstate.opt.nu), TOL, f"{arch} moments")
    # at step 1 Adam moves an element by lr_1 g / (|g| + eps), which
    # magnifies a gradient's rounding where |g| nears eps: those elements
    # (|g| < 1e-6, read from the reference's first moment, (1 - b1) g) are
    # held to Adam's step bound, the others to TOL
    lr_1 = float(jopt.warmup_cosine(1e-3, 2, 20)(jnp.asarray(1)))
    mu = _ref_paths(jstate.opt.mu)
    want = _ref_paths(jstate.params)
    for key, got in tckpt._paths(tstate.params):
        w = np.asarray(want[key])
        tiny = np.abs(np.asarray(mu[key])) < 1e-7
        d = np.abs(_np(got) - w)
        assert (d[~tiny] <= TOL["atol"] + TOL["rtol"] * np.abs(w[~tiny])
                ).all(), key
        assert (d[tiny] <= 2 * lr_1).all(), key
    assert int(tstate.step) == 1
    # the context follows its sequence: strided, not contiguous, halves
    order = np.array([0, 2, 1, 3])
    whole = tloop.make_train_step(tc, to, 1)(
        convert.train_state_from_numpy(state, CPU), _t(tok[order]),
        _t(aux[order]))[1]["loss"]
    assert_allclose(float(whole), float(tm["loss"]), rtol=1e-6)
    mixed = step(convert.train_state_from_numpy(state, CPU), _t(tok),
                 _t(aux[order]))[1]["loss"]
    assert abs(float(mixed) - float(tm["loss"])) > 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_packages(arch, tmp_path, ref):
    """The reference writes and the port restores, then the other way:
    the gates, the cross blocks, the encoder stack; every leaf equal in
    its own dtype (bf16 params, random bf16 moments)."""
    jc, tc = _cfgs(arch, dtype="bfloat16")
    p = ref.params(arch, "bfloat16")
    rng = np.random.default_rng(8)
    mu = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.normal(size=a.shape)).astype(
            ml_dtypes.bfloat16), p)
    ref = jloop.TrainState(p, jopt.OptState(np.asarray(7, np.int32), mu, mu),
                           np.asarray(7, np.int32))
    tp = tlm.init_lm(tc, torch.Generator().manual_seed(8), device=CPU)
    port_like = tloop.TrainState(
        tp, topt.adam(1e-3, moment_dtype=torch.bfloat16).init(tp),
        torch.zeros((), dtype=torch.int32))
    port = convert.train_state_from_numpy(ref, CPU)
    assert list(tckpt._flatten(port)) == list(jckpt._flatten(ref))
    jckpt.save(str(tmp_path / "ref"), 7, ref, {"seed": 0})
    got, manifest = tckpt.restore(str(tmp_path / "ref"), port_like)
    assert manifest == {"step": 7, "seed": 0}
    want = dict(tckpt._paths(port))
    for key, leaf in tckpt._paths(got):
        assert leaf.dtype == want[key].dtype and torch.equal(
            leaf, want[key]), key
    tckpt.save(str(tmp_path / "port"), 8, port, {"seed": 1})
    back, manifest = jckpt.restore(str(tmp_path / "port"), ref)
    assert manifest == {"step": 8, "seed": 1}
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree_util.tree_leaves(ref)):
        assert np.asarray(a).dtype == np.asarray(b).dtype and \
            np.array_equal(np.asarray(a).astype(np.float32),
                           np.asarray(b).astype(np.float32)), path


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_and_refuse_to_train(arch, capsys):
    """The serve launcher decodes both families as the reference's does
    (a fresh cache, zero cross keys and values) and prints its line; the
    train launcher raises the ValueError that names the way these
    families train."""
    name = treg.get_smoke(arch).name
    for vq in (False, True):
        report = tserve.main(["--arch", arch, "--smoke", "--tokens", "4",
                              "--device", "cpu"] + (["--vq"] if vq else []))
        assert report["tokens"] == 4 and report["tok_per_s"] > 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert line.startswith(f"{name} strategy=replicate vq={vq}: ") \
            and "tok/s" in line
        jc = jreg.get_smoke(arch)
        if vq:
            jc = jc.with_vq(k=min(jc.vq_k, 128), window=64)
        assert report["cache_bytes"] == sum(
            a.size * a.dtype.itemsize for a in jax.tree_util.tree_leaves(
                jax.eval_shape(lambda: jlm.init_serve_cache(jc, 4, 1024))))
    with pytest.raises(ValueError, match=r"make_train_step\(\.\.\.\)"):
        tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu"])
