"""The ssm (xlstm) and hybrid (zamba2) families of the PyTorch port
against the JAX reference, and what the moe, ssm and hybrid families
share: ``init_lm`` and ``init_serve_cache`` trees (names, shapes,
per-leaf dtypes), ``forward_train`` / ``train_loss`` / gradients (remat
off and on: a checkpoint per xLSTM pair, per zamba2 group), ``prefill``,
40 teacher-forced ``serve_step``s (exact, and VQ in zamba2's shared
block), one launcher Adam step with bf16 moments on bf16 smokes, the
converters' per-leaf dtypes, checkpoints written by each package and
restored by the other, and both launchers on the CPU.  The reference's
weights cross with ``repro_torch.convert``; its side runs on its plain
CPU path.

Tolerances:
  * f32 model losses ``rtol=1e-5, atol=1e-6``; hidden states, logits and
    parameter gradients ``rtol=1e-5, atol=1e-5``
    (``tests/test_torch_lm_train.py``), zamba2's ``rtol=1e-4, atol=1e-5``
    (its Mamba2 scan adds in another order:
    ``tests/test_torch_lm_recurrent.py``);
  * 40-step ``serve_step`` logits ``rtol=1e-4, atol=1e-4``, codebook
    counts equal at every step (``tests/test_torch_lm.py``);
  * Adam with bf16 moments fed the same gradients: params and moments
    within one bf16 ulp under the launcher's clipping (the global norm
    summed in another order; ``tests/test_torch_lm_train.py``); a whole
    bf16 launcher step: the loss within 1 % (bf16 forwards round per op in
    eager PyTorch and per fusion in XLA), every param within twice the
    step's move plus one bf16 ulp of the reference's (at step 1 Adam
    moves every element by the scheduled lr times the sign of its
    gradient, and a gradient within rounding of 0 may differ in sign);
  * checkpoints: every leaf equal, in its own dtype.
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
from repro_torch.nn import ssm as tssm                       # noqa: E402
from repro_torch.nn import xlstm as tx                       # noqa: E402
from repro_torch.train import checkpoint as tckpt            # noqa: E402
from repro_torch.train import loop as tloop                  # noqa: E402
from repro_torch.train import optimizer as topt              # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
FAMILIES = {"moe": "qwen3-moe-30b-a3b", "ssm": "xlstm-350m",
            "hybrid": "zamba2-2.7b"}
NEW_ARCHS = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b", "xlstm-350m",
             "zamba2-2.7b"]


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


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _init(key, cfg):
    return _numpy(jax.jit(jlm.init_lm, static_argnums=1)(key, cfg))


@pytest.fixture(scope="module")
def ref_params():
    return {arch: _init(jax.random.PRNGKey(5), _cfgs(arch)[0])
            for arch in ("xlstm-350m", "zamba2-2.7b")}


# ---------------------------------------------------------------------------
# trees: params and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_tree_matches_reference(arch, dtype):
    """Names (checkpoint paths), shapes and per-leaf dtypes -- the MoE
    router and the Mamba2 scalars stay f32 in a bf16 model -- and the
    reference's distributions."""
    jc, tc = _cfgs(arch, dtype=dtype)
    want = {k: (tuple(a.shape), a.dtype.name) for k, a in _ref_paths(
        jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jc))
        ).items()}
    p = tlm.init_lm(tc, torch.Generator().manual_seed(0), device=CPU)
    got = {k: (tuple(t.shape), str(t.dtype)[6:])
           for k, t in tckpt._paths(p)}
    assert got == want
    assert abs(float(p["embed"].float().std()) - 0.02) < 0.003
    assert abs(float(p["head"].float().std()) * tc.d_model ** 0.5 - 1) < 0.1
    if tc.family == "hybrid":
        mb = p["mamba"]["mamba"]
        assert mb.a_log.dtype == torch.float32 and mb.a_log.shape[:2] == (
            tc.n_layers // tc.attn_period, tc.attn_period)
        assert torch.equal(mb.dt_bias, torch.full_like(mb.dt_bias, -2.0))
        assert abs(float(mb.conv_w.float().std()) - 0.5) < 0.05
    if tc.family == "ssm":
        sl = p["pairs"]["slstm"]
        assert abs(float(sl.w_h.float().std()) * tc.d_model ** 0.5 - 0.3) \
            < 0.03 and not bool(sl.b.any())


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("vq", [False, True])
def test_init_serve_cache_matches_reference(arch, vq):
    """The decode state's tree, shapes and dtypes (the xLSTM family has
    no attention, so ``vq`` changes nothing there), and the converter's
    copy of the reference's cache, equal."""
    jc, tc = _cfgs(arch, vq, dtype="bfloat16")
    jcache = _numpy(jlm.init_serve_cache(jc, 2, 16))
    want = {k: (tuple(a.shape), a.dtype.name)
            for k, a in _ref_paths(jcache).items()}
    tcache = tlm.init_serve_cache(tc, 2, 16, device=CPU)
    assert {k: (tuple(t.shape), str(t.dtype)[6:])
            for k, t in tckpt._paths(tcache)} == want
    conv = convert.serve_cache_from_numpy(jcache, CPU)
    for (k, a), (k2, b) in zip(tckpt._paths(conv), tckpt._paths(tcache)):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k
    assert tserve.cache_bytes(tcache) == sum(
        a.nbytes for a in jax.tree_util.tree_leaves(jcache))


# ---------------------------------------------------------------------------
# training forward, loss, gradients, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,vq", [("xlstm-350m", False),
                                     ("zamba2-2.7b", True)])
def test_train_loss_grads_and_prefill_match_reference(arch, vq, ref_params):
    jc, tc = _cfgs(arch, vq)
    jp = ref_params[arch]
    tok = _tokens(jc.vocab, 2, 33, seed=3)
    loss, grads = jax.jit(jax.value_and_grad(jlm.train_loss),
                          static_argnums=2)(jp, tok, jc)
    params = convert.lm_params_from_numpy(jp, CPU)
    tol = SCAN_TOL if tc.family == "hybrid" else MODEL_TOL
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat)
        tloss, tgrads = tloop.loss_and_grads(params, _t(tok), cfg)
        assert_allclose(float(tloss), float(loss), **TOL)
        _leaves_close(tgrads, grads, tol, f"{arch} remat {remat}")
    want = jax.jit(jlm.prefill, static_argnums=2)(jp, tok[:, :32], jc)
    with torch.no_grad():
        got = tlm.prefill(params, _t(tok[:, :32]), tc)
    assert got.shape == (2, jc.vocab)
    assert_allclose(_np(got), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,vq", [("xlstm-350m", False),
                                     ("zamba2-2.7b", False),
                                     ("zamba2-2.7b", True)])
def test_serve_step_logits_match_reference(arch, vq, ref_params):
    """40 teacher-forced steps at batch 3: the recurrent states carried,
    zamba2's shared block decoding from one cache a group (VQ: counts
    equal at every step)."""
    jc, tc = _cfgs(arch, vq)
    jp = ref_params[arch]
    tp = convert.lm_params_from_numpy(jp, CPU)
    jcache = jlm.init_serve_cache(jc, 3, 48)
    tcache = tlm.init_serve_cache(tc, 3, 48, device=CPU)
    step = jax.jit(lambda p, t, c: jlm.serve_step(p, t, c, jc))
    tokens = np.random.default_rng(12).integers(
        0, jc.vocab, (40, 3, 1)).astype(np.int32)
    for s in range(40):
        jl, jcache = step(jp, tokens[s], jcache)
        tl, tcache = tlm.serve_step(tp, _t(tokens[s]).long(), tcache, tc)
        assert_allclose(_np(tl), np.asarray(jl), err_msg=f"step {s}",
                        **STEP_TOL)
        if vq:
            assert np.array_equal(tcache["attn"].count.numpy(),
                                  np.asarray(jcache["attn"].count)), s
    _leaves_close(tcache, jcache, STEP_TOL, f"{arch} cache")
    if vq:
        assert np.asarray(jcache["attn"].count).max() > 1


# ---------------------------------------------------------------------------
# the launcher's Adam step with bf16 moments, converters, checkpoints
# ---------------------------------------------------------------------------

def _bf16_cfgs(family: str):
    return _cfgs(FAMILIES[family], dtype="bfloat16")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_launcher_adam_with_bf16_moments_matches_reference(family):
    """The launcher's optimizer (Adam, bf16 moments for every leaf -- the
    f32 router and Mamba2 scalars included -- ``clip_norm=1.0``) on a bf16
    smoke's tree, fed the same gradients (each leaf in its own dtype) for
    one step: params and moments within one bf16 ulp, f32 leaves within
    ``rtol=1e-6``."""
    jc, _ = _bf16_cfgs(family)
    steps, lr = 20, 3e-4
    jo = jopt.adam(jopt.warmup_cosine(lr, 10, steps), clip_norm=1.0,
                   moment_dtype=jnp.bfloat16)
    to = tlaunch.optimizer(lr, steps)
    jp = _init(jax.random.PRNGKey(6), jc)
    rng = np.random.default_rng(7)
    g = jax.tree_util.tree_map(
        lambda a: (1e-2 * rng.normal(size=a.shape)).astype(a.dtype), jp)
    jstate = jloop.TrainState(jp, jo.init(jp), jnp.zeros((), jnp.int32))
    tstate = convert.train_state_from_numpy(_numpy(jstate), CPU)
    for key, m in tckpt._paths(tstate.opt.mu):
        assert m.dtype == torch.bfloat16, key
    jparams, jopt_state = jax.jit(jo.update)(g, jstate.opt, jp)
    tparams, topt_state = to.update(convert.lm_params_from_numpy(g, CPU),
                                    tstate.opt, tstate.params)
    for (key, got), want in zip(
            tckpt._paths((tparams, topt_state.mu, topt_state.nu)),
            jax.tree_util.tree_leaves((jparams, jopt_state.mu,
                                       jopt_state.nu))):
        w = np.asarray(want).astype(np.float32)
        assert str(got.dtype)[6:] == np.asarray(want).dtype.name, key
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        tol = ulp if got.dtype == torch.bfloat16 else 1e-6 * np.abs(w)
        assert (np.abs(_np(got) - w) <= tol).all(), key
    assert int(topt_state.step) == 1


def test_launcher_train_step_bf16_matches_reference():
    """One whole ``make_step`` of each package from the same state, the
    MoE smoke in bf16 with the launcher's optimizer: the loss (aux term
    included) and every param within the bf16 step bound."""
    jc, tc = _bf16_cfgs("moe")
    steps, lr = 20, 3e-4
    jo = jopt.adam(jopt.warmup_cosine(lr, 10, steps), clip_norm=1.0,
                   moment_dtype=jnp.bfloat16)
    to = tlaunch.optimizer(lr, steps)
    jp = _init(jax.random.PRNGKey(6), jc)
    state = jloop.TrainState(jp, jo.init(jp), jnp.zeros((), jnp.int32))
    tstate = convert.train_state_from_numpy(_numpy(state), CPU)
    tok = _tokens(jc.vocab, 2, 17, seed=7)
    jstate, jm = jax.jit(jloop.make_train_step(
        jc, jo, 1, jnp.bfloat16))(state, tok)
    tstate2, tm = tlaunch.make_step(tc, to, 1)(tstate, _t(tok))
    assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-2)
    # at step 1 Adam moves an element by lr_t (1 - b1) / sqrt(1 - b2) =
    # the scheduled lr in the direction of its gradient's sign
    lr_1 = float(jopt.warmup_cosine(lr, 10, steps)(jnp.asarray(1)))
    before = dict(tckpt._paths(tstate.params))
    for (key, got), want in zip(tckpt._paths(tstate2.params),
                                jax.tree_util.tree_leaves(jstate.params)):
        w = np.asarray(want).astype(np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        excess = np.abs(_np(got) - w) - (2 * lr_1 + ulp)
        assert excess.max() <= 0, (key, float(excess.max()))
        assert got.dtype == before[key].dtype, key
    assert int(tstate2.step) == 1 and int(tstate2.opt.step) == 1


def _ref_train_state(family: str, seed: int):
    """A reference TrainState of the family's bf16 smoke with bf16
    moments (random, so a restore that drops a leaf shows), and a port
    state of the same structure to restore into."""
    jc, tc = _bf16_cfgs(family)
    p = _init(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    mu = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.normal(size=a.shape)).astype(
            ml_dtypes.bfloat16), p)
    ref = jloop.TrainState(p, jopt.OptState(np.asarray(7, np.int32), mu, mu),
                           np.asarray(7, np.int32))
    tp = tlm.init_lm(tc, torch.Generator().manual_seed(seed), device=CPU)
    port_like = tloop.TrainState(
        tp, topt.adam(1e-3, moment_dtype=torch.bfloat16).init(tp),
        torch.zeros((), dtype=torch.int32))
    return ref, port_like


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpoints_cross_packages(family, tmp_path):
    """The reference writes and the port restores, then the other way:
    the reference's key layout (zamba2's two-deep ``mamba`` stack, the
    xLSTM pairs, the experts), every leaf equal in its own dtype."""
    ref, port_like = _ref_train_state(family, 8)
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


def test_converters_keep_each_leafs_type_and_dtype():
    jc, _ = _bf16_cfgs("hybrid")
    tp = convert.lm_params_from_numpy(_init(jax.random.PRNGKey(0), jc), CPU)
    mb = tp["mamba"]["mamba"]
    assert isinstance(mb, tssm.Mamba2Params)
    assert mb.in_proj.dtype == torch.bfloat16
    assert mb.a_log.dtype == mb.d_skip.dtype == mb.dt_bias.dtype == \
        torch.float32
    jc, _ = _bf16_cfgs("ssm")
    tp = convert.lm_params_from_numpy(_init(jax.random.PRNGKey(0), jc), CPU)
    assert isinstance(tp["pairs"]["mlstm"], tx.MLSTMParams)
    assert isinstance(tp["pairs"]["slstm"], tx.SLSTMParams)
    cache = convert.serve_cache_from_numpy(
        _numpy(jlm.init_serve_cache(jc, 2, 8)), CPU)
    assert isinstance(cache["mlstm"], tx.MLSTMState)
    assert isinstance(cache["slstm"], tx.SLSTMState)
    moved = convert.to_device(cache, CPU)
    assert isinstance(moved["slstm"], tx.SLSTMState)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-2.7b"])
def test_launchers_serve_and_train_the_recurrent_families(arch, capsys,
                                                          tmp_path):
    name = treg.get_smoke(arch).name
    for vq in (False, True):
        report = tserve.main(["--arch", arch, "--smoke", "--tokens", "4",
                              "--device", "cpu"] + (["--vq"] if vq else []))
        assert report["tokens"] == 4 and report["tok_per_s"] > 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert line.startswith(f"{name} strategy=replicate vq={vq}: ")
    argv = ["--arch", arch, "--smoke", "--steps", "10", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "10"]
    state = tlaunch.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step    10  loss ") and out[-1] == "done"
    assert tckpt.latest_step(str(tmp_path)) == 10
    for key, m in tckpt._paths(state.opt.mu):
        assert m.dtype == torch.bfloat16, key
    tlaunch.main(argv[:4] + ["12"] + argv[5:])
    assert capsys.readouterr().out.splitlines() == ["resumed from step 10",
                                                    "done"]
