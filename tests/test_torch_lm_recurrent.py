"""The recurrent substrates of the PyTorch port against the JAX reference:
the mLSTM's parallel form (one chunk and 1,024-row chunks) and its step,
the sLSTM's time loop and its step, the Mamba2 scan and its step --
outputs, new states and gradients in the input and every parameter --
then the reference's own train-vs-decode contract
(``tests/test_recurrent_equivalence.py``) held by the port, up to the
whole xlstm and zamba2 smokes (``forward_train`` against token-by-token
``serve_step``).  Inputs and weights are numpy from a seed, the same for
both packages; the JAX side runs on its plain CPU path.

Tolerances (f32):
  * the mLSTM and sLSTM forms, their states and gradients: ``rtol=1e-5,
    atol=1e-6`` (the reference's order of operations; the sLSTM's input
    projection is one product before its loop, row for row the
    reference's per-step product), the absolute part times the largest
    entry of the array compared where it exceeds 1 (a gradient entry
    sums terms of that order that may cancel); the 1,024-row chunks
    within the reference's own distance from an f64 evaluation of the
    same function (a row's decay-masked sum runs over 2,048 signed
    terms and is divided by their sum's magnitude);
  * the Mamba2 train form ``rtol=1e-4, atol=1e-5``, scaled alike, looser
    by design: the port scans 64-step chunks in log steps and carries the
    state between them, where the reference runs one ``associative_scan``
    over the sequence -- the same products and sums grouped in another
    order, an error that grows with the number of terms a state sums; the
    step form (no scan) ``rtol=1e-5, atol=1e-6``;
  * train form vs step form: the reference's own tolerances (mLSTM
    ``2e-3``, sLSTM ``rtol=1e-4, atol=1e-5``, Mamba2 ``2e-4``, the whole
    models ``3e-3``).
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.nn import ssm as jssm                             # noqa: E402
from repro.nn import xlstm as jx                             # noqa: E402
from repro_torch.configs import registry as treg             # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.nn import ssm as tssm                       # noqa: E402
from repro_torch.nn import xlstm as tx                       # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
CHUNK_TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread (small shapes, shared
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _params(cls, shapes: dict, seed: int, scale: float = 1.0):
    """numpy params of a NamedTuple's fields, N(0, scale^2 / f_in)."""
    rng = np.random.default_rng(seed)
    return cls(**{k: (scale * rng.normal(size=s) / np.sqrt(s[0])
                      ).astype(np.float32) for k, s in shapes.items()})


def _close(got, want, tol, what):
    """``got`` within ``rtol |want| + atol max(1, max |want|)``: the
    absolute part scales with the array's largest entry, as a gradient
    entry sums terms of that order that may cancel."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert_allclose(got, want, rtol=tol["rtol"], atol=tol["atol"] * scale,
                    err_msg=what)


def _check_vjp(jfn, tfn, args, cot, tol, what):
    """Outputs and the VJP of ``cot`` in every argument (NamedTuples of
    arrays or arrays) of both packages' functions (the reference's
    jitted)."""
    def run(args_, cot_):
        out, vjp = jax.vjp(jfn, *args_)
        return out, vjp(cot_)
    jout, jgrads = jax.jit(run)(args, cot)
    targs = [type(a)(*(_t(x).requires_grad_(True) for x in a))
             if hasattr(a, "_fields") else _t(a).requires_grad_(True)
             for a in args]
    tout = tfn(*targs)
    _close(_np(tout), jout, tol, f"{what} out")
    torch.sum(tout * _t(np.asarray(cot))).backward()
    for i, (ta, jg) in enumerate(zip(targs, jgrads)):
        if hasattr(ta, "_fields"):
            for name, x, g in zip(ta._fields, ta, jg):
                _close(_np(x.grad), g, tol, f"{what} d{name}")
        else:
            _close(_np(ta.grad), jg, tol, f"{what} d arg {i}")


def _state_close(got, want, tol, what):
    for name, g, w in zip(got._fields, got, want):
        assert_allclose(_np(g), np.asarray(w), err_msg=f"{what} {name}",
                        **tol)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm(d, h, seed):
    return _params(jx.MLSTMParams, {
        "wq": (d, d), "wk": (d, d), "wv": (d, d), "w_if": (d, 2 * h),
        "wo": (d, d), "ogate": (d, d)}, seed)


@pytest.mark.parametrize("s", [16, 37])
def test_mlstm_train_forward_and_grads_match_reference(s):
    d, h, b = 32, 4, 2
    p = _mlstm(d, h, s)
    x = np.random.default_rng(s + 1).normal(size=(b, s, d)).astype(
        np.float32)
    cot = np.random.default_rng(s + 2).normal(size=(b, s, d)).astype(
        np.float32)
    _check_vjp(lambda p_, x_: jx.apply_mlstm_train(p_, x_, h),
               lambda p_, x_: tx.apply_mlstm_train(p_, x_, h),
               (p, x), cot, TOL, f"mlstm S {s}")


def test_mlstm_train_in_chunks_matches_reference():
    """S 2,048 > 1,024 and a multiple of it: both packages take the
    query-chunked path (two chunks).  A row sums 2,048 signed terms and
    divides by their sum's magnitude, which may cancel: the two f32
    results are each ~1e-4 from an f64 evaluation of the same function,
    so the port is held within the reference's own distance from it."""
    d, h = 16, 2
    p = _mlstm(d, h, 3)
    x = np.random.default_rng(4).normal(size=(1, 2048, d)).astype(
        np.float32)
    want = np.asarray(jax.jit(jx.apply_mlstm_train, static_argnums=2)(
        p, x, h))
    with torch.no_grad():
        got = _np(tx.apply_mlstm_train(jx.MLSTMParams(*map(_t, p)), _t(x),
                                       h))
        exact = tx.apply_mlstm_train(
            jx.MLSTMParams(*(torch.from_numpy(np.asarray(a, np.float64))
                             for a in p)),
            torch.from_numpy(x.astype(np.float64)), h).numpy()
    ref_err = np.abs(want - exact)
    assert np.abs(got - exact).max() <= ref_err.max()
    assert_allclose(got, want, rtol=CHUNK_TOL["rtol"],
                    atol=CHUNK_TOL["atol"] + 2 * ref_err.max())


def test_mlstm_step_matches_reference_from_the_initial_state():
    d, h, b = 32, 4, 3
    p = _mlstm(d, h, 5)
    tp = tx.MLSTMParams(*map(_t, p))
    js, ts = jx.init_mlstm_state(b, d, h), tx.init_mlstm_state(b, d, h)
    _state_close(ts, js, TOL, "init")
    rng = np.random.default_rng(6)
    for i in range(12):
        xt = rng.normal(size=(b, 1, d)).astype(np.float32)
        jo, js = jx.apply_mlstm_step(p, xt, js, h)
        to, ts = tx.apply_mlstm_step(tp, _t(xt), ts, h)
        assert_allclose(_np(to), np.asarray(jo), err_msg=f"step {i}", **TOL)
        _state_close(ts, js, TOL, f"step {i}")


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm(d, seed):
    p = _params(jx.SLSTMParams, {"w_x": (d, 4 * d), "w_h": (d, 4 * d),
                                 "b": (4 * d,), "wo": (d, d)}, seed)
    return p._replace(w_h=0.3 * p.w_h)


def test_slstm_train_forward_and_grads_match_reference():
    d, b, s = 24, 2, 10
    p = _slstm(d, 7)
    x = np.random.default_rng(8).normal(size=(b, s, d)).astype(np.float32)
    cot = np.random.default_rng(9).normal(size=(b, s, d)).astype(np.float32)
    _check_vjp(jx.apply_slstm_train, tx.apply_slstm_train, (p, x), cot, TOL,
               "slstm")


def test_slstm_step_matches_reference_from_the_initial_state():
    d, b = 24, 3
    p = _slstm(d, 10)
    tp = tx.SLSTMParams(*map(_t, p))
    js, ts = jx.init_slstm_state(b, d), tx.init_slstm_state(b, d)
    _state_close(ts, js, TOL, "init")
    rng = np.random.default_rng(11)
    for i in range(12):
        xt = rng.normal(size=(b, 1, d)).astype(np.float32)
        jo, js = jx.apply_slstm_step(p, xt, js)
        to, ts = tx.apply_slstm_step(tp, _t(xt), ts)
        assert_allclose(_np(to), np.asarray(jo), err_msg=f"step {i}", **TOL)
        _state_close(ts, js, TOL, f"step {i}")


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def _mamba(d, n, seed):
    di, h, _ = jssm.dims(d, n)
    rng = np.random.default_rng(seed)
    f = np.float32
    return jssm.Mamba2Params(
        in_proj=(rng.normal(size=(d, 2 * di + 2 * n + h)) / np.sqrt(d)
                 ).astype(f),
        conv_w=(0.5 * rng.normal(size=(4, di + 2 * n))).astype(f),
        a_log=(0.3 * rng.normal(size=(h,))).astype(f),
        d_skip=(1.0 + 0.1 * rng.normal(size=(h,))).astype(f),
        dt_bias=(-2.0 + 0.5 * rng.normal(size=(h,))).astype(f),
        norm_scale=(1.0 + 0.1 * rng.normal(size=(di,))).astype(f),
        out_proj=(rng.normal(size=(di, d)) / np.sqrt(di)).astype(f))


@pytest.mark.parametrize("s", [12, 150])
def test_mamba2_train_forward_and_grads_match_reference(s):
    """S 12 (one chunk) and 150 (two full 64-step chunks and a partial
    one, the state carried across)."""
    d, n, b = 64, 16, 2
    p = _mamba(d, n, s)
    x = np.random.default_rng(s + 1).normal(size=(b, s, d)).astype(
        np.float32)
    cot = np.random.default_rng(s + 2).normal(size=(b, s, d)).astype(
        np.float32)
    _check_vjp(lambda p_, x_: jssm.apply_mamba2_train(p_, x_, d, n),
               lambda p_, x_: tssm.apply_mamba2_train(p_, x_, d, n),
               (p, x), cot, SCAN_TOL, f"mamba2 S {s}")


def test_mamba2_step_matches_reference_from_the_initial_state():
    d, n, b = 64, 16, 3
    p = _mamba(d, n, 12)
    tp = tssm.Mamba2Params(*map(_t, p))
    js = jssm.init_mamba2_state(b, d, n)
    ts = tssm.init_mamba2_state(b, d, n)
    _state_close(ts, js, TOL, "init")
    rng = np.random.default_rng(13)
    for i in range(12):
        xt = rng.normal(size=(b, 1, d)).astype(np.float32)
        jo, js = jssm.apply_mamba2_step(p, xt, js, d, n)
        to, ts = tssm.apply_mamba2_step(tp, _t(xt), ts, d, n)
        assert_allclose(_np(to), np.asarray(jo), err_msg=f"step {i}", **TOL)
        _state_close(ts, js, TOL, f"step {i}")


def test_init_mamba2_keeps_its_scalars_f32_in_bf16():
    p = tssm.init_mamba2(torch.Generator().manual_seed(0), 128, 16,
                         torch.bfloat16)
    jp = jax.eval_shape(lambda: jssm.init_mamba2(jax.random.PRNGKey(0), 128,
                                                 16, jnp.bfloat16))
    for name, got, want in zip(p._fields, p, jp):
        assert tuple(got.shape) == tuple(want.shape), name
        assert str(got.dtype)[6:] == want.dtype.name, name


# ---------------------------------------------------------------------------
# train form vs step form (the reference's contract, on the port)
# ---------------------------------------------------------------------------

def _stepwise(step, x, st):
    outs = []
    for i in range(x.shape[1]):
        o, st = step(x[:, i:i + 1], st)
        outs.append(o)
    return torch.cat(outs, dim=1)


@torch.no_grad()
def test_port_train_forms_equal_their_step_forms():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 16, 32), generator=gen)
    p = tx.init_mlstm(gen, 32, 4)
    seq = _stepwise(lambda xt, st: tx.apply_mlstm_step(p, xt, st, 4), x,
                    tx.init_mlstm_state(2, 32, 4))
    assert_allclose(_np(tx.apply_mlstm_train(p, x, 4)), _np(seq), rtol=2e-3,
                    atol=2e-3)
    p = tx.init_slstm(gen, 32)
    seq = _stepwise(lambda xt, st: tx.apply_slstm_step(p, xt, st), x,
                    tx.init_slstm_state(2, 32))
    assert_allclose(_np(tx.apply_slstm_train(p, x)), _np(seq), rtol=1e-4,
                    atol=1e-5)
    p = tssm.init_mamba2(gen, 32, 16)
    seq = _stepwise(lambda xt, st: tssm.apply_mamba2_step(p, xt, st, 32, 16),
                    x, tssm.init_mamba2_state(2, 32, 16))
    assert_allclose(_np(tssm.apply_mamba2_train(p, x, 32, 16)), _np(seq),
                    rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-2.7b"])
@torch.no_grad()
def test_port_prefix_decode_consistency(arch):
    """The reference's whole-model contract on the port: token-by-token
    ``serve_step`` tracks ``forward_train``'s teacher-forced logits."""
    cfg = treg.get_smoke(arch)
    params = tlm.init_lm(cfg, torch.Generator().manual_seed(0), device=CPU)
    tokens = torch.randint(0, cfg.vocab, (1, 8),
                           generator=torch.Generator().manual_seed(1))
    hidden, aux = tlm.forward_train(params, tokens, cfg)
    assert float(aux) == 0.0
    logits_train = hidden @ params["head"]
    cache = tlm.init_serve_cache(cfg, 1, 32, device=CPU)
    for t in range(8):
        lg, cache = tlm.serve_step(params, tokens[:, t:t + 1], cache, cfg)
        assert_allclose(_np(lg), _np(logits_train[:, t]), rtol=3e-3,
                        atol=3e-3, err_msg=f"token {t}")
