"""The MoE family of the PyTorch port against the JAX reference:
``apply_moe`` (forward, aux loss and gradients in x, the router and the
experts; ties at the router's top-k and at an expert's capacity
boundary; capacity drops), then the qwen3-moe and phi3.5-moe smokes
through ``forward_train`` / ``train_loss`` with the aux term and its
gradient (remat off, per layer and grouped), ``prefill``, 40
teacher-forced ``serve_step``s with the exact and the VQ cache, and both
launchers on the CPU.  The reference's weights are carried across with
``repro_torch.convert``; the JAX side runs on its plain CPU path.

Tolerances (f32):
  * ``apply_moe`` and its gradients: ``rtol=1e-5, atol=1e-6`` (the
    reference's order of operations: the same top-k selections, f32
    products of at most d or eff terms, the same scatter-add);
  * a model's loss ``rtol=1e-5, atol=1e-6``, its hidden states, logits
    and parameter gradients ``rtol=1e-5, atol=1e-5`` (as
    ``tests/test_torch_lm_train.py``);
  * 40-step ``serve_step`` logits ``rtol=1e-4, atol=1e-4``, codebook
    counts equal at every step (as ``tests/test_torch_lm.py``).
"""
import dataclasses

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.configs import registry as jreg                   # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.nn import ffn as jffn                             # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.configs import registry as treg             # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.nn import ffn as tffn                       # noqa: E402
from repro_torch.train import checkpoint as tckpt            # noqa: E402
from repro_torch.train import loop as tloop                  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
ARCHS = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"]


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
    return torch.from_numpy(np.array(a, copy=True))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_close(port, ref, tol, what):
    """Every leaf of two trees, matched by checkpoint path."""
    pk = dict(tckpt._paths(port))
    rk = {"/".join(str(p) for p in path): leaf for path, leaf in
          jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert set(pk) == set(rk), what
    for key, leaf in pk.items():
        assert_allclose(_np(leaf), np.asarray(rk[key]).astype(np.float32),
                        err_msg=f"{what} {key}", **tol)


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

def _moe_case(case: str):
    """(params as numpy, x [T, d], top_k, capacity_factor) of one case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    t, d, ff, e, k, cf = 48, 16, 24, 8, 2, 1.25
    if case == "drop":                     # capacity 3 for ~12 routed slots
        cf = 0.25
    if case == "ample":
        cf = float(e)
    f = np.float32
    router = (rng.normal(size=(d, e)) / np.sqrt(d)).astype(f)
    x = rng.normal(size=(t, d)).astype(f)
    if case == "router_tie":
        # experts 2 and 5 score alike for every token: the router's top-k
        # must take the lower index first
        router[:, 5] = router[:, 2]
    if case == "capacity_tie":
        # blocks of identical tokens tie for every expert's slots; at cap
        # 3 each expert's boundary falls inside a block of equal scores
        x = np.repeat(x[:8], 6, axis=0)
        cf = 0.25
    p = (router,
         (rng.normal(size=(e, d, ff)) / np.sqrt(d)).astype(f),
         (rng.normal(size=(e, d, ff)) / np.sqrt(d)).astype(f),
         (rng.normal(size=(e, ff, d)) / np.sqrt(ff)).astype(f))
    return p, x, k, cf


@pytest.mark.parametrize("case", ["plain", "ample", "drop", "router_tie",
                                  "capacity_tie"])
def test_apply_moe_forward_aux_and_grads_match_reference(case):
    p, x, k, cf = _moe_case(case)
    cot = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(p_, x_):
        y, aux = jffn.apply_moe(jffn.MoEParams(*p_), x_, k, cf)
        return jnp.sum(y * cot) + 0.3 * aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, x)
    tp = [_t(a).requires_grad_(True) for a in p]
    tx = _t(x).requires_grad_(True)
    ty, taux = tffn.apply_moe(tffn.MoEParams(*tp), tx, k, cf)
    (torch.sum(ty * _t(cot)) + 0.3 * taux).backward()
    assert_allclose(_np(ty), np.asarray(jy), **TOL)
    assert_allclose(float(taux.detach()), float(jaux), **TOL)
    assert_allclose(_np(tx.grad), np.asarray(jgx), **TOL)
    for name, a, b in zip(tffn.MoEParams._fields, tp, jgp):
        assert_allclose(_np(a.grad), np.asarray(b), err_msg=name, **TOL)
    cap = tffn.moe_capacity(x.shape[0], k, p[0].shape[1], cf)
    zero_rows = int((np.abs(np.asarray(jy)).sum(-1) == 0).sum())
    if case in ("drop", "capacity_tie"):
        assert cap == 3 and zero_rows > 0          # tokens were dropped
    if case == "ample":
        assert cap == x.shape[0] and zero_rows == 0


def test_apply_moe_selection_breaks_ties_to_the_lower_index():
    """Two identical tokens, one slot: the expert takes the lower one, as
    ``lax.top_k`` orders ties; the router's top-1 between two identical
    experts picks the lower expert."""
    d, ff, e = 4, 6, 2
    rng = np.random.default_rng(0)
    router = np.zeros((d, e), np.float32)            # every prob 0.5
    w = [(rng.normal(size=s)).astype(np.float32)
         for s in ((e, d, ff), (e, d, ff), (e, ff, d))]
    x = np.repeat(rng.normal(size=(1, d)).astype(np.float32), 4, axis=0)
    args = (router, *w)
    jy, _ = jffn.apply_moe(jffn.MoEParams(*args), x, 1, 0.5)
    ty, _ = tffn.apply_moe(tffn.MoEParams(*map(_t, args)), _t(x), 1, 0.5)
    jy = np.asarray(jy)
    # capacity 1: only token 0 goes to expert 0; expert 1 has no token
    assert (np.abs(jy[1:]).sum(-1) == 0).all() and np.abs(jy[0]).sum() > 0
    assert_allclose(_np(ty), jy, **TOL)


def test_init_moe_distributions_and_dtypes():
    p = tffn.init_moe(torch.Generator().manual_seed(0), 64, 16, 96,
                      torch.bfloat16)
    assert p.router.dtype == torch.float32 and p.router.shape == (64, 16)
    assert p.w1.dtype == p.w3.dtype == p.w2.dtype == torch.bfloat16
    assert p.w1.shape == p.w3.shape == (16, 64, 96)
    assert p.w2.shape == (16, 96, 64)
    for t, f_in in ((p.router, 64), (p.w1, 64), (p.w3, 64), (p.w2, 96)):
        assert abs(float(t.float().std()) * np.sqrt(f_in) - 1.0) < 0.05


# ---------------------------------------------------------------------------
# the moe family through the model's entry points
# ---------------------------------------------------------------------------

def _cfgs(arch: str, vq: bool = False, **kw):
    jc, tc = jreg.get_smoke(arch), treg.get_smoke(arch)
    if vq:
        jc, tc = jc.with_vq(k=4, window=8), tc.with_vq(k=4, window=8)
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


@pytest.fixture(scope="module")
def ref_params():
    return {arch: _numpy(jlm.init_lm(jax.random.PRNGKey(3), _cfgs(arch)[0]))
            for arch in ARCHS}


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_grads_and_prefill_match_reference(arch,
                                                              ref_params):
    jc, tc = _cfgs(arch, True)
    jp = ref_params[arch]
    tok = _tokens(jc.vocab, 2, 33, seed=1)          # S 32: 4 VQ windows
    jh, jaux = jax.jit(jlm.forward_train, static_argnums=2)(
        jp, tok[:, :-1], jc)
    (loss, grads) = jax.jit(jax.value_and_grad(jlm.train_loss),
                            static_argnums=2)(jp, tok, jc)
    params = convert.lm_params_from_numpy(jp, CPU)
    with torch.no_grad():
        th, taux = tlm.forward_train(params, _t(tok[:, :-1]), tc)
    assert_allclose(_np(th), np.asarray(jh), **MODEL_TOL)
    assert float(jaux) > 0
    assert_allclose(float(taux), float(jaux), **TOL)
    tloss, tgrads = tloop.loss_and_grads(params, _t(tok), tc)
    assert_allclose(float(tloss), float(loss), **TOL)
    _leaves_close(tgrads, grads, MODEL_TOL, f"{arch} grad")
    # the aux term reaches the router: its gradient differs without it
    assert float(tgrads["blocks"]["moe"].router.abs().sum()) > 0
    want = jax.jit(jlm.prefill, static_argnums=2)(jp, tok[:, :32], jc)
    with torch.no_grad():
        got = tlm.prefill(params, _t(tok[:, :32]), tc)
    assert got.shape == (2, jc.vocab)
    assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)


def test_remat_variants_agree():
    """remat off, per layer and grouped (2 groups of 2 layers, the
    reference's nested checkpoint) at 4 layers: the aux loss summed inside
    and across the groups, the same loss and gradients bit for bit (the
    no-remat path is held to the reference above)."""
    _, tc = _cfgs("qwen3-moe-30b-a3b", n_layers=4)
    params = tlm.init_lm(tc, torch.Generator().manual_seed(4), device=CPU)
    tok = _t(_tokens(tc.vocab, 2, 17, seed=2))
    out = [tloop.loss_and_grads(params, tok, dataclasses.replace(
        tc, remat=remat, remat_group=group))
        for remat, group in [(False, 0), (True, 0), (True, 2)]]
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        for (key, a), (_, b) in zip(tckpt._paths(grads),
                                    tckpt._paths(out[0][1])):
            assert torch.equal(a, b), key


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("vq", [False, True])
def test_serve_step_logits_match_reference(arch, vq, ref_params):
    """40 teacher-forced steps at batch 3 (capacity 1 for every expert:
    a token past it loses the expert, as in the reference)."""
    jc, tc = _cfgs(arch, vq)
    jp = ref_params[arch]
    tp = convert.lm_params_from_numpy(jp, CPU)
    jcache = jlm.init_serve_cache(jc, 3, 48)
    tcache = tlm.init_serve_cache(tc, 3, 48, device=CPU)
    step = jax.jit(lambda p, t, c: jlm.serve_step(p, t, c, jc))
    tokens = np.random.default_rng(11).integers(
        0, jc.vocab, (40, 3, 1)).astype(np.int32)
    for s in range(40):
        jl, jcache = step(jp, tokens[s], jcache)
        tl, tcache = tlm.serve_step(tp, _t(tokens[s]).long(), tcache, tc)
        assert_allclose(_np(tl), np.asarray(jl), err_msg=f"step {s}",
                        **STEP_TOL)
        if vq:
            assert np.array_equal(tcache["kv"].count.numpy(),
                                  np.asarray(jcache["kv"].count)), s
    assert np.array_equal(tcache["kv"].pos.numpy(),
                          np.asarray(jcache["kv"].pos))
    if vq:
        assert np.asarray(jcache["kv"].count).max() > 1


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_and_train_the_moe_family(arch, capsys):
    report = tserve.main(["--arch", arch, "--smoke", "--vq", "--tokens",
                          "4", "--device", "cpu"])
    assert report["tokens"] == 4 and report["vq"] and report["tok_per_s"] > 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(
        f"{treg.get_smoke(arch).name} strategy=replicate vq=True: ")
    state = tlaunch.main(["--arch", arch, "--smoke", "--steps", "10",
                          "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step    10  loss ") and out[-1] == "done"
    assert state.opt.mu["blocks"]["moe"].router.dtype == torch.bfloat16
    assert int(state.step) == 10
