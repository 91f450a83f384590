"""The LM decode path of the PyTorch port against the JAX reference: the
architecture configs, the NN primitives, GQA attention and cached decode,
VQ-Attention decode step by step, the plain attention kernels against the
JAX oracles and the interpret-mode Pallas kernel, ``serve_step`` over 40
teacher-forced steps, the converters and the launcher on the CPU.  The
JAX side runs with ``REPRO_FORCE_PALLAS`` unset (its plain CPU path)
except where a test calls a Pallas kernel itself.  The CUDA kernels are
held against their plain versions on a card by ``tests/test_torch_cuda.py``.

Tolerances:
  * f32 primitives and attention (sums of at most a few thousand products
    in another order): ``rtol=1e-5, atol=1e-6``;
  * VQ-Attention decode: codebook counts exactly equal at every step (the
    assignment argmin sees the same distances up to the last bits); cluster
    sums and outputs ``rtol=1e-5, atol=1e-5``;
  * the plain ``vq_attention_decode`` against the oracle and the Pallas
    kernel: ``rtol=2e-4, atol=2e-4``, the reference's own tolerance
    (``tests/test_kernels.py``);
  * f32 ``serve_step`` logits over 40 steps: ``rtol=1e-4, atol=1e-4``
    (two layers of f32 matmuls, errors compounding through the residual
    stream and the codebook);
  * bf16 ``serve_step`` logits, in units of the bf16 ulp of the largest
    |logit| (``u``): exact attention ``atol = 6u``, VQ-Attention
    ``atol = 12u``.  XLA keeps f32 across fused elementwise chains (a
    matmul's output into the residual add, silu into the gate product) and
    rounds once per fusion, where eager PyTorch rounds after every op: the
    two agree op by op (matmul, rmsnorm and rope are bit-equal), but the
    residual stream drifts by an ulp here and there, so a third of the
    bf16 keys differ from the reference's by one ulp and the logits by
    about 4u (3.6u measured).  Under VQ-Attention a key one ulp away can
    flip a near-tied codebook assignment, moving one token from one
    cluster to another (the llama smoke does so at step 26, 8.7u
    measured): the bf16 test therefore holds the total mass per head, not
    each count; the f32 test holds every count.
"""
import collections
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.configs import base as jbase                      # noqa: E402
from repro.configs import registry as jreg                   # noqa: E402
from repro.kernels import ref as jref                        # noqa: E402
from repro.kernels.vq_attention import (                     # noqa: E402
    vq_attention_decode_pallas)
from repro.models import lm as jlm                           # noqa: E402
from repro.nn import attention as jattn                      # noqa: E402
from repro.nn import layers as jlayers                       # noqa: E402
from repro.nn import vq_attention as jvq                     # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.configs import base as tbase                # noqa: E402
from repro_torch.configs import registry as treg             # noqa: E402
from repro_torch.kernels import flash_attention as tfa       # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.kernels import ref as tref                  # noqa: E402
from repro_torch.kernels import vq_attention as tva          # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.nn import attention as tattn                # noqa: E402
from repro_torch.nn import layers as tlayers                 # noqa: E402
from repro_torch.nn import vq_attention as tvq               # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
VQ_TOL = dict(rtol=1e-5, atol=1e-5)
ORACLE_TOL = dict(rtol=2e-4, atol=2e-4)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_arch_configs_match_reference():
    assert list(treg.LM_ARCHS) == list(jreg.LM_ARCHS)
    assert treg.ARCHS is treg.LM_ARCHS and list(treg.SMOKES) == list(
        jreg.SMOKES)
    assert tbase.SHAPES == jbase.SHAPES
    names = [f.name for f in dataclasses.fields(jbase.ArchConfig)]
    assert [f.name for f in dataclasses.fields(tbase.ArchConfig)] == names
    for arch in jreg.LM_ARCHS:
        for a, b in [(jreg.get_arch(arch), treg.get_arch(arch)),
                     (jreg.get_smoke(arch), treg.get_smoke(arch))]:
            assert dataclasses.asdict(a) == dataclasses.asdict(b), arch
            assert a.hd == b.hd and a.param_count() == b.param_count()
            va, vb = a.with_vq(k=64, window=16), b.with_vq(k=64, window=16)
            assert dataclasses.asdict(va) == dataclasses.asdict(vb)
    full = treg.get_arch("llama3.2-3b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.vocab) == (28, 3072, 24, 8, 128, 8192,
                                                128256)
    assert 3.60e9 < full.param_count() < 3.62e9


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_swiglu_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    assert_allclose(_np(tlayers.rmsnorm(_t(x), _t(scale), 1e-5)),
                    np.asarray(jlayers.rmsnorm(x, scale, 1e-5)), **TOL)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    for theta in (500000.0, 10000.0):
        assert_allclose(_np(tlayers.rope(_t(x), _t(pos), theta)),
                        np.asarray(jlayers.rope(x, pos, theta)), **TOL)
    h = rng.normal(size=(4, 24)).astype(np.float32)
    w1, w3 = (rng.normal(size=(24, 40)).astype(np.float32) / 5
              for _ in range(2))
    w2 = rng.normal(size=(40, 24)).astype(np.float32) / 6
    assert_allclose(_np(tlayers.swiglu(_t(h), _t(w1), _t(w3), _t(w2))),
                    np.asarray(jlayers.swiglu(h, w1, w3, w2)), **TOL)


def _attn_params(rng, d, hq, hkv, hd):
    f = np.float32
    return jattn.AttnParams(
        wq=(rng.normal(size=(d, hq * hd)) / np.sqrt(d)).astype(f),
        wk=(rng.normal(size=(d, hkv * hd)) / np.sqrt(d)).astype(f),
        wv=(rng.normal(size=(d, hkv * hd)) / np.sqrt(d)).astype(f),
        wo=(rng.normal(size=(hq * hd, d)) / np.sqrt(hq * hd)).astype(f),
        q_norm=rng.normal(size=(hd,)).astype(f),
        k_norm=rng.normal(size=(hd,)).astype(f))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_qkv_matches_reference(qk_norm):
    rng = np.random.default_rng(1 + qk_norm)
    d, hq, hkv, hd = 32, 6, 2, 8
    jp = _attn_params(rng, d, hq, hkv, hd)
    tp = tattn.AttnParams(*(_t(a) for a in jp))
    x = rng.normal(size=(3, 7, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) + 11, (3, 7))
    want = jattn.qkv(jp, x, hq, hkv, hd, pos, qk_norm=qk_norm,
                     rope_theta=10000.0)
    got = tattn.qkv(tp, _t(x), hq, hkv, hd, _t(pos), qk_norm=qk_norm,
                    rope_theta=10000.0)
    for g, w in zip(got, want):
        assert_allclose(_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("sq,skv,causal,masked", [
    (8, 8, True, False), (8, 20, True, False), (8, 20, False, True),
    (2048, 2048, True, False),          # the chunked branch (2 chunks)
    (2048, 2048, False, True)])
def test_gqa_attend_matches_reference(sq, skv, causal, masked):
    rng = np.random.default_rng(sq + skv + causal)
    b, hq, hkv, dh = (2, 6, 2, 8) if sq < 1024 else (1, 2, 1, 8)
    q = rng.normal(size=(b, sq, hq, dh)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((b, skv)) < 0.7).astype(np.float32)
        mask[:, 0] = 1.0
    want = jattn.gqa_attend(q, k, v, causal=causal, kv_mask=mask)
    got = tattn.gqa_attend(_t(q), _t(k), _t(v), causal=causal,
                           kv_mask=None if mask is None else _t(mask))
    assert got.shape == (b, sq, hq, dh)
    assert_allclose(_np(got), np.asarray(want), **TOL)


def test_decode_attend_matches_reference_past_the_end():
    """Seven steps into a 4-slot cache: from pos 4 on, both write the last
    slot (the reference's dynamic_update_slice clamps its start)."""
    rng = np.random.default_rng(3)
    b, hq, hkv, dh, s_max = 2, 4, 2, 8, 4
    jc = jattn.init_kv_cache(b, s_max, hkv, dh, jnp.float32)
    tc = tattn.init_kv_cache(b, s_max, hkv, dh, torch.float32, CPU)
    for _ in range(7):
        q = rng.normal(size=(b, 1, hq, dh)).astype(np.float32)
        kn = rng.normal(size=(b, 1, hkv, dh)).astype(np.float32)
        vn = rng.normal(size=(b, 1, hkv, dh)).astype(np.float32)
        jo, jc = jattn.decode_attend(q, jc, kn, vn)
        to, tc = tattn.decode_attend(_t(q), tc, _t(kn), _t(vn))
        assert_allclose(_np(to), np.asarray(jo), **TOL)
        assert np.array_equal(tc.k.numpy(), np.asarray(jc.k))
        assert np.array_equal(tc.v.numpy(), np.asarray(jc.v))
        assert int(tc.pos) == int(jc.pos)
    assert int(tc.pos) == 7


# ---------------------------------------------------------------------------
# VQ-Attention decode, step by step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,w", [(8, 4), (4, 8)])
def test_vq_attention_decode_steps_match_reference(k, w):
    """From an empty cache for 3w + k + 12 steps: the codebook fills one
    codeword at a time (an empty codeword scores exactly 0, ties at 0 go
    to the lowest index), then clusters grow; counts equal at every step."""
    rng = np.random.default_rng(10 * k + w)
    b, hq, hkv, dh = 2, 6, 2, 8
    cfg_j, cfg_t = jvq.VQAttnConfig(k=k, window=w), \
        tvq.VQAttnConfig(k=k, window=w)
    jc = jvq.init_vq_cache(b, hkv, dh, cfg_j, jnp.float32)
    tc = tvq.init_vq_cache(b, hkv, dh, cfg_t, torch.float32, CPU)
    step_j = jax.jit(lambda q, kn, vn, c: jvq.vq_attention_decode(
        q, kn, vn, c, cfg_j))
    live = []
    for _ in range(3 * w + k + 12):
        q = rng.normal(size=(b, 1, hq, dh)).astype(np.float32)
        kn = rng.normal(size=(b, 1, hkv, dh)).astype(np.float32)
        vn = rng.normal(size=(b, 1, hkv, dh)).astype(np.float32)
        jo, jc = step_j(q, kn, vn, jc)
        to, tc = tvq.vq_attention_decode(_t(q), _t(kn), _t(vn), tc, cfg_t)
        assert np.array_equal(tc.count.numpy(), np.asarray(jc.count))
        assert_allclose(tc.sum_k.numpy(), np.asarray(jc.sum_k), **VQ_TOL)
        assert_allclose(tc.sum_v.numpy(), np.asarray(jc.sum_v), **VQ_TOL)
        assert np.array_equal(tc.win_k.numpy(), np.asarray(jc.win_k))
        assert_allclose(_np(to), np.asarray(jo), **VQ_TOL)
        assert int(tc.pos) == int(jc.pos)
        live.append((tc.count.numpy() > 0).sum(-1))
    live = np.stack(live)
    # the codebook filled progressively and some clusters merged tokens
    assert live[w].max() == 1 and live[-1].max() > 1
    assert tc.count.numpy().max() > 1


@pytest.mark.parametrize("n,g,d,kcb,w", [(1, 1, 8, 4, 4), (4, 2, 32, 16, 8),
                                         (6, 4, 64, 128, 32)])
def test_plain_vq_attention_decode_vs_oracle_and_pallas(n, g, d, kcb, w):
    rng = np.random.default_rng(n * 17 + kcb)
    q = rng.normal(size=(n, g, d)).astype(np.float32)
    cbk = rng.normal(size=(n, kcb, d)).astype(np.float32)
    cbv = rng.normal(size=(n, kcb, d)).astype(np.float32)
    mass = (np.abs(rng.normal(size=(n, kcb))) + 0.1).astype(np.float32)
    mass[:, -1] = 0.0                    # an empty codeword
    wk = rng.normal(size=(n, w, d)).astype(np.float32)
    wv = rng.normal(size=(n, w, d)).astype(np.float32)
    wm = np.ones((n, w), np.float32)
    wm[:, w // 2:] = 0.0                 # a half-filled window
    got = _np(tref.vq_attention_decode(*map(_t, (q, cbk, cbv, mass, wk, wv,
                                                 wm))))
    oracle = jax.vmap(lambda *a: jref.vq_attention_decode(*a))(
        q, cbk, cbv, mass, wk, wv, wm)
    pallas = vq_attention_decode_pallas(q, cbk, cbv, mass, wk, wv, wm,
                                        interpret=True)
    assert_allclose(got, np.asarray(oracle), **ORACLE_TOL)
    assert_allclose(got, np.asarray(pallas), **ORACLE_TOL)


def test_plain_vq_attention_decode_single_valid_key():
    """Only codeword 0 and window slot 0 count: the masked ones add
    nothing, in the plain version, the oracle and the Pallas kernel."""
    rng = np.random.default_rng(3)
    n, g, d, kcb, w = 2, 2, 16, 8, 4
    q, cbk, cbv = (rng.normal(size=s).astype(np.float32)
                   for s in ((n, g, d), (n, kcb, d), (n, kcb, d)))
    wk, wv = (rng.normal(size=(n, w, d)).astype(np.float32) for _ in "kv")
    mass = np.zeros((n, kcb), np.float32)
    mass[:, 0] = 2.0
    wm = np.zeros((n, w), np.float32)
    wm[:, 0] = 1.0
    args = (q, cbk, cbv, mass, wk, wv, wm)
    got = _np(tref.vq_attention_decode(*map(_t, args)))
    assert np.isfinite(got).all()
    assert_allclose(got, np.asarray(jax.vmap(jref.vq_attention_decode)(
        *args)), **ORACLE_TOL)
    assert_allclose(got, np.asarray(vq_attention_decode_pallas(
        *args, interpret=True)), **ORACLE_TOL)


@pytest.mark.parametrize("b,h,sq,skv,d", [(1, 2, 16, 16, 8),
                                          (2, 3, 40, 40, 16),
                                          (1, 2, 24, 56, 32),
                                          (2, 1, 1, 33, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_attention_vs_reference(b, h, sq, skv, d, causal):
    """sq == skv and sq < skv (queries the last sq positions).  The Pallas
    flash kernel does not run on the installed jax (ROADMAP.md queue 3),
    so the oracle is the reference."""
    rng = np.random.default_rng(b + h + sq + skv + d + causal)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, h, skv, d)).astype(np.float32)
    got = tref.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    want = jref.flash_attention(q, k, v, causal=causal)
    assert got.shape == (b, h, sq, d)
    assert_allclose(_np(got), np.asarray(want), **TOL)


def test_ops_lm_kernels_dispatch_by_device():
    rng = np.random.default_rng(5)
    q = _t(rng.normal(size=(1, 2, 8, 8)).astype(np.float32))
    assert torch.equal(ops.flash_attention(q, q, q, causal=True),
                       tref.flash_attention(q, q, q, causal=True))
    n, g, d, kcb, w = 2, 3, 8, 4, 4
    args = [_t(rng.normal(size=s).astype(np.float32)) for s in
            ((n, g, d), (n, kcb, d), (n, kcb, d))]
    args.append(torch.ones((n, kcb)))
    args += [_t(rng.normal(size=(n, w, d)).astype(np.float32))
             for _ in range(2)]
    args.append(torch.ones((n, w)))
    assert torch.equal(ops.vq_attention_decode(*args),
                       tref.vq_attention_decode(*args))
    # the wrappers launch on CUDA tensors or raise
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tva.vq_attention_decode_cuda(*args)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tfa.flash_attention_cuda(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention_cuda(q.double(), q.double(), q.double())


# ---------------------------------------------------------------------------
# serve_step, teacher-forced, against the reference
# ---------------------------------------------------------------------------

def _serve_pair(arch: str, vq: bool, dtype: str):
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    if vq:
        jcfg, tcfg = jcfg.with_vq(k=4, window=8), tcfg.with_vq(k=4, window=8)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    params = jlm.init_lm(jax.random.PRNGKey(7), jcfg)
    return jcfg, tcfg, params


def _run_serve(arch, vq, dtype, steps=40, batch=3, context=48):
    """40 teacher-forced steps through both packages: the per-step
    logits of both, and the two caches; under f32 VQ-Attention the counts
    must agree at every step."""
    jcfg, tcfg, jparams = _serve_pair(arch, vq, dtype)
    tparams = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), CPU)
    jcache = jlm.init_serve_cache(jcfg, batch, context)
    tcache = convert.serve_cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcache), CPU)
    step = jax.jit(lambda p, t, c: jlm.serve_step(p, t, c, jcfg))
    tokens = np.random.default_rng(11).integers(
        0, jcfg.vocab, (steps, batch, 1)).astype(np.int32)
    out = []
    for s in range(steps):
        jl, jcache = step(jparams, tokens[s], jcache)
        tl, tcache = tlm.serve_step(tparams, _t(tokens[s]).long(), tcache,
                                    tcfg)
        out.append((np.asarray(jl, np.float32), _np(tl)))
        if vq and dtype == "float32":
            assert np.array_equal(tcache["kv"].count.numpy(),
                                  np.asarray(jcache["kv"].count)), s
    assert np.array_equal(tcache["kv"].pos.numpy(),
                          np.asarray(jcache["kv"].pos))
    return out, jcache, tcache


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-3-8b"])
@pytest.mark.parametrize("vq", [False, True])
def test_serve_step_logits_match_reference_f32(arch, vq):
    out, jcache, tcache = _run_serve(arch, vq, "float32")
    for s, (want, got) in enumerate(out):
        assert_allclose(got, want, err_msg=f"step {s}", **STEP_TOL)
    if vq:
        kv_j, kv_t = jcache["kv"], tcache["kv"]
        assert np.asarray(kv_j.count).max() > 1     # clusters were folded
        assert_allclose(kv_t.sum_k.numpy(), np.asarray(kv_j.sum_k),
                        **STEP_TOL)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-3-8b"])
@pytest.mark.parametrize("vq", [False, True])
def test_serve_step_logits_match_reference_bf16(arch, vq):
    out, jcache, tcache = _run_serve(arch, vq, "bfloat16")
    kv = tcache["kv"]
    assert (kv.win_k if vq else kv.k).dtype == torch.bfloat16
    for s, (want, got) in enumerate(out):
        assert got.dtype == np.float32 and np.isfinite(got).all()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert_allclose(got, want, rtol=0, atol=(12 if vq else 6) * ulp,
                        err_msg=f"step {s}")
    if vq:
        assert np.array_equal(kv.count.numpy().sum(-1),
                              np.asarray(jcache["kv"].count).sum(-1))


# ---------------------------------------------------------------------------
# converters, launcher, example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trips(dtype):
    jcfg, _, jparams = _serve_pair("qwen3-32b", True, dtype)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = convert.lm_params_from_numpy(np_params, CPU)
    assert isinstance(tparams["blocks"]["attn"], tattn.AttnParams)
    assert tparams["blocks"]["attn"].wq.shape[0] == jcfg.n_layers
    want = jax.tree_util.tree_leaves(np_params)
    got = jax.tree_util.tree_leaves(
        tparams, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype) == "torch." + w.dtype.name
        assert np.array_equal(_np(g), np.asarray(w, np.float32))
    for vq in (False, True):
        cfg = jcfg if vq else dataclasses.replace(jcfg, vq_attn=False)
        jc = jax.tree_util.tree_map(np.asarray,
                                    jlm.init_serve_cache(cfg, 2, 16))
        tc = convert.serve_cache_from_numpy(jc, CPU)
        kind = tvq.VQKVCache if vq else tattn.KVCache
        assert isinstance(tc["kv"], kind)
        for f in kind._fields:
            assert np.array_equal(_np(getattr(tc["kv"], f)),
                                  np.asarray(getattr(jc["kv"], f),
                                             np.float32))
        moved = convert.to_device(tc, CPU)
        assert isinstance(moved["kv"], kind)
    odd = collections.namedtuple("Odd", "k v")(np.zeros(2), np.zeros(2))
    with pytest.raises(TypeError, match="unknown LM leaf"):
        convert.serve_cache_from_numpy({"kv": odd}, CPU)


def test_init_lm_and_cache_shapes_follow_the_reference():
    cfg = treg.get_smoke("qwen3-32b").with_vq(k=4, window=8)
    p = tlm.init_lm(cfg, torch.Generator().manual_seed(0), device=CPU)
    jp = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), cfg))
    want = [(tuple(a.shape), a.dtype.name)
            for a in jax.tree_util.tree_leaves(jp)]
    got = [(tuple(t.shape), str(t.dtype)[6:]) for t in
           jax.tree_util.tree_leaves(p, is_leaf=lambda x: isinstance(
               x, torch.Tensor))]
    assert got == want
    for vq_cfg in (cfg, dataclasses.replace(cfg, vq_attn=False)):
        jc = jax.eval_shape(lambda: jlm.init_serve_cache(vq_cfg, 2, 16))
        tc = tlm.init_serve_cache(vq_cfg, 2, 16, device=CPU)
        assert [tuple(t.shape) for t in tc["kv"]] == [
            tuple(a.shape) for a in jc["kv"]]
    # the reference's distributions: N(0, 0.02^2) embeddings, N(0, 1/f_in)
    # weights, unit norms
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    assert abs(float(p["head"].std()) - cfg.d_model ** -0.5) < 0.02
    assert torch.equal(p["blocks"]["ln1"], torch.ones_like(
        p["blocks"]["ln1"]))


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama3.2-3b", "--smoke", "--vq", "--tokens", "6", "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    line = res.stdout.strip().splitlines()[-1]
    assert line.startswith("llama3b-smoke strategy=replicate vq=True: ") \
        and "tok/s" in line
    assert line.endswith("cache 0.2 MB"), line
    report = tserve.main(["--arch", "llama3.2-3b", "--smoke", "--vq",
                          "--tokens", "6", "--device", "cpu"])
    assert report["tokens"] == 6 and report["tok_per_s"] > 0
    # k = min(vq_k, 128), window 64 under --vq, as the reference sets them
    jc = jlm.init_serve_cache(
        jreg.get_smoke("llama3.2-3b").with_vq(k=128, window=64), 4, 1024)
    assert report["cache_bytes"] == sum(
        np.asarray(a).nbytes for a in jax.tree_util.tree_leaves(jc))


def test_serve_launcher_refuses_later_slices():
    """``--production-mesh`` on a one-rank world raises, naming the 256
    ranks the mesh needs (the mesh itself: ``tests/test_torch_lm_sharding.
    py``); the cross-attention families, once refused here, now serve
    (their parity: ``tests/test_torch_lm_cross.py``)."""
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tserve.main(["--arch", "llama3.2-3b", "--production-mesh",
                     "--smoke", "--device", "cpu"])
    for arch in ("whisper-tiny", "llama-3.2-vision-11b"):
        report = tserve.main(["--arch", arch, "--smoke", "--tokens", "2",
                              "--device", "cpu"])
        assert report["tokens"] == 2 and report["tok_per_s"] > 0


def test_lm_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA requests are honoured")
    cfg = treg.get_smoke("llama3.2-3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_lm(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "llama3.2-3b", "--smoke", "--tokens", "1"])


def test_serve_lm_example_runs_on_cpu(capsys):
    from repro_torch.examples import serve_lm
    serve_lm.main(["--tokens", "3", "--context", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "exact-kv" in out and "vq-kv" in out
