"""The orders of work of two CUDA kernels of the PyTorch port, emulated in
plain PyTorch on the CPU and held against the plain versions and the JAX
reference.

* ``vq_attention.cu`` splits each group's keys over several blocks, each
  block's warps walk 16-key tiles with an online softmax, and the warps'
  partials merge in a fixed order: in shared memory with one split, in
  (split, warp) order from a workspace with several (``csrc/
  vq_attention.cu``).  :func:`emulate_vq_attention` does the same in f32
  and is held to ``ref.vq_attention_decode`` (the port's plain version)
  and ``repro.kernels.ref.vq_attention_decode`` (the JAX oracle) with the
  kernel's own tolerances: ``rtol=1e-5, atol=1e-6`` in f32, two bf16 units
  in the last place in bf16.
* ``spmm_ell.cu`` does not gather a slot whose value is 0.  On a finite
  source that leaves the f32 slot-order sum bit-equal to
  ``ref.spmm_ell``, which multiplies every slot: a hypothesis test.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st   # noqa: E402

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import ref as jref                         # noqa: E402
from repro_torch.kernels import ref as tref                   # noqa: E402
from repro_torch.kernels import vq_attention as tva           # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
KEYS = tva.KEYS_PER_WARP
WARPS = 4                     # the kernel's warps a block at these shapes


# ---------------------------------------------------------------------------
# vq_attention: split, walk, merge
# ---------------------------------------------------------------------------

def _online(state, s_tile, v_tile):
    """One tile of a warp's online softmax: scores [n, g, t], values
    [n, t, d]."""
    m, l, acc = state
    mx = s_tile.amax(-1)
    m_new = torch.maximum(m, mx)
    p = torch.where(s_tile == -math.inf, torch.zeros(()),
                    torch.exp(s_tile - m_new[..., None]))
    alpha = torch.where(m_new == -math.inf, torch.ones(()),
                        torch.exp(m - m_new))
    return (m_new, l * alpha + p.sum(-1),
            acc * alpha[..., None] + p @ v_tile)


def _factors(ms, ref_max):
    return torch.where(ms == -math.inf, torch.zeros(()),
                       torch.exp(ms - ref_max))


def emulate_vq_attention(q, cb_k, cb_v, mass, win_k, win_v, win_mask,
                         splits: int, warps: int = WARPS):
    """The kernel's split-and-merge softmax in f32: ``splits`` contiguous
    ranges of 16-key tiles, each range's tiles dealt to ``warps`` warps in
    turn, a warp's online softmax over its tiles.  One split: the warps
    merged with the block's max.  Several: every warp's partial a slot,
    the slots merged in (split, warp) order, chunks of 16 slots merged
    with the chunk's max and online from chunk to chunk.  The output is
    cast to q's dtype.  bf16 scores are the unscaled dot times the scale
    (the tensor-core route), f32 ones the pre-scaled query's dot."""
    n, g, d = q.shape
    kcb = cb_k.shape[1]
    total = kcb + win_k.shape[1]
    scale = 1.0 / math.sqrt(d)
    keys = torch.cat([cb_k, win_k], 1).float()
    vals = torch.cat([cb_v, win_v], 1).float()
    bias = torch.cat([
        torch.where(mass > 0, torch.log(torch.clamp_min(mass, 1e-9)),
                    torch.full_like(mass, -math.inf)),
        torch.where(win_mask > 0, torch.zeros_like(win_mask),
                    torch.full_like(win_mask, -math.inf))], 1)
    if q.dtype == torch.bfloat16:
        dot = (q.float() @ keys.transpose(1, 2)) * scale
    else:
        dot = (q.float() * scale) @ keys.transpose(1, 2)
    s = torch.where(bias[:, None, :] == -math.inf,
                    torch.full_like(dot, -math.inf), dot + bias[:, None, :])
    tiles = -(-total // KEYS)
    per = -(-tiles // splits)
    fresh = lambda: (torch.full((n, g), -math.inf), torch.zeros((n, g)),
                     torch.zeros((n, g, d)))
    slots = []
    for sp in range(splits):
        lo = min(tiles, sp * per)
        hi = min(tiles, lo + per)
        for w in range(warps):
            state = fresh()
            for t in range(lo + w, hi, warps):
                sl = slice(t * KEYS, min(total, (t + 1) * KEYS))
                state = _online(state, s[..., sl], vals[:, sl])
            slots.append(state)
    if splits == 1:
        ms = torch.stack([x[0] for x in slots])
        f = _factors(ms, ms.amax(0))
        den = torch.zeros((n, g))
        acc = torch.zeros((n, g, d))
        for (_, l_w, a_w), f_w in zip(slots, f):
            den = den + l_w * f_w
            acc = acc + a_w * f_w[..., None]
        return (acc / den[..., None]).to(q.dtype)
    m_all, den, acc = fresh()
    for c in range(0, len(slots), 16):
        chunk = slots[c:c + 16]
        ms = torch.stack([x[0] for x in chunk])
        mc = torch.maximum(m_all, ms.amax(0))
        live = mc != -math.inf
        fo = torch.where(live, torch.exp(m_all - mc), torch.ones(()))
        den, acc = den * fo, acc * fo[..., None]
        for (m_x, l_x, a_x) in chunk:
            f = torch.where(m_x == -math.inf, torch.zeros(()),
                            torch.exp(m_x - mc))
            den = den + l_x * f
            acc = acc + a_x * f[..., None]
        m_all = torch.where(live, mc, m_all)
    return (acc / den[..., None]).to(q.dtype)


def _operands(n, g, d, kcb, w, seed, dtype):
    """numpy-seeded inputs: empty codewords, masked window slots, group 0
    with one valid key."""
    rng = np.random.default_rng(seed)
    q, cbk, cbv = (rng.standard_normal(s).astype(np.float32) for s in
                   ((n, g, d), (n, kcb, d), (n, kcb, d)))
    wk, wv = (rng.standard_normal((n, w, d)).astype(np.float32)
              for _ in "kv")
    mass = (rng.random((n, kcb)) * 20).astype(np.float32)
    mass[:, ::3] = 0.0
    wm = (rng.random((n, w)) < 0.7).astype(np.float32)
    if w:
        wm[:, 0] = 1.0
        wm[0] = 0.0
        wm[0, w - 1] = 1.0
    mass[0] = 0.0
    ts = [torch.from_numpy(a) for a in (q, cbk, cbv, mass, wk, wv, wm)]
    return [t.to(dtype) if i in (0, 1, 2, 4, 5) else t
            for i, t in enumerate(ts)]


def assert_bf16_close(got, want, ulps: int = 2):
    """Within ``ulps`` bf16 units in the last place of ``want`` (an ulp
    taken at no less than 2^-10), as the card tests hold the kernel."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(w), 2.0 ** -10)
    tol = ulps * 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(g - w) <= tol).all(), np.abs(g - w).max()


def _close(got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert_bf16_close(got, want)


SHAPES = [(32, 3, 128, 128, 64),       # the decode path's shape
          (3, 5, 40, 37, 20),          # k + w not a multiple of 16
          (2, 4, 64, 0, 45)]           # no codewords


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("n,g,d,kcb,w", SHAPES)
def test_split_merge_matches_plain_and_reference(dtype, splits, n, g, d,
                                                 kcb, w):
    args = _operands(n, g, d, kcb, w, seed=n + kcb + splits, dtype=dtype)
    got = emulate_vq_attention(*args, splits=splits)
    assert got.dtype == dtype and got.shape == (n, g, d)
    _close(got.float().numpy(), tref.vq_attention_decode(*args).float()
           .numpy(), dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jargs = [jnp.asarray(a.float().numpy(), dtype=jdt if i in (0, 1, 2, 4, 5)
                         else jnp.float32) for i, a in enumerate(args)]
    want = jax.vmap(jref.vq_attention_decode)(*jargs)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


def test_split_merge_group_without_keys_is_nan():
    args = _operands(3, 2, 16, 8, 8, seed=1, dtype=torch.float32)
    args[3][1] = 0.0
    args[6][1] = 0.0
    for splits in (1, 2, 3):
        got = emulate_vq_attention(*args, splits=splits)
        assert torch.isnan(got[1]).all()
        assert torch.isfinite(got[[0, 2]]).all()


@pytest.mark.parametrize("n,kcb,w,sms,want", [
    (32, 128, 64, 132, 4),       # the decode path: 12 tiles, 3 a split
    (1024, 1024, 512, 132, 1),   # the config defaults: no split
    (132, 128, 64, 132, 1), (1, 1, 0, 132, 1), (1, 1000, 0, 132, 63),
    (2, 128, 64, 132, 12), (5, 40, 9, 132, 4), (64, 128, 64, 132, 3)])
def test_split_count(n, kcb, w, sms, want):
    """Enough blocks to fill the SMs, none without a tile, at most 64."""
    got = tva.split_count(n, kcb, w, sms)
    assert got == want
    tiles = -(-(kcb + w) // KEYS)
    assert 1 <= got <= min(tiles, tva.MAX_SPLITS)
    per = -(-tiles // got)
    assert (got - 1) * per < tiles        # the last split holds a tile


# ---------------------------------------------------------------------------
# spmm_ell: padding not gathered
# ---------------------------------------------------------------------------

def spmm_ell_skipping_zeros(idx, val, x, x_scale=None):
    """The kernel's sum: slots in order, each product and sum rounded on
    its own, slots whose value is 0 (or -0) left out; the scale once at
    the end."""
    x32 = x.float()
    acc = torch.zeros((idx.shape[0], x.shape[1]))
    for d in range(idx.shape[1]):
        live = (val[:, d] != 0)[:, None]
        acc = torch.where(live, acc + val[:, d, None] * x32[idx[:, d].long()],
                          acc)
    if x_scale is not None:
        acc = acc * x_scale.float().reshape(1, -1)
    return acc


_FINITE = st.floats(width=32, allow_nan=False, allow_infinity=False,
                    min_value=-2.0 ** 50, max_value=2.0 ** 50)
_VALUES = st.one_of(st.just(0.0), st.just(-0.0), _FINITE,
                    st.sampled_from([1e-45, -1e-45, 1.1754942e-38]))


@settings(max_examples=150, deadline=None, database=None)
@given(data=st.data())
def test_skipping_zero_slots_is_bit_equal_on_finite_sources(data):
    b = data.draw(st.integers(1, 5))
    deg = data.draw(st.integers(0, 40))
    n = data.draw(st.integers(1, 6))
    f = data.draw(st.integers(1, 7))
    quantized = data.draw(st.booleans())
    idx = torch.tensor(data.draw(st.lists(st.integers(0, n - 1),
                                          min_size=b * deg,
                                          max_size=b * deg)),
                       dtype=torch.int32).reshape(b, deg)
    val = torch.tensor(data.draw(st.lists(_VALUES, min_size=b * deg,
                                          max_size=b * deg)),
                       dtype=torch.float32).reshape(b, deg)
    if quantized:
        x = torch.tensor(data.draw(st.lists(st.integers(-127, 127),
                                            min_size=n * f,
                                            max_size=n * f)),
                         dtype=torch.int8).reshape(n, f)
        sc = torch.tensor(data.draw(st.lists(
            st.floats(2.0 ** -20, 1024.0, width=32), min_size=f,
            max_size=f)),
            dtype=torch.float32).reshape(1, f)
    else:
        x = torch.tensor(data.draw(st.lists(_VALUES, min_size=n * f,
                                            max_size=n * f)),
                         dtype=torch.float32).reshape(n, f)
        sc = None
    got = spmm_ell_skipping_zeros(idx, val, x, sc)
    want = tref.spmm_ell(idx, val, x, sc)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_skipping_zero_slots_differs_on_a_non_finite_padding_row():
    """Where only padding names a non-finite row the plain version's
    0 * inf is NaN and the kernel's sum leaves the slot out (the one
    divergence, ROADMAP.md queue 3)."""
    idx = torch.tensor([[0, 1], [1, 1]], dtype=torch.int32)
    val = torch.tensor([[0.0, 2.0], [1.0, 0.0]])
    x = torch.tensor([[math.inf, -math.inf], [3.0, -4.0]])
    got = spmm_ell_skipping_zeros(idx, val, x)
    want = tref.spmm_ell(idx, val, x)
    assert torch.isnan(want[0]).all() and torch.equal(got[0], 2.0 * x[1])
    assert torch.equal(got[1], want[1])
