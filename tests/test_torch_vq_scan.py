"""The rescoring rule of the ``vq_update`` CUDA kernel, on the CPU.

The kernel (``src/repro_torch/kernels/csrc/vq_update.cuh``) scans the
distances ``|c|^2 - 2 x.c`` on the tensor cores: the operands split into
TF32 hi + lo parts, three products accumulated onto ``|c|^2``.  It folds the
approximate distances over groups of codewords; a row whose runner-up
group lies more than ``2 * candidate_bound`` above its smallest distance is
settled by rescoring the winning group's codewords exactly; any other row
rescores every codeword within that band.  The claim is that the
assignment and qerr are then the plain version's (``ref.vq_assign_update``)
bit for bit.  The card cannot run here, so this file emulates the scan in
plain torch -- the same split (fp32 mantissas masked to TF32's 10 bits), the
products summed in float64, and the tensor cores' accumulation error set
adversarially to the full allowance of the bound's model (the plain
version's winner pushed up, every other codeword down) -- with the same
bound and exact rescoring in index order, and holds it against the plain
version on hypothesis-generated and hand-built near-tie inputs.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as tref                   # noqa: E402
from repro_torch.kernels.vq_update import (TC_EPS,            # noqa: E402
                                           candidate_bound)


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """v truncated to TF32 (the low 13 mantissa bits cleared)."""
    return (v.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _tf32(v)
    return hi, _tf32(v - hi)          # v - hi is exact in fp32


def emulate_scan(x: torch.Tensor, cw: torch.Tensor):
    """The kernel's two-stage scan: -> (idx [nb, n] int32, qerr [nb, n],
    candidates per row [nb, n], the largest |d~ - d| / E)."""
    nb, n, f = x.shape
    n_mma = 3 * -(-f // 8)
    cn2 = tref._sq_norms(cw)                                   # [nb, k] f32
    ah, al = _split(-2.0 * x)
    bh, bl = _split(cw)

    def mm(a, b):
        return torch.einsum("bnf,bkf->bnk", a.double(), b.double())
    exact_sum = cn2[:, None, :].double() + mm(al, bh) + mm(ah, bl) \
        + mm(ah, bh)
    # the sum of magnitudes each of the n_mma accumulations adds (<= |c|^2
    # + 2 * sum_j |2 x_j c_j|): the model's error allowance for all of them
    mag = cn2[:, None, :].double() + 2.0 * mm((2.0 * x).abs(), cw.abs())
    allowance = n_mma * TC_EPS * mag
    # the plain version's fp32 distances and its winner
    dot = torch.zeros((nb, n, cw.shape[1]), dtype=torch.float32)
    for j in range(f):
        dot = dot + x[:, :, j, None] * cw[:, None, :, j]
    d = cn2[:, None, :] - 2.0 * dot
    win = torch.argmin(d, dim=2, keepdim=True)
    sign = -torch.ones_like(d, dtype=torch.float64)
    sign.scatter_(2, win, 1.0)
    dt = (exact_sum + sign * allowance).float()                # d~
    # the kernel's rule.  A lane sees codewords 2q, 2q + 1 of every tile of
    # 8; tiles pair up (0, 1), (2, 3), ... (an odd last full tile and the
    # tail tile stand alone), giving groups of a lane's codewords.  A row
    # is settled when its second smallest group minimum lies beyond
    # min d~ + 2E: then the winning group's tile and the next one are
    # rescored at the lane's two columns; a near-tie row rescores every
    # candidate d~ <= min d~ + 2E
    x_norm = torch.sqrt((x.double() ** 2).sum(-1)).float()     # [nb, n]
    c_max = torch.sqrt(cn2.max(dim=1).values)[:, None]         # [nb, 1]
    e = candidate_bound(x_norm, c_max, f)
    k = dt.shape[2]
    c = torch.arange(k)
    tile, lane = c // 8, (c % 8) // 2
    pairs_end = (k // 8) & ~1
    first = torch.where(tile < pairs_end, tile - tile % 2, tile)
    key = first * 8 + 2 * lane                   # the group's first column
    keys, group = torch.unique(key, sorted=True, return_inverse=True)
    gmin = torch.full((*dt.shape[:2], len(keys)), float("inf")) \
        .scatter_reduce(2, group.expand_as(dt), dt, reduce="amin")
    top2 = torch.topk(gmin, min(2, gmin.shape[2]), dim=2,
                      largest=False).values
    m1 = top2[..., 0]
    runner_up = top2[..., 1] if gmin.shape[2] > 1 else torch.full_like(
        m1, float("inf"))
    thr = m1 + 2.0 * e
    settled = torch.isfinite(thr) & (runner_up > thr)
    c0 = keys[torch.argmin(gmin, dim=2)]        # lowest first column on ties
    win = (c[None, None, :] == c0[..., None]) \
        | (c[None, None, :] == c0[..., None] + 1) \
        | (c[None, None, :] == c0[..., None] + 8) \
        | (c[None, None, :] == c0[..., None] + 9)
    cand = torch.where(settled[..., None], win, ~(dt > thr[..., None]))
    ratio = float(((dt.double() - d.double()).abs() / e[..., None].double())
                  .max())
    # exact rescoring of the candidates, lowest index on ties
    rescored = torch.where(cand, d, torch.full_like(d, float("inf")))
    idx = torch.argmin(rescored, dim=2)
    best = rescored.gather(2, idx[..., None])[..., 0]
    qerr = torch.clamp(best + tref._sq_norms(x), min=0.0)
    return idx.to(torch.int32), qerr, cand.sum(-1), ratio


def assert_scan_exact(x, cw):
    x = torch.as_tensor(np.asarray(x, np.float32))
    cw = torch.as_tensor(np.asarray(cw, np.float32))
    idx, qerr, cands, ratio = emulate_scan(x, cw)
    want = tref.vq_assign_update(x, cw)
    assert ratio <= 1.0, f"|d~ - d| reached {ratio} x the bound"
    assert torch.equal(idx, want[0])
    assert torch.equal(qerr, want[1])
    assert bool((cands >= 1).all())
    return cands


def _near_tie_case(nb, n, k, f, seed, scale=1.0):
    """Duplicated codewords, codewords one fp32 ulp apart in one coordinate,
    rows on a codeword, rows equidistant from two, large-norm rows."""
    rng = np.random.default_rng(seed)
    cw = rng.standard_normal((nb, k, f)).astype(np.float32) * scale
    cw[:, 1::4] = cw[:, 0::4][:, :cw[:, 1::4].shape[1]]
    c2 = cw[:, 2::4]
    c2[:] = cw[:, 0::4][:, :c2.shape[1]]
    c2[..., 0] = np.nextafter(c2[..., 0], np.float32(np.inf))
    cw[:, 2::4] = c2
    pick = rng.integers(0, k, (nb, n))
    x = np.take_along_axis(cw, pick[..., None], 1).copy()
    other = np.take_along_axis(cw, ((pick + 1) % k)[..., None], 1)
    x[:, 1::3] = (0.5 * (x + other))[:, 1::3]          # equidistant
    x[:, 2::5] += 1e-4 * rng.standard_normal(x[:, 2::5].shape)
    x[:, 3::7] *= 1e3                                  # |x| ~ 1e3
    return x.astype(np.float32), cw


@pytest.mark.parametrize("f", [8, 21, 5, 32])
@pytest.mark.parametrize("k", [16, 64, 257])
def test_scan_exact_on_near_ties(f, k):
    assert_scan_exact(*_near_tie_case(2, 150, k, f, seed=f * k))


@pytest.mark.parametrize("f", [8, 21])
def test_scan_exact_with_small_codewords_and_large_rows(f):
    x, cw = _near_tie_case(2, 120, 64, f, seed=f, scale=1e-3)
    assert_scan_exact(x * 1e3, cw)


@pytest.mark.parametrize("f", [8, 21])
def test_scan_exact_when_every_row_is_alike(f):
    """The collapsed codebook's rows: one row repeated, duplicated
    codewords among the nearest."""
    x, cw = _near_tie_case(3, 1, 128, f, seed=7 + f)
    assert_scan_exact(np.repeat(x, 200, axis=1), cw)


def test_scan_prunes_on_random_rows():
    """On rows with no planted ties nearly every row is settled with the
    winning group's four codewords rescored: the rescoring is rare, not a
    second full scan."""
    rng = np.random.default_rng(0)
    for f in (8, 21):
        x = rng.standard_normal((2, 500, f)).astype(np.float32)
        cw = rng.standard_normal((2, 512, f)).astype(np.float32)
        cands = assert_scan_exact(x, cw)
        assert float(cands.float().mean()) < 4.1


_floats = st.floats(-8.0, 8.0, width=32, allow_subnormal=False)


@settings(max_examples=40, deadline=None)
@given(f=st.integers(1, 32), k=st.integers(1, 40), n=st.integers(1, 24),
       seed=st.integers(0, 2 ** 31 - 1), exp=st.integers(-12, 12),
       dup=st.booleans(), data=st.data())
def test_scan_exact_hypothesis(f, k, n, seed, exp, dup, data):
    rng = np.random.default_rng(seed)
    cw = rng.standard_normal((1, k, f)).astype(np.float32) * np.float32(
        2.0 ** exp)
    if dup and k > 1:
        cw[0, k - 1] = cw[0, 0]                       # the lowest must win
    row = data.draw(st.lists(_floats, min_size=f, max_size=f))
    x = np.empty((1, n, f), np.float32)
    x[0, 0] = row
    x[0, 1:] = cw[0, rng.integers(0, k, n - 1)] \
        + rng.standard_normal((n - 1, f)).astype(np.float32) * np.float32(
            2.0 ** (exp - 20))
    assert_scan_exact(x, cw)


def test_plain_tie_rule_matches_the_reference():
    """Exactly duplicated codewords tie in any arithmetic: the port's plain
    version and the JAX reference both keep the lowest index."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    rng = np.random.default_rng(3)
    cw = rng.standard_normal((1, 32, 8)).astype(np.float32)
    cw[:, 1::2] = cw[:, 0::2]
    x = (cw[:, np.arange(64) % 32]
         + 0.01 * rng.standard_normal((1, 64, 8))).astype(np.float32)
    want = np.asarray(jref.vq_assign_update(jnp.asarray(x[0]),
                                            jnp.asarray(cw[0]))[0])
    got = tref.vq_assign_update(torch.as_tensor(x), torch.as_tensor(cw))[0]
    assert np.array_equal(got[0].numpy(), want)
    assert not np.any(want % 2)                  # a duplicate never wins
