"""The rescoring rule of the ``vq_update`` and ``vq_assign`` CUDA kernels,
on the CPU.

The kernels share one scan (``src/repro_torch/kernels/csrc/vq_update.cuh``)
of the distances ``|c|^2 - 2 x.c`` on the tensor cores: the operands split
into TF32 hi + lo parts, three products accumulated onto ``|c|^2`` (m16n8k8
steps; at ``vq_assign``'s f 4 one 4-deep step of an m16n8k8 and an
m16n8k4).  It folds the approximate
distances over groups of codewords (a lane's columns of 2 tiles, or of 4 at
``vq_assign``'s f 4) and rescores the winning group's codewords exactly,
which gives u, an exact distance; no codeword of norm above ``norm_cap(|x|,
u)`` can then win, so the row's threshold is ``T = u + candidate_bound(|x|,
min(c_max, norm_cap))``.  A row whose runner-up group lies above T is
settled; any other row rescores every codeword with an approximate distance
of at most T.  The claim is that the assignment and qerr / want_min are
then the plain version's (``ref.vq_assign_update``, ``ref.vq_assign``) bit
for bit.  The card cannot run here, so this file emulates the scan in
plain torch -- the same split (fp32 mantissas masked to TF32's 10 bits), the
products summed in float64, and the tensor cores' accumulation error set
adversarially to the full allowance of the bound's model (the plain
version's winner pushed up, every other codeword down) -- with the same
bound and exact rescoring in index order, and holds it against the plain
version on hypothesis-generated and hand-built near-tie inputs.
"""
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as tref                   # noqa: E402
from repro_torch.kernels import vq_assign as tva              # noqa: E402
from repro_torch.kernels import vq_update as tvu              # noqa: E402
from repro_torch.kernels.vq_update import (TC_EPS,            # noqa: E402
                                           candidate_bound, norm_cap)

HEADER = Path(tva.__file__).resolve().parent / "csrc" / "vq_update.cuh"


def assign_scan(f: int) -> dict:
    """The shape of ``vq_assign``'s scan at width f (``Cfg`` in the header):
    the tiles a fold group."""
    return dict(group=4 if f == 4 else 2)


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """v truncated to TF32 (the low 13 mantissa bits cleared)."""
    return (v.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _tf32(v)
    return hi, _tf32(v - hi)          # v - hi is exact in fp32


def emulate_scan(x: torch.Tensor, cw: torch.Tensor, group: int = 2):
    """The kernel's two-stage scan with fold groups of ``group`` tiles: ->
    (idx [nb, n] int32, qerr [nb, n], candidates per row [nb, n], the
    largest |d~ - d| / E)."""
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
    # 8; ``group`` consecutive tiles make a group (tiles past the last
    # whole group and the tail tile stand alone), giving groups of a lane's
    # codewords.  The winning group's codewords (the lane's two columns of
    # its tiles) are rescored exactly: u, and the threshold T = u +
    # E(min(c_max, r(u))).  A row is settled when its second smallest group
    # minimum lies beyond T; a near-tie row rescores every candidate d~ <= T
    x_norm = torch.sqrt((x.double() ** 2).sum(-1)).float()     # [nb, n]
    c_norm = torch.sqrt(cn2)                                   # [nb, k]
    c_max = c_norm.max(dim=1).values[:, None]                  # [nb, 1]
    k = dt.shape[2]
    c = torch.arange(k)
    tile, lane = c // 8, (c % 8) // 2
    groups_end = (k // 8) // group * group
    first = torch.where(tile < groups_end, tile - tile % group, tile)
    key = first * 8 + 2 * lane                   # the group's first column
    keys, member = torch.unique(key, sorted=True, return_inverse=True)
    gmin = torch.full((*dt.shape[:2], len(keys)), float("inf")) \
        .scatter_reduce(2, member.expand_as(dt), dt, reduce="amin")
    top2 = torch.topk(gmin, min(2, gmin.shape[2]), dim=2,
                      largest=False).values
    runner_up = top2[..., 1] if gmin.shape[2] > 1 else torch.full_like(
        top2[..., 0], float("inf"))
    c0 = keys[torch.argmin(gmin, dim=2)]        # lowest first column on ties
    off = c[None, None, :] - c0[..., None]
    win = (off >= 0) & (off < 8 * group) & (off % 8 < 2)
    u = torch.where(win, d, torch.full_like(d, float("inf"))).min(-1).values
    # a runner-up that ties the minimum d~ cannot settle: such a row takes
    # u's bound min d~ + E(c_max) instead of the rescored group
    m1 = top2[..., 0]
    tie = ~(runner_up > m1)
    u = torch.where(tie, m1 + candidate_bound(x_norm, c_max, f), u)
    cm = torch.minimum(c_max, norm_cap(x_norm, u))
    e = candidate_bound(x_norm, cm, f)
    thr = u + e
    settled = ~tie & torch.isfinite(thr) & (runner_up > thr)
    cand = torch.where(settled[..., None], win, ~(dt > thr[..., None]))
    # the model's claim: every codeword of norm <= cm (so every one that
    # can win) has |d~ - d| <= E(cm)
    near = c_norm[:, None, :] <= cm[..., None]
    gap = (dt.double() - d.double()).abs() / e[..., None].double()
    ratio = float(torch.where(near, gap, torch.zeros_like(gap)).max())
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


def assert_assign_scan_exact(x, cw):
    """``vq_assign``'s scan at x's width: idx and want_min bit-equal to
    ``ref.vq_assign``; x may be any strided view."""
    f = x.shape[2]
    idx, qerr, cands, ratio = emulate_scan(x, cw, **assign_scan(f))
    want, wmin = tref.vq_assign(x, cw, want_min=True)
    assert ratio <= 1.0, f"|d~ - d| reached {ratio} x the bound"
    assert torch.equal(idx, want)
    assert torch.equal(qerr, wmin)
    assert bool((cands >= 1).all())
    return cands


def _branch_view(x):
    """[nb, n, f] -> the same values as the branch view of an [n, nb * f]
    table, as core/codebook.py hands them to vq_assign."""
    nb, n, f = x.shape
    table = torch.as_tensor(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(1, 0, 2).reshape(n, nb * f)))
    return table.reshape(n, nb, f).transpose(0, 1)


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


# ---------------------------------------------------------------------------
# vq_assign's scan: f 4 with its codewords' hi / lo parts staged, 4-deep
# k-steps and groups of 4 tiles, f 16 on m16n8k8 with groups of 2 tiles;
# rows read through the branch view of an [n, nb * f] table; idx and
# want_min against ref.vq_assign
# ---------------------------------------------------------------------------

def test_assign_scan_shapes_mirror_the_kernel():
    """The emulation's shapes are the header's: ``Cfg`` picks 4-deep
    k-steps and groups of 4 tiles at f 4 only, and the wrapper's kstep
    mirrors the depth."""
    src = HEADER.read_text()
    assert "static constexpr int KSTEP = F == 4 ? 4 : 8;" in src
    assert "static constexpr int GT = F == 4 ? 4 : 2;" in src
    assert [tva.kstep(f) for f in (4, 8, 16, 21)] == [4, 8, 8, 8]


@pytest.mark.parametrize("f", [4, 16])
@pytest.mark.parametrize("k", [16, 256, 1024])
def test_assign_scan_exact_on_near_ties(f, k):
    x, cw = _near_tie_case(2, 150, k, f, seed=3 * f + k)
    assert_assign_scan_exact(_branch_view(x), torch.as_tensor(cw))


@pytest.mark.parametrize("f", [4, 16])
def test_assign_scan_exact_with_small_codewords_and_large_rows(f):
    x, cw = _near_tie_case(2, 120, 256, f, seed=f, scale=1e-3)
    assert_assign_scan_exact(_branch_view(x * 1e3), torch.as_tensor(cw))


@pytest.mark.parametrize("f", [4, 16])
def test_assign_scan_exact_when_every_row_is_alike(f):
    x, cw = _near_tie_case(3, 1, 1024, f, seed=11 + f)
    assert_assign_scan_exact(_branch_view(np.repeat(x, 200, axis=1)),
                             torch.as_tensor(cw))


@pytest.mark.parametrize("k", [16, 1001])
def test_assign_scan_exact_with_duplicated_codewords_and_equidistant_rows(k):
    """Every codeword twice (the lower index must win) and rows exactly
    halfway between two codewords, at f 4 where such ties are common."""
    rng = np.random.default_rng(k)
    cw = rng.standard_normal((2, k, 4)).astype(np.float32)
    cw[:, 1::2] = cw[:, 0::2][:, :cw[:, 1::2].shape[1]]
    a, b = rng.integers(0, k, (2, 2, 300))
    pa = np.take_along_axis(cw, a[..., None], 1)
    pb = np.take_along_axis(cw, b[..., None], 1)
    x = (0.5 * (pa + pb)).astype(np.float32)
    assert_assign_scan_exact(_branch_view(x), torch.as_tensor(cw))


def test_assign_scan_prunes_on_random_rows():
    """Random rows are settled with the winning group's 8 (f 4) or 4 (f
    16) codewords rescored: the rescoring stays a small share of the
    scan."""
    rng = np.random.default_rng(1)
    for f in (4, 16):
        x = rng.standard_normal((2, 500, f)).astype(np.float32)
        cw = rng.standard_normal((2, 1024, f)).astype(np.float32)
        cands = assert_assign_scan_exact(_branch_view(x),
                                         torch.as_tensor(cw))
        assert float(cands.float().mean()) < 8.2


@settings(max_examples=40, deadline=None)
@given(f=st.sampled_from([4, 16]), k=st.sampled_from([16, 256, 1024]),
       n=st.integers(1, 24), seed=st.integers(0, 2 ** 31 - 1),
       exp=st.integers(-12, 12), dup=st.booleans(), data=st.data())
def test_assign_scan_exact_hypothesis(f, k, n, seed, exp, dup, data):
    rng = np.random.default_rng(seed)
    cw = rng.standard_normal((1, k, f)).astype(np.float32) * np.float32(
        2.0 ** exp)
    if dup:
        cw[0, k - 1] = cw[0, 0]                       # the lowest must win
        cw[0, k // 2] = cw[0, 1]
    row = data.draw(st.lists(_floats, min_size=f, max_size=f))
    x = np.empty((1, n, f), np.float32)
    x[0, 0] = row
    x[0, 1:] = cw[0, rng.integers(0, k, n - 1)] \
        + rng.standard_normal((n - 1, f)).astype(np.float32) * np.float32(
            2.0 ** (exp - 20))
    assert_assign_scan_exact(_branch_view(x), torch.as_tensor(cw))


def _clustered_case(nb, n, k, f, seed):
    """Codewords in tight clusters of 8 with rows inside them, as trained
    codebooks hold them, and one in 32 scaled 15x out, far from every row."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((nb, k // 8, f)).astype(np.float32)
    cw = np.repeat(centres, 8, axis=1) + 0.05 * rng.standard_normal(
        (nb, k, f)).astype(np.float32)
    cw[:, 7::32] *= 15.0
    pick = rng.integers(0, k // 8, (nb, n))
    x = np.take_along_axis(centres, pick[..., None], 1) + 0.05 * \
        rng.standard_normal((nb, n, f)).astype(np.float32)
    return x.astype(np.float32), cw.astype(np.float32)


@pytest.mark.parametrize("f", [8, 21, 4, 16])
def test_scan_exact_and_pruned_next_to_far_out_codewords(f):
    """The few far-out codewords of a trained codebook must not widen every
    row's band: the threshold uses the norms that can win (``norm_cap``),
    so most rows stay settled -- a settled row rescores only its winning
    group -- and the answer stays exact."""
    x, cw = _clustered_case(2, 300, 256, f, seed=5 * f)
    if f in (4, 16):
        cands = assert_assign_scan_exact(_branch_view(x),
                                         torch.as_tensor(cw))
        group = assign_scan(f)["group"]
    else:
        cands = assert_scan_exact(x, cw)
        group = 2
    assert float((cands <= 2 * group).float().mean()) > 0.9


# ---------------------------------------------------------------------------
# the wide build (f > 32, or a codebook beyond the narrow build's shared
# memory): codewords streamed in tiles, each row's smallest d~, its
# codeword and the runner-up over every other codeword; the winner
# rescored exactly gives u, and the wide bound (the plain version's own
# rounding at width f added) settles the row or queues it for the
# rescoring of every candidate
# ---------------------------------------------------------------------------

WIDE_HEADER = HEADER.read_text()


def emulate_wide_scan(x: torch.Tensor, cw: torch.Tensor):
    """The wide build's scan with the tensor cores' error set adversarially
    (as in :func:`emulate_scan`): -> (idx, qerr, candidates per row, the
    largest |d~ - d| / E)."""
    nb, n, f = x.shape
    n_mma = 3 * -(-f // 8)
    cn2 = tref._sq_norms(cw)
    ah, al = _split(-2.0 * x)
    bh, bl = _split(cw)

    def mm(a, b):
        return torch.einsum("bnf,bkf->bnk", a.double(), b.double())
    exact_sum = cn2[:, None, :].double() + mm(al, bh) + mm(ah, bl) \
        + mm(ah, bh)
    mag = cn2[:, None, :].double() + 2.0 * mm((2.0 * x).abs(), cw.abs())
    # the wgmma accumulation's allowance: n_mma + WIDE_TC_EXTRA units
    allowance = (n_mma + tvu.WIDE_TC_EXTRA) * TC_EPS * mag
    dot = torch.zeros((nb, n, cw.shape[1]), dtype=torch.float32)
    for j in range(f):
        dot = dot + x[:, :, j, None] * cw[:, None, :, j]
    d = cn2[:, None, :] - 2.0 * dot
    win = torch.argmin(d, dim=2, keepdim=True)
    sign = -torch.ones_like(d, dtype=torch.float64)
    sign.scatter_(2, win, 1.0)
    dt = (exact_sum + sign * allowance).float()                # d~
    k = dt.shape[2]
    # per row: the smallest d~ and its (lowest) codeword, the runner-up
    top2 = torch.topk(dt, min(2, k), dim=2, largest=False).values
    m2 = top2[..., 1] if k > 1 else torch.full_like(top2[..., 0],
                                                    float("inf"))
    i1 = torch.argmin(dt, dim=2)
    u = d.gather(2, i1[..., None])[..., 0]
    x_norm = torch.sqrt(tref._sq_norms(x))
    c_norm = torch.sqrt(cn2)
    c_max = c_norm.max(dim=1).values[:, None]
    cm = torch.minimum(c_max, norm_cap(x_norm, u, wide=True))
    e = candidate_bound(x_norm, cm, f, wide=True)
    thr = u + e
    settled = torch.isfinite(thr) & (m2 > thr)
    one = torch.zeros_like(d, dtype=torch.bool).scatter_(2, i1[..., None],
                                                          True)
    cand = torch.where(settled[..., None], one, ~(dt > thr[..., None]))
    near = c_norm[:, None, :] <= cm[..., None]
    gap = (dt.double() - d.double()).abs() / e[..., None].double()
    ratio = float(torch.where(near, gap, torch.zeros_like(gap)).max())
    rescored = torch.where(cand, d, torch.full_like(d, float("inf")))
    idx = torch.argmin(rescored, dim=2)
    best = rescored.gather(2, idx[..., None])[..., 0]
    qerr = torch.clamp(best + tref._sq_norms(x), min=0.0)
    return idx.to(torch.int32), qerr, cand.sum(-1), ratio


def assert_wide_scan_exact(x, cw):
    """idx and qerr bit-equal to ``ref.vq_assign_update``, and idx and
    want_min to ``ref.vq_assign`` on x's branch view."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    cw = torch.as_tensor(np.asarray(cw, np.float32))
    idx, qerr, cands, ratio = emulate_wide_scan(x, cw)
    assert ratio <= 1.0, f"|d~ - d| reached {ratio} x the bound"
    want = tref.vq_assign_update(x, cw)
    assert torch.equal(idx, want[0])
    assert torch.equal(qerr, want[1])
    widx, wmin = tref.vq_assign(_branch_view(x), cw, want_min=True)
    assert torch.equal(idx, widx) and torch.equal(qerr, wmin)
    assert bool((cands >= 1).all())
    return cands


def test_wide_build_mirrors_the_header():
    """The wrapper's bound, margins, scratch and shared-memory plan are the
    header's."""
    assert "(float)(3 * ks_n + 9 + (2 * f + 3 + 15) / 16) * kEpsBound" \
        in WIDE_HEADER
    assert 6 + tvu.WIDE_TC_EXTRA == 9
    assert "constexpr float kWideUp = 1.000244140625f;" in WIDE_HEADER
    assert 1.000244140625 == tvu.WIDE_UP
    assert f"constexpr int kWideMaxF = {tvu.WIDE_MAX_F};" in WIDE_HEADER
    assert f"constexpr int kWideBN = {tvu.WIDE_BN};" in WIDE_HEADER
    assert f"constexpr int kWideMinStages = {tvu.WIDE_MIN_STAGES};" \
        in WIDE_HEADER
    assert f"constexpr int kWideMaxStages = {tvu.WIDE_MAX_STAGES};" \
        in WIDE_HEADER
    assert f"constexpr int kWideMaxKC = {tvu.WIDE_MAX_KC};" in WIDE_HEADER
    for bm in (64, 128):
        assert f"sizeof(WideMisc<{bm}>) == {tvu.wide_misc_bytes(bm)}" \
            in WIDE_HEADER
    # every width the wide build takes has a plan at 64-row tiles, the
    # widest with its rows a chunk at a time; the rows split once up to
    # f 392 at 64-row tiles and f 192 at 128; 128-row tiles reach f 360
    for f in range(1, tvu.WIDE_MAX_F + 1):
        for wgs in (1, 2):
            plan = tvu.wide_plan(f, wgs)
            if plan is None:
                assert wgs == 2 and f > 360
                continue
            ares, kc, stages, smem = plan
            assert smem <= tvu.SMEM_LIMIT and stages >= tvu.WIDE_MIN_STAGES
            assert kc % 8 == 0 and 8 <= kc <= min(tvu.wide_fp(f),
                                                 tvu.WIDE_MAX_KC)
            assert ares == (f <= (392 if wgs == 1 else 192))
    # the widest plan of each kind fits, one more column does not
    assert tvu.wide_smem_bytes(392, 1, True, 8, 3) <= tvu.SMEM_LIMIT \
        < tvu.wide_smem_bytes(400, 1, True, 8, 3)
    assert tvu.wide_smem_bytes(440, 1, False, 8, 3) <= tvu.SMEM_LIMIT
    assert tvu.wide_plan(65, 2) == (True, 48, 3, 230656)
    assert tvu.wide_plan(256, 1) == (True, 24, 3, 210432)


@pytest.mark.parametrize("nb,k,f", [(4, 1024, 65), (1, 1, 33), (2, 129, 440),
                                    (3, 37, 43), (1, 1000, 256)])
def test_wide_scratch_size_and_padding(nb, k, f):
    """The scratch a wide launch needs: the counter, |c|^2 of k_pad
    codewords (+inf past k) and their hi / lo parts over f_pad columns
    (zeros past k and f), every tile and K chunk 16-byte aligned."""
    kp, fp = tvu.wide_kpad(k), tvu.wide_fp(f)
    assert kp % tvu.WIDE_BN == 0 and k <= kp < k + tvu.WIDE_BN
    assert fp % 8 == 0 and f <= fp < f + 8
    assert tvu.wide_scratch_floats(nb, k, f) == 4 + nb * kp * (1 + 2 * fp)
    rng = np.random.default_rng(nb + k + f)
    cw = torch.as_tensor(rng.standard_normal((nb, k, f)).astype(np.float32))
    lay = tvu.wide_split_layout(cw)
    assert lay.numel() + 4 == tvu.wide_scratch_floats(nb, k, f)
    cn2 = lay[:nb * kp].reshape(nb, kp)
    assert torch.equal(cn2[:, :k], tref._sq_norms(cw))
    assert bool(torch.isinf(cn2[:, k:]).all())
    parts = lay[nb * kp:].reshape(nb, kp // tvu.WIDE_BN, 2, tvu.WIDE_BN, fp)
    # a tile's parts and each 4-column slab start on 16 bytes
    assert (4 + nb * kp) % 4 == 0 and (tvu.WIDE_BN * fp) % 4 == 0
    dense = _from_layout(parts)
    assert bool((dense[:, :, k:] == 0).all())
    assert bool((dense[..., f:] == 0).all())


def _from_layout(parts: torch.Tensor) -> torch.Tensor:
    """[nb, tiles, 2, 128, f_pad] in the kernel's slab order -> [nb, 2,
    k_pad, f_pad] by codeword and column (``wide_split_off`` inverted)."""
    nb, tiles, _, bn, fp = parts.shape
    v = parts.reshape(nb, tiles, 2, fp // 4, bn // 8, 8, 4)
    v = v.permute(0, 2, 1, 4, 5, 3, 6)             # nb, 2, tile, g, c8, j4
    return v.reshape(nb, 2, tiles * bn, fp)


@pytest.mark.parametrize("f", [33, 43, 65, 168, 256])
def test_wide_split_layout_is_the_emulations_split(f):
    """The prologue's hi / lo parts are the emulation's ``_split`` of the
    codewords (TF32 truncation, lo of the exact remainder), laid out at
    the header's ``wide_split_off``: codeword c, column j of branch b at
    tile c / 128, slab j / 4, core matrix (c % 128) / 8, lane (c % 8) * 4 +
    j % 4."""
    nb, k = 2, 300
    rng = np.random.default_rng(f)
    cw = torch.as_tensor((rng.standard_normal((nb, k, f)) * np.exp(
        rng.uniform(-8, 8, (nb, k, 1)))).astype(np.float32))
    kp, fp = tvu.wide_kpad(k), tvu.wide_fp(f)
    lay = tvu.wide_split_layout(cw)
    parts = lay[nb * kp:].reshape(nb, -1)
    hi, lo = _split(cw)
    for b, c, j in [(0, 0, 0), (1, 299, f - 1), (0, 130, 5), (1, 7, f // 2),
                    (0, 255, 3), (1, 128, 4)]:
        off = (c // 128) * 2 * 128 * fp \
            + ((j // 4) * 16 + (c % 128) // 8) * 32 + (c % 8) * 4 + j % 4
        assert parts[b, off].view(torch.int32) == hi[b, c, j].view(
            torch.int32)
        assert parts[b, off + 128 * fp].view(torch.int32) == lo[b, c, j].view(
            torch.int32)
    dense = _from_layout(lay[nb * kp:].reshape(nb, kp // 128, 2, 128, fp))
    assert torch.equal(dense[:, 0, :k, :f].view(torch.int32),
                       hi.view(torch.int32))
    assert torch.equal(dense[:, 1, :k, :f].view(torch.int32),
                       lo.view(torch.int32))


@pytest.mark.parametrize("k,f,wide", [(1024, 32, False), (1024, 21, False),
                                      (1024, 33, True), (1024, 65, True),
                                      (4096, 32, True), (2641, 21, False),
                                      (2642, 21, True), (1, 440, True)])
def test_wide_dispatch(k, f, wide):
    """Both kernels take the wide build past f 32 or where the narrow
    build's codebook would not fit; no build takes f > 440."""
    assert tvu.uses_wide(k, f) == wide
    assert tva.uses_wide(k, f) == (wide or tva.smem_bytes(k, f)
                                   > tvu.SMEM_LIMIT)
    tvu.check_width("vq_update", k, f)
    with pytest.raises(ValueError, match="outside"):
        tvu.check_width("vq_update", k, tvu.WIDE_MAX_F + 1)


@pytest.mark.parametrize("f", [43, 65, 168, 256, 440])
def test_wide_bound_covers_the_plain_rounding(f):
    """E at the wide widths: 3 ceil(f / 8) accumulations as in the narrow
    build and ``WIDE_TC_EXTRA`` more for wgmma's accumulation, plus
    ceil((2f + 3) / 16) for the plain version's rounding ((2f + 3) 2^-24
    (|c|^2 + 2X), the header's (iii)); the allowance then covers (i) + (ii)
    + (iii) with room.  The norm cap's margins cover rho = (2f + 3)
    2^-24."""
    n_mma = 3 * -(-f // 8)
    tc = n_mma + tvu.WIDE_TC_EXTRA
    coef = candidate_bound(0.0, 1.0, f, wide=True) / TC_EPS
    assert coef == pytest.approx(tc + 6 + -(-(2 * f + 3) // 16))
    assert candidate_bound(0.0, 1.0, f) / TC_EPS == pytest.approx(n_mma + 6)
    # per unit of 2^-20: |c|^2 terms and X terms, (i) + (ii) + (iii)
    rounding = (2 * f + 3) / 16
    assert tc + rounding <= coef
    assert 4.02 * tc + 6.02 + 2 * rounding <= 4 * coef
    rho = (2 * f + 3) * 2.0 ** -24
    for xn, u in [(1.0, -0.5), (3.0, 2.0), (1e3, -1e6 + 1.0), (0.0, 5.0)]:
        exact = ((1 + rho) * xn + np.sqrt((1 + rho) ** 2 * xn ** 2
                                          + (1 - rho) * u)) / (1 - rho)
        cap = float(norm_cap(torch.tensor(xn, dtype=torch.float32),
                             torch.tensor(u, dtype=torch.float32),
                             wide=True))
        assert cap >= exact


@pytest.mark.parametrize("f", [43, 65, 168, 256])
@pytest.mark.parametrize("k", [37, 1024])
def test_wide_scan_exact_on_near_ties(f, k):
    assert_wide_scan_exact(*_near_tie_case(2, 120, k, f, seed=f * k))


@pytest.mark.parametrize("f", [65, 256])
def test_wide_scan_exact_with_small_codewords_and_large_rows(f):
    x, cw = _near_tie_case(2, 100, 256, f, seed=f, scale=1e-3)
    assert_wide_scan_exact(x * 1e3, cw)


@pytest.mark.parametrize("f", [65, 256])
def test_wide_scan_exact_when_every_row_is_alike(f):
    x, cw = _near_tie_case(2, 1, 256, f, seed=3 + f)
    assert_wide_scan_exact(np.repeat(x, 100, axis=1), cw)


@pytest.mark.parametrize("f", [43, 65, 168, 256])
def test_wide_scan_candidates_stay_in_the_cluster(f):
    """Rows inside clusters of 8 codewords, with far-out codewords beside
    (a trained codebook): as f grows E outgrows the gaps inside a cluster
    and most rows queue, but a queued row's candidates stay inside its
    cluster -- the norm cap keeps the far-out codewords out -- and the
    answer stays exact."""
    x, cw = _clustered_case(2, 200, 256, f, seed=7 * f)
    cands = assert_wide_scan_exact(x, cw)
    assert int(cands.max()) <= 8


@pytest.mark.parametrize("f", [43, 65, 168, 256])
def test_wide_scan_settles_random_rows(f):
    """On rows with no planted ties nearly every row settles with its
    winner alone rescored: the queue's second pass stays rare."""
    rng = np.random.default_rng(f)
    x = rng.standard_normal((2, 300, f)).astype(np.float32)
    cw = rng.standard_normal((2, 1024, f)).astype(np.float32)
    cands = assert_wide_scan_exact(x, cw)
    assert float((cands == 1).float().mean()) > 0.95


@settings(max_examples=30, deadline=None)
@given(f=st.integers(33, 300), k=st.integers(1, 40), n=st.integers(1, 16),
       seed=st.integers(0, 2 ** 31 - 1), exp=st.integers(-12, 12),
       dup=st.booleans())
def test_wide_scan_exact_hypothesis(f, k, n, seed, exp, dup):
    rng = np.random.default_rng(seed)
    cw = rng.standard_normal((1, k, f)).astype(np.float32) * np.float32(
        2.0 ** exp)
    if dup and k > 1:
        cw[0, k - 1] = cw[0, 0]                       # the lowest must win
    x = cw[0, rng.integers(0, k, n)][None] \
        + rng.standard_normal((1, n, f)).astype(np.float32) * np.float32(
            2.0 ** (exp - 20))
    assert_wide_scan_exact(x.astype(np.float32), cw)
