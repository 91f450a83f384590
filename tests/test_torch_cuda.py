"""The hand-written CUDA kernels of the PyTorch port against their plain
PyTorch versions, on a CUDA card.  Every test here needs the card (marker
``gpu``) and skips without one: a CUDA kernel has no CPU mode.  The file
imports neither JAX nor ``repro`` so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The kernels keep their plain versions' summation order, so values agree
well inside ``rtol=1e-5, atol=1e-6``; assignments are equal except at
near-ties of ``1e-5 * (1 + |d|)``.  The scatter-adds (``vq_update``'s
cluster sums, ``spmm_ell_t``) use atomics in no fixed order: a sum of
``c`` terms may move by ``c * 2^-24 * sum |term|``, which
:func:`assert_scatter_close` allows.  One ``vq_train_step`` on the card
and one link step are held against the same step on the CPU at
``rtol=1e-4, atol=1e-5``.

The LM side's attention kernels stream their keys with an online softmax,
so they agree with the plain two-pass softmax to ``rtol=1e-5, atol=1e-6``
in f32 and to two bf16 units in the last place in bf16 (both round the
same f32 result, which differs in its last bits).  LM decode on the card
is held against the CPU at ``rtol=1e-4, atol=1e-4`` with equal codebook
counts.  LM training launches no hand-written kernel (the reference's
training path is plain JAX): ``vq_attention_train``, ``train_loss`` and a
train step run on the card against the CPU, with the tolerances each test
states.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

from repro_torch.kernels import context_ell as tce           # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.kernels import ref as tref                  # noqa: E402
from repro_torch.kernels import spmm_ell as tsp              # noqa: E402
from repro_torch.kernels import vq_assign as tva             # noqa: E402
from repro_torch.kernels import vq_update as tvu             # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
STEP = dict(rtol=1e-4, atol=1e-5)
LM_STEP = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: a CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def assert_assign_equal_but_near_ties(got, want, x, cw):
    """got/want [nb, b] against x [nb, b, f], cw [nb, k, f] (numpy); returns
    the mismatch rate."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    x64, c64 = x.astype(np.float64), cw.astype(np.float64)
    d = (c64 * c64).sum(-1)[:, None, :] - 2 * np.einsum('nbf,nkf->nbk',
                                                         x64, c64)
    d_got = np.take_along_axis(d, got[..., None].astype(np.int64), 2)[..., 0]
    d_want = np.take_along_axis(d, want[..., None].astype(np.int64),
                                2)[..., 0]
    diff = got != want
    near = np.abs(d_got - d_want) <= 1e-5 * (1 + np.abs(d_want))
    assert np.all(near[diff]), f"{diff.sum()} non-tie mismatches"
    return diff.mean()


def assert_scatter_close(got, want, terms_abs, terms):
    """A scatter-add's result against its plain version: each element may
    move by ``terms * 2^-24 * sum |term|`` (any order of fp32 adds),
    plus 1e-30 for exact zeros."""
    got, want = np.asarray(got), np.asarray(want)
    tol = np.maximum(np.asarray(terms), 1) * 2.0 ** -24 \
        * np.asarray(terms_abs) + 1e-30
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{bad.sum()} elements off by up to "
                           f"{np.abs(got - want).max()}")


# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("nb,n,k,f", [(32, 5000, 1024, 4), (8, 3000, 1024, 16),
                                      (3, 130, 33, 12), (1, 1, 1, 1),
                                      (2, 700, 64, 8)])
def test_vq_assign_kernel_vs_plain(cuda, nb, n, k, f):
    """The index bit-equal to the plain version's on the same card, read
    through the branch view of an [n, nb * f] table."""
    g = torch.Generator().manual_seed(n + k)
    table = torch.randn((n, nb * f), generator=g)
    cw = torch.randn((nb, k, f), generator=g)
    x = table.to(cuda).reshape(n, nb, f).transpose(0, 1)   # strided view
    before = tva.launches
    got = tva.vq_assign_cuda(x, cw.to(cuda))
    torch.cuda.synchronize()
    assert tva.launches == before + 1
    want = tref.vq_assign(table.reshape(n, nb, f).transpose(0, 1), cw)
    assert torch.equal(got.cpu(), want), \
        f"{int((got.cpu() != want).sum())} assignments differ"


@pytest.mark.gpu
@pytest.mark.parametrize("nb,n,k,f", [(32, 5000, 1024, 4), (8, 3000, 1024, 16),
                                      (1, 7, 3, 5), (1, 130, 33, 12),
                                      (1, 100, 300, 8)])
def test_vq_assign_kernel_want_min_vs_plain(cuda, nb, n, k, f):
    """The kernel's ``want_min`` output and its index, both bit-equal to
    the plain version's; the index is the one without it."""
    g = torch.Generator().manual_seed(n + k + f)
    x = torch.randn((nb, n, f), generator=g)
    cw = torch.randn((nb, k, f), generator=g)
    got, gmin = tva.vq_assign_cuda(x.to(cuda), cw.to(cuda), want_min=True)
    torch.cuda.synchronize()
    want, wmin = tref.vq_assign(x, cw, want_min=True)
    assert torch.equal(got, tva.vq_assign_cuda(x.to(cuda), cw.to(cuda)))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(gmin.cpu(), wmin)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [4, 16, 8, 12])
@pytest.mark.parametrize("n,k", [(5003, 1024), (777, 1001), (130, 37),
                                 (300, 256), (64, 16)])
def test_vq_assign_near_ties_bit_equal(cuda, f, n, k):
    """Duplicated codewords (the lowest index must win), 1-ulp neighbours,
    rows on a codeword, rows equidistant from two, large-norm rows, read
    through the branch view of an [n, nb * f] table: index and want_min
    bit-equal to the plain version at the served widths and two generic
    ones, n and k off the kernel's tiles."""
    x, cw = _near_tie_codebook(3, n, k, f, n + k + f, cuda)
    table = x.transpose(0, 1).reshape(n, 3 * f).contiguous()
    xv = table.reshape(n, 3, f).transpose(0, 1)
    got, gmin = tva.vq_assign_cuda(xv, cw, want_min=True)
    want, wmin = tref.vq_assign(xv, cw, want_min=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want), \
        f"{int((got != want).sum())} assignments differ"
    assert torch.equal(gmin, wmin)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [4, 16])
def test_vq_assign_every_row_equidistant_or_alike(cuda, f):
    """Every codeword twice and every row exactly halfway between two
    codewords, or every row alike: all rows queue for rescoring."""
    g = torch.Generator().manual_seed(f)
    cw = torch.randn((2, 512, f), generator=g)
    cw[:, 1::2] = cw[:, 0::2]
    a = torch.randint(0, 512, (2, 4000), generator=g)
    b = torch.randint(0, 512, (2, 4000), generator=g)
    x = 0.5 * (torch.gather(cw, 1, a[..., None].expand(2, 4000, f))
               + torch.gather(cw, 1, b[..., None].expand(2, 4000, f)))
    x[:, 2000:] = x[:, :1]
    for xs in (x, x[:, :, :].contiguous() * 1e3):
        got, gmin = tva.vq_assign_cuda(xs.to(cuda), cw.to(cuda),
                                       want_min=True)
        want, wmin = tref.vq_assign(xs, cw, want_min=True)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(gmin.cpu(), wmin)
        assert not bool((want % 2).any())        # a duplicate never wins


@pytest.mark.gpu
@pytest.mark.parametrize("b,deg,n,f", [(256, 18, 256, 128), (33, 7, 50, 12),
                                       (1, 1, 1, 1), (300, 0, 20, 8)])
def test_spmm_ell_kernel_vs_plain(cuda, b, deg, n, f):
    g = torch.Generator().manual_seed(b + deg)
    idx = torch.randint(0, n, (b, deg), generator=g, dtype=torch.int32)
    val = torch.randn((b, deg), generator=g)
    x = torch.randn((n, f), generator=g)
    got = tsp.spmm_ell_cuda(idx.to(cuda), val.to(cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tref.spmm_ell(idx, val, x))


@pytest.mark.gpu
@pytest.mark.parametrize("b,deg,n,nb,k,f_blk", [
    (256, 18, 5000, 32, 1024, 4), (256, 18, 5000, 8, 1024, 16),
    (33, 7, 50, 4, 16, 8), (1, 1, 1, 1, 1, 1), (5, 0, 10, 4, 8, 8)])
def test_context_ell_kernel_vs_plain(cuda, b, deg, n, nb, k, f_blk):
    g = torch.Generator().manual_seed(b + nb)
    ids = torch.randint(0, n, (b, deg), generator=g, dtype=torch.int32)
    val = torch.randn((b, deg), generator=g)
    assign = torch.randint(0, k, (nb, n), generator=g, dtype=torch.int32)
    cw = torch.randn((nb, k, f_blk), generator=g)
    before = tce.launches
    got = tce.context_ell_cuda(*(t.to(cuda) for t in (ids, val, assign, cw)))
    assert tce.launches == before + (deg > 0)
    assert_allclose(got.cpu().numpy(),
                    tref.context_ell(ids, val, assign, cw).numpy(), **TOL)


@pytest.mark.gpu
def test_kernel_wrappers_reject_bad_operands(cuda):
    idx = torch.zeros((4, 2), dtype=torch.int64, device=cuda)
    val = torch.zeros((4, 2), device=cuda)
    x = torch.zeros((6, 8), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        tsp.spmm_ell_cuda(idx, val, x)
    with pytest.raises(ValueError, match="contiguous"):
        tsp.spmm_ell_cuda(idx.int(), val, x.t())
    with pytest.raises(ValueError, match="outside"):
        tva.vq_assign_cuda(torch.zeros((1, 4, 441), device=cuda),
                           torch.zeros((1, 16, 441), device=cuda))


# ---------------------------------------------------------------------------
# the training slice's kernels
# ---------------------------------------------------------------------------

def _vq_update_case(cuda, nb, n, k, f, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((nb, n, f), generator=g)
    cw = torch.randn((nb, k, f), generator=g)
    before = tvu.launches
    got = tvu.vq_assign_update_cuda(x.to(cuda), cw.to(cuda))
    torch.cuda.synchronize()
    assert tvu.launches == before + 1
    got = [t.cpu() for t in got]
    want = tref.vq_assign_update(x, cw)
    assert [t.dtype for t in got] == [t.dtype for t in want]
    assert [t.shape for t in got] == [t.shape for t in want]
    rate = assert_assign_equal_but_near_ties(got[0], want[0], x.numpy(),
                                             cw.numpy())
    assert rate <= 1e-3
    same = (got[0] == want[0]).numpy()
    # same order, each step rounded: qerr bit-equal where idx agrees
    assert np.array_equal(got[1].numpy()[same], want[1].numpy()[same])
    if same.all():
        assert torch.equal(got[2], want[2])               # counts exact
        flat = (want[0].long() + k * torch.arange(nb)[:, None]).reshape(-1)
        terms_abs = torch.zeros((nb * k, f)).index_add_(
            0, flat, x.abs().reshape(-1, f)).reshape(nb, k, f)
        assert_scatter_close(got[3], want[3], terms_abs,
                             want[2][..., None].numpy())
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("nb,n,k,f", [(32, 5000, 1024, 8), (8, 3000, 1024, 21),
                                      (3, 130, 33, 12), (2, 700, 64, 5),
                                      (1, 1, 1, 1), (4, 1, 16, 21)])
def test_vq_update_kernel_vs_plain(cuda, nb, n, k, f):
    """Both training widths (8 and the odd 21), a generic width, b = 1."""
    _vq_update_case(cuda, nb, n, k, f, seed=n + k + f)


@pytest.mark.gpu
def test_vq_update_dynamic_shared_memory(cuda):
    """k = 2048 codewords of width 21 take 180 KiB of shared memory per
    block (the opt-in above 48 KiB); a table too large for that takes the
    wide build, and a width no build takes is refused."""
    _vq_update_case(cuda, 2, 1000, 2048, 21, seed=5)
    before = tvu.launches_wide
    _vq_update_case(cuda, 1, 300, 4096, 32, seed=6)
    assert tvu.launches_wide == before + 1
    with pytest.raises(ValueError, match="outside"):
        tvu.vq_assign_update_cuda(torch.zeros((1, 4, 441), device=cuda),
                                  torch.zeros((1, 16, 441), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("nb,n,k,f", [(32, 5000, 1024, 8),
                                      (8, 3000, 1024, 21)])
def test_vq_update_generic_matches_fixed_width(cuda, nb, n, k, f):
    """The generic-width instantiation (timed against the fixed-width
    builds) computes the same function, and is not counted as a launch;
    on rows whose fp32 sums are exact in any order both sums are exact."""
    g = torch.Generator().manual_seed(f)
    x = ((torch.randn((nb, n, f), generator=g) * 64).round() / 64).to(cuda)
    cw = torch.randn((nb, k, f), generator=g).to(cuda)
    fixed = tvu.vq_assign_update_cuda(x, cw)
    before = tvu.launches
    generic = tvu.vq_assign_update_generic_cuda(x, cw)
    assert tvu.launches == before
    for a, b in zip(fixed, generic):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_vq_update_hot_spot(cuda):
    """Every row on one codeword (the early-training hot spot): counts
    exact, sums within the scatter tolerance."""
    x = torch.rand((4, 20000, 8)) + 3.0
    cw = torch.zeros((4, 64, 8))
    cw[:, 7] = 3.5
    got = [t.cpu() for t in tvu.vq_assign_update_cuda(x.to(cuda),
                                                      cw.to(cuda))]
    assert (got[0] == 7).all()
    assert (got[2][:, 7] == 20000).all() and got[2].sum() == 4 * 20000
    want = tref.vq_assign_update(x, cw)
    assert_scatter_close(got[3], want[3], want[3].abs(),
                         want[2][..., None].numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("b,deg,n_src,f", [(256, 18, 256, 128),
                                           (33, 7, 50, 12), (1, 1, 1, 1),
                                           (300, 0, 20, 8)])
def test_spmm_ell_t_kernel_vs_plain(cuda, b, deg, n_src, f):
    g = torch.Generator().manual_seed(b + deg + f)
    idx = torch.randint(0, n_src, (b, deg), generator=g, dtype=torch.int32)
    val = torch.randn((b, deg), generator=g)
    pad = torch.rand((b, deg), generator=g) < 0.5      # val 0 at row 0
    idx[pad], val[pad] = 0, 0.0
    gr = torch.randn((b, f), generator=g)
    before = tsp.launches_t
    got = tsp.spmm_ell_t_cuda(idx.to(cuda), val.to(cuda), gr.to(cuda), n_src)
    torch.cuda.synchronize()
    assert tsp.launches_t == before + (deg > 0)
    want = tref.spmm_ell_t(idx, val, gr, n_src)
    terms = tref.spmm_ell_t(idx, (val != 0).float(), torch.ones_like(gr),
                            n_src)
    assert_scatter_close(got.cpu(), want,
                         tref.spmm_ell_t(idx, val.abs(), gr.abs(), n_src),
                         terms)


def _spmm_t_case(b, deg, n_src, f, form, seed):
    """idx / val / g for spmm_ell_t: half the slots padding (val 0 at row
    0); ``hub``: half the live slots name one row; ``padding_rows``: every
    other row of g all padding, with inf / NaN in g there."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, n_src, (b, deg), generator=g, dtype=torch.int32)
    val = torch.randn((b, deg), generator=g)
    pad = torch.rand((b, deg), generator=g) < 0.5
    idx[pad], val[pad] = 0, 0.0
    gr = torch.randn((b, f), generator=g)
    if form == "hub":
        live = (val != 0).nonzero(as_tuple=True)
        pick = torch.arange(live[0].numel()) % 2 == 0
        idx[live[0][pick], live[1][pick]] = n_src // 2
    if form == "padding_rows":
        idx[0::2], val[0::2] = 0, 0.0
        gr[0::4] = float("inf")
        gr[2::4] = float("nan")
    return idx, val, gr


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["random", "hub", "unaligned",
                                  "padding_rows"])
@pytest.mark.parametrize("f", [1, 12, 40, 128, 130])
def test_spmm_ell_t_forms_and_widths(cuda, form, f):
    """The warp-per-row scatter at every column mapping (1, 2, 4 and 8
    columns a lane; f 130 in two passes, f 1 / 130 scalar reductions), with
    a hub row taking half the live slots, a g whose storage offset leaves
    its rows unaligned, and rows of padding only, whose non-finite g the
    kernel never reads (the plain version's 0 * inf is NaN there, so those
    rows are held out of its g)."""
    b, deg, n_src = 700, 18, 500
    idx, val, gr = _spmm_t_case(b, deg, n_src, f, form, f)
    g_dev = gr.to(cuda)
    if form == "unaligned":
        buf = torch.empty(gr.numel() + 1, device=cuda)
        g_dev = buf[1:].view(b, f)
        g_dev.copy_(gr)
        assert g_dev.is_contiguous() and g_dev.data_ptr() % 16 != 0
    before = tsp.launches_t
    got = tsp.spmm_ell_t_cuda(idx.to(cuda), val.to(cuda), g_dev, n_src)
    torch.cuda.synchronize()
    assert tsp.launches_t == before + 1
    g_plain = torch.where(torch.isfinite(gr), gr, torch.zeros_like(gr))
    want = tref.spmm_ell_t(idx, val, g_plain, n_src)
    terms = tref.spmm_ell_t(idx, (val != 0).float(), torch.ones_like(gr),
                            n_src)
    assert bool(torch.isfinite(got).all())
    assert_scatter_close(got.cpu(), want,
                         tref.spmm_ell_t(idx, val.abs(), g_plain.abs(),
                                         n_src), terms)
    if form == "hub":
        assert int(terms[n_src // 2, 0]) >= int((val != 0).sum()) // 2


@pytest.mark.gpu
def test_spmm_ell_autograd_backward_is_the_kernel(cuda):
    g = torch.Generator().manual_seed(3)
    idx = torch.randint(0, 40, (64, 6), generator=g, dtype=torch.int32)
    val = torch.randn((64, 6), generator=g)
    x = torch.randn((40, 16), generator=g)
    w = torch.randn((64, 16), generator=g)
    xc = x.to(cuda).requires_grad_(True)
    before = tsp.launches_t
    (ops.spmm_ell(idx.to(cuda), val.to(cuda), xc) * w.to(cuda)).sum() \
        .backward()
    assert tsp.launches_t == before + 1
    xr = x.clone().requires_grad_(True)
    (ops.spmm_ell(idx, val, xr) * w).sum().backward()
    assert_allclose(xc.grad.cpu().numpy(), xr.grad.numpy(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,deg,n,nb,k,f_blk,f_out", [
    (300, 18, 5000, 32, 1024, 4, 128), (100, 18, 5000, 8, 1024, 5, 128),
    (13, 3, 40, 4, 16, 8, 7), (1, 1, 1, 1, 1, 1, 1), (5, 0, 10, 4, 8, 8, 3)])
def test_context_ell_wt_kernel_vs_plain(cuda, b, deg, n, nb, k, f_blk, f_out):
    """The w_t epilogue, b not a multiple of the kernel's 8-row blocks,
    and D = 0 (zeros, no launch)."""
    g = torch.Generator().manual_seed(b + nb + f_out)
    ids = torch.randint(0, n, (b, deg), generator=g, dtype=torch.int32)
    val = torch.randn((b, deg), generator=g)
    assign = torch.randint(0, k, (nb, n), generator=g, dtype=torch.int32)
    cw = torch.randn((nb, k, f_blk), generator=g)
    w_t = torch.randn((nb * f_blk, f_out), generator=g)
    before = (tce.launches, tce.launches_wt)
    got = tce.context_ell_cuda(*(t.to(cuda) for t in (ids, val, assign, cw)),
                               w_t=w_t.to(cuda))
    torch.cuda.synchronize()
    assert (tce.launches, tce.launches_wt) == tuple(
        c + (deg > 0) for c in before)
    assert got.shape == (b, f_out)
    assert_allclose(got.cpu().numpy(),
                    tref.context_ell(ids, val, assign, cw, w_t).numpy(),
                    **TOL)


@pytest.mark.gpu
def test_vq_train_step_cuda_vs_cpu(cuda):
    """One Alg. 1 step on the card against the same step on the CPU plain
    path, from the same state and batch; the kernels each launch as the
    step's layer count says."""
    from repro_torch.convert import to_device
    from repro_torch.core.codebook import CodebookConfig
    from repro_torch.graph import batching as tb
    from repro_torch.graph.datasets import synthetic_arxiv
    from repro_torch.models import gnn as tgnn
    from repro_torch.train.optimizer import rmsprop
    g = synthetic_arxiv(n=600, seed=0)
    cfg = tgnn.GNNConfig(backbone="gcn", f_in=g.f, hidden=32,
                         n_out=g.num_classes, n_layers=2,
                         codebook=CodebookConfig(k=32, f_prod=4))
    opt = rmsprop(3e-3)
    bids = np.random.default_rng(0).choice(g.n, 150, replace=False)
    mask = np.zeros(g.n, np.float32)
    mask[g.train_idx] = 1.0
    outs = {}
    for dev in ("cpu", cuda):
        params = tgnn.init_gnn(cfg, torch.Generator().manual_seed(0),
                               device=dev)
        vq = tgnn.init_vq_states(cfg, g.n, torch.Generator().manual_seed(1),
                                 device=dev)
        ops_ = tb.full_operands(g, device=dev)
        plan = tb.build_epoch_plan(g, full_ops=ops_, device=dev)
        ids = torch.from_numpy(bids.astype(np.int32)).to(dev)
        pack = tb.plan_batch(plan, ids)
        counts = (tvu.launches, tce.launches, tce.launches_wt, tsp.launches,
                  tsp.launches_t)
        res = tgnn.vq_train_step(
            params, vq, opt.init(params), pack,
            torch.from_numpy(g.features[bids]).to(dev),
            torch.from_numpy(g.labels[bids]).to(dev), ops_.degrees, cfg, opt,
            loss_mask=torch.from_numpy(mask[bids]).to(dev))
        outs[str(dev)] = to_device(list(res[:2]) + list(res[3:]), "cpu")
        if dev == cuda:
            torch.cuda.synchronize()
            got = tuple(a - b for a, b in zip(
                (tvu.launches, tce.launches, tce.launches_wt, tsp.launches,
                 tsp.launches_t), counts))
            assert got == (2, 3, 1, 2, 1)
    (pc, vc, lc, oc, ec), (pg, vg, lg, og, eg) = outs["cpu"], outs["cuda"]
    assert_allclose(lg.numpy(), lc.numpy(), **STEP)
    assert_allclose(og.numpy(), oc.numpy(), **STEP)
    assert_allclose(eg.numpy(), ec.numpy(), **STEP)
    for a, b in zip(pg, pc):
        for name in a:
            assert_allclose(a[name].numpy(), b[name].numpy(), **STEP)
    for a, b in zip(vg, vc):
        agree = (a.assignment == b.assignment).float().mean()
        assert agree >= 0.99
        if agree == 1:
            for fa, fb in zip(a.codebook, b.codebook):
                assert_allclose(fa.numpy(), fb.numpy(), **STEP)
            assert torch.equal(a.counts, b.counts)


@pytest.mark.gpu
def test_link_train_step_cuda_vs_cpu(cuda):
    """One link step (SAGE, the host-packed batch and its mined pairs) on
    the card against the same step on the CPU, from the same state; the
    kernels each launch as the step's layer count says."""
    from repro_torch.convert import to_device
    from repro_torch.core.codebook import CodebookConfig
    from repro_torch.graph import batching as tb
    from repro_torch.graph.datasets import synthetic_collab
    from repro_torch.models import gnn as tgnn
    from repro_torch.train.gnn_trainer import _batch_pairs
    from repro_torch.train.optimizer import rmsprop
    g = synthetic_collab(n=600, seed=4)
    cfg = tgnn.GNNConfig(backbone="sage", f_in=g.f, hidden=32, n_out=32,
                         n_layers=2, task="link",
                         codebook=CodebookConfig(k=32, f_prod=4))
    opt = rmsprop(3e-3)
    rng = np.random.default_rng(0)
    bids = rng.choice(g.n, 300, replace=False)
    pos, neg = _batch_pairs(g, bids, np.ones(len(bids), np.float32), rng)
    assert len(pos) > 2
    outs = {}
    for dev in ("cpu", cuda):
        params = tgnn.init_gnn(cfg, torch.Generator().manual_seed(0),
                               device=dev)
        vq = tgnn.init_vq_states(cfg, g.n, torch.Generator().manual_seed(1),
                                 device=dev)
        pack = tb.make_pack(g, bids, device=dev)
        counts = (tvu.launches, tce.launches, tce.launches_wt, tsp.launches,
                  tsp.launches_t)
        res = tgnn.vq_train_step(
            params, vq, opt.init(params), pack,
            torch.from_numpy(g.features[bids]).to(dev),
            torch.from_numpy(g.labels[bids]).to(dev),
            torch.from_numpy(g.degrees()).to(dev), cfg, opt,
            pos_pairs=torch.from_numpy(pos).to(dev),
            neg_pairs=torch.from_numpy(neg).to(dev))
        outs[str(dev)] = to_device(list(res[:2]) + list(res[3:]), "cpu")
        if dev == cuda:
            torch.cuda.synchronize()
            got = tuple(a - b for a, b in zip(
                (tvu.launches, tce.launches, tce.launches_wt, tsp.launches,
                 tsp.launches_t), counts))
            assert got == (2, 3, 1, 2, 1)
    (pc, vc, lc, oc, ec), (pg, vg, lg, og, eg) = outs["cpu"], outs["cuda"]
    assert np.isfinite(float(lg))
    assert_allclose(lg.numpy(), lc.numpy(), **STEP)
    assert_allclose(og.numpy(), oc.numpy(), **STEP)
    assert_allclose(eg.numpy(), ec.numpy(), **STEP)
    for a, b in zip(pg, pc):
        for name in a:
            assert_allclose(a[name].numpy(), b[name].numpy(), **STEP)
    for a, b in zip(vg, vc):
        agree = (a.assignment == b.assignment).float().mean()
        assert agree >= 0.99
        if agree == 1:
            for fa, fb in zip(a.codebook, b.codebook):
                assert_allclose(fa.numpy(), fb.numpy(), **STEP)
            assert torch.equal(a.counts, b.counts)


# ---------------------------------------------------------------------------
# the precision tiers' kernel forms
# ---------------------------------------------------------------------------

QDTYPES = [torch.int8, torch.float8_e4m3fn]


def _tier_case(b, deg, n, nb, k, f_blk, seed):
    from repro_torch.distributed.quantization import quantize_codewords
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, n, (b, deg), generator=g, dtype=torch.int32)
    val = torch.randn((b, deg), generator=g)
    assign = torch.randint(0, k, (nb, n), generator=g, dtype=torch.int32)
    cw = torch.randn((nb, k, f_blk), generator=g)
    return ids, val, assign, cw, quantize_codewords


def _table(assign, tab):
    from repro_torch.distributed.quantization import PackedAssignment
    if tab == "a4":
        return PackedAssignment.pack(assign)
    return assign.to(torch.uint8 if tab == "u8" else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("cw_dtype", QDTYPES)
@pytest.mark.parametrize("tab", ["u8", "a4", "i32"])
@pytest.mark.parametrize("b,deg,n,nb,k,f_blk,f_out", [
    (256, 18, 5001, 32, 16, 4, 128), (300, 18, 5001, 8, 16, 5, 128),
    (13, 3, 41, 4, 16, 8, 7), (1, 1, 1, 1, 1, 1, 1)])
def test_context_ell_q_kernel_vs_plain(cuda, cw_dtype, tab, b, deg, n, nb, k,
                                       f_blk, f_out):
    """Quantized codewords over uint8, packed (odd n) and int32 tables,
    the plain and the w_t form: bit-equal to the plain version."""
    ids, val, assign, cw, quantize = _tier_case(b, deg, n, nb, k, f_blk,
                                                b + nb + f_out)
    qt = quantize(cw, dtype=cw_dtype)
    w_t = torch.randn((nb * f_blk, f_out),
                      generator=torch.Generator().manual_seed(1))
    a = _table(assign, tab)
    a_dev = a.to(cuda)
    for wt in (None, w_t):
        before = (tce.launches_q, tce.launches_q_wt)
        got = tce.context_ell_cuda(
            ids.to(cuda), val.to(cuda), a_dev, qt.q.to(cuda),
            None if wt is None else wt.to(cuda), qt.scale.to(cuda))
        torch.cuda.synchronize()
        assert (tce.launches_q, tce.launches_q_wt) == (
            before[0] + 1, before[1] + (wt is not None))
        want = tref.context_ell(ids, val, a, qt.q, wt, qt.scale)
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", QDTYPES)
@pytest.mark.parametrize("b,deg,n,f", [(256, 18, 5000, 128),
                                       (33, 7, 51, 12), (1, 1, 1, 1)])
def test_spmm_ell_q_kernel_vs_plain(cuda, x_dtype, b, deg, n, f):
    from repro_torch.distributed.quantization import quantize_codewords
    g = torch.Generator().manual_seed(b + f)
    idx = torch.randint(0, n, (b, deg), generator=g, dtype=torch.int32)
    val = torch.randn((b, deg), generator=g)
    qt = quantize_codewords(torch.randn((1, n, f), generator=g),
                            dtype=x_dtype)
    x, sc = qt.q[0], qt.scale[0]
    before = (tsp.launches, tsp.launches_q)
    got = ops.spmm_ell(idx.to(cuda), val.to(cuda),
                       type(qt)(x.to(cuda), sc.to(cuda)))
    torch.cuda.synchronize()
    assert (tsp.launches, tsp.launches_q) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got.cpu(), tref.spmm_ell(idx, val, x, sc))


def _padded_case(b, deg, n, f, pad, seed):
    """ids/values [b, D] with a share ``pad`` of the slots padding as
    ``core/message_passing.py:intra_messages`` writes it (row 0, value
    0), and an f32 source [n, f]."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, n, (b, deg), generator=g, dtype=torch.int32)
    val = torch.randn((b, deg), generator=g)
    padding = torch.rand((b, deg), generator=g) < pad
    val[padding] = 0.0
    idx[padding] = 0
    return idx, val, torch.randn((n, f), generator=g)


def _source(x, x_dtype):
    """x as the kernel takes it: f32, or int8 / fp8 rows and [1, f] scales."""
    if x_dtype == torch.float32:
        return x, None
    from repro_torch.distributed.quantization import quantize_codewords
    qt = quantize_codewords(x[None], dtype=x_dtype)
    return qt.q[0], qt.scale[0]


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32] + QDTYPES)
@pytest.mark.parametrize("b,deg,n,f,pad", [
    (4096, 18, 4096, 128, 0.75),         # a training-like batch
    (256, 18, 256, 128, 0.97),           # a serving-like batch
    (300, 18, 500, 12, 0.5), (300, 18, 500, 130, 0.5),   # odd f
    (77, 40, 300, 64, 0.3), (65, 70, 90, 32, 0.6),       # D past 32
    (50, 5, 60, 300, 0.2),               # rows past 256 columns
    (33, 1, 40, 128, 0.5), (33, 0, 40, 128, 0.0),        # D 1 and D 0
    (40, 18, 50, 128, 1.0)])             # nothing but padding
def test_spmm_ell_forward_bit_equal(cuda, x_dtype, b, deg, n, f, pad):
    """The warp-per-row forward, f32 and 1-byte sources, bit-equal to its
    plain version with padding skipped, at ragged shapes."""
    idx, val, x = _padded_case(b, deg, n, f, pad, seed=b + deg + f)
    x, sc = _source(x, x_dtype)
    before = tsp.launches
    got = tsp.spmm_ell_cuda(idx.to(cuda), val.to(cuda), x.to(cuda),
                            None if sc is None else sc.to(cuda))
    torch.cuda.synchronize()
    assert tsp.launches == before + 1
    assert torch.equal(got.cpu(), tref.spmm_ell(idx, val, x, sc))


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32] + QDTYPES)
@pytest.mark.parametrize("f", [128, 12])
def test_spmm_ell_forward_unaligned_source(cuda, x_dtype, f):
    """A source view that starts one element past an aligned address takes
    the element-by-element gather, with the same bits."""
    idx, val, x = _padded_case(500, 18, 700, f, 0.5, seed=f)
    x, sc = _source(x, x_dtype)
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
    flat[1:] = x.reshape(-1)
    xc = flat.to(cuda)[1:].view(x.shape)
    assert xc.data_ptr() % 4 != 0 or x_dtype == torch.float32
    assert xc.data_ptr() % 16 != 0 and xc.is_contiguous()
    got = tsp.spmm_ell_cuda(idx.to(cuda), val.to(cuda), xc,
                            None if sc is None else sc.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tref.spmm_ell(idx, val, x, sc))


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_spmm_ell_forward_skips_padding_of_a_non_finite_row(cuda, bad):
    """The one divergence (ROADMAP.md, queue 3): a slot with value 0 is not
    gathered, so a non-finite source row that only padding names leaves
    the kernel's rows finite where the plain version's 0 * inf = NaN; a
    live slot that names it makes the kernel's row non-finite too."""
    idx, val, x = _padded_case(64, 18, 80, 128, 0.75, seed=3)
    idx[(idx == 0) & (val != 0)] = 1         # only padding names row 0 ...
    live_row = 5
    val[live_row, 2], idx[live_row, 2] = 0.5, 0          # ... but here
    x[0] = bad
    got = tsp.spmm_ell_cuda(idx.to(cuda), val.to(cuda), x.to(cuda)).cpu()
    want = tref.spmm_ell(idx, val, x)
    # the kernel's semantics: padding moved onto a finite row adds +-0
    skipped = tref.spmm_ell(torch.where(val == 0, 1, idx), val, x)
    torch.testing.assert_close(got, skipped, rtol=0, atol=0, equal_nan=True)
    padded = (val == 0).any(1)
    only_padding = padded.clone()
    only_padding[live_row] = False
    assert only_padding.sum() > 10
    assert torch.isnan(want[only_padding]).all()
    assert torch.isfinite(got[only_padding]).all()
    assert not torch.isfinite(got[live_row]).all()
    assert torch.equal(got[~padded], want[~padded])


@pytest.mark.gpu
@pytest.mark.parametrize("emit,k", [(torch.uint8, 256), (torch.uint8, 40),
                                    ("uint4", 16)])
def test_vq_update_narrow_emit_kernel(cuda, emit, k):
    """The uint8 emit (the uint4 one through it) gives the int32 build's
    ids, qerr and counts; ``launches_u8`` counts it."""
    g = torch.Generator().manual_seed(k)
    x = torch.randn((8, 3000, 8), generator=g).to(cuda)
    cw = torch.randn((8, k, 8), generator=g).to(cuda)
    wide = tvu.vq_assign_update_cuda(x, cw)
    before = tvu.launches_u8
    narrow = tvu.vq_assign_update_cuda(x, cw, emit)
    torch.cuda.synchronize()
    assert tvu.launches_u8 == before + 1
    assert narrow[0].dtype == torch.uint8
    assert torch.equal(narrow[0].int(), wide[0])
    assert torch.equal(narrow[1], wide[1]) and torch.equal(narrow[2], wide[2])


@pytest.mark.gpu
def test_tier_kernels_reject_what_they_do_not_take(cuda):
    """A narrow table whose ids cannot reach k, a quantized table without
    its scales: raised before any launch, never a plain-version run."""
    from repro_torch.distributed.quantization import PackedAssignment
    ids = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    val = torch.zeros((4, 2), device=cuda)
    sc = torch.ones((1, 1, 4), device=cuda)
    q = torch.zeros((1, 300, 4), dtype=torch.int8, device=cuda)
    before = tce.launches
    with pytest.raises(ValueError, match="ids < 256"):
        tce.context_ell_cuda(ids, val, torch.zeros(
            (1, 4), dtype=torch.uint8, device=cuda), q, cw_scale=sc)
    with pytest.raises(ValueError, match="ids < 16"):
        tce.context_ell_cuda(ids, val, PackedAssignment(torch.zeros(
            (1, 2), dtype=torch.uint8, device=cuda), 4), q[:, :17],
            cw_scale=sc)
    with pytest.raises(ValueError, match="cw_scale"):
        tce.context_ell_cuda(ids, val, torch.zeros(
            (1, 4), dtype=torch.uint8, device=cuda), q[:, :16])
    with pytest.raises(ValueError, match="k <= 256"):
        tvu.vq_assign_update_cuda(torch.zeros((1, 4, 4), device=cuda),
                                  torch.zeros((1, 300, 4), device=cuda),
                                  torch.uint8)
    assert tce.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["int8", "fp8+a4"])
def test_vq_train_step_under_tier_cuda_vs_cpu(cuda, tier):
    """One Alg. 1 step under a tier on the card against the CPU plain path:
    loss and params within STEP, the quantized forms launched in place of
    the f32 ones, the snapshots requantized on both within a quantum."""
    from repro_torch.convert import to_device
    from repro_torch.core.codebook import CodebookConfig
    from repro_torch.graph import batching as tb
    from repro_torch.graph.datasets import synthetic_arxiv
    from repro_torch.models import gnn as tgnn
    from repro_torch.train.optimizer import rmsprop
    g = synthetic_arxiv(n=600, seed=0)
    cfg = tgnn.GNNConfig(backbone="gcn", f_in=g.f, hidden=32,
                         n_out=g.num_classes, n_layers=2,
                         codebook=CodebookConfig(k=16, f_prod=4))
    opt = rmsprop(3e-3)
    bids = np.random.default_rng(0).choice(g.n, 150, replace=False)
    mask = np.zeros(g.n, np.float32)
    mask[g.train_idx] = 1.0
    ops.configure_kernel_precision(tier)
    try:
        params = tgnn.init_gnn(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        vq = tgnn.init_vq_states(cfg, g.n, torch.Generator().manual_seed(1),
                                 device="cpu")
    finally:
        ops.configure_kernel_precision(reset=True)
    outs = {}
    for dev in ("cpu", cuda):
        p, v = to_device(params, dev), to_device(vq, dev)
        ops_ = tb.full_operands(g, device=dev)
        plan = tb.build_epoch_plan(g, full_ops=ops_, device=dev)
        pack = tb.plan_batch(plan, torch.from_numpy(
            bids.astype(np.int32)).to(dev))
        q0 = (tce.launches_q, tce.launches_q_wt)
        res = tgnn.vq_train_step(
            p, v, opt.init(p), pack,
            torch.from_numpy(g.features[bids]).to(dev),
            torch.from_numpy(g.labels[bids]).to(dev), ops_.degrees, cfg, opt,
            loss_mask=torch.from_numpy(mask[bids]).to(dev))
        outs[str(dev)] = to_device([res[0], res[1], res[3]], "cpu")
        if dev == cuda:
            torch.cuda.synchronize()
            assert (tce.launches_q - q0[0], tce.launches_q_wt - q0[1]) \
                == (3, 1)
    (pc, vc, lc), (pg, vg, lg) = outs["cpu"], outs["cuda"]
    assert_allclose(lg.numpy(), lc.numpy(), **STEP)
    for a, b in zip(pg, pc):
        for name in a:
            assert_allclose(a[name].numpy(), b[name].numpy(), **STEP)
    for a, b in zip(vg, vc):
        assert type(a.assignment) is type(b.assignment)
        for qa, qb in ((a.qcw.feat, b.qcw.feat), (a.qcw.grad, b.qcw.grad)):
            assert qa.q.dtype == qb.q.dtype
            assert_allclose(qa.scale.numpy(), qb.scale.numpy(), rtol=1e-4)
            va, vb = qa.q.float().numpy(), qb.q.float().numpy()
            quantum = 1.0 if qa.q.dtype == torch.int8 \
                else np.maximum(np.abs(va), np.abs(vb)) / 8 + 2.0 ** -9
            assert np.all(np.abs(va - vb) <= quantum * 1.0001)


# ---------------------------------------------------------------------------
# the LM decode slice's kernels
# ---------------------------------------------------------------------------

def assert_bf16_close(got, want, ulps: int = 2):
    """bf16 results within ``ulps`` units in the last place of the plain
    version's value (an ulp taken at no less than 2^-10: below that the
    f32 sums' own rounding, ~1e-7 of the unit-scale terms, dominates)."""
    g = got.float().cpu().numpy()
    w = want.float().cpu().numpy()
    mag = np.maximum(np.abs(w), 2.0 ** -10)
    tol = ulps * 2.0 ** (np.floor(np.log2(mag)) - 7)
    bad = ~(np.abs(g - w) <= tol)
    assert not bad.any(), (f"{bad.sum()} elements beyond {ulps} bf16 ulps "
                           f"(max abs err {np.nanmax(np.abs(g - w))})")


def _vq_attn_operands(n, g, d, kcb, w, seed, dtype):
    gen = torch.Generator().manual_seed(seed)
    q, cbk, cbv = (torch.randn(s, generator=gen) for s in
                   ((n, g, d), (n, kcb, d), (n, kcb, d)))
    wk, wv = (torch.randn((n, w, d), generator=gen) for _ in "kv")
    mass = torch.rand((n, kcb), generator=gen) * 20
    mass[:, ::3] = 0.0                           # empty codewords
    wm = (torch.rand((n, w), generator=gen) < 0.7).float()
    wm[:, 0] = 1.0
    wm[0] = 0.0
    wm[0, w - 1] = 1.0                           # a single valid slot
    cast = [t.to(dtype) for t in (q, cbk, cbv)]
    return cast[0], cast[1], cast[2], mass, wk.to(dtype), wv.to(dtype), wm


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,g,d,kcb,w", [(32, 3, 128, 128, 64),
                                         (16, 8, 64, 128, 64),
                                         (128, 1, 80, 128, 64),
                                         (32, 4, 128, 128, 64),
                                         (24, 1, 64, 128, 64),
                                         (5, 2, 64, 16, 8), (1, 1, 8, 4, 4),
                                         (3, 16, 256, 70, 130),
                                         (2, 4, 100, 3, 1), (4, 8, 128, 0, 9)])
def test_vq_attention_kernel_vs_plain(cuda, dtype, n, g, d, kcb, w):
    from repro_torch.kernels import vq_attention as tvatt
    args = _vq_attn_operands(n, g, d, kcb, w, n + kcb + w, dtype)
    before = tvatt.launches
    got = tvatt.vq_attention_decode_cuda(*(t.to(cuda) for t in args))
    torch.cuda.synchronize()
    assert tvatt.launches == before + 1 and got.dtype == dtype
    want = tref.vq_attention_decode(*args)
    if dtype == torch.float32:
        assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    else:
        assert_bf16_close(got, want)
    assert torch.equal(ops.vq_attention_decode(*(t.to(cuda) for t in args)),
                       got)


@pytest.mark.gpu
def test_vq_attention_kernel_row_without_keys_is_nan_like_plain(cuda):
    from repro_torch.kernels import vq_attention as tvatt
    args = list(_vq_attn_operands(2, 3, 16, 4, 4, 0, torch.float32))
    args[3][1] = 0.0
    args[6][1] = 0.0                             # group 1 sees no key
    got = tvatt.vq_attention_decode_cuda(*(t.to(cuda) for t in args)).cpu()
    want = tref.vq_attention_decode(*args)
    assert torch.isnan(want[1]).all() and torch.isnan(got[1]).all()
    assert_allclose(got[0].numpy(), want[0].numpy(), **TOL)


def _check_vq_attn(got, want, dtype):
    if dtype == torch.float32:
        assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    else:
        assert_bf16_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64])
@pytest.mark.parametrize("n,g,d,kcb,w", [(32, 3, 128, 128, 64),
                                         (3, 5, 96, 37, 20),
                                         (2, 16, 256, 300, 50),
                                         (4, 2, 64, 0, 45)])
def test_vq_attention_split_counts(cuda, dtype, splits, n, g, d, kcb, w):
    """Every split count -- one block a group, two, several, more blocks
    than 16-key tiles -- within the stated tolerance of the plain
    version, at k + w that is not a multiple of the 16-key tile and k 0."""
    from repro_torch.kernels import vq_attention as tvatt
    args = _vq_attn_operands(n, g, d, kcb, w, n + g + kcb, dtype)
    got = tvatt.vq_attention_decode_cuda(*(t.to(cuda) for t in args),
                                         splits=splits)
    torch.cuda.synchronize()
    _check_vq_attn(got, tref.vq_attention_decode(*args), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vq_attention_back_to_back_launches_reset_counters(cuda, dtype):
    """Launches queued one after another on one stream, on the kept
    workspace: each is right and gives the same bits (the partials merge
    in split order, whichever block is last), and the per-group counters
    are zero after them."""
    from repro_torch.kernels import vq_attention as tvatt
    n, g, d, kcb, w = 32, 3, 128, 128, 64
    args = [t.to(cuda) for t in
            _vq_attn_operands(n, g, d, kcb, w, 9, dtype)]
    other = [t.to(cuda) for t in
             _vq_attn_operands(n, g, d, kcb, w, 10, dtype)]
    splits = tvatt.split_count(n, kcb, w, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert splits > 1
    outs = [tvatt.vq_attention_decode_cuda(*(args if i % 2 == 0 else other))
            for i in range(6)]
    torch.cuda.synchronize()
    for i, o in enumerate(outs):
        assert torch.equal(o, outs[i % 2])
    _check_vq_attn(outs[0], tref.vq_attention_decode(
        *(t.cpu() for t in args)), dtype)
    _check_vq_attn(outs[1], tref.vq_attention_decode(
        *(t.cpu() for t in other)), dtype)
    key = (args[0].device, torch.cuda.current_stream(cuda).cuda_stream, n,
           g, d, splits)
    assert int(tvatt._workspaces[key][2].abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 5])
def test_vq_attention_group_without_keys_at_every_split(cuda, dtype, splits):
    """A group whose every key is masked is NaN, as the plain version's
    softmax over -inf; its neighbours are unaffected, whichever split
    holds the valid keys."""
    from repro_torch.kernels import vq_attention as tvatt
    args = list(_vq_attn_operands(3, 3, 64, 40, 30, 4, dtype))
    args[3][1] = 0.0
    args[6][1] = 0.0                         # group 1 sees no key
    args[3][2] = 0.0
    args[6][2] = 0.0
    args[6][2, 29] = 1.0                     # group 2: the last key only
    got = tvatt.vq_attention_decode_cuda(*(t.to(cuda) for t in args),
                                         splits=splits).cpu()
    want = tref.vq_attention_decode(*args)
    assert torch.isnan(want[1]).all() and torch.isnan(got[1]).all()
    _check_vq_attn(got[[0, 2]], want[[0, 2]], dtype)


@pytest.mark.gpu
def test_vq_attention_rejects_bad_splits(cuda):
    from repro_torch.kernels import vq_attention as tvatt
    args = [t.to(cuda) for t in
            _vq_attn_operands(2, 3, 16, 4, 4, 0, torch.float32)]
    for bad in (0, tvatt.MAX_SPLITS + 1):
        with pytest.raises(ValueError, match="splits"):
            tvatt.vq_attention_decode_cuda(*args, splits=bad)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,sq,skv,d", [(1, 2, 64, 64, 64),
                                          (2, 3, 100, 100, 128),
                                          (1, 2, 37, 130, 16),
                                          (1, 1, 1, 33, 8),
                                          (2, 2, 70, 70, 256),
                                          (1, 2, 5, 5, 3)])
def test_flash_attention_kernel_vs_plain(cuda, dtype, causal, b, h, sq, skv,
                                         d):
    from repro_torch.kernels import flash_attention as tfa
    gen = torch.Generator().manual_seed(b + h + sq + skv + d)
    q = torch.randn((b, h, sq, d), generator=gen).to(dtype)
    k, v = (torch.randn((b, h, skv, d), generator=gen).to(dtype)
            for _ in "kv")
    before = tfa.launches
    got = tfa.flash_attention_cuda(q.to(cuda), k.to(cuda), v.to(cuda),
                                   causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1 and got.dtype == dtype
    want = tref.flash_attention(q, k, v, causal=causal)
    if dtype == torch.float32:
        assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    else:
        assert_bf16_close(got, want)


@pytest.mark.gpu
def test_flash_attention_kernel_rows_without_keys_are_nan_like_plain(cuda):
    """Causal with sq > skv: the first sq - skv queries see no key."""
    from repro_torch.kernels import flash_attention as tfa
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 2, 80, 16), generator=gen)
    k, v = (torch.randn((1, 2, 30, 16), generator=gen) for _ in "kv")
    got = tfa.flash_attention_cuda(q.to(cuda), k.to(cuda), v.to(cuda)).cpu()
    want = tref.flash_attention(q, k, v)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(want[:, :, :50]).all()
    assert_allclose(got[:, :, 50:].numpy(), want[:, :, 50:].numpy(), **TOL)


def _flash_case(b, h, sq, skv, d, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, h, sq, d), generator=gen).to(dtype)
    k, v = (torch.randn((b, h, skv, d), generator=gen).to(dtype)
            for _ in "kv")
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(1, 1), (63, 63), (65, 65), (100, 100),
                                    (130, 130), (1, 65), (63, 130),
                                    (100, 65), (130, 1), (65, 300),
                                    (300, 257)])
def test_flash_attention_tc_route_vs_plain(cuda, d, causal, sq, skv):
    """The tensor-core kernel (bf16, d 64 / 128) at sequence lengths that
    are not multiples of its 64-row query and 64-key tiles, causal with
    skv > sq and sq > skv (rows that see no key are NaN on both sides):
    within 2 bf16 ulps of the plain version, one tensor-core launch."""
    from repro_torch.kernels import flash_attention as tfa
    q, k, v = _flash_case(2, 3, sq, skv, d, torch.bfloat16, sq + skv + d)
    args = [t.to(cuda) for t in (q, k, v)]
    assert tfa.route(*args) == "tc"
    before = (tfa.launches, tfa.launches_tc, tfa.launches_fma)
    got = tfa.flash_attention_cuda(*args, causal=causal)
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.launches_tc, tfa.launches_fma) == (
        before[0] + 1, before[1] + 1, before[2])
    want = tref.flash_attention(q, k, v, causal=causal)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got.cpu()), nan)
    assert bool(nan.any()) == (causal and sq > skv)
    assert_bf16_close(got.cpu()[~nan], want[~nan])
    assert torch.allclose(ops.flash_attention(*args, causal=causal), got,
                          rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 3),
                                     (torch.bfloat16, 8),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 64),
                                     (torch.float32, 128)])
def test_flash_attention_fma_route_covers_the_rest(cuda, dtype, d):
    """f32 operands and the head widths the tensor-core kernel does not
    take stay on the FMA kernel, as does a bf16 view that is not 16-byte
    aligned."""
    from repro_torch.kernels import flash_attention as tfa
    for causal in (True, False):
        q, k, v = _flash_case(1, 2, 70, 90, d, dtype, d)
        args = [t.to(cuda) for t in (q, k, v)]
        assert tfa.route(*args) == "fma"
        before = (tfa.launches_tc, tfa.launches_fma)
        got = tfa.flash_attention_cuda(*args, causal=causal)
        torch.cuda.synchronize()
        assert (tfa.launches_tc, tfa.launches_fma) == (before[0],
                                                       before[1] + 1)
        want = tref.flash_attention(q, k, v, causal=causal)
        if dtype == torch.float32:
            assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
        else:
            assert_bf16_close(got, want)
    q, k, v = _flash_case(1, 2, 40, 40, 64, torch.bfloat16, 5)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    qu = flat[1:].view(q.shape)
    qu.copy_(q.to(cuda))
    assert qu.data_ptr() % 16 != 0 and qu.is_contiguous()
    assert tfa.route(qu, k.to(cuda), v.to(cuda)) == "fma"
    got = tfa.flash_attention_cuda(qu, k.to(cuda), v.to(cuda))
    assert_bf16_close(got, tref.flash_attention(q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("vq", [False, True])
def test_lm_decode_cuda_vs_cpu(cuda, vq):
    """24 teacher-forced decode steps of the llama3.2-3b smoke (f32) on the
    card and on the CPU from the same weights: logits ``rtol=1e-4,
    atol=1e-4``, codebook counts equal, ``vq_attention`` launched once per
    layer and step."""
    from repro_torch import convert
    from repro_torch.configs.registry import get_smoke
    from repro_torch.kernels import vq_attention as tvatt
    from repro_torch.models import lm
    cfg = get_smoke("llama3.2-3b")
    if vq:
        cfg = cfg.with_vq(k=4, window=8)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_params = convert.to_device(params, cuda)
    caches = [lm.init_serve_cache(cfg, 3, 32, device=d) for d in ("cpu",
                                                                 cuda)]
    tokens = torch.randint(0, cfg.vocab, (24, 3, 1),
                           generator=torch.Generator().manual_seed(1))
    before = tvatt.launches
    for s in range(24):
        want, caches[0] = lm.serve_step(params, tokens[s], caches[0], cfg)
        got, caches[1] = lm.serve_step(gpu_params, tokens[s].to(cuda),
                                       caches[1], cfg)
        assert_allclose(got.cpu().numpy(), want.numpy(), **LM_STEP)
        if vq:
            assert torch.equal(caches[1]["kv"].count.cpu(),
                               caches[0]["kv"].count)
    assert tvatt.launches - before == (24 * cfg.n_layers if vq else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b",
                                  "xlstm-350m", "zamba2-2.7b"])
@pytest.mark.parametrize("vq", [False, True])
def test_lm_families_cuda_vs_cpu(cuda, arch, vq):
    """The moe, ssm and hybrid smokes (f32): 24 teacher-forced decode steps
    card vs CPU (logits ``rtol=1e-4, atol=1e-4``, codebook counts equal,
    ``vq_attention`` once per attention layer and step: every layer of
    the moe family, one a group in the hybrid, none in the ssm), then
    ``train_loss`` and its gradients card vs CPU at ``rtol=1e-4,
    atol=1e-5``."""
    from repro_torch import convert
    from repro_torch.configs.registry import get_smoke
    from repro_torch.kernels import vq_attention as tvatt
    from repro_torch.models import lm
    from repro_torch.train.loop import loss_and_grads
    from repro_torch.train.optimizer import tree_leaves
    cfg = get_smoke(arch)
    if vq:
        cfg = cfg.with_vq(k=4, window=8)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_params = convert.to_device(params, cuda)
    caches = [lm.init_serve_cache(cfg, 3, 32, device=d)
              for d in ("cpu", cuda)]
    tokens = torch.randint(0, cfg.vocab, (24, 3, 1),
                           generator=torch.Generator().manual_seed(1))
    before = tvatt.launches
    for s in range(24):
        want, caches[0] = lm.serve_step(params, tokens[s], caches[0], cfg)
        got, caches[1] = lm.serve_step(gpu_params, tokens[s].to(cuda),
                                       caches[1], cfg)
        assert_allclose(got.cpu().numpy(), want.numpy(), **LM_STEP)
        if vq and cfg.family != "ssm":
            key = "kv" if cfg.family == "moe" else "attn"
            assert torch.equal(caches[1][key].count.cpu(),
                               caches[0][key].count)
    per_step = {"moe": cfg.n_layers, "ssm": 0,
                "hybrid": cfg.n_layers // max(cfg.attn_period, 1)}
    assert tvatt.launches - before == (24 * per_step[cfg.family] if vq
                                       else 0)
    batch = torch.randint(0, cfg.vocab, (2, 33),
                          generator=torch.Generator().manual_seed(2))
    lc, gc = loss_and_grads(gpu_params, batch.to(cuda), cfg)
    lh, gh = loss_and_grads(params, batch, cfg)
    assert_allclose(lc.cpu().numpy(), lh.numpy(), rtol=1e-4, atol=1e-5)
    for a, b in zip(tree_leaves(gc), tree_leaves(gh)):
        assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-11b"])
@pytest.mark.parametrize("vq", [False, True])
def test_lm_cross_families_cuda_vs_cpu(cuda, arch, vq):
    """The audio and vlm smokes (f32), every vlm gate nonzero and the
    cross caches filled from a seeded generator (at init both would make
    the cross output 0): 24 teacher-forced decode steps card vs CPU
    (logits ``rtol=1e-4, atol=1e-4``, codebook counts equal,
    ``vq_attention`` once per decoder layer and step), then
    ``train_loss`` with the stub context and its gradients at
    ``rtol=1e-4, atol=1e-5``."""
    from repro_torch import convert
    from repro_torch.configs.registry import get_smoke
    from repro_torch.kernels import vq_attention as tvatt
    from repro_torch.models import lm
    from repro_torch.train.loop import loss_and_grads
    from repro_torch.train.optimizer import tree_leaves
    cfg = get_smoke(arch)
    if vq:
        cfg = cfg.with_vq(k=4, window=8)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_lm(cfg, gen, device="cpu")
    if cfg.family == "vlm":
        params["cross_blocks"]["gate"].uniform_(0.4, 1.2, generator=gen)
    gpu_params = convert.to_device(params, cuda)
    cpu_cache = lm.init_serve_cache(cfg, 3, 32, device="cpu")
    for name in ("cross_k", "cross_v"):
        cpu_cache[name].normal_(generator=gen)
    caches = [cpu_cache, convert.to_device(cpu_cache, cuda)]
    tokens = torch.randint(0, cfg.vocab, (24, 3, 1), generator=gen)
    before = tvatt.launches
    for s in range(24):
        want, caches[0] = lm.serve_step(params, tokens[s], caches[0], cfg)
        got, caches[1] = lm.serve_step(gpu_params, tokens[s].to(cuda),
                                       caches[1], cfg)
        assert_allclose(got.cpu().numpy(), want.numpy(), **LM_STEP)
        if vq:
            assert torch.equal(caches[1]["kv"].count.cpu(),
                               caches[0]["kv"].count)
    assert tvatt.launches - before == (24 * cfg.n_layers if vq else 0)
    batch = torch.randint(0, cfg.vocab, (2, 33), generator=gen)
    f = cfg.enc_seq if cfg.family == "audio" else cfg.n_patches
    aux = torch.randn((2, f, cfg.d_model), generator=gen)
    lc, gc = loss_and_grads(gpu_params, batch.to(cuda), cfg, aux.to(cuda))
    lh, gh = loss_and_grads(params, batch, cfg, aux)
    assert_allclose(lc.cpu().numpy(), lh.numpy(), rtol=1e-4, atol=1e-5)
    for a, b in zip(tree_leaves(gc), tree_leaves(gh)):
        assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def _all_launches() -> int:
    from repro_torch.kernels import (context_ell, flash_attention, spmm_ell,
                                     spmm_ell_hbm, vq_assign, vq_attention,
                                     vq_update)
    return sum(m.launches for m in (context_ell, flash_attention, spmm_ell,
                                    spmm_ell_hbm, vq_assign, vq_attention,
                                    vq_update))


def _rel_err(got, want) -> float:
    """||got - want|| / ||want||, in f64 on the CPU."""
    g, w = got.detach().cpu().double(), want.detach().cpu().double()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kcb,w,nblk", [(4, 8, 4), (16, 4, 3)])
def test_vq_attention_train_cuda_vs_cpu(cuda, dtype, kcb, w, nblk):
    """``vq_attention_train``'s output and q / k / v gradients on the card
    against the CPU (TF32 off), codebook masses equal.  f32: ``rtol=1e-5,
    atol=1e-5``.  bf16 (the scores and codebook in f32, cast back): the
    output within 2 bf16 ulps; each gradient sums bf16 casts of several f32
    paths, so it is held to a relative norm error of 2^-7 (one bf16 ulp)."""
    from repro_torch.nn import vq_attention as tvq
    from repro_torch.runtime import resolve_device
    resolve_device(cuda)
    gen = torch.Generator().manual_seed(kcb + nblk)
    b, hq, hkv, dh, s = 2, 4, 2, 16, w * nblk
    q, k, v = (torch.randn(shape, generator=gen).to(dtype) for shape in
               ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
    ct = torch.randn((b, s, hq, dh), generator=gen).to(dtype)
    cfg = tvq.VQAttnConfig(k=kcb, window=w)
    before = _all_launches()
    outs = []
    for dev in ("cpu", cuda):
        xs = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        o, count = tvq.train_blocks(*xs, cfg)
        o.backward(ct.to(dev))
        outs.append((o, count, [x.grad for x in xs]))
    assert _all_launches() == before
    (ow, cw, gw), (og, cg, gg) = outs
    assert og.dtype == dtype and torch.equal(cg.cpu(), cw)
    if dtype == torch.float32:
        assert_allclose(og.detach().cpu().numpy(), ow.detach().numpy(),
                        rtol=1e-5, atol=1e-5)
        for got, want in zip(gg, gw):
            assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                            atol=1e-5)
    else:
        assert_bf16_close(og.detach(), ow.detach())
        for got, want in zip(gg, gw):
            assert got.dtype == dtype and _rel_err(got, want) < 2.0 ** -7


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vq", [False, True])
def test_train_loss_cuda_vs_cpu(cuda, dtype, vq):
    """``train_loss`` and its gradient in every parameter of the llama
    smoke (remat on, 4 VQ windows) on the card against the CPU from the
    same weights.  f32: loss ``rtol=1e-5``, gradients ``rtol=1e-4,
    atol=1e-5``.  bf16: every matmul rounds its output to bf16, and the
    card's and the CPU's products round differently, so the loss is held
    to ``rtol=1e-2`` and each gradient leaf to a relative norm error of
    5e-2."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models import lm
    from repro_torch.runtime import resolve_device
    from repro_torch.train.loop import loss_and_grads
    from repro_torch.train.optimizer import tree_leaves
    resolve_device(cuda)
    cfg = dataclasses.replace(get_smoke("llama3.2-3b"), dtype=dtype,
                              remat=True)
    if vq:
        cfg = cfg.with_vq(k=8, window=8)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(2), device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 33),
                        generator=torch.Generator().manual_seed(3))
    before = _all_launches()
    lw, gw = loss_and_grads(params, tok, cfg)
    lg, gg = loss_and_grads(convert.to_device(params, cuda), tok.to(cuda),
                            cfg)
    assert _all_launches() == before
    assert bool(torch.isfinite(lg))
    if dtype == "float32":
        assert_allclose(float(lg), float(lw), rtol=1e-5)
        for got, want in zip(tree_leaves(gg), tree_leaves(gw)):
            assert_allclose(got.cpu().numpy(), want.numpy(), **STEP)
    else:
        assert_allclose(float(lg), float(lw), rtol=1e-2)
        for got, want in zip(tree_leaves(gg), tree_leaves(gw)):
            assert got.dtype == torch.bfloat16
            if float(want.float().norm()) > 0:
                assert _rel_err(got, want) < 5e-2


@pytest.mark.gpu
def test_lm_train_step_on_the_card_launches_no_kernel(cuda):
    """Three steps of the launcher's ``make_train_step`` (bf16 moments) on
    the llama smoke in f32 with VQ-Attention, on the card and on the CPU:
    no hand-written kernel launched (the reference's training path calls
    none), losses and gradient norms ``rtol=1e-4, atol=1e-5``."""
    from repro_torch import convert
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import lm
    from repro_torch.runtime import resolve_device
    from repro_torch.train.loop import TrainState
    resolve_device(cuda)
    cfg = get_smoke("llama3.2-3b").with_vq(k=8, window=8)
    opt = tlaunch.optimizer(1e-3, 3)
    step = tlaunch.make_step(cfg, opt, 2)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(4), device="cpu")
    states = [TrainState(p, opt.init(p), torch.zeros(
        (), dtype=torch.int32, device=p["embed"].device))
        for p in (params, convert.to_device(params, cuda))]
    gen = torch.Generator().manual_seed(5)
    before = _all_launches()
    for _ in range(3):
        tok = torch.randint(0, cfg.vocab, (4, 25), generator=gen)
        states[0], mw = step(states[0], tok)
        states[1], mg = step(states[1], tok.to(cuda))
        for key in ("loss", "grad_norm"):
            assert_allclose(float(mg[key]), float(mw[key]), **STEP)
    assert _all_launches() == before
    assert states[1].opt.mu["head"].dtype == torch.bfloat16
    assert int(states[1].step) == 3


# ---------------------------------------------------------------------------
# the staged-stripe SpMM (spmm_ell_hbm.cu)
# ---------------------------------------------------------------------------

def _hbm_case(b, deg, n, f, seed, pad=0.3):
    """ids/values [b, D] with padding slots (value 0) and whole padding
    rows every 5th row, and an f32 source [n, f]."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, n, (b, deg), generator=g, dtype=torch.int32)
    val = torch.randn((b, deg), generator=g)
    padding = torch.rand((b, deg), generator=g) < pad
    padding[::5] = True
    val[padding] = 0.0
    idx[padding] = 0
    return idx, val, torch.randn((n, f), generator=g)


HBM_SHAPES = [(200, 18, 3000, 128, 128, 128), (53, 6, 210, 40, 8, 8),
              (53, 6, 210, 8, 16, 64), (33, 7, 50, 12, 32, 24),
              (257, 5, 2000, 200, 128, 64), (7, 3, 20, 1, 128, 512),
              (600, 18, 20000, 128, 128, 128),
              # the reference's default tiles, 128 rows and 512-row stripes
              (700, 18, 20000, 128, 128, 512), (300, 9, 1500, 40, 128, 512),
              (130, 4, 100, 256, 128, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,deg,n,f,bb,stripe", HBM_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32] + QDTYPES)
def test_spmm_ell_hbm_kernel_vs_plain(cuda, b, deg, n, f, bb, stripe,
                                      x_dtype):
    """Bit-equal to its plain version for f32, int8 and fp8 sources at
    ragged shapes (tiles with count 0 included), from the host-built and
    the device-built index alike; close to the resident order's sum."""
    from repro_torch.distributed.quantization import quantize_codewords
    from repro_torch.graph.batching import make_stripe_index
    from repro_torch.kernels import spmm_ell_hbm as thbm
    idx, val, x = _hbm_case(b, deg, n, f, seed=b + f)
    if b >= 2 * bb:                       # a tile of padding rows only
        val[bb:2 * bb] = 0.0
        idx[bb:2 * bb] = 0
    sc = None
    if x_dtype != torch.float32:
        qt = quantize_codewords(x[None], dtype=x_dtype)
        x, sc = qt.q[0], qt.scale[0]
    host = make_stripe_index(idx.numpy(), n, mask=val.numpy() != 0, bb=bb,
                             stripe=stripe, device=cuda)
    dev = thbm.stripe_index_torch(idx.to(cuda), val.to(cuda), n, bb=bb,
                                  stripe=stripe)
    assert torch.equal(host.counts, dev.counts)
    if b >= 2 * bb:
        assert int(dev.counts[1]) == 0
    want = tref.spmm_ell_hbm(idx, val, x, make_stripe_index(
        idx.numpy(), n, mask=val.numpy() != 0, bb=bb, stripe=stripe,
        device="cpu"), sc)
    args = [idx.to(cuda), val.to(cuda), x.to(cuda)]
    scc = None if sc is None else sc.to(cuda)
    before = (thbm.launches, thbm.launches_q)
    # at the reference's tiles a call without an index gives the same bits
    indices = (host, dev) + ((None,) if (bb, stripe) == (128, 512) else ())
    for si in indices:
        got = thbm.spmm_ell_hbm_cuda(*args, si, scc)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    quantized = x_dtype != torch.float32
    n = len(indices)
    assert (thbm.launches, thbm.launches_q) == (before[0] + n,
                                                before[1] + n * quantized)
    assert_allclose(want.numpy(), tref.spmm_ell(idx, val, x, sc).numpy(),
                    **TOL)


@pytest.mark.gpu
def test_spmm_ell_hbm_unaligned_source_and_default_index(cuda):
    """A source view that is not 16-byte aligned is gathered element by
    element; without an index the call takes the reference's tiles and
    every touched stripe, as the index built on the device lists them."""
    from repro_torch.kernels import spmm_ell_hbm as thbm
    idx, val, _ = _hbm_case(300, 9, 999, 8, seed=11)
    g = torch.Generator().manual_seed(12)
    base = torch.randint(-127, 128, (1000, 8), generator=g,
                         dtype=torch.int8)
    x = base[1:]                                       # 8 bytes off
    sc = torch.rand((1, 8), generator=g) + 0.1
    xc = base.to(cuda)[1:]
    assert xc.data_ptr() % 16 != 0 and xc.is_contiguous()
    got = thbm.spmm_ell_hbm_cuda(idx.to(cuda), val.to(cuda), xc, None,
                                 sc.to(cuda))
    torch.cuda.synchronize()
    si = thbm.stripe_index_torch(idx, val, 999)
    assert (si.bb, si.stripe) == (128, 512)
    assert torch.equal(got.cpu(), tref.spmm_ell_hbm(idx, val, x, si, sc))


@pytest.mark.gpu
def test_spmm_ell_hbm_rejects_bad_operands(cuda):
    from repro_torch.graph.batching import make_stripe_index
    from repro_torch.kernels import spmm_ell_hbm as thbm
    idx, val, x = _hbm_case(64, 4, 4096, 128, seed=13)
    want = tref.spmm_ell_hbm(idx, val, x, make_stripe_index(
        idx.numpy(), 4096, mask=val.numpy() != 0, bb=64, stripe=512,
        device="cpu"))
    idx, val, x = idx.to(cuda), val.to(cuda), x.to(cuda)
    # a 512-row stripe of 128 f32 columns (256 KB, more than a block's
    # shared memory) is taken: nothing is staged any more
    big = make_stripe_index(idx.cpu().numpy(), 4096,
                            mask=val.cpu().numpy() != 0, bb=64, stripe=512,
                            device=cuda)
    got = thbm.spmm_ell_hbm_cuda(idx, val, x, big)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    tiles = make_stripe_index(idx[:32].cpu().numpy(), 4096, bb=8,
                              stripe=64, device=cuda)
    with pytest.raises(ValueError, match="tiles"):
        thbm.spmm_ell_hbm_cuda(idx, val, x, tiles)
    rows = make_stripe_index(idx.cpu().numpy() % 128, 128, bb=8, stripe=64,
                             device=cuda)
    with pytest.raises(ValueError, match="n_src"):
        thbm.spmm_ell_hbm_cuda(idx, val, x, rows)
    wide, wval, _ = _hbm_case(300, 4, 4096, 8, seed=15)
    with pytest.raises(ValueError, match="row tile"):       # 256 > 128
        thbm.spmm_ell_hbm_cuda(wide.to(cuda), wval.to(cuda), x,
                               make_stripe_index(wide.numpy(), 4096, bb=256,
                                                 stripe=16, device=cuda))
    with pytest.raises(ValueError, match="columns"):
        thbm.spmm_ell_hbm_cuda(idx, val, torch.zeros((4096, 300),
                                                     device=cuda))
    with pytest.raises(TypeError):
        thbm.spmm_ell_hbm_cuda(idx, val, x.half())
    with pytest.raises(ValueError, match="x_scale"):
        thbm.spmm_ell_hbm_cuda(idx, val, x.to(torch.int8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        thbm.spmm_ell_hbm_cuda(idx.cpu(), val.cpu(), x.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32] + QDTYPES)
def test_spmm_ell_hbm_deg_up_to_its_shared_memory_limit(cuda, x_dtype):
    """Shared memory holds the tile's slot lists, so it bounds the slots a
    row: the widest deg that fits is taken and bit-equal to the plain
    version, one more slot is refused."""
    from repro_torch.distributed.quantization import quantize_codewords
    from repro_torch.kernels import spmm_ell_hbm as thbm
    n, f = 4096, 128
    deg = 1
    while thbm.smem_bytes(128, 512, deg + 1, n,
                          indexed=False) <= thbm.SMEM_LIMIT:
        deg += 1
    idx, val, x = _hbm_case(300, deg, n, f, seed=deg)
    sc = None
    if x_dtype != torch.float32:
        qt = quantize_codewords(x[None], dtype=x_dtype)
        x, sc = qt.q[0], qt.scale[0]
    si = thbm.stripe_index_torch(idx, val, n)
    want = tref.spmm_ell_hbm(idx, val, x, si, sc)
    scc = None if sc is None else sc.to(cuda)
    got = thbm.spmm_ell_hbm_cuda(idx.to(cuda), val.to(cuda), x.to(cuda),
                                 None, scc)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    wide = torch.cat([idx, idx[:, :1]], 1).contiguous()
    wval = torch.cat([val, val[:, :1]], 1).contiguous()
    with pytest.raises(ValueError, match="shared memory"):
        thbm.spmm_ell_hbm_cuda(wide.to(cuda), wval.to(cuda), x.to(cuda),
                               None, scc)


@pytest.mark.gpu
def test_dispatch_sends_cuda_tensors_to_each_variant(cuda):
    """``ops.spmm_ell`` on the card: a forced or budget-picked variant
    launches that kernel (f32 and QTensor sources), the backward of the
    staged forward is ``spmm_ell_t``; the results agree."""
    from repro_torch.distributed.quantization import QTensor
    from repro_torch.kernels import spmm_ell_hbm as thbm
    idx, val, x = _hbm_case(300, 9, 5000, 64, seed=14)
    idx, val = idx.to(cuda), val.to(cuda)
    sc = torch.rand((1, 64), device=cuda) + 0.5
    q = QTensor(torch.randint(-127, 128, (5000, 64), device=cuda,
                              dtype=torch.int8), sc)
    outs = {}
    try:
        # 0.5 MiB: the f32 source (1.28 MB) is staged, the int8 one
        # (0.32 MB) stays resident
        for variant, budget in (("resident", None), ("hbm", None),
                                ("auto", 0.5), ("auto", 50.0)):
            ops.configure_spmm_dispatch(variant=variant,
                                        l2_budget_mb=budget, reset=True)
            picked = ops.spmm_ell_variant(5000, 64, 4)
            picked_q = ops.spmm_ell_variant(5000, 64, 1)
            xc = x.to(cuda).requires_grad_(True)
            before = thbm.launches, tsp.launches, tsp.launches_t
            out = ops.spmm_ell(idx, val, xc)
            out.sum().backward()
            ops.spmm_ell(idx, val, q)
            torch.cuda.synchronize()
            staged = (picked == "hbm") + (picked_q == "hbm")
            assert (thbm.launches - before[0], tsp.launches - before[1],
                    tsp.launches_t - before[2]) == (staged, 2 - staged, 1), \
                (variant, budget)
            outs[picked] = (out.detach(), xc.grad)
        assert set(outs) == {"resident", "hbm"}
        for a, b in zip(outs["hbm"], outs["resident"]):
            assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL)
    finally:
        ops.configure_spmm_dispatch(reset=True)


@pytest.mark.gpu
def test_sampler_step_cuda_vs_cpu(cuda):
    """One NS-SAGE epoch plan through ``sampler_train_epoch`` on the card,
    the staged kernel forced by a small budget, and on the CPU: losses and
    params ``rtol=1e-4, atol=1e-5``."""
    from repro_torch import convert
    from repro_torch.core.codebook import CodebookConfig
    from repro_torch.graph.batching import pack_sampler_epoch
    from repro_torch.graph.datasets import synthetic_arxiv
    from repro_torch.graph.sampling import sample_epoch
    from repro_torch.kernels import spmm_ell_hbm as thbm
    from repro_torch.models.gnn import (GNNConfig, init_gnn,
                                        sampler_train_epoch)
    from repro_torch.train.optimizer import adam
    gr = synthetic_arxiv(n=3000, seed=0)
    cfg = GNNConfig(backbone="gcn", f_in=gr.f, hidden=32,
                    n_out=gr.num_classes, n_layers=2,
                    codebook=CodebookConfig(k=32, f_prod=4))
    batches = sample_epoch(gr, "ns-sage", batch_size=700,
                           rng=np.random.default_rng(0), fanouts=[3, 3])
    opt = adam(1e-3)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    res = {}
    try:
        ops.configure_spmm_dispatch(l2_budget_mb=0.01, reset=True)
        for dev in ("cpu", cuda):
            p = convert.to_device(params, dev)
            splan = pack_sampler_epoch(batches, gr.max_degree(), device=dev)
            before = thbm.launches
            res[str(dev)] = sampler_train_epoch(
                p, opt.init(p), splan,
                torch.from_numpy(gr.features).to(dev),
                torch.from_numpy(gr.labels).to(dev), cfg, opt)
            if dev != "cpu":
                assert thbm.launches - before == \
                    splan.s * cfg.n_layers
    finally:
        ops.configure_spmm_dispatch(reset=True)
    (pc, _, lc), (pg, _, lg) = res["cpu"], res[str(cuda)]
    assert_allclose(lg.cpu().numpy(), lc.numpy(), **STEP)
    for a, b in zip(pg, pc):
        for k in a:
            assert_allclose(a[k].cpu().numpy(), b[k].numpy(), **STEP)


# ---------------------------------------------------------------------------
# vq_update's tensor-core scan and context_ell's paths, at the inputs that
# stress them: bit-equal to the plain version computed on the same card
# ---------------------------------------------------------------------------

def _assert_vq_update_exact(x, cw, emit=torch.int32):
    """idx and qerr bit-equal to the plain version on the card, counts
    equal, sums within the scatter bound of the exact (float64) sums: a
    sum of c terms in any order is within c 2^-24 sum |term| of them,
    while two fp32 sums in different orders -- the kernel's and the plain
    version's -- may differ by twice that (the wide build's reached 1.045
    times it on near-tie codebooks, on an H100 80GB HBM3 at 700 W)."""
    got = tvu.vq_assign_update_cuda(x, cw, emit)
    want = tref.vq_assign_update(x, cw, emit)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]), \
        f"{int((got[0] != want[0]).sum())} assignments differ"
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    nb, _, f = x.shape
    k = cw.shape[1]
    flat = (want[0].long() + k * torch.arange(nb, device=x.device)[:, None]
            ).reshape(-1)
    terms_abs = torch.zeros((nb * k, f), device=x.device).index_add_(
        0, flat, x.abs().reshape(-1, f)).reshape(nb, k, f)
    exact = torch.zeros((nb * k, f), dtype=torch.float64,
                        device=x.device).index_add_(
        0, flat, x.double().reshape(-1, f)).reshape(nb, k, f)
    assert_scatter_close(got[3].cpu().double(), exact.cpu(), terms_abs.cpu(),
                         want[2][..., None].cpu().numpy())
    return got


def _near_tie_codebook(nb, n, k, f, seed, cuda):
    """Codewords 1::4 duplicate 0::4 (the lowest index must win), 2::4 are
    0::4 one fp32 ulp up in one coordinate; rows on a codeword, halfway
    between two (equidistant), and one in seven scaled to |x| ~ 1e3."""
    g = torch.Generator().manual_seed(seed)
    cw = torch.randn((nb, k, f), generator=g)
    cw[:, 1::4] = cw[:, 0::4][:, :cw[:, 1::4].shape[1]]
    c2 = cw[:, 0::4][:, :cw[:, 2::4].shape[1]].clone()
    c2[..., 0] = torch.nextafter(c2[..., 0], torch.full_like(c2[..., 0], 9.0))
    cw[:, 2::4] = c2
    pick = torch.randint(0, k, (nb, n), generator=g)
    on = torch.gather(cw, 1, pick[..., None].expand(nb, n, f))
    other = torch.gather(cw, 1, ((pick + 5) % k)[..., None].expand(nb, n, f))
    x = torch.randn((nb, n, f), generator=g)
    x[:, 0::3] = on[:, 0::3]
    x[:, 1::3] = (0.5 * (on + other))[:, 1::3]
    x[:, 3::7] *= 1e3
    return x.contiguous().to(cuda), cw.contiguous().to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [8, 21, 12])
@pytest.mark.parametrize("n,k", [(5003, 1024), (777, 1001), (130, 37),
                                 (300, 2641)])
def test_vq_update_near_ties_bit_equal(cuda, f, n, k):
    """Duplicated codewords, 1-ulp neighbours, equidistant and large-norm
    rows -- most rows near ties, rescored through the warps' queues -- n
    and k not multiples of the kernel's tiles (32 rows a warp, 8
    codewords), at both training widths and a generic one; k 2641 at f 21
    leaves no room for the rows beside the codewords (read in place)."""
    _assert_vq_update_exact(*_near_tie_codebook(3, n, k, f, n + k + f, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [8, 21, 4, 16])
def test_scan_next_to_far_out_codewords_bit_equal(cuda, f):
    """Codewords in tight clusters with rows inside them and one in 32
    scaled 15x out, as trained codebooks hold them: the rows' thresholds
    use the norms that can win, and both kernels on the scan stay
    bit-equal (vq_update at its widths, vq_assign at its served ones, read
    through a branch view)."""
    g = torch.Generator().manual_seed(f)
    nb, n, k = 3, 4000, 1024
    centres = torch.randn((nb, k // 8, f), generator=g)
    cw = centres.repeat_interleave(8, dim=1) \
        + 0.05 * torch.randn((nb, k, f), generator=g)
    cw[:, 7::32] *= 15.0
    pick = torch.randint(0, k // 8, (nb, n), generator=g)
    x = torch.gather(centres, 1, pick[..., None].expand(nb, n, f)) \
        + 0.05 * torch.randn((nb, n, f), generator=g)
    if f in (8, 21):
        _assert_vq_update_exact(x.contiguous().to(cuda), cw.to(cuda))
        return
    table = x.transpose(0, 1).reshape(n, nb * f).contiguous().to(cuda)
    xv = table.reshape(n, nb, f).transpose(0, 1)
    got, gmin = tva.vq_assign_cuda(xv, cw.to(cuda), want_min=True)
    want, wmin = tref.vq_assign(xv, cw.to(cuda), want_min=True)
    assert torch.equal(got, want)
    assert torch.equal(gmin, wmin)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [8, 21])
def test_vq_update_large_rows_next_to_small_codewords(cuda, f):
    g = torch.Generator().manual_seed(f)
    x = (torch.randn((4, 3000, f), generator=g) * 1e3).to(cuda)
    cw = (torch.randn((4, 1024, f), generator=g) * 1e-2).to(cuda)
    _assert_vq_update_exact(x, cw)


@pytest.mark.gpu
@pytest.mark.parametrize("k,f", [(1024, 8), (1024, 21), (2048, 21)])
def test_vq_update_every_row_on_one_codeword(cuda, k, f):
    """The collapsed codebook: every row alike, at k 1024 and at k 2048 /
    f 21 (its codewords alone take 180 KiB of the block's shared memory):
    the warp-aggregated statistics stay exact."""
    g = torch.Generator().manual_seed(k + f)
    cw = torch.randn((4, k, f), generator=g)
    x = torch.randn((4, 1, f), generator=g).expand(4, 20000, f).contiguous()
    got = tvu.vq_assign_update_cuda(x.to(cuda), cw.to(cuda))
    assert bool((got[2].max(dim=1).values == 20000).all())
    _assert_vq_update_exact(x.to(cuda), cw.to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("emit,k", [(torch.uint8, 256), ("uint4", 16)])
def test_vq_update_narrow_emit_near_ties(cuda, emit, k):
    _assert_vq_update_exact(*_near_tie_codebook(8, 3001, k, 8, k, cuda),
                            emit)


# The scan's own tensor-core distances d~ for one branch: the kernel's
# fragment loads (load_b), 3xTF32 products (tile_dist) and |c|^2 staging,
# one m16 tile of rows a warp, written out for every (row, codeword).
_DIST_PROBE = r"""
#include "vq_update.cuh"
namespace {
template <int F>
__global__ void dist_probe(const float* x, const float* cw, float* dout,
                           int n, int k) {
  extern __shared__ float sm[];
  float* c_s = sm;
  float* cn2_s = sm + (size_t)k * F;
  for (int i = threadIdx.x; i < k * F; i += blockDim.x) {
    const int c = i / F;
    c_s[cw_off<F>(c, i - c * F, F)] = cw[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float a = 0.f;
    for (int j = 0; j < F; ++j) {
      const float v = c_s[cw_off<F>(c, j, F)];
      a = __fadd_rn(a, __fmul_rn(v, v));
    }
    cn2_s[c] = a;
  }
  __syncthreads();
  constexpr int KS = Cfg<F>::KS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = (blockIdx.x * (blockDim.x / 32) + warp) * 16;
  if (r0 >= n) return;
  uint32_t ah[KS][4], al[KS][4];
  for (int h = 0; h < 2; ++h)
    for (int ks = 0; ks < KS; ++ks)
      for (int t = 0; t < 2; ++t) {
        const int r = r0 + g + 8 * h, j = ks * 8 + q + 4 * t;
        const float v = (r < n && j < F) ? x[(size_t)r * F + j] : 0.f;
        split_tf32(-2.f * v, ah[ks][h + 2 * t], al[ks][h + 2 * t]);
      }
  for (int nt = 0; nt < k / 8; ++nt) {
    uint32_t bh[KS][2], bl[KS][2];
    float cc[2], d[4];
    load_b<F>(c_s, cn2_s, nt, g, q, k, F, KS, false, bh, bl, cc);
    tile_dist<F>(d, ah, al, bh, bl, cc, KS);
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + 8 * (i >> 1), c = nt * 8 + 2 * q + (i & 1);
      if (r < n) dout[(size_t)r * k + c] = d[i];
    }
  }
}
}  // namespace
extern "C" int probe_dist(const float* x, const float* cw, float* d, int n,
                          int k, int f) {
  const size_t smem = (size_t)k * (f + 1) * 4;
  const int blocks = (n + 127) / 128;
  auto kern = f == 8 ? dist_probe<8> : dist_probe<21>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<blocks, 256, smem>>>(x, cw, d, n, k);
  return (int)cudaDeviceSynchronize();
}
"""


@pytest.mark.gpu
@pytest.mark.parametrize("f", [8, 21])
def test_vq_update_tensor_core_distances_within_the_bound(cuda, f, tmp_path):
    """The exact answers of ``vq_update`` rest on |d~ - d| <= E for every
    row and codeword (``vq_update.candidate_bound``; its step (ii) models
    the tensor cores' accumulation).  The scan's own d~, from a probe
    built on the kernel's header, against the plain version's fp32 d on
    the four input families of the derivation -- random, mixed magnitudes
    (one coordinate 1e6 times the rest, codewords over six decades), large
    rows next to small codewords, and |c|^2-dominated: the largest error
    stays under a quarter of E."""
    import ctypes
    import subprocess
    from repro_torch.kernels import _build
    src = tmp_path / "probe.cu"
    src.write_text(_DIST_PROBE)
    lib = tmp_path / "probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-shared", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    probe = ctypes.CDLL(str(lib))
    probe.probe_dist.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    g = torch.Generator(device=cuda).manual_seed(f)
    n, k = 8192, 1024
    x = torch.randn((n, f), generator=g, device=cuda)
    cw = torch.randn((k, f), generator=g, device=cuda)
    xm = torch.randn((n, f), generator=g, device=cuda) * 1e-3
    xm[:, 0] *= 1e6
    cwm = cw * torch.logspace(-3, 3, f, device=cuda)
    for xs, cs in ((x, cw), (xm, cwm), (x * 1e3, cw * 1e-2),
                   (x * 1e-3, cw * 10 + 50)):
        xs, cs = xs.contiguous(), cs.contiguous()
        d = torch.empty((n, k), device=cuda)
        assert probe.probe_dist(xs.data_ptr(), cs.data_ptr(), d.data_ptr(),
                                n, k, f) == 0
        dot = torch.zeros((n, k), device=cuda)
        for j in range(f):
            dot = dot + xs[:, j, None] * cs[None, :, j]
        want = tref._sq_norms(cs)[None, :] - 2.0 * dot
        bound = tvu.candidate_bound(xs.double().norm(dim=1)[:, None],
                                    float(cs.double().norm(dim=1).max()), f)
        ratio = float(((d.double() - want.double()).abs() / bound).max())
        assert ratio < 0.25, ratio


# vq_assign's scan distances d~ for one branch at its served widths: the
# shared memory staged as the kernel stages it (with its codewords' hi / lo
# pairs at f 4), the kernel's load_b and tile_dist, one m16 tile of rows a
# warp, written out for every (row, codeword).
_ASSIGN_PROBE = r"""
#include "vq_update.cuh"
namespace {
template <int F>
__global__ void assign_probe(const float* x, const float* cw, float* dout,
                             int n, int k) {
  using C = Cfg<F>;
  extern __shared__ float sm[];
  const int npair = (k + 7) / 8 * 8 * C::KS * C::KSTEP;
  float2* b_s = reinterpret_cast<float2*>(sm);
  float* cn2_s = sm + (C::SPLIT ? 2 * npair : 0);
  float* c_s = cn2_s + k;
  for (int i = threadIdx.x; i < k * F; i += blockDim.x)
    c_s[cw_off<F>(i / F, i % F, F)] = cw[i];
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float a = 0.f;
    for (int j = 0; j < F; ++j) {
      const float v = c_s[cw_off<F>(c, j, F)];
      a = __fadd_rn(a, __fmul_rn(v, v));
    }
    cn2_s[c] = a;
  }
  if (C::SPLIT)
    for (int i = threadIdx.x; i < npair; i += blockDim.x) {
      const int c = i / (C::KS * C::KSTEP), j = i % (C::KS * C::KSTEP);
      uint32_t h, l;
      split_tf32(c < k && j < F ? c_s[cw_off<F>(c, j, F)] : 0.f, h, l);
      b_s[i] = make_float2(__uint_as_float(h), __uint_as_float(l));
    }
  __syncthreads();
  const float* scan_s = C::SPLIT ? reinterpret_cast<const float*>(b_s) : c_s;
  constexpr int KS = C::KS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = (blockIdx.x * (blockDim.x / 32) + warp) * 16;
  if (r0 >= n) return;
  uint32_t ah[KS][4] = {}, al[KS][4] = {};
  for (int h = 0; h < 2; ++h)
    for (int ks = 0; ks < KS; ++ks)
      for (int t = 0; t < C::KSTEP / 4; ++t) {
        const int r = r0 + g + 8 * h, j = ks * C::KSTEP + q + 4 * t;
        const float v = (r < n && j < F) ? x[(size_t)r * F + j] : 0.f;
        split_tf32(-2.f * v, ah[ks][h + 2 * t], al[ks][h + 2 * t]);
      }
  for (int nt = 0; nt < k / 8; ++nt) {
    uint32_t bh[KS][2], bl[KS][2];
    float cc[2], d[4];
    load_b<F>(scan_s, cn2_s, nt, g, q, k, F, KS, false, bh, bl, cc);
    tile_dist<F>(d, ah, al, bh, bl, cc, KS);
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + 8 * (i >> 1), c = nt * 8 + 2 * q + (i & 1);
      if (r < n) dout[(size_t)r * k + c] = d[i];
    }
  }
}
}  // namespace
extern "C" int probe_dist(const float* x, const float* cw, float* d, int n,
                          int k, int f) {
  const size_t smem = smem_base<4>(k, 4) > smem_base<16>(k, 16)
                          ? smem_base<4>(k, 4) : smem_base<16>(k, 16);
  const int blocks = (n + 127) / 128;
  auto kern = f == 4 ? assign_probe<4> : assign_probe<16>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<blocks, 256, smem>>>(x, cw, d, n, k);
  return (int)cudaDeviceSynchronize();
}
"""


@pytest.mark.gpu
@pytest.mark.parametrize("f", [4, 16])
def test_vq_assign_tensor_core_distances_within_the_bound(cuda, f,
                                                          tmp_path):
    """``vq_assign``'s scan at its served widths -- m16n8k4 products from
    the staged hi / lo pairs at f 4, m16n8k8 at f 16 -- against the plain
    version's fp32 d, on the four input families of the bound's
    derivation: the largest |d~ - d| stays under a quarter of the bound
    its rescoring uses (``vq_update.candidate_bound``)."""
    import ctypes
    import subprocess
    from repro_torch.kernels import _build
    src = tmp_path / "probe.cu"
    src.write_text(_ASSIGN_PROBE)
    lib = tmp_path / "probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-shared", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    probe = ctypes.CDLL(str(lib))
    probe.probe_dist.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    g = torch.Generator(device=cuda).manual_seed(f)
    n, k = 8192, 1024
    x = torch.randn((n, f), generator=g, device=cuda)
    cw = torch.randn((k, f), generator=g, device=cuda)
    xm = torch.randn((n, f), generator=g, device=cuda) * 1e-3
    xm[:, 0] *= 1e6
    cwm = cw * torch.logspace(-3, 3, f, device=cuda)
    for xs, cs in ((x, cw), (xm, cwm), (x * 1e3, cw * 1e-2),
                   (x * 1e-3, cw * 10 + 50)):
        xs, cs = xs.contiguous(), cs.contiguous()
        d = torch.empty((n, k), device=cuda)
        assert probe.probe_dist(xs.data_ptr(), cs.data_ptr(), d.data_ptr(),
                                n, k, f) == 0
        dot = torch.zeros((n, k), device=cuda)
        for j in range(f):
            dot = dot + xs[:, j, None] * cs[None, :, j]
        want = tref._sq_norms(cs)[None, :] - 2.0 * dot
        bound = tvu.candidate_bound(xs.double().norm(dim=1)[:, None],
                                    float(cs.double().norm(dim=1).max()), f)
        ratio = float(((d.double() - want.double()).abs() / bound).max())
        assert ratio < 0.25, ratio


def _context_operands(b, deg, n, nb, k, fb, f_out, seed, cuda):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, n, (b, deg), generator=g, dtype=torch.int32)
    val = torch.randn((b, deg), generator=g)
    val[:, -1] = 0.0                                  # a padding slot
    assign = torch.randint(0, k, (nb, n), generator=g, dtype=torch.int32)
    cw = torch.randn((nb, k, fb), generator=g)
    w_t = torch.randn((nb * fb, f_out), generator=g)
    return [t.to(cuda) for t in (ids, val, assign, cw, w_t)]


def _node_major(table):
    """The table over contiguous [n, nb] storage (a packed table's bytes:
    [ceil(n / 2), nb]), as ``core.conv.hold_table`` holds a tier state's
    table on the card."""
    from repro_torch.distributed.quantization import PackedAssignment
    if isinstance(table, PackedAssignment):
        return PackedAssignment(table.packed.t().contiguous().t(), table.n)
    return table.t().contiguous().t()


@pytest.mark.gpu
@pytest.mark.parametrize("cw_dtype", [torch.float32] + QDTYPES)
@pytest.mark.parametrize("tab", ["i32", "u8", "a4"])
@pytest.mark.parametrize("b", [31, 4099])
@pytest.mark.parametrize("deg", [1, 17, 40])
def test_context_ell_every_form_both_layouts(cuda, cw_dtype, tab, b, deg):
    """Every codeword type x table kind, the plain and the w_t form, the
    table row-major and node-major: b not a multiple of the w_t kernel's
    32 rows (31 takes the small-batch kernels, 4,099 the staged one), deg
    not a multiple of the 32-slot chunk, f_out 130 not a multiple of the
    epilogue's 4 x 128 outputs.  Bit-equal."""
    from repro_torch.distributed.quantization import quantize_codewords
    ids, val, assign, cw, w_t = _context_operands(b, deg, 3001, 8, 16, 5,
                                                  130, b + deg, cuda)
    scale = None
    if cw_dtype != torch.float32:
        qt = quantize_codewords(cw, dtype=cw_dtype)
        cw, scale = qt.q, qt.scale
    a = _table(assign, tab)
    for wt in (None, w_t):
        want = tref.context_ell(ids, val, a, cw, wt, scale)
        for table in (a, _node_major(a)):
            got = tce.context_ell_cuda(ids, val, table, cw, wt, scale)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,k,fb", [(32, 1024, 4), (8, 1024, 16),
                                     (8, 1024, 5)])
def test_context_ell_staged_groups_bit_equal(cuda, nb, k, fb):
    """The large-batch kernel stages groups of branches' codewords (at k
    1024: 8 branches of width 4, 3 of width 16) and the w_t form all of
    them where they fit (8 x 5): every path bit-equal, both layouts."""
    ids, val, assign, cw, w_t = _context_operands(5000, 18, 20000, nb, k, fb,
                                                  128, nb + fb, cuda)
    for wt in (None, w_t):
        want = tref.context_ell(ids, val, assign, cw, wt)
        for table in (assign, _node_major(assign)):
            got = tce.context_ell_cuda(ids, val, table, cw, wt)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.gpu
def test_context_ell_rejects_a_table_in_neither_layout(cuda):
    ids, val, assign, cw, _ = _context_operands(8, 3, 50, 4, 16, 2, 4, 0,
                                                cuda)
    with pytest.raises(ValueError, match="node-major"):
        tce.context_ell_cuda(ids, val, assign[:, ::2], cw)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", [False, True])
@pytest.mark.parametrize("tab", ["i32", "u8", "a4"])
def test_table_layout_on_the_card(cuda, tab, tier):
    """Moved to the card, the table of a state with a quantized codeword
    snapshot (a tier) is held node-major and an fp32 state's row-major,
    whatever its type; ``refresh_assignment`` keeps the layout and gives
    the CPU refresh's table and histogram; moved back, it is row-major."""
    from repro_torch import convert
    from repro_torch.core import conv as tconv
    from repro_torch.distributed.quantization import quantize_codewords
    g = torch.Generator().manual_seed(3)
    assign = torch.randint(0, 16, (8, 3001), generator=g, dtype=torch.int32)
    qcw = None
    if tier:
        q = quantize_codewords(torch.randn((8, 16, 4), generator=g))
        qcw = tconv.QuantizedCodewords(q, q)
    st = tconv.LayerVQState(None, _table(assign, tab),
                            tconv.branch_histogram(assign, 16), qcw)
    dev = convert.to_device(st, cuda)

    def buf(table):
        return table.packed if tab == "a4" else table

    assert tce.is_node_major(buf(dev.assignment)) == tier
    assert tier or buf(dev.assignment).is_contiguous()
    ids = torch.randperm(3001, generator=g)[:500].int()
    new = torch.randint(0, 16, (8, 500), generator=g, dtype=torch.int32)
    want = tconv.refresh_assignment(st, ids, new)
    got = tconv.refresh_assignment(dev, ids.to(cuda), new.to(cuda))
    assert tce.is_node_major(buf(got.assignment)) == tier
    assert torch.equal(buf(got.assignment).cpu(), buf(want.assignment))
    assert torch.equal(got.counts.cpu(), want.counts)
    assert buf(convert.to_device(got, "cpu").assignment).is_contiguous()


# ---------------------------------------------------------------------------
# the wide build of the scan (f > 32, or a codebook beyond the narrow
# build's shared memory): odd widths, k across its 128-codeword tiles, n
# across its 64- and 128-row tiles, strided rows, near ties, the queue
# counter, the prologue's split codewords and the launch plan
# ---------------------------------------------------------------------------

WIDE_F = [33, 43, 65, 72, 128, 129, 168, 256, 300, 440]
WIDE_K = [1, 63, 511, 513, 1024, 2049, 4096]


@pytest.mark.gpu
@pytest.mark.parametrize("f", WIDE_F)
@pytest.mark.parametrize("k", WIDE_K)
def test_vq_update_wide_vs_plain(cuda, f, k):
    """idx and qerr bit-equal, counts equal, sums within the scatter bound,
    n not a multiple of the row tile; the launch takes the wide build
    and is counted at its shape."""
    g = torch.Generator().manual_seed(f * k)
    x = torch.randn((2, 701, f), generator=g).to(cuda)
    cw = torch.randn((2, k, f), generator=g).to(cuda)
    key = (2, 701, k, f, "int32")
    before = tvu.launches_wide, tvu.launches_wide_by_shape.get(key, 0)
    _assert_vq_update_exact(x, cw)
    assert (tvu.launches_wide, tvu.launches_wide_by_shape[key]) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("f", WIDE_F)
@pytest.mark.parametrize("k", WIDE_K)
def test_vq_assign_wide_vs_plain_on_a_branch_view(cuda, f, k):
    """Index and want_min bit-equal, rows read through the branch view of
    an [n, nb * f] table."""
    g = torch.Generator().manual_seed(f + k)
    nb, n = 3, 517
    table = torch.randn((n, nb * f), generator=g).to(cuda)
    xv = table.reshape(n, nb, f).transpose(0, 1)
    cw = torch.randn((nb, k, f), generator=g).to(cuda)
    key = (nb, n, k, f)
    before = tva.launches_wide, tva.launches_wide_by_shape.get(key, 0)
    got, gmin = tva.vq_assign_cuda(xv, cw, want_min=True)
    want, wmin = tref.vq_assign(xv, cw, want_min=True)
    torch.cuda.synchronize()
    assert (tva.launches_wide, tva.launches_wide_by_shape[key]) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want), \
        f"{int((got != want).sum())} assignments differ"
    assert torch.equal(gmin, wmin)
    assert torch.equal(tva.vq_assign_cuda(xv, cw), got)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [43, 65, 256])
@pytest.mark.parametrize("nb,n", [(1, 1), (1, 37), (2, 64), (1, 127),
                                  (3, 129), (1, 5000), (4, 42335)])
def test_vq_update_wide_row_tiles(cuda, f, nb, n):
    """n smaller than one tile, one row past a tile, a grid with fewer
    128-row tiles than SMs (the launch then takes 64-row tiles) and the
    training batch: both row tilings bit-equal to each other and to the
    plain version."""
    g = torch.Generator().manual_seed(nb * n + f)
    x = torch.randn((nb, n, f), generator=g).to(cuda)
    cw = torch.randn((nb, 1024, f), generator=g).to(cuda)
    got = _assert_vq_update_exact(x, cw)
    for wgs in (1, 2):
        other = tvu.vq_assign_update_wide_tiles_cuda(x, cw, wgs)
        assert torch.equal(other[0], got[0]) and torch.equal(other[1], got[1])
        assert torch.equal(other[2], got[2])


@pytest.mark.gpu
@pytest.mark.parametrize("f", [43, 65, 72, 168, 256, 440])
@pytest.mark.parametrize("n,k", [(3001, 1024), (130, 37), (700, 2049)])
def test_wide_near_ties_bit_equal(cuda, f, n, k):
    """Duplicated codewords, 1-ulp neighbours, equidistant and large-norm
    rows: most rows queue and are rescored; both kernels bit-equal."""
    x, cw = _near_tie_codebook(2, n, k, f, n + k + f, cuda)
    _assert_vq_update_exact(x, cw)
    table = x.transpose(0, 1).reshape(n, 2 * f).contiguous()
    xv = table.reshape(n, 2, f).transpose(0, 1)
    got, gmin = tva.vq_assign_cuda(xv, cw, want_min=True)
    want, wmin = tref.vq_assign(xv, cw, want_min=True)
    assert torch.equal(got, want)
    assert torch.equal(gmin, wmin)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [43, 65, 128, 256, 440])
def test_wide_every_row_on_one_codeword(cuda, f):
    """The collapsed codebook at the wide widths: one codeword takes every
    row; the chained statistics stay exact in count."""
    g = torch.Generator().manual_seed(f)
    cw = torch.randn((2, 1024, f), generator=g)
    x = torch.randn((2, 1, f), generator=g).expand(2, 9000, f).contiguous()
    got = tvu.vq_assign_update_cuda(x.to(cuda), cw.to(cuda))
    assert bool((got[2].max(dim=1).values == 9000).all())
    _assert_vq_update_exact(x.to(cuda), cw.to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [43, 65, 256])
@pytest.mark.parametrize("emit,k", [(torch.uint8, 256), (torch.uint8, 37),
                                    ("uint4", 16)])
def test_vq_update_wide_narrow_emit(cuda, emit, k, f):
    """The uint8 emit of the wide build: the int32 build's ids, qerr and
    counts, counted in ``launches_u8``; near ties bit-equal."""
    x, cw = _near_tie_codebook(4, 2001, k, f, k + f, cuda)
    before = (tvu.launches_u8, tvu.launches_wide)
    narrow = tvu.vq_assign_update_cuda(x, cw, emit)
    wide = tvu.vq_assign_update_cuda(x, cw)
    torch.cuda.synchronize()
    assert (tvu.launches_u8, tvu.launches_wide) == (before[0] + 1,
                                                    before[1] + 2)
    assert narrow[0].dtype == torch.uint8
    assert torch.equal(narrow[0].int(), wide[0])
    assert torch.equal(narrow[1], wide[1]) and torch.equal(narrow[2],
                                                           wide[2])
    _assert_vq_update_exact(x, cw, emit)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [43, 65, 128])
@pytest.mark.parametrize("ties", [False, True])
def test_wide_queue_counter(cuda, f, ties):
    """The kernel's count of rows queued for its second pass.  On integer
    rows and codewords in [-2, 2] every TF32 part and every sum is exact,
    so d~ = d and the count is the one ``queued_rows_est``'s rule gives
    (here E < 1: exactly the rows whose two smallest distances tie); with
    codeword 1 a copy of codeword 0 and every row on it, every row ties and
    queues."""
    g = torch.Generator().manual_seed(f + ties)
    nb, n, k = 2, 3001, 1024
    cw = torch.randint(-2, 3, (nb, k, f), generator=g).float()
    if ties:
        cw[:, 1] = cw[:, 0]
        x = cw[:, :1].expand(nb, n, f).contiguous()
    else:
        x = torch.randint(-2, 3, (nb, n, f), generator=g).float()
    x, cw = x.to(cuda), cw.to(cuda)
    _assert_vq_update_exact(x, cw)
    torch.cuda.synchronize()
    got = tvu.wide_queued_rows()
    want = tvu.queued_rows_est(x, cw)
    assert got == want
    if ties:
        assert got == nb * n
    tva.vq_assign_cuda(x, cw)
    assert tvu.wide_queued_rows() == want


@pytest.mark.gpu
@pytest.mark.parametrize("nb,k,f", [(2, 1000, 65), (1, 37, 440),
                                    (3, 1024, 43), (1, 129, 256)])
def test_wide_prologue_writes_the_split_layout(cuda, nb, k, f):
    """The scratch the prologue writes: |c|^2 in the plain version's order
    (+inf past k) and the codewords' TF32 hi / lo parts in the tile layout,
    bit for bit as ``wide_split_layout`` computes them in plain torch."""
    g = torch.Generator().manual_seed(k + f)
    cw = torch.randn((nb, k, f), generator=g).to(cuda)
    x = torch.randn((nb, 65, f), generator=g).to(cuda)
    tvu.vq_assign_update_cuda(x, cw)
    torch.cuda.synchronize()
    got = tvu.last_wide_scratch
    assert got.numel() == tvu.wide_scratch_floats(nb, k, f)
    want = tvu.wide_split_layout(cw)
    assert torch.equal(got[4:].view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 32, 33, 43, 65, 72, 128, 168, 192, 193,
                               256, 300, 360, 368, 392, 400, 440])
@pytest.mark.parametrize("wgs", [1, 2])
def test_wide_plan_matches_the_card(cuda, f, wgs):
    """The launch's plan on the card (rows split once or a chunk at a time,
    K chunk, stages, shared memory) is ``vq_update.wide_plan``'s."""
    want = tvu.wide_plan(f, wgs)
    if want is None:
        with pytest.raises(RuntimeError, match="vq_wide_plan"):
            tva.wide_plan_card(f, wgs)
    else:
        assert tva.wide_plan_card(f, wgs) == want


# ---------------------------------------------------------------------------
# the dispatch layer: the context loop, the tuner's knobs, the tuner
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("table", ["int32", "uint8", "packed"])
@pytest.mark.parametrize("cw_dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("wt", [False, True])
def test_context_loop_variant_on_the_card(cuda, table, cw_dtype, wt):
    """``REPRO_CONTEXT_VARIANT=loop``'s path: one spmm_ell a branch, no
    context_ell launch; the plain form bit-equal to the plain version, the
    ``w_t`` form (a matmul) within what summing its products in another
    order may move it."""
    from repro_torch.distributed.quantization import (PackedAssignment,
                                                      QTensor,
                                                      quantize_codewords)
    k = 16 if table == "packed" else 200
    ids, val, assign, cw, w_t = _context_operands(300, 7, 999, 6, k, 5, 9,
                                                  seed=k + wt, cuda=cuda)
    if table != "int32":
        assign = assign.to(torch.uint8)
    a = PackedAssignment.pack(assign) if table == "packed" else assign
    cws = QTensor(cw, None) if cw_dtype == torch.float32 \
        else quantize_codewords(cw, dtype=cw_dtype)
    arg = cw if cw_dtype == torch.float32 else cws
    w = w_t if wt else None
    want = tref.context_ell(ids, val, a, cws.q, w, cws.scale)
    try:
        ops.configure_context_dispatch(variant="loop")
        before = tce.launches, tsp.launches
        got = ops.context_ell(ids, val, a, arg, w)
        torch.cuda.synchronize()
        assert (tce.launches - before[0], tsp.launches - before[1]) == (0, 6)
    finally:
        ops.configure_context_dispatch(reset=True)
    if wt:
        # the loop's product is a matmul: its C = nb * f_blk products
        # summed in another order than the plain version's
        ctx = tref.context_ell(ids, val, a, cws.q, None, cws.scale)
        assert_scatter_close(got.cpu().numpy(), want.cpu().numpy(),
                             (ctx.abs() @ w_t.abs()).cpu().numpy(),
                             2 * ctx.shape[1])
    else:
        assert torch.equal(got, want)
    fused = ops.context_ell(ids, val, a, arg, w)
    torch.cuda.synchronize()
    assert tce.launches == before[0] + 1
    if not wt:
        assert torch.equal(fused, got)


@pytest.mark.gpu
@pytest.mark.parametrize("bb,stripe", [(32, 256), (64, 1024), (128, 512)])
def test_spmm_ell_hbm_tiles_set_by_the_caller(cuda, bb, stripe):
    """The staged kernel at the tuner's tiles is the plain version at the
    index those tiles give; an index pins its own tiles."""
    from repro_torch.kernels import spmm_ell_hbm as thbm
    idx, val, x = _hbm_case(300, 9, 5000, 64, seed=bb + stripe)
    si = thbm.stripe_index_torch(idx, val, 5000, bb=bb, stripe=stripe)
    want = tref.spmm_ell_hbm(idx, val, x, si)
    idx, val, x = idx.to(cuda), val.to(cuda), x.to(cuda)
    got = thbm.spmm_ell_hbm_cuda(idx, val, x, None, bb=bb, stripe=stripe)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="pins its own tiles"):
        thbm.spmm_ell_hbm_cuda(idx, val, x, thbm.stripe_index_torch(
            idx, val, 5000), bb=bb)
    assert thbm.tiles_error(256, 512, 9, 5000, False) is not None


@pytest.mark.gpu
@pytest.mark.parametrize("wgs", [1, 2])
@pytest.mark.parametrize("emit", [torch.int32, torch.uint8])
def test_vq_update_wide_row_tile_set_by_the_caller(cuda, wgs, emit):
    """The counted wide launch at the tuner's row tile: idx / qerr / counts
    the plain version's, counted once; the narrow build has no tile."""
    g = torch.Generator().manual_seed(wgs)
    x = torch.randn((2, 700, 65), generator=g).to(cuda)
    cw = torch.randn((2, 200, 65), generator=g).to(cuda)
    want = tref.vq_assign_update(x, cw, emit)
    before = tvu.launches, tvu.launches_wide
    got = tvu.vq_assign_update_cuda(x, cw, emit, wgs=wgs)
    torch.cuda.synchronize()
    assert (tvu.launches, tvu.launches_wide) == (before[0] + 1,
                                                 before[1] + 1)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="narrow build"):
        tvu.vq_assign_update_cuda(x[..., :8].contiguous(),
                                  cw[..., :8].contiguous(), wgs=wgs)


@pytest.mark.gpu
def test_tuner_measures_once_and_steers_the_dispatch(cuda, tmp_path,
                                                     monkeypatch):
    """``REPRO_AUTOTUNE=1`` on a fresh cache: each tuner measures its key
    once (every candidate's time kept), a second query is a hit with no
    launch, and the tuned calls give the plain versions' results."""
    from repro_torch.distributed.quantization import PackedAssignment
    from repro_torch.kernels import autotune
    from repro_torch.kernels import spmm_ell_hbm as thbm
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    autotune.clear(memory_only=True)
    try:
        n0 = len(autotune.measured)
        sp = autotune.tuned_spmm(5000, 64, 4)
        assert sp["variant"] in ("resident", "hbm")
        assert sp["bb"] <= thbm.MAX_BB and sp["stripe"] in (256, 512, 1024)
        assert "resident" in sp["ms"] and len(sp["ms"]) == 10
        ctx = autotune.tuned_context(3000, 4, 0.5, "uint4")
        assert ctx["variant"] in ("fused", "loop") and len(ctx["ms"]) == 2
        vu = autotune.tuned_vq_update(700, 200, 65, nb=2)
        assert vu["wgs"] in (1, 2)
        # the uint8 emit races its own entries under its own key
        vu8 = autotune.tuned_vq_update(700, 200, 65, nb=2,
                                       emit_dtype=torch.uint8)
        assert vu8["wgs"] in (1, 2) and len(vu8["ms"]) == 2
        assert autotune.tuned_vq_update(700, 200, 8, nb=2) is None
        assert len(autotune.measured) == n0 + 4
        before = (tsp.launches, tce.launches, thbm.launches, tvu.launches)
        assert autotune.tuned_spmm(4097, 64, 4) == sp          # same bucket
        assert autotune.tuned_context(2049, 4, 0.5, "uint4") == ctx
        assert autotune.tuned_vq_update(700, 200, 65, nb=2) == vu
        assert autotune.tuned_vq_update(700, 200, 65, nb=2,
                                        emit_dtype=torch.uint8) == vu8
        assert (tsp.launches, tce.launches, thbm.launches,
                tvu.launches) == before
        assert len(autotune.measured) == n0 + 4
        on_disk = autotune.lookup(autotune.cache_key("spmm", (5000, 64, 4),
                                                     torch.float32))
        assert on_disk["variant"] == sp["variant"]
        assert torch.cuda.get_device_name() in autotune.cache_key(
            "spmm", (1, 1, 1), torch.float32)
        # the tuned dispatch: the plain versions' results
        idx, val, x = _hbm_case(300, 9, 5000, 64, seed=3)
        got = ops.spmm_ell(idx.to(cuda), val.to(cuda), x.to(cuda))
        assert_allclose(got.cpu().numpy(),
                        tref.spmm_ell(idx, val, x).numpy(), **TOL)
        ids, v, a, cw, _ = _context_operands(300, 7, 3000, 4, 16, 5, 9,
                                             seed=5, cuda=cuda)
        pa = PackedAssignment.pack(a.to(torch.uint8))
        assert torch.equal(ops.context_ell(ids, v, pa, cw),
                           tref.context_ell(ids, v, pa, cw))
        xg = torch.randn((2, 700, 65), device=cuda)
        cg = torch.randn((2, 200, 65), device=cuda)
        for emit in (torch.int32, torch.uint8):
            got = ops.vq_assign_update(xg, cg, emit_dtype=emit)
            for a_, b_ in zip(got[:3],
                              tref.vq_assign_update(xg, cg, emit)[:3]):
                assert torch.equal(a_, b_)
        assert len(autotune.measured) == n0 + 4
    finally:
        autotune.clear(memory_only=True)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", ["item", "masked_index", "host_scalar"])
def test_analysis_sync_pass_fires_on_a_seeded_sync(cuda, seed):
    """REPRO102: an entry that reads a value back to the host (``.item()``),
    selects by a mask (``nonzero`` underneath) or copies a host scalar to
    the card (the H2D copy waits for the host) is a finding; an entry that
    only queues work is clean; the registry's serving entry is clean."""
    from repro_torch.analysis import dispatch_checks, registry
    x = torch.ones(8, device=cuda)
    calls = {"item": lambda t: float((t * 2).sum().item()),
             "masked_index": lambda t: t[t > 0],
             "host_scalar": lambda t: t + torch.tensor(2.0, device=t.device)}
    seeded = registry.Entry(f"fixture:{seed}", make=lambda dev: (x,),
                            call=calls[seed])
    found = dispatch_checks.sync_findings(seeded, cuda)
    assert [f.rule for f in found] == ["REPRO102"]
    clean = registry.Entry("fixture:clean", make=lambda dev: (x,),
                           call=lambda t: t * 2)
    assert dispatch_checks.sync_findings(clean, cuda) == []
    serve = {e.name: e for e in registry.entries()}["vq_serve_batch[int8]"]
    assert dispatch_checks.sync_findings(serve, cuda) == []
    assert torch.cuda.get_sync_debug_mode() == 0
