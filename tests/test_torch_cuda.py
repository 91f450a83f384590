"""The hand-written CUDA kernels of the PyTorch port against their plain
PyTorch versions, on a CUDA card.  Every test here needs the card (marker
``gpu``) and skips without one: a CUDA kernel has no CPU mode.  The file
imports neither JAX nor ``repro`` so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The kernels keep their plain versions' summation order, so values agree
well inside ``rtol=1e-5, atol=1e-6``; assignments are equal except at
near-ties of ``1e-5 * (1 + |d|)``.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

from repro_torch.kernels import context_ell as tce           # noqa: E402
from repro_torch.kernels import ref as tref                  # noqa: E402
from repro_torch.kernels import spmm_ell as tsp              # noqa: E402
from repro_torch.kernels import vq_assign as tva             # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


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


# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("nb,n,k,f", [(32, 5000, 1024, 4), (8, 3000, 1024, 16),
                                      (3, 130, 33, 12), (1, 1, 1, 1),
                                      (2, 700, 64, 8)])
def test_vq_assign_kernel_vs_plain(cuda, nb, n, k, f):
    g = torch.Generator().manual_seed(n + k)
    table = torch.randn((n, nb * f), generator=g)
    cw = torch.randn((nb, k, f), generator=g)
    x = table.to(cuda).reshape(n, nb, f).transpose(0, 1)   # strided view
    before = tva.launches
    got = tva.vq_assign_cuda(x, cw.to(cuda))
    torch.cuda.synchronize()
    assert tva.launches == before + 1
    want = tref.vq_assign(table.reshape(n, nb, f).transpose(0, 1), cw)
    rate = assert_assign_equal_but_near_ties(
        got.cpu(), want, table.reshape(n, nb, f).transpose(0, 1).numpy(),
        cw.numpy())
    assert rate <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("b,deg,n,f", [(256, 18, 256, 128), (33, 7, 50, 12),
                                       (1, 1, 1, 1), (300, 0, 20, 8)])
def test_spmm_ell_kernel_vs_plain(cuda, b, deg, n, f):
    g = torch.Generator().manual_seed(b + deg)
    idx = torch.randint(0, n, (b, deg), generator=g, dtype=torch.int32)
    val = torch.randn((b, deg), generator=g)
    x = torch.randn((n, f), generator=g)
    got = tsp.spmm_ell_cuda(idx.to(cuda), val.to(cuda), x.to(cuda))
    assert_allclose(got.cpu().numpy(), tref.spmm_ell(idx, val, x).numpy(),
                    **TOL)


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
    with pytest.raises(ValueError, match="shared memory"):
        tva.vq_assign_cuda(torch.zeros((1, 4, 32), device=cuda),
                           torch.zeros((1, 4096, 32), device=cuda))
