"""Kernels of the PyTorch port: the plain PyTorch versions in
``repro_torch.kernels.ref`` against the JAX oracles (``repro.kernels.ref``)
and the Pallas kernels in interpret mode, on the reference's own sweep
shapes; the device-only dispatch of ``ops.py``; the isolation of the
package from JAX.  The CUDA kernels themselves are held against their
plain versions on a card by ``tests/test_torch_cuda.py``.

Tolerances: fp32 sums over at most 32 slots or 128 dims in another order,
``rtol=1e-5, atol=1e-6``.  Assignments must be equal except where the
reference's two candidate distances differ by at most ``1e-5 * (1 + |d|)``
(a near-tie that any two summation orders may break differently).  The
fused update's cluster statistics: counts exact, sums (up to a few hundred
rows each, summed in another order) ``rtol=1e-5, atol=1e-5``.  The
``w_t`` epilogue sums up to 40 products of unit-scale context and weights
whose terms cancel to much smaller results: ``rtol=1e-5, atol=1e-5``.

The quantized forms (int8 / fp8 codewords or sources with their scales,
uint8 and nibble-packed tables, the narrow emit) are held to the same
tolerances: their operands widen to f32 exactly, but XLA's CPU code fuses
each slot's multiply and add into one FMA (one rounding where the port
rounds twice; an FMA emulation reproduces the reference's bits), so the
port's plain versions -- which round as the CUDA kernels do, and agree
with them bit for bit -- differ from the JAX oracles in the last bits.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.distributed import quantization as jq             # noqa: E402
from repro.kernels import ref as jref                        # noqa: E402
from repro.kernels.context_ell import context_ell_pallas     # noqa: E402
from repro.kernels.spmm_ell import spmm_ell_pallas           # noqa: E402
from repro.kernels.vq_assign import vq_assign_pallas         # noqa: E402
from repro.kernels.vq_update import vq_assign_update_pallas  # noqa: E402
from repro_torch.distributed import quantization as tq       # noqa: E402
from repro_torch.kernels import _build, ops                  # noqa: E402
from repro_torch.kernels import context_ell as tce           # noqa: E402
from repro_torch.kernels import ref as tref                  # noqa: E402
from repro_torch.kernels import spmm_ell as tsp              # noqa: E402
from repro_torch.kernels import vq_assign as tva             # noqa: E402
from repro_torch.kernels import vq_update as tvu             # noqa: E402

from test_torch_cuda import assert_assign_equal_but_near_ties  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
WT_TOL = dict(rtol=1e-5, atol=1e-5)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# plain versions vs the JAX oracles and interpret-mode Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,k,f", [(1, 1, 1), (7, 3, 5), (64, 16, 4),
                                   (130, 33, 12), (256, 512, 128),
                                   (100, 1024, 8)])
@pytest.mark.parametrize("nb", [1, 3])
def test_vq_assign_ref_vs_jax(b, k, f, nb):
    rng = np.random.default_rng(b * 131 + k + nb)
    x = rng.normal(size=(nb, b, f)).astype(np.float32)
    cw = rng.normal(size=(nb, k, f)).astype(np.float32)
    got = tref.vq_assign(torch.from_numpy(x), torch.from_numpy(cw))
    assert got.dtype == torch.int32 and got.shape == (nb, b)
    want = np.stack([np.asarray(jref.vq_assign(x[i], cw[i]))
                     for i in range(nb)])
    assert_assign_equal_but_near_ties(got, want, x, cw)
    pallas = np.stack([np.asarray(vq_assign_pallas(
        jnp.asarray(x[i]), jnp.asarray(cw[i]), interpret=True))
        for i in range(nb)])
    assert_assign_equal_but_near_ties(got, pallas, x, cw)


@pytest.mark.parametrize("b,k,f", [(7, 3, 5), (130, 33, 12), (100, 300, 8)])
def test_vq_assign_ref_want_min_vs_pallas(b, k, f):
    """``want_min``: each row's squared distance to its codeword against
    ``vq_assign_pallas(want_min=True)`` in interpret mode, at the shapes of
    the reference's own test; the index is the one without it."""
    rng = np.random.default_rng(b + k)
    x = rng.normal(size=(1, b, f)).astype(np.float32)
    cw = rng.normal(size=(1, k, f)).astype(np.float32)
    got, mind = tref.vq_assign(torch.from_numpy(x), torch.from_numpy(cw),
                               want_min=True)
    assert mind.dtype == torch.float32 and mind.shape == (1, b)
    assert torch.equal(got, tref.vq_assign(torch.from_numpy(x),
                                           torch.from_numpy(cw)))
    p_idx, p_min = vq_assign_pallas(jnp.asarray(x[0]), jnp.asarray(cw[0]),
                                    interpret=True, want_min=True)
    assert_assign_equal_but_near_ties(got, np.asarray(p_idx)[None], x, cw)
    assert_allclose(mind.numpy()[0], np.asarray(p_min), **TOL)


def test_vq_assign_ref_ties_keep_lowest_index():
    """Exact ties (duplicate codewords) resolve to the first index, as
    jnp.argmin and the Pallas kernel's strict-< combine do."""
    cw = np.zeros((2, 6, 4), np.float32)
    cw[:, 1] = cw[:, 4] = 1.0           # codewords 1 and 4 coincide
    cw[:, 2] = cw[:, 5] = -3.0
    x = np.ones((2, 5, 4), np.float32)
    got = tref.vq_assign(torch.from_numpy(x), torch.from_numpy(cw)).numpy()
    assert (got == 1).all()
    assert (np.asarray(jref.vq_assign(x[0], cw[0])) == 1).all()


def test_vq_assign_ref_strided_rows_and_blocking(monkeypatch):
    """The [nb, n, f] branch view of an [n, nb*f] table (the codebook's
    layout) and the row blocking of the plain version change nothing."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(300, 4 * 8)).astype(np.float32))
    cw = torch.from_numpy(rng.normal(size=(4, 32, 8)).astype(np.float32))
    view = table.reshape(300, 4, 8).transpose(0, 1)
    assert not view.is_contiguous()
    want = tref.vq_assign(view.contiguous(), cw)
    monkeypatch.setattr(tref, "_ASSIGN_BLOCK_ELEMS", 4 * 32 * 7)
    assert torch.equal(tref.vq_assign(view, cw), want)


@pytest.mark.parametrize("b,deg,n,f", [(1, 1, 1, 1), (8, 4, 16, 8),
                                       (33, 7, 50, 12), (128, 32, 300, 64),
                                       (256, 18, 256, 128)])
def test_spmm_ell_ref_vs_jax(b, deg, n, f):
    rng = np.random.default_rng(b + deg * 100)
    idx = rng.integers(0, n, (b, deg)).astype(np.int32)
    val = rng.normal(size=(b, deg)).astype(np.float32)
    val[:, -1] = 0.0                    # a padding column (val 0, idx valid)
    x = rng.normal(size=(n, f)).astype(np.float32)
    got = tref.spmm_ell(torch.from_numpy(idx), torch.from_numpy(val),
                        torch.from_numpy(x)).numpy()
    assert got.shape == (b, f) and got.dtype == np.float32
    assert_allclose(got, np.asarray(jref.spmm_ell(idx, val, x)), **TOL)
    assert_allclose(got, np.asarray(spmm_ell_pallas(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x),
        interpret=True)), **TOL)


@pytest.mark.parametrize("b,deg,n,nb,k,f_blk", [
    (1, 1, 1, 1, 1, 1),        # degenerate minimum
    (8, 4, 16, 2, 4, 8),       # everything below one tile
    (33, 7, 50, 4, 16, 8),     # b a non-multiple of the Pallas tile, nb=4
    (128, 32, 300, 2, 64, 16), # multi-tile
    (5, 0, 10, 4, 8, 8),       # D=0: no out-of-batch slots
    (257, 5, 999, 1, 256, 8),  # single branch, paper-scale k
])
def test_context_ell_ref_vs_jax(b, deg, n, nb, k, f_blk):
    rng = np.random.default_rng(b * 131 + deg * 7 + nb)
    ids = rng.integers(0, n, (b, deg)).astype(np.int32)
    val = rng.normal(size=(b, deg)).astype(np.float32)
    assign = rng.integers(0, k, (nb, n)).astype(np.int32)
    cw = rng.normal(size=(nb, k, f_blk)).astype(np.float32)
    got = tref.context_ell(torch.from_numpy(ids), torch.from_numpy(val),
                           torch.from_numpy(assign),
                           torch.from_numpy(cw)).numpy()
    assert got.shape == (b, nb * f_blk) and got.dtype == np.float32
    assert_allclose(got, np.asarray(jref.context_ell(ids, val, assign, cw)),
                    **TOL)
    assert_allclose(got, np.asarray(context_ell_pallas(
        jnp.asarray(ids), jnp.asarray(val), jnp.asarray(assign),
        jnp.asarray(cw), interpret=True)), **TOL)
    if deg == 0:
        assert not got.any()


@pytest.mark.parametrize("case", ["all_out_of_batch", "padded_rows"])
def test_context_ell_ref_edge_rows(case):
    """Rows whose every slot is a real out-of-batch edge, and rows that are
    all padding (val 0 everywhere -> a zero row)."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 100, (40, 6)).astype(np.int32)
    val = rng.normal(size=(40, 6)).astype(np.float32)
    if case == "all_out_of_batch":
        val = np.abs(val) + 0.5
    else:
        val[[3, 17]] = 0.0
    assign = rng.integers(0, 16, (4, 100)).astype(np.int32)
    cw = rng.normal(size=(4, 16, 8)).astype(np.float32)
    got = tref.context_ell(*map(torch.from_numpy, (ids, val, assign,
                                                   cw))).numpy()
    assert_allclose(got, np.asarray(jref.context_ell(ids, val, assign, cw)),
                    **TOL)
    if case == "padded_rows":
        assert not got[[3, 17]].any()


@pytest.mark.parametrize("b,k,f", [(1, 1, 1), (7, 3, 5), (130, 33, 12),
                                   (300, 64, 21), (100, 1024, 8),
                                   (257, 16, 21)])
@pytest.mark.parametrize("nb", [1, 3])
def test_vq_assign_update_ref_vs_jax(b, k, f, nb):
    """The fused update's plain version against the reference oracle and
    the Pallas kernel in interpret mode, per branch: f = 21 (the odd
    training width), b not a multiple of the kernel's 256-row tile."""
    rng = np.random.default_rng(b * 7 + k + f + nb)
    x = rng.normal(size=(nb, b, f)).astype(np.float32)
    cw = rng.normal(size=(nb, k, f)).astype(np.float32)
    idx, qerr, counts, sums = tref.vq_assign_update(torch.from_numpy(x),
                                                    torch.from_numpy(cw))
    assert idx.dtype == torch.int32 and idx.shape == (nb, b)
    assert qerr.shape == (nb, b) and counts.shape == (nb, k)
    assert sums.shape == (nb, k, f)
    assert counts.sum() == nb * b
    assert torch.equal(idx, tref.vq_assign(torch.from_numpy(x),
                                           torch.from_numpy(cw)))
    for want in (jref.vq_assign_update, lambda a, c: vq_assign_update_pallas(
            jnp.asarray(a), jnp.asarray(c), interpret=True)):
        w = [np.stack([np.asarray(want(x[i], cw[i])[j]) for i in range(nb)])
             for j in range(4)]
        assert_assign_equal_but_near_ties(idx, w[0], x, cw)
        same = idx.numpy() == w[0]
        assert_allclose(qerr.numpy()[same], w[1][same], rtol=1e-5,
                        atol=1e-6)
        if same.all():
            assert np.array_equal(counts.numpy(), w[2])
            assert_allclose(sums.numpy(), w[3], rtol=1e-5, atol=1e-5)


def test_vq_assign_update_ref_ties_and_qerr():
    """Duplicate codewords resolve to the lowest index; qerr is the squared
    distance to the winner (clamped at 0 for a row on its codeword)."""
    cw = np.zeros((2, 6, 4), np.float32)
    cw[:, 1] = cw[:, 4] = 1.0
    x = np.ones((2, 5, 4), np.float32)
    idx, qerr, counts, sums = tref.vq_assign_update(torch.from_numpy(x),
                                                    torch.from_numpy(cw))
    assert (idx == 1).all() and (qerr == 0).all()
    assert (counts[:, 1] == 5).all() and counts.sum() == 10
    assert (sums[:, 1] == 5).all()


@pytest.mark.parametrize("b,deg,n,nb,k,f_blk,f_out", [
    (1, 1, 1, 1, 1, 1, 1), (33, 7, 50, 4, 16, 8, 12),
    (128, 18, 300, 8, 64, 5, 32), (5, 0, 10, 4, 8, 8, 3)])
def test_context_ell_wt_ref_vs_jax(b, deg, n, nb, k, f_blk, f_out):
    """The fused ``@ w_t`` epilogue (the Eq. 7 backward form)."""
    rng = np.random.default_rng(b + f_out)
    ids = rng.integers(0, n, (b, deg)).astype(np.int32)
    val = rng.normal(size=(b, deg)).astype(np.float32)
    assign = rng.integers(0, k, (nb, n)).astype(np.int32)
    cw = rng.normal(size=(nb, k, f_blk)).astype(np.float32)
    w_t = rng.normal(size=(nb * f_blk, f_out)).astype(np.float32)
    got = tref.context_ell(*map(torch.from_numpy, (ids, val, assign, cw)),
                           w_t=torch.from_numpy(w_t)).numpy()
    assert got.shape == (b, f_out)
    assert_allclose(got, np.asarray(jref.context_ell(ids, val, assign, cw,
                                                     w_t=w_t)), **WT_TOL)
    assert_allclose(got, np.asarray(context_ell_pallas(
        *map(jnp.asarray, (ids, val, assign, cw)), w_t=jnp.asarray(w_t),
        interpret=True)), **WT_TOL)
    assert_allclose(got, tref.context_ell(
        *map(torch.from_numpy, (ids, val, assign, cw))).numpy() @ w_t,
        **WT_TOL)


@pytest.mark.parametrize("b,deg,n,f", [(1, 1, 1, 1), (33, 7, 50, 12),
                                       (128, 18, 128, 64)])
def test_spmm_ell_backward_vs_jax_vjp(b, deg, n, f):
    """``ops.spmm_ell``'s autograd backward (the plain ``spmm_ell_t`` on
    the CPU) against ``jax.vjp`` of the reference SpMM, padding slots
    (val 0 at row 0, as intra_messages leaves them) included."""
    rng = np.random.default_rng(b + deg + f)
    idx = rng.integers(0, n, (b, deg)).astype(np.int32)
    val = rng.normal(size=(b, deg)).astype(np.float32)
    pad = rng.random((b, deg)) < 0.4
    idx[pad], val[pad] = 0, 0.0
    x = rng.normal(size=(n, f)).astype(np.float32)
    g = rng.normal(size=(b, f)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jref.spmm_ell(idx, val, xx), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ops.spmm_ell(torch.from_numpy(idx), torch.from_numpy(val), xt)
    assert_allclose(out.detach().numpy(), np.asarray(jref.spmm_ell(
        idx, val, x)), **TOL)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert_allclose(got.numpy(), want, **TOL)
    assert_allclose(tref.spmm_ell_t(*map(torch.from_numpy, (idx, val, g)),
                                    n).numpy(), want, **TOL)


def test_spmm_ell_refuses_edge_values_that_require_grad():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    val = torch.ones((4, 2), requires_grad=True)
    with pytest.raises(ValueError, match="nbr_val requires grad"):
        ops.spmm_ell(idx, val, torch.zeros((3, 5)))
    with torch.no_grad():
        assert ops.spmm_ell(idx, val, torch.ones((3, 5))).shape == (4, 5)


# ---------------------------------------------------------------------------
# the precision tiers' forms: quantized codewords / sources, narrow tables
# ---------------------------------------------------------------------------

QDTYPES = [(jnp.int8, torch.int8), (jnp.float8_e4m3fn, torch.float8_e4m3fn)]


def _q_codewords(cw, jdt, tdt):
    """The same codewords quantized by both packages (byte-equal, held by
    tests/test_torch_quant.py) -> (jax QTensor, torch QTensor)."""
    return (jq.quantize_codewords(jnp.asarray(cw), dtype=jdt),
            tq.quantize_codewords(torch.from_numpy(cw), dtype=tdt))


def _tables(assign, tab):
    """One [nb, n] id table in a storage form, for both packages."""
    if tab == "a4":
        return (jq.PackedAssignment.pack(jnp.asarray(assign)),
                tq.PackedAssignment.pack(torch.from_numpy(assign)))
    a = assign.astype(np.int32 if tab == "i32" else np.uint8)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("jdt,tdt", QDTYPES)
@pytest.mark.parametrize("tab", ["u8", "a4", "i32"])
@pytest.mark.parametrize("b,deg,n,nb,k,f_blk,f_out", [
    (1, 1, 1, 1, 1, 1, 1), (33, 7, 51, 4, 16, 8, 12),
    (130, 18, 301, 8, 16, 5, 32), (5, 0, 10, 4, 8, 8, 3)])
def test_context_ell_q_ref_vs_jax(jdt, tdt, tab, b, deg, n, nb, k, f_blk,
                                  f_out):
    """``_context_ell_q_kernel`` / ``_context_ell_q_wt_kernel`` over uint8,
    nibble-packed (odd n: a padded high nibble) and int32 tables: the
    plain version against the reference oracle and the interpret-mode
    Pallas kernel, with and without the ``w_t`` epilogue."""
    rng = np.random.default_rng(b * 13 + n + f_out)
    ids = rng.integers(0, n, (b, deg)).astype(np.int32)
    val = rng.normal(size=(b, deg)).astype(np.float32)
    assign = rng.integers(0, k, (nb, n)).astype(np.uint8)
    cw = rng.normal(size=(nb, k, f_blk)).astype(np.float32)
    w_t = rng.normal(size=(nb * f_blk, f_out)).astype(np.float32)
    qj, qt = _q_codewords(cw, jdt, tdt)
    ja, ta = _tables(assign, tab)
    ti, tv = torch.from_numpy(ids), torch.from_numpy(val)
    for wt in (None, w_t):
        got = tref.context_ell(ti, tv, ta, qt.q,
                               None if wt is None else torch.from_numpy(wt),
                               qt.scale).numpy()
        assert got.shape == (b, nb * f_blk if wt is None else f_out)
        tol = TOL if wt is None else WT_TOL
        assert_allclose(got, np.asarray(jref.context_ell(
            ids, val, ja, qj.q, w_t=wt, cw_scale=qj.scale)), **tol)
        if deg:
            assert_allclose(got, np.asarray(context_ell_pallas(
                jnp.asarray(ids), jnp.asarray(val), ja, qj.q,
                cw_scale=qj.scale,
                w_t=None if wt is None else jnp.asarray(wt),
                interpret=True)), **tol)
        # every table form gives the same bits as the int32 one
        assert np.array_equal(got, tref.context_ell(
            ti, tv, torch.from_numpy(assign.astype(np.int32)), qt.q,
            None if wt is None else torch.from_numpy(wt), qt.scale).numpy())
        # ops unwraps the QTensor onto the same plain version
        assert np.array_equal(got, ops.context_ell(
            ti, tv, ta, qt,
            None if wt is None else torch.from_numpy(wt)).numpy())


@pytest.mark.parametrize("jdt,tdt", QDTYPES)
@pytest.mark.parametrize("b,deg,n,f", [(1, 1, 1, 1), (33, 7, 50, 12),
                                       (256, 18, 300, 128)])
def test_spmm_ell_q_ref_vs_jax(jdt, tdt, b, deg, n, f):
    """``_spmm_ell_q_kernel``: an int8 / fp8 source with [1, f] scales,
    through ``ops.spmm_ell(QTensor)``, the reference oracle and the
    interpret-mode Pallas kernel."""
    rng = np.random.default_rng(b + f)
    idx = rng.integers(0, n, (b, deg)).astype(np.int32)
    val = rng.normal(size=(b, deg)).astype(np.float32)
    val[:, -1] = 0.0
    x = rng.normal(size=(n, f)).astype(np.float32)
    qj, qt = _q_codewords(x[None], jdt, tdt)
    jqx, jsc = qj.q[0], qj.scale[0]
    tqx = tq.QTensor(qt.q[0], qt.scale[0])
    got = ops.spmm_ell(torch.from_numpy(idx), torch.from_numpy(val),
                       tqx).numpy()
    assert got.shape == (b, f) and got.dtype == np.float32
    assert np.array_equal(got, tref.spmm_ell(
        torch.from_numpy(idx), torch.from_numpy(val), *tqx).numpy())
    assert_allclose(got, np.asarray(jref.spmm_ell(idx, val, jqx, jsc)),
                    **TOL)
    assert_allclose(got, np.asarray(spmm_ell_pallas(
        jnp.asarray(idx), jnp.asarray(val), jqx, x_scale=jsc,
        interpret=True)), **TOL)


@pytest.mark.parametrize("emit,jemit,k", [
    (torch.uint8, jnp.uint8, 256), (torch.uint8, jnp.uint8, 33),
    ("uint4", jnp.uint4, 16), ("uint4", jnp.uint4, 5)])
def test_vq_assign_update_narrow_emit(emit, jemit, k):
    """The narrow emit: the ids of the int32 emit in a uint8 tensor
    (values < 16 for uint4), equal to the interpret-mode Pallas kernel's
    narrow emit; every other output unchanged."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(3, 300, 8)).astype(np.float32)
    cw = rng.normal(size=(3, k, 8)).astype(np.float32)
    tx, tc = torch.from_numpy(x), torch.from_numpy(cw)
    wide = ops.vq_assign_update(tx, tc)
    narrow = ops.vq_assign_update(tx, tc, emit_dtype=emit)
    assert narrow[0].dtype == torch.uint8
    assert torch.equal(narrow[0].int(), wide[0])
    for a, b in zip(narrow[1:], wide[1:]):
        assert torch.equal(a, b)
    for i in range(3):
        jidx = vq_assign_update_pallas(jnp.asarray(x[i]), jnp.asarray(cw[i]),
                                       emit_dtype=jemit, interpret=True)[0]
        assert jidx.dtype == jemit
        same = np.asarray(jidx).astype(np.int32) == wide[0][i].numpy()
        assert_assign_equal_but_near_ties(
            wide[0][i:i + 1], np.asarray(jidx).astype(np.int32)[None],
            x[i:i + 1], cw[i:i + 1])
        assert same.mean() > 0.99


@pytest.mark.parametrize("emit,jemit,k,match", [
    (torch.uint8, jnp.uint8, 257, "k <= 256"),
    ("uint4", jnp.uint4, 17, "k <= 16"),
    (torch.int8, jnp.int8, 4, "not a supported assignment storage"),
    ("int4", jnp.int4, 4, "not a supported assignment storage")])
def test_vq_assign_update_emit_errors_match_reference(emit, jemit, k, match):
    x = np.zeros((1, 8, 4), np.float32)
    cw = np.zeros((1, k, 4), np.float32)
    with pytest.raises(ValueError, match=match):
        vq_assign_update_pallas(jnp.asarray(x[0]), jnp.asarray(cw[0]),
                                emit_dtype=jemit, interpret=True)
    with pytest.raises(ValueError, match=match):
        ops.vq_assign_update(torch.from_numpy(x), torch.from_numpy(cw),
                             emit_dtype=emit)


# ---------------------------------------------------------------------------
# dispatch: the device decides; CPU tensors never reach a kernel
# ---------------------------------------------------------------------------

def test_ops_cpu_tensors_take_the_plain_versions_training_kernels():
    counters = (tvu, "launches"), (tce, "launches_wt"), (tsp, "launches_t")
    before = [getattr(m, a) for m, a in counters]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 20, 5)).astype(np.float32))
    cw = torch.from_numpy(rng.normal(size=(2, 8, 5)).astype(np.float32))
    for a, b in zip(ops.vq_assign_update(x, cw),
                    tref.vq_assign_update(x, cw)):
        assert torch.equal(a, b)
    idx = torch.from_numpy(rng.integers(0, 20, (6, 3)).astype(np.int32))
    val = torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32))
    assert torch.equal(ops.spmm_ell_t(idx, val, g, 20),
                       tref.spmm_ell_t(idx, val, g, 20))
    a = torch.from_numpy(rng.integers(0, 8, (2, 20)).astype(np.int32))
    w_t = torch.from_numpy(rng.normal(size=(10, 7)).astype(np.float32))
    assert torch.equal(ops.context_ell(idx, val, a, cw, w_t),
                       tref.context_ell(idx, val, a, cw, w_t))
    assert [getattr(m, a) for m, a in counters] == before


def test_training_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tvu.vq_assign_update_cuda(torch.zeros((1, 4, 4)),
                                  torch.zeros((1, 2, 4)))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tsp.spmm_ell_t_cuda(torch.zeros((4, 2), dtype=torch.int32),
                            torch.zeros((4, 2)), torch.zeros((4, 3)), 5)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tce.context_ell_cuda(torch.zeros((4, 2), dtype=torch.int32),
                             torch.zeros((4, 2)),
                             torch.zeros((1, 4), dtype=torch.int32),
                             torch.zeros((1, 2, 4)), w_t=torch.zeros((4, 3)))


def test_ops_cpu_tensors_take_the_plain_versions():
    before = (tva.launches, tsp.launches, tce.launches)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 20, 4)).astype(np.float32))
    cw = torch.from_numpy(rng.normal(size=(2, 8, 4)).astype(np.float32))
    assert torch.equal(ops.vq_assign(x, cw), tref.vq_assign(x, cw))
    idx = torch.from_numpy(rng.integers(0, 20, (5, 3)).astype(np.int32))
    val = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    src = torch.from_numpy(rng.normal(size=(20, 6)).astype(np.float32))
    assert torch.equal(ops.spmm_ell(idx, val, src),
                       tref.spmm_ell(idx, val, src))
    a = torch.from_numpy(rng.integers(0, 8, (2, 20)).astype(np.int32))
    assert torch.equal(ops.context_ell(idx, val, a, cw),
                       tref.context_ell(idx, val, a, cw))
    assert (tva.launches, tsp.launches, tce.launches) == before


def test_tier_kernel_wrappers_refuse_what_they_do_not_take():
    """The quantized forms' wrappers check before any launch: CPU
    tensors, a uint8 table with k > 256, a packed table with k > 16,
    quantized codewords without scales, an emit dtype that cannot index
    k."""
    idx = torch.zeros((4, 2), dtype=torch.int32)
    val = torch.zeros((4, 2))
    sc = torch.ones((1, 1, 4))
    cases = [
        (ValueError, "CUDA tensors only", lambda: tce.context_ell_cuda(
            idx, val, torch.zeros((1, 4), dtype=torch.uint8),
            torch.zeros((1, 2, 4), dtype=torch.int8), cw_scale=sc)),
        (ValueError, "CUDA tensors only", lambda: tsp.spmm_ell_cuda(
            idx, val, torch.zeros((3, 4), dtype=torch.float8_e4m3fn),
            torch.ones((1, 4)))),
        (ValueError, "cw_scale", lambda: tce.context_ell_cuda(
            idx, val, torch.zeros((1, 4), dtype=torch.uint8),
            torch.zeros((1, 2, 4), dtype=torch.int8))),
        (ValueError, "x_scale", lambda: tsp.spmm_ell_cuda(
            idx, val, torch.zeros((3, 4), dtype=torch.int8))),
        (TypeError, "assignment of dtype", lambda: tce.context_ell_cuda(
            idx, val, torch.zeros((1, 4), dtype=torch.int64),
            torch.zeros((1, 2, 4)))),
        (ValueError, "k <= 256", lambda: tvu.vq_assign_update_cuda(
            torch.zeros((1, 4, 4)), torch.zeros((1, 300, 4)), torch.uint8)),
    ]
    if torch.cuda.is_available():
        dev = "cuda"
        cases += [
            (ValueError, "ids < 256", lambda: tce.context_ell_cuda(
                idx.to(dev), val.to(dev),
                torch.zeros((1, 4), dtype=torch.uint8, device=dev),
                torch.zeros((1, 300, 4), dtype=torch.int8, device=dev),
                cw_scale=sc.to(dev))),
            (ValueError, "ids < 16", lambda: tce.context_ell_cuda(
                idx.to(dev), val.to(dev), tq.PackedAssignment(
                    torch.zeros((1, 2), dtype=torch.uint8, device=dev), 4),
                torch.zeros((1, 17, 4), device=dev)))]
    for exc, match, call in cases:
        with pytest.raises(exc, match=match):
            call()


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches on CUDA tensors or raises; it never computes the
    plain version itself."""
    x = torch.zeros((1, 4, 4))
    cw = torch.zeros((1, 2, 4))
    idx = torch.zeros((4, 2), dtype=torch.int32)
    val = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tva.vq_assign_cuda(x, cw)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tsp.spmm_ell_cuda(idx, val, x[0])
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tce.context_ell_cuda(idx, val, torch.zeros((1, 4), dtype=torch.int32),
                             cw)


def test_build_is_keyed_on_sources_and_lazy():
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    assert _build.library_path().parent.name == h
    assert {p.name for p in _build._sources()} == {
        "vq_assign.cu", "vq_update.cu", "vq_update_u8.cu", "spmm_ell.cu",
        "spmm_ell_hbm.cu", "context_ell.cu", "vq_attention.cu",
        "flash_attention.cu"}
    for src in _build._sources():      # each names the TPU kernel it ports
        assert "Replaces the TPU kernel src/repro/kernels/" in src.read_text()


def test_port_imports_neither_jax_nor_repro():
    """Importing every repro_torch module pulls in no jax and no repro
    module, imports no triton and builds nothing."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "assert {'repro_torch.analysis.' + m for m in (\n"
        "    'ast_checks', 'dispatch_checks', 'registry', 'smem_checks',\n"
        "    'trace_count', '__main__')} <= set(mods), mods\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._lib is None\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
