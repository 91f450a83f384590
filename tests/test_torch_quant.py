"""The precision tiers of the PyTorch port against the JAX reference on the
CPU: ``quantize_codewords`` (int8 and fp8, fresh and with a previous
snapshot inside and outside the drift band), the nibble packing of the
'+a4' tiers, the size accounting, the tier configuration, and the VQ state
in each tier -- ``init_layer_vq_state``, ``quantize_vq_states``,
``refresh_assignment`` on uint8 and packed tables and quantize-on-update.
Inputs come from numpy seeds or from states built in ``repro`` and carried
across with ``repro_torch.convert``.

Tolerance: none.  Quantized bytes, scales, tables and histograms are
compared byte for byte.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.core import conv as jconv                         # noqa: E402
from repro.core.codebook import CodebookConfig as JCodebookConfig  # noqa
from repro.distributed import quantization as jq             # noqa: E402
from repro.kernels import ops as jops                        # noqa: E402
from repro.models import gnn as jgnn                         # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.core import conv as tconv                   # noqa: E402
from repro_torch.core.codebook import CodebookConfig         # noqa: E402
from repro_torch.distributed import quantization as tq       # noqa: E402
from repro_torch.kernels import context_ell as tce          # noqa: E402
from repro_torch.kernels import ops as tops                  # noqa: E402
from repro_torch.models import gnn as tgnn                   # noqa: E402

CPU = "cpu"
QDTYPES = [(jnp.int8, torch.int8), (jnp.float8_e4m3fn, torch.float8_e4m3fn)]
TIERS = ["int8", "fp8", "int8+a4", "fp8+a4"]


def _bytes(x) -> np.ndarray:
    """The storage bytes of a quantized tensor of either package."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def assert_qtensor_equal(t: tq.QTensor, j) -> None:
    assert np.array_equal(_bytes(t.q), _bytes(j.q))
    assert np.array_equal(t.scale.numpy(), np.asarray(j.scale))


@pytest.fixture
def tier_reset():
    """Leaves no tier override behind, in either package."""
    yield
    tops.configure_kernel_precision(reset=True)
    jops.configure_kernel_precision(reset=True)


# ---------------------------------------------------------------------------
# quantize_codewords
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jdt,tdt", QDTYPES)
@pytest.mark.parametrize("shape", [(1, 1, 1), (4, 64, 8), (32, 256, 4),
                                   (8, 16, 21)])
def test_quantize_codewords_byte_equal(jdt, tdt, shape):
    rng = np.random.default_rng(sum(shape))
    cw = (rng.normal(size=shape) * rng.uniform(0.01, 30, shape[-1])
          ).astype(np.float32)
    cw[..., 0, :] = 0.0 if shape[1] > 1 else cw[..., 0, :]  # an all-0 row
    t = tq.quantize_codewords(torch.from_numpy(cw), dtype=tdt)
    j = jq.quantize_codewords(jnp.asarray(cw), dtype=jdt)
    assert t.q.dtype == tdt and t.q.shape == shape
    assert t.scale.shape == (shape[0], 1, shape[2])
    assert_qtensor_equal(t, j)


def test_quantize_codewords_half_way_cases_round_to_even():
    """int8 rounds half to even (0.5 -> 0, 1.5 -> 2, -2.5 -> -2) and fp8
    rounds its own half-way values to even, in both packages."""
    amax = 127.0
    vals = np.array([0.5, 1.5, 2.5, -2.5, 126.5, amax], np.float32)
    cw = vals.reshape(1, -1, 1)
    for jdt, tdt in QDTYPES:
        assert_qtensor_equal(
            tq.quantize_codewords(torch.from_numpy(cw), dtype=tdt),
            jq.quantize_codewords(jnp.asarray(cw), dtype=jdt))
    t = tq.quantize_codewords(torch.from_numpy(cw), dtype=torch.int8)
    assert t.q.flatten().tolist()[:4] == [0, 2, 2, -2]


@pytest.mark.parametrize("jdt,tdt", QDTYPES)
@pytest.mark.parametrize("factor,kept", [(0.95, True), (1.0, True),
                                         (1.0 / (1.25 * 1.2), False),
                                         (1.5, False)])
def test_quantize_codewords_drift_band(jdt, tdt, factor, kept):
    """With ``prev``: inside the band ``[prev_amax / 1.25, prev_amax]`` the
    scale is reused, outside it recomputed, byte-equal to the reference;
    ``prev`` pins the storage dtype whatever ``dtype`` says."""
    rng = np.random.default_rng(3)
    cw = rng.normal(size=(2, 32, 4)).astype(np.float32)
    tprev = tq.quantize_codewords(torch.from_numpy(cw), dtype=tdt)
    jprev = jq.quantize_codewords(jnp.asarray(cw), dtype=jdt)
    moved = cw * np.float32(factor)
    t = tq.quantize_codewords(torch.from_numpy(moved), prev=tprev)
    j = jq.quantize_codewords(jnp.asarray(moved), prev=jprev)
    assert t.q.dtype == tdt
    assert_qtensor_equal(t, j)
    assert torch.equal(t.scale, tprev.scale) == kept


def test_quantize_codewords_rejects_unknown_dtype():
    with pytest.raises(ValueError, match="unsupported codeword storage"):
        tq.quantize_codewords(torch.zeros((1, 2, 2)), dtype=torch.int16)
    assert tq.codeword_qmax(torch.int8) == 127.0
    assert tq.codeword_qmax(torch.float8_e4m3fn) == 448.0
    assert tq.CODEWORD_SCALE_DRIFT == jq.CODEWORD_SCALE_DRIFT


# ---------------------------------------------------------------------------
# nibble packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 15, 16, 17, 301])
def test_pack_unpack_gather_match_reference(m):
    rng = np.random.default_rng(m)
    ids = rng.integers(0, 16, (3, m)).astype(np.uint8)
    ids[0, :min(m, 16)] = np.arange(min(m, 16))      # every id present
    tp = tq.pack_nibbles(torch.from_numpy(ids))
    jp = jq.pack_nibbles(jnp.asarray(ids))
    assert tp.dtype == torch.uint8 and tp.shape == (3, (m + 1) // 2)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    if m % 2:                                   # odd tail: high nibble 0
        assert not (tp[:, -1] >> 4).any()
    assert np.array_equal(tq.unpack_nibbles(tp, m).numpy(), ids)
    q = rng.integers(0, m, 40)
    assert np.array_equal(
        tq.gather_nibbles(tp, torch.from_numpy(q)).numpy(),
        np.asarray(jq.gather_nibbles(jp, jnp.asarray(q))))
    pa = tq.PackedAssignment.pack(torch.from_numpy(ids))
    assert pa.shape == (3, m) and pa.n == m
    assert np.array_equal(pa.unpack().numpy(), ids)


@pytest.mark.parametrize("m,n_ids", [(17, 9), (301, 120), (300, 300)])
def test_scatter_nibbles_matches_reference(m, n_ids):
    """Distinct ids, both parities next to each other: the reference's two
    parity passes and the port's scatter give the same bytes, equal to a
    scatter into the unpacked table."""
    rng = np.random.default_rng(m + n_ids)
    ids = rng.integers(0, 16, (2, m)).astype(np.uint8)
    at = rng.permutation(m)[:n_ids]
    vals = rng.integers(0, 16, (2, n_ids)).astype(np.uint8)
    t = tq.scatter_nibbles(tq.pack_nibbles(torch.from_numpy(ids)),
                           torch.from_numpy(at), torch.from_numpy(vals))
    j = jq.scatter_nibbles(jq.pack_nibbles(jnp.asarray(ids)),
                           jnp.asarray(at), jnp.asarray(vals))
    assert np.array_equal(t.numpy(), np.asarray(j))
    dense = ids.copy()
    dense[:, at] = vals
    assert np.array_equal(tq.unpack_nibbles(t, m).numpy(), dense)


def test_scatter_nibbles_repeated_ids_last_wins():
    """A repeated id (a wrap-padded batch) keeps its last value, as a
    sequential scatter into the unpacked table would; the sibling nibble
    of every touched byte is kept."""
    ids = np.zeros((1, 9), np.uint8)
    at = np.array([3, 4, 3, 8, 3, 4])
    vals = np.array([[1, 2, 3, 4, 5, 6]], np.uint8)
    t = tq.scatter_nibbles(tq.pack_nibbles(torch.from_numpy(ids)),
                           torch.from_numpy(at), torch.from_numpy(vals))
    dense = ids.copy()
    for i, v in zip(at, vals[0]):
        dense[0, i] = v
    assert np.array_equal(tq.unpack_nibbles(t, 9).numpy(), dense)
    assert dense[0].tolist() == [0, 0, 0, 5, 6, 0, 0, 0, 4]


def test_dtype_nbits_and_tree_bytes():
    for name, bits in [("uint4", 4), ("int4", 4), ("u4", 4), ("s32", 32),
                       ("f8e4m3fn", 8), ("bf16", 16)]:
        assert tq.dtype_nbits(name) == bits == jq.dtype_nbits(name)
    for t, j in [(torch.int8, jnp.int8), (torch.uint8, jnp.uint8),
                 (torch.float8_e4m3fn, jnp.float8_e4m3fn),
                 (torch.int32, jnp.int32), (torch.float32, jnp.float32)]:
        assert tq.dtype_nbits(t) == jq.dtype_nbits(j)
    with pytest.raises(KeyError):
        tq.dtype_nbits("no_such_dtype")
    pa = tq.PackedAssignment.pack(torch.zeros((4, 9), dtype=torch.uint8))
    q = tq.QTensor(torch.zeros((4, 16, 8), dtype=torch.int8),
                   torch.zeros((4, 1, 8)))
    assert tq.tree_bytes((pa, q)) == 4 * 5 + 4 * 16 * 8 + 4 * 8 * 4
    assert tq.tree_bytes([{"a": torch.zeros(3)}, None]) == 12


# ---------------------------------------------------------------------------
# the tier configuration
# ---------------------------------------------------------------------------

def test_kernel_precision_config(monkeypatch, tier_reset):
    assert tops.PRECISIONS == jops.PRECISIONS
    monkeypatch.delenv("REPRO_KERNEL_PRECISION", raising=False)
    assert tops.kernel_precision() == "fp32"
    monkeypatch.setenv("REPRO_KERNEL_PRECISION", "fp8+a4")
    assert tops.kernel_precision() == "fp8+a4"
    tops.configure_kernel_precision("int8")      # override out-ranks env
    assert tops.kernel_precision() == "int8"
    tops.configure_kernel_precision(reset=True)
    assert tops.kernel_precision() == "fp8+a4"
    monkeypatch.setenv("REPRO_KERNEL_PRECISION", "int4")
    with pytest.raises(ValueError, match="REPRO_KERNEL_PRECISION='int4'"):
        tops.kernel_precision()
    with pytest.raises(ValueError, match="fp32, int8, fp8, int8\\+a4"):
        tops.configure_kernel_precision("int4")
    for p in tops.PRECISIONS:
        j = jops.precision_codeword_dtype(p)
        t = tops.precision_codeword_dtype(p)
        assert (t is None) == (j is None)
        if t is not None:
            assert tq.dtype_name(t) == jnp.dtype(j).name
        assert tops.precision_packs_assignment(p) \
            == jops.precision_packs_assignment(p)


# ---------------------------------------------------------------------------
# VQ state in each tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["fp32"] + TIERS)
@pytest.mark.parametrize("k", [16, 64, 300])
def test_init_layer_vq_state_under_each_tier(tier, k, tier_reset):
    """Storage of a fresh state: uint8 tables where the tier and k <= 256
    allow, packed under '+a4' with k <= 16, an int8 / fp8 snapshot under a
    quantized tier -- as the reference builds it; the ids are the int32
    draw of the same seed in every tier, so the histogram is the same."""
    tops.configure_kernel_precision(tier)
    jops.configure_kernel_precision(tier)
    cfg, jcfg = CodebookConfig(k=k, f_prod=4), JCodebookConfig(k=k, f_prod=4)
    t = tconv.init_layer_vq_state(301, 32, 16, cfg,
                                  generator=torch.Generator().manual_seed(0),
                                  device=CPU)
    j = jconv.init_layer_vq_state(jax.random.PRNGKey(0), 301, 32, 16, jcfg)
    jpacked = isinstance(j.assignment, jq.PackedAssignment)
    assert isinstance(t.assignment, tq.PackedAssignment) == jpacked
    if jpacked:
        assert t.assignment.packed.shape == j.assignment.packed.shape
        ids = t.assignment.unpack()
    else:
        assert tq.dtype_name(t.assignment.dtype) == j.assignment.dtype.name
        ids = t.assignment
    assert (t.qcw is None) == (j.qcw is None)
    if t.qcw is not None:
        assert tq.dtype_name(t.qcw.feat.q.dtype) == j.qcw.feat.q.dtype.name
        assert t.qcw.grad.q.shape == j.qcw.grad.q.shape
    tops.configure_kernel_precision("fp32")
    ref = tconv.init_layer_vq_state(
        301, 32, 16, cfg, generator=torch.Generator().manual_seed(0),
        device=CPU)
    assert torch.equal(ids.int(), ref.assignment)
    assert torch.equal(t.counts, ref.counts)


def _ref_world(k, n=300):
    from repro.graph.datasets import synthetic_arxiv
    g = synthetic_arxiv(n=n, seed=0)
    kw = dict(backbone="gcn", f_in=g.f, hidden=32, n_out=g.num_classes,
              n_layers=2)
    jcfg = jgnn.GNNConfig(codebook=JCodebookConfig(k=k, f_prod=4), **kw)
    tcfg = tgnn.GNNConfig(codebook=CodebookConfig(k=k, f_prod=4), **kw)
    jvq = jgnn.init_vq_states(jax.random.PRNGKey(1), jcfg, g.n)
    return jcfg, tcfg, jvq


def assert_states_equal(tst, jst):
    """Tables, histograms and snapshots byte-equal (codebooks as well)."""
    for t, j in zip(tst, jst):
        if isinstance(j.assignment, jq.PackedAssignment):
            assert isinstance(t.assignment, tq.PackedAssignment)
            assert t.assignment.n == j.assignment.n
            assert np.array_equal(t.assignment.packed.numpy(),
                                  np.asarray(j.assignment.packed))
        else:
            assert tq.dtype_name(t.assignment.dtype) == j.assignment.dtype.name
            assert np.array_equal(t.assignment.numpy(),
                                  np.asarray(j.assignment))
        assert np.array_equal(t.counts.numpy(), np.asarray(j.counts))
        assert (t.qcw is None) == (j.qcw is None)
        if t.qcw is not None:
            assert_qtensor_equal(t.qcw.feat, j.qcw.feat)
            assert_qtensor_equal(t.qcw.grad, j.qcw.grad)


@pytest.mark.parametrize("tier", ["fp32"] + TIERS)
def test_quantize_vq_states_under_each_tier(tier):
    """The serving conversion of the same fp32 states: tables, histograms
    and snapshots byte-equal to the reference's, idempotent, and carried
    across by ``convert`` unchanged."""
    jcfg, tcfg, jvq = _ref_world(16)
    tvq = convert.vq_states_from_numpy(jvq, CPU)
    jout = jgnn.quantize_vq_states(jvq, jcfg, precision=tier)
    tout = tgnn.quantize_vq_states(tvq, tcfg, precision=tier)
    assert_states_equal(tout, jout)
    assert_states_equal(tgnn.quantize_vq_states(tout, tcfg, precision=tier),
                        jout)
    assert_states_equal(convert.vq_states_from_numpy(jout, CPU), jout)


def test_quantize_vq_states_guards(tier_reset):
    jcfg, tcfg, jvq = _ref_world(32)
    tvq = convert.vq_states_from_numpy(jvq, CPU)
    with pytest.raises(ValueError, match="k <= 16"):
        tgnn.quantize_vq_states(tvq, tcfg, precision="int8+a4")
    tops.configure_kernel_precision("fp8")       # the default follows it
    out = tgnn.quantize_vq_states(tvq, tcfg)
    assert out[0].qcw.feat.q.dtype == torch.float8_e4m3fn
    tops.configure_kernel_precision(reset=True)   # fp32 reads as int8
    assert tgnn.quantize_vq_states(tvq, tcfg)[0].qcw.feat.q.dtype \
        == torch.int8
    big = tcfg._replace(codebook=CodebookConfig(k=300, f_prod=4))
    with pytest.raises(ValueError, match="k <= 256"):
        tgnn.quantize_vq_states(tvq, big, precision="int8")


@pytest.mark.parametrize("tier", TIERS)
def test_refresh_and_requantize_match_reference(tier):
    """``refresh_assignment`` on uint8 and packed tables (a batch whose ids
    pair up both nibbles of many bytes) and ``quantize_layer_state`` after
    a codebook change inside and outside the drift band: byte-equal."""
    jcfg, tcfg, jvq = _ref_world(16)
    jst = jgnn.quantize_vq_states(jvq, jcfg, precision=tier)[0]
    tst = convert.vq_states_from_numpy([jst], CPU)[0]
    rng = np.random.default_rng(5)
    bids = rng.permutation(300)[:150].astype(np.int32)
    new = rng.integers(0, 16, (jst.counts.shape[0], 150)).astype(np.int32)
    jr = jconv.refresh_assignment(jst, jnp.asarray(bids), jnp.asarray(new))
    tr = tconv.refresh_assignment(tst, torch.from_numpy(bids),
                                  torch.from_numpy(new))
    assert_states_equal([tr], [jr])
    cbj, cbt = jr.codebook, tr.codebook
    for factor in (0.9, 2.0):
        jm = jr._replace(codebook=cbj._replace(
            codewords_w=cbj.codewords_w * factor))
        tm = tr._replace(codebook=cbt._replace(
            codewords_w=cbt.codewords_w * factor))
        fi = jcfg.layer_dims()[0][0]
        jq_ = jconv.quantize_layer_state(jm, fi, jcfg.layer_codebook_cfg())
        tq_ = tconv.quantize_layer_state(tm, fi, tcfg.layer_codebook_cfg())
        assert_states_equal([tq_], [jq_])



def _node_major(table):
    """A table held as ``core.conv.hold_table`` holds a tier state's table
    on the card: the same [nb, n] values (a packed table's bytes) over
    contiguous [n, nb] storage."""
    if isinstance(table, tq.PackedAssignment):
        return tq.PackedAssignment(table.packed.t().contiguous().t(), table.n)
    return table.t().contiguous().t()


def _buf(table) -> torch.Tensor:
    return table.packed if isinstance(table, tq.PackedAssignment) else table


@pytest.mark.parametrize("tier", ["fp32"] + TIERS)
def test_refresh_keeps_a_node_major_table_node_major(tier):
    """``refresh_assignment`` writes a node-major table (int32, uint8 or
    packed bytes) along its storage rows: the new table is node-major
    again, with no second copy, and equals the reference's refresh of the
    row-major table, histogram included.  On the CPU every table is held
    row-major (``hold_table`` forms node-major tables on the card only),
    and ``to_device`` returns a moved table to that layout."""
    jcfg, tcfg, jvq = _ref_world(16)
    jst = jvq[0] if tier == "fp32" else \
        jgnn.quantize_vq_states(jvq, jcfg, precision=tier)[0]
    tst = convert.vq_states_from_numpy([jst], CPU)[0]
    assert _buf(tst.assignment).is_contiguous()
    nm = tst._replace(assignment=_node_major(tst.assignment))
    assert tce.is_node_major(_buf(nm.assignment))
    rng = np.random.default_rng(7)
    bids = rng.permutation(300)[:150].astype(np.int32)
    new = rng.integers(0, 16, (jst.counts.shape[0], 150)).astype(np.int32)
    jr = jconv.refresh_assignment(jst, jnp.asarray(bids), jnp.asarray(new))
    tr = tconv.refresh_assignment(nm, torch.from_numpy(bids),
                                  torch.from_numpy(new))
    assert tce.is_node_major(_buf(tr.assignment))
    assert _buf(tr.assignment).untyped_storage().nbytes() \
        == _buf(tr.assignment).numel() * _buf(tr.assignment).element_size()
    assert_states_equal([tr], [jr])
    moved = convert.to_device(tr, CPU)
    assert _buf(moved.assignment).is_contiguous()
    assert_states_equal([moved], [jr])
    for st in (tr, nm):
        assert _buf(tconv.hold_table(st).assignment).is_contiguous()


@pytest.mark.parametrize("tier", ["fp32"] + TIERS)
def test_context_ell_reads_either_layout(tier):
    """The context term (``ops.context_ell``, plain and ``w_t``) of a
    node-major table equals the row-major table's bit for bit."""
    jcfg, tcfg, jvq = _ref_world(16)
    jst = jvq[0] if tier == "fp32" else \
        jgnn.quantize_vq_states(jvq, jcfg, precision=tier)[0]
    tst = convert.vq_states_from_numpy([jst], CPU)[0]
    fi = jcfg.layer_dims()[0][0]
    fcw, gcw = tconv.layer_codewords(tst, fi, tcfg.layer_codebook_cfg())
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 300, (37, 9)).astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((37, 9)).astype(np.float32))
    nb, _, fb = (fcw.q if isinstance(fcw, tq.QTensor) else fcw).shape
    w_t = torch.from_numpy(rng.standard_normal((nb * fb, 5))
                           .astype(np.float32))
    for wt in (None, w_t):
        want = tops.context_ell(ids, vals, tst.assignment, fcw, wt)
        got = tops.context_ell(ids, vals, _node_major(tst.assignment), fcw,
                               wt)
        assert torch.equal(got, want)
