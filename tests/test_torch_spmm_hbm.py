"""The staged-stripe SpMM of the PyTorch port against the JAX reference on
the CPU: the stripe index (host-built and device-built), the kernel's plain
version ``ref.spmm_ell_hbm`` and the resident / staged dispatch of
``ops.spmm_ell``.

The reference's Pallas ``spmm_ell_hbm_pallas`` does not run on the
installed JAX (``pltpu.TPUCompilerParams``), but its own oracle,
``repro.kernels.ref.spmm_ell``, does, and its index builders and
``ValueError``s run before the ``pallas_call``: the port is held against
those.  Inputs come from numpy seeds; the JAX side runs with
``REPRO_FORCE_PALLAS`` unset.  Tolerances: the plain version sums each
row's slots in (stripe, slot) order, the oracle in slot order, one
separately rounded multiply and add at a time on both sides (XLA's CPU
code may fuse them), so they agree to ``rtol=1e-5, atol=1e-6``; indices
and variants must be equal.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.graph import batching as jb                       # noqa: E402
from repro.graph.structure import build_graph as j_build     # noqa: E402
from repro.kernels import ops as jops                        # noqa: E402
from repro.kernels import ref as jref                        # noqa: E402
from repro.kernels import spmm_ell_hbm as jhbm               # noqa: E402
from repro_torch.graph import batching as tb                 # noqa: E402
from repro_torch.graph.structure import build_graph as t_build  # noqa: E402
from repro_torch.kernels import ops as tops                  # noqa: E402
from repro_torch.kernels import ref as tref                  # noqa: E402
from repro_torch.kernels import spmm_ell_hbm as thbm         # noqa: E402
from repro_torch.nn.gnn_layers import GCN                    # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu"

# (b, deg, n_src, bb, stripe): ragged last tiles, n_src not a multiple of
# the stripe, a stripe above n_src, one tile, non-power-of-two stripes
SHAPES = [(90, 5, 700, 32, 128), (53, 6, 210, 8, 8), (53, 6, 210, 16, 64),
          (200, 9, 3000, 128, 128), (33, 7, 50, 32, 24), (7, 3, 20, 128, 512),
          (257, 5, 2000, 128, 96)]


def _case(b, deg, n, f=8, seed=0, pad=0.3):
    """ids [b, D], values [b, D] with about ``pad`` of the slots padding
    (value 0, id 0 as the packers leave them) and whole padding rows, and a
    source [n, f]."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (b, deg)).astype(np.int32)
    val = rng.normal(size=(b, deg)).astype(np.float32)
    padding = rng.random((b, deg)) < pad
    padding[::5] = True                     # rows with no live slot
    val[padding] = 0.0
    idx[padding] = 0
    x = rng.normal(size=(n, f)).astype(np.float32)
    return idx, val, x


def _host_pair(idx, n, **kw):
    j = jb.make_stripe_index(idx, n, **kw)
    t = tb.make_stripe_index(idx, n, device=CPU, **kw)
    return j, t


def _assert_index_equal(t, j):
    assert (t.bb, t.stripe, t.n_src) == (j.bb, j.stripe, j.n_src)
    assert t.ids.dtype == torch.int32 and t.counts.dtype == torch.int32
    assert np.array_equal(t.ids.numpy(), np.asarray(j.ids))
    assert np.array_equal(t.counts.numpy(), np.asarray(j.counts))


# ---------------------------------------------------------------------------
# the stripe index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,deg,n,bb,stripe", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_make_stripe_index_matches_reference(b, deg, n, bb, stripe, masked):
    idx, val, _ = _case(b, deg, n)
    kw = dict(bb=bb, stripe=stripe)
    if masked:
        kw["mask"] = (val != 0).astype(np.float32)
    j, t = _host_pair(idx, n, **kw)
    _assert_index_equal(t, j)


@pytest.mark.parametrize("b,deg,n,bb,stripe", SHAPES)
def test_device_index_matches_stripe_index_jnp(b, deg, n, bb, stripe):
    idx, val, _ = _case(b, deg, n, seed=1)
    j = jhbm.stripe_index_jnp(jnp.asarray(idx), jnp.asarray(val), n, bb=bb,
                              stripe=stripe)
    t = thbm.stripe_index_torch(torch.from_numpy(idx), torch.from_numpy(val),
                                n, bb=bb, stripe=stripe)
    _assert_index_equal(t, j)
    # the live part agrees with the host-built index over the same slots
    h = tb.make_stripe_index(idx, n, mask=val != 0, bb=bb, stripe=stripe,
                             device=CPU)
    assert torch.equal(h.counts, t.counts)
    for row_h, row_t, c in zip(h.ids, t.ids, t.counts):
        assert torch.equal(row_h[:c], row_t[:c])


def test_stripe_index_shapes_fixed_across_batches():
    """Successive packs of one shape give one index shape."""
    rng = np.random.default_rng(0)
    shapes = set()
    for _ in range(5):
        idx = rng.integers(0, 777, (60, 6))
        si = tb.make_stripe_index(idx, 777, bb=16, stripe=64, device=CPU)
        shapes.add((tuple(si.ids.shape), tuple(si.counts.shape), si.bb,
                    si.stripe))
    assert len(shapes) == 1


def test_stripe_index_max_stripes_cap_matches_reference():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 1000, (32, 8))
    j, t = _host_pair(idx, 1000, bb=8, stripe=64, max_stripes=64)
    assert t.ids.shape[1] == 64
    _assert_index_equal(t, j)
    for make in (jb.make_stripe_index,
                 lambda *a, **k: tb.make_stripe_index(*a, device=CPU, **k)):
        with pytest.raises(ValueError, match="max_stripes"):
            make(idx, 1000, bb=8, stripe=8, max_stripes=2)


@pytest.mark.parametrize("bad", ["tiles", "n_src"])
def test_index_mismatch_raises_like_reference(bad):
    """The reference's two ValueErrors (tile count, source rows), raised
    before its pallas_call, and the port's from the same calls."""
    idx, val, x = _case(64, 4, 256)
    if bad == "tiles":                        # built for 4 tiles, not 8
        args = (idx[:32], x.shape[0])
    else:
        args = (idx % 128, 128)
    j, t = _host_pair(*args, bb=8, stripe=64)
    with pytest.raises(ValueError, match=bad) as je:
        jhbm.spmm_ell_hbm_pallas(jnp.asarray(idx), jnp.asarray(val),
                                 jnp.asarray(x), j, interpret=True)
    with pytest.raises(ValueError, match=bad) as te:
        tref.spmm_ell_hbm(torch.from_numpy(idx), torch.from_numpy(val),
                          torch.from_numpy(x), t)
    assert str(te.value) == str(je.value)


def test_clamp_and_default_tiles():
    """The tiles are clamped as the reference clamps them, and default to
    the reference's (128 rows, 512-row stripes) wherever an index is built;
    at those tiles a block's shared memory holds the slot lists of the
    slice's widest rows (D 18) with room to spare."""
    import inspect
    for args in [(5, 100, 128, 512), (300, 7, 128, 512), (1000, 5000, 64, 96)]:
        assert thbm.clamp_tiles(*args) == jhbm.clamp_tiles(*args)
    ref_kw = inspect.signature(jb.make_stripe_index).parameters
    assert (thbm.DEFAULT_BB, thbm.DEFAULT_STRIPE) == (
        ref_kw["bb"].default, ref_kw["stripe"].default) == (128, 512)
    for fn in (tb.make_stripe_index, thbm.stripe_index_torch):
        kw = inspect.signature(fn).parameters
        assert (kw["bb"].default, kw["stripe"].default) == (128, 512)
    full = inspect.signature(tb.full_operands).parameters
    ref_full = inspect.signature(jb.full_operands).parameters
    assert (full["stripe_bb"].default, full["stripe"].default) == (
        ref_full["stripe_bb"].default, ref_full["stripe"].default)
    assert 4 * thbm.smem_bytes(128, 512, 18, 169343) <= thbm.SMEM_LIMIT


@pytest.mark.parametrize("b,deg,n", [(300, 18, 5000), (90, 5, 700),
                                     (7, 3, 20), (1000, 9, 169)])
@pytest.mark.parametrize("masked", [False, True])
def test_default_tiles_index_matches_reference(b, deg, n, masked):
    """The index built with every tile argument left at its default, on
    the host and on the device, is array-equal to the reference's."""
    idx, val, _ = _case(b, deg, n, seed=8)
    kw = {"mask": (val != 0).astype(np.float32)} if masked else {}
    j, t = _host_pair(idx, n, **kw)
    assert (t.bb, t.stripe) == thbm.clamp_tiles(b, n, 128, 512)
    _assert_index_equal(t, j)
    # the reference builds its in-jit index at spmm_ell_hbm_pallas's tiles
    jd = jhbm.stripe_index_jnp(jnp.asarray(idx), jnp.asarray(val), n,
                               bb=128, stripe=512)
    td = thbm.stripe_index_torch(torch.from_numpy(idx),
                                 torch.from_numpy(val), n)
    _assert_index_equal(td, jd)


# ---------------------------------------------------------------------------
# the plain version against the reference's oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,deg,n,bb,stripe", SHAPES)
@pytest.mark.parametrize("f", [8, 32])
def test_plain_staged_spmm_matches_reference_oracle(b, deg, n, bb, stripe,
                                                    f):
    idx, val, x = _case(b, deg, n, f, seed=2)
    t = tb.make_stripe_index(idx, n, mask=val != 0, bb=bb, stripe=stripe,
                             device=CPU)
    got = tref.spmm_ell_hbm(torch.from_numpy(idx), torch.from_numpy(val),
                            torch.from_numpy(x), t)
    want = np.asarray(jref.spmm_ell(jnp.asarray(idx), jnp.asarray(val),
                                    jnp.asarray(x)))
    assert got.shape == (b, f)
    assert_allclose(got.numpy(), want, **TOL)
    # every row of a tile with no live slot is exactly zero
    dead = np.repeat(t.counts.numpy() == 0, bb)[:b]
    assert not got.numpy()[dead].any()


@pytest.mark.parametrize("b,deg,n", [(300, 18, 5000), (257, 5, 2000),
                                     (7, 3, 20)])
@pytest.mark.parametrize("f", [8, 128])
def test_plain_staged_spmm_at_default_tiles_matches_reference_oracle(
        b, deg, n, f):
    """The plain version at the reference's default tiles (the index
    built with no tile argument, as ``spmm_ell_hbm_cuda`` builds it)
    against the reference's oracle."""
    idx, val, x = _case(b, deg, n, f, seed=9)
    t = thbm.stripe_index_torch(torch.from_numpy(idx), torch.from_numpy(val),
                                n)
    got = tref.spmm_ell_hbm(torch.from_numpy(idx), torch.from_numpy(val),
                            torch.from_numpy(x), t)
    want = np.asarray(jref.spmm_ell(jnp.asarray(idx), jnp.asarray(val),
                                    jnp.asarray(x)))
    assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("b,deg,n,bb,stripe", SHAPES[:4])
def test_plain_staged_spmm_quantized_source(qdtype, b, deg, n, bb, stripe):
    """An int8 / fp8 e4m3 source with per-channel scales: the same
    function as the reference's oracle on the same stored values."""
    idx, val, x = _case(b, deg, n, 16, seed=3)
    scale = (np.abs(x).max(0, keepdims=True) / 127.0).astype(np.float32)
    if qdtype == "int8":
        q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        tq, jq = torch.from_numpy(q), jnp.asarray(q)
    else:
        tq = (torch.from_numpy(x) / torch.from_numpy(scale)).to(
            torch.float8_e4m3fn)
        jq = jnp.asarray(tq.float().numpy()).astype(jnp.float8_e4m3fn)
    t = thbm.stripe_index_torch(torch.from_numpy(idx), torch.from_numpy(val),
                                n, bb=bb, stripe=stripe)
    got = tref.spmm_ell_hbm(torch.from_numpy(idx), torch.from_numpy(val), tq,
                            t, torch.from_numpy(scale))
    want = np.asarray(jref.spmm_ell(jnp.asarray(idx), jnp.asarray(val), jq,
                                    jnp.asarray(scale)))
    assert_allclose(got.numpy(), want, **TOL)


def test_plain_staged_spmm_drops_unlisted_stripes():
    """An index that omits a stripe drops that stripe's messages (the
    reference's documented contract), and only those."""
    idx, val, x = _case(40, 6, 300, 8, seed=4, pad=0.0)
    t = tb.make_stripe_index(idx, 300, bb=8, stripe=64, device=CPU)
    drop = int(t.ids[0, 0])
    counts = t.counts.clone()
    ids = t.ids.clone()
    ids[0, :counts[0] - 1] = t.ids[0, 1:counts[0]].clone()
    counts[0] -= 1
    cut = thbm.StripeIndex(ids, counts, bb=8, stripe=64, n_src=300)
    got = tref.spmm_ell_hbm(torch.from_numpy(idx), torch.from_numpy(val),
                            torch.from_numpy(x), cut)
    kept = val.copy()
    kept[:8][idx[:8] // 64 == drop] = 0.0
    want = np.asarray(jref.spmm_ell(jnp.asarray(idx), jnp.asarray(kept),
                                    jnp.asarray(x)))
    assert_allclose(got.numpy(), want, **TOL)


def test_spmm_backward_matches_jax_autodiff():
    """d/dx of ops.spmm_ell (the transposed SpMM, the backward of both
    variants) against JAX autodiff of the reference's oracle; a stripe
    index passed along changes nothing on the CPU."""
    idx, val, x = _case(120, 7, 500, 16, seed=5)
    w = np.random.default_rng(6).normal(size=(120, 16)).astype(np.float32)
    jg = jax.grad(lambda xx: jnp.sum(jref.spmm_ell(
        jnp.asarray(idx), jnp.asarray(val), xx) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    si = tb.make_stripe_index(idx, 500, mask=val != 0, device=CPU)
    (tops.spmm_ell(torch.from_numpy(idx), torch.from_numpy(val), xt, si)
     * torch.from_numpy(w)).sum().backward()
    assert_allclose(xt.grad.numpy(), np.asarray(jg), **TOL)


# ---------------------------------------------------------------------------
# the resident / staged dispatch
# ---------------------------------------------------------------------------

GRID = [(n, f, item) for n in (64, 20000, 42335, 84670, 169343, 262144)
        for f in (40, 64, 128) for item in (1, 4)]


@pytest.fixture
def clean_dispatch(monkeypatch):
    for var in ("REPRO_SPMM_VARIANT", "REPRO_SPMM_VMEM_BUDGET_MB",
                "REPRO_SPMM_L2_BUDGET_MB"):
        monkeypatch.delenv(var, raising=False)
    jops.configure_spmm_dispatch(reset=True)
    tops.configure_spmm_dispatch(reset=True)
    yield monkeypatch
    jops.configure_spmm_dispatch(reset=True)
    tops.configure_spmm_dispatch(reset=True)


@pytest.mark.parametrize("budget", [0.001, 4.0, 8.0, 16.0, 50.0, 200.0])
def test_variant_matches_reference_at_a_configured_budget(clean_dispatch,
                                                          budget):
    jops.configure_spmm_dispatch(vmem_budget_mb=budget)
    tops.configure_spmm_dispatch(l2_budget_mb=budget)
    for n, f, item in GRID:
        assert tops.spmm_ell_variant(n, f, item) == \
            jops.spmm_ell_variant(n, f, item), (n, f, item, budget)


def test_variant_env_budget_and_forcing_match_reference(clean_dispatch):
    """Each package under its own budget variable: the reference's VMEM
    one, the port's L2 one (the port refuses the VMEM name)."""
    mp = clean_dispatch
    for n, f, item in GRID:
        mp.setenv("REPRO_SPMM_VMEM_BUDGET_MB", "4")
        want = jops.spmm_ell_variant(n, f, item)
        mp.delenv("REPRO_SPMM_VMEM_BUDGET_MB")
        mp.setenv("REPRO_SPMM_L2_BUDGET_MB", "4")
        assert tops.spmm_ell_variant(n, f, item) == want
        mp.delenv("REPRO_SPMM_L2_BUDGET_MB")
    mp.setenv("REPRO_SPMM_L2_BUDGET_MB", "4")
    for forced in ("resident", "hbm"):
        mp.setenv("REPRO_SPMM_VARIANT", forced)
        assert tops.spmm_ell_variant(20000, 64) == forced == \
            jops.spmm_ell_variant(20000, 64)
    # a programmatic setting wins over the environment
    tops.configure_spmm_dispatch(variant="resident")
    assert tops.spmm_ell_variant(8, 8) == "resident"
    tops.configure_spmm_dispatch(variant="auto", l2_budget_mb=0.001)
    assert tops.spmm_ell_variant(64, 64) == "hbm"


def test_default_budget_is_the_cards_l2(clean_dispatch):
    """50 MiB: the slice's sources split as the port's table says."""
    assert tops.spmm_ell_variant(169343, 128) == "hbm"      # full graph
    assert tops.spmm_ell_variant(262144, 128) == "hbm"      # NS-SAGE, LABOR
    assert tops.spmm_ell_variant(131072, 128) == "hbm"      # GraphSAINT
    assert tops.spmm_ell_variant(32768, 128) == "resident"  # Cluster-GCN
    assert tops.spmm_ell_variant(42335, 128) == "resident"  # VQ batch
    assert tops.spmm_ell_variant(84670, 128) == "resident"  # hybrid batch
    assert tops.spmm_ell_variant(169343, 128, 1) == "resident"  # int8 full


def test_configure_reset_and_bad_knobs(clean_dispatch):
    mp = clean_dispatch
    tops.configure_spmm_dispatch(variant="hbm", l2_budget_mb=0.001)
    assert tops.spmm_ell_variant(8, 8) == "hbm"
    tops.configure_spmm_dispatch(reset=True)
    assert not tops._dispatch_overrides
    assert tops.spmm_ell_variant(8, 8) == "resident"
    tops.configure_spmm_dispatch(variant="hbm", reset=True)
    assert tops._dispatch_overrides == {"variant": "hbm"}
    with pytest.raises(ValueError, match="unknown spmm variant"):
        tops.configure_spmm_dispatch(variant="nope")
    tops.configure_spmm_dispatch(reset=True)
    mp.setenv("REPRO_SPMM_VARIANT", "warp")
    with pytest.raises(ValueError, match="REPRO_SPMM_VARIANT"):
        tops.spmm_ell_variant(8, 8)
    mp.delenv("REPRO_SPMM_VARIANT")
    for bad in ("x", "0", "-3"):
        mp.setenv("REPRO_SPMM_L2_BUDGET_MB", bad)
        with pytest.raises(ValueError, match="REPRO_SPMM_L2_BUDGET_MB"):
            tops.spmm_ell_variant(8, 8)


def test_cpu_tensors_take_the_plain_path_whatever_the_variant(
        clean_dispatch):
    """On the CPU ``ops.spmm_ell`` runs the reference's CPU path (the
    plain ``spmm_ell``) under either forced variant."""
    idx, val, x = _case(70, 5, 400, 8, seed=7)
    want = tref.spmm_ell(torch.from_numpy(idx), torch.from_numpy(val),
                         torch.from_numpy(x))
    for forced in ("resident", "hbm"):
        tops.configure_spmm_dispatch(variant=forced)
        got = tops.spmm_ell(torch.from_numpy(idx), torch.from_numpy(val),
                            torch.from_numpy(x))
        assert torch.equal(got, want)


def test_full_operands_stripe_index_and_gcn_apply():
    """``full_operands(stripe_index=True)`` carries the reference's index,
    at given tiles and at the defaults; GCN's full_apply passes it along
    and its output is unchanged."""
    rng = np.random.default_rng(0)
    n, m = 120, 600
    src = rng.integers(0, n, m).astype(np.int64)
    dst = rng.integers(0, n, m).astype(np.int64)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    tr = np.arange(n)
    jg = j_build(src, dst, n, feats, labels, (tr, tr, tr))
    tg = t_build(src, dst, n, feats, labels, (tr, tr, tr))
    jo = jb.full_operands(jg, stripe_index=True, stripe_bb=32, stripe=32)
    to = tb.full_operands(tg, stripe_index=True, stripe_bb=32, stripe=32,
                          device=CPU)
    assert isinstance(to.stripe_index, thbm.StripeIndex)
    _assert_index_equal(to.stripe_index, jo.stripe_index)
    assert tb.full_operands(tg, device=CPU).stripe_index is None
    _assert_index_equal(
        tb.full_operands(tg, stripe_index=True, device=CPU).stripe_index,
        jb.full_operands(jg, stripe_index=True).stripe_index)
    p = GCN.init(16, 8, generator=torch.Generator().manual_seed(0),
                 device=CPU)
    x = torch.from_numpy(feats)
    plain = GCN.full_apply(p, x, tb.full_operands(tg, device=CPU),
                           torch.relu)
    assert torch.equal(GCN.full_apply(p, x, to, torch.relu), plain)
