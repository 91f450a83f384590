"""The dispatch and tuning layer of the PyTorch port against the JAX
reference on the CPU: the context dispatch (``context_ell_variant`` on a
grid of table sizes and item sizes at configured budgets, the forced
variants, the environment's precedence, configure and reset, the
reference's VMEM-named budgets refused with the port's L2 names), the
per-branch loop ``_context_ell_loop`` on CPU tensors against the
reference's ``ref.context_ell`` (int32, uint8 and packed tables; f32,
int8 and fp8 codewords; with and without ``w_t``), the measure-and-cache
tuner's cache (buckets, the key's parts, record / lookup, a corrupt file,
the opt-in gate) and its precedence from a pre-seeded cache -- nothing is
measured on the CPU -- and ``hostenv``'s reads.

Inputs come from numpy with a seed.  Tolerances: dispatch decisions and
the loop's plain form exact (the loop is also bit-equal to the port's
plain version); against the reference ``rtol=1e-5, atol=1e-6`` and, with
``w_t`` (a matmul in another summation order), ``rtol=1e-5,
atol=1e-5``.
"""
import json

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                      # noqa: E402

from repro.distributed import quantization as jq             # noqa: E402
from repro.kernels import ops as jops                        # noqa: E402
from repro.kernels import ref as jref                        # noqa: E402
from repro_torch import hostenv                              # noqa: E402
from repro_torch.distributed import quantization as tq       # noqa: E402
from repro_torch.kernels import _build                       # noqa: E402
from repro_torch.kernels import autotune                     # noqa: E402
from repro_torch.kernels import ops as tops                  # noqa: E402
from repro_torch.kernels import ref as tref                  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
WT_TOL = dict(rtol=1e-5, atol=1e-5)
VARS = ("REPRO_CONTEXT_VARIANT", "REPRO_CONTEXT_VMEM_BUDGET_MB",
        "REPRO_CONTEXT_L2_BUDGET_MB", "REPRO_SPMM_VARIANT",
        "REPRO_SPMM_VMEM_BUDGET_MB", "REPRO_SPMM_L2_BUDGET_MB",
        "REPRO_AUTOTUNE", "REPRO_AUTOTUNE_CACHE", "REPRO_FORCE_PALLAS")


def _reset():
    for mod in (tops, jops):
        mod.configure_context_dispatch(reset=True)
        mod.configure_spmm_dispatch(reset=True)
    autotune.clear(memory_only=True)
    hostenv.reset_env_snapshot()


@pytest.fixture
def env(monkeypatch):
    """No dispatch variable, override or cached entry in either package."""
    for var in VARS:
        monkeypatch.delenv(var, raising=False)
    _reset()
    yield monkeypatch
    _reset()


# ---------------------------------------------------------------------------
# the context dispatch
# ---------------------------------------------------------------------------

GRID = [(n, nb, item) for n in (64, 20000, 169343, 235868, 500000, 2 ** 21)
        for nb in (1, 8, 32) for item in (4, 1, 0.5)]


@pytest.mark.parametrize("budget", [0.001, 1.0, 8.0, 21.0, 50.0, 200.0])
def test_context_variant_matches_reference_at_a_configured_budget(env,
                                                                  budget):
    jops.configure_context_dispatch(vmem_budget_mb=budget)
    tops.configure_context_dispatch(l2_budget_mb=budget)
    for n, nb, item in GRID:
        assert tops.context_ell_variant(n, nb, item) == \
            jops.context_ell_variant(n, nb, item), (n, nb, item, budget)


def test_context_env_budget_and_forcing_match_reference(env):
    """Each package under its own variable: the reference's VMEM budget,
    the port's L2 budget; a forced variant wins over both; a programmatic
    setting wins over the environment."""
    for n, nb, item in GRID:
        env.setenv("REPRO_CONTEXT_VMEM_BUDGET_MB", "4")
        want = jops.context_ell_variant(n, nb, item)
        env.delenv("REPRO_CONTEXT_VMEM_BUDGET_MB")
        env.setenv("REPRO_CONTEXT_L2_BUDGET_MB", "4")
        assert tops.context_ell_variant(n, nb, item) == want, (n, nb, item)
        env.delenv("REPRO_CONTEXT_L2_BUDGET_MB")
    env.setenv("REPRO_CONTEXT_L2_BUDGET_MB", "0.001")
    for forced in ("fused", "loop"):
        env.setenv("REPRO_CONTEXT_VARIANT", forced)
        assert tops.context_ell_variant(1000, 4) == forced == \
            jops.context_ell_variant(1000, 4)
    env.setenv("REPRO_CONTEXT_VARIANT", "auto")
    assert tops.context_ell_variant(1000, 4) == "loop"
    tops.configure_context_dispatch(variant="fused")
    assert tops.context_ell_variant(1000, 4) == "fused"
    tops.configure_context_dispatch(variant="auto", l2_budget_mb=100.0)
    assert tops.context_ell_variant(1000, 4) == "fused"
    tops.configure_context_dispatch(reset=True)
    assert tops.context_ell_variant(1000, 4) == "loop"


def test_context_configure_and_reset(env):
    tops.configure_context_dispatch(variant="loop")
    assert tops.context_ell_variant(1000, 1) == "loop"
    tops.configure_context_dispatch(l2_budget_mb=0.001)     # keeps 'loop'
    assert tops._context_overrides == {"variant": "loop",
                                       "l2_budget_mb": 0.001}
    tops.configure_context_dispatch(variant="auto")
    assert tops.context_ell_variant(1000, 1) == "loop"        # 4 kB, budget 1 KiB
    tops.configure_context_dispatch(reset=True)
    assert tops._context_overrides == {}
    assert tops.context_ell_variant(1000, 1) == "fused"
    with pytest.raises(ValueError, match="unknown context variant"):
        tops.configure_context_dispatch(variant="nope")
    env.setenv("REPRO_CONTEXT_VARIANT", "nope")
    with pytest.raises(ValueError, match="want auto, fused or loop"):
        tops.context_ell_variant(1000, 1)
    env.setenv("REPRO_CONTEXT_VARIANT", "auto")
    for bad in ("x", "0", "-3"):
        env.setenv("REPRO_CONTEXT_L2_BUDGET_MB", bad)
        with pytest.raises(ValueError, match="CONTEXT_L2_BUDGET_MB"):
            tops.context_ell_variant(1000, 1)


def test_default_context_budget_follows_the_cards_measurement(env):
    """Unbounded: the main paths' tables (arxiv's [32, 169343] int32, 21.7
    MB, its uint8 and packed forms, the link graph's [32, 235868], 30.2
    MB), every table the card measured the fused kernel faster at (up to
    [32, 4,000,000] int32, 512 MB) and any larger one stay fused; only a
    configured budget sends a table to the loop."""
    for n, item in ((169343, 4), (169343, 1), (169343, 0.5), (235868, 4),
                    (500000, 4), (4000000, 4), (4200000, 4), (2 ** 40, 4)):
        assert tops.context_ell_variant(n, 32, item) == "fused"
    env.setenv("REPRO_CONTEXT_L2_BUDGET_MB", "512")
    assert tops.context_ell_variant(4000000, 32, 4) == "fused"
    assert tops.context_ell_variant(4200000, 32, 4) == "loop"


@pytest.mark.parametrize("kind", ["SPMM", "CONTEXT"])
def test_vmem_budgets_raise_naming_the_l2_variables(env, kind):
    env.setenv(f"REPRO_{kind}_VMEM_BUDGET_MB", "8")
    call = (lambda: tops.spmm_ell_variant(64, 8)) if kind == "SPMM" \
        else (lambda: tops.context_ell_variant(64, 8))
    with pytest.raises(ValueError, match=f"REPRO_{kind}_L2_BUDGET_MB"):
        call()
    # a forced variant reads no budget, in the reference neither
    env.setenv(f"REPRO_{kind}_VARIANT", "hbm" if kind == "SPMM" else "loop")
    call()


# ---------------------------------------------------------------------------
# the per-branch loop on CPU tensors
# ---------------------------------------------------------------------------

def _loop_case(seed: int, table: str, k: int, b=37, deg=6, n=91, nb=4,
               f_blk=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, (b, deg)).astype(np.int32)
    vals = rng.normal(size=(b, deg)).astype(np.float32)
    vals[rng.random((b, deg)) < 0.3] = 0.0           # padding slots
    a = rng.integers(0, k, (nb, n)).astype(np.int32)
    cw = rng.normal(size=(nb, k, f_blk)).astype(np.float32)
    w_t = rng.normal(size=(nb * f_blk, 7)).astype(np.float32)
    ta = torch.from_numpy(a)
    ja = jnp.asarray(a)
    if table == "uint8":
        ta, ja = ta.to(torch.uint8), ja.astype(jnp.uint8)
    elif table == "packed":
        ta = tq.PackedAssignment.pack(ta)
        ja = jq.PackedAssignment.pack(ja)
    return ids, vals, ta, ja, cw, w_t


CW_DTYPES = [("f32", None, None), ("int8", torch.int8, jnp.int8),
             ("fp8", torch.float8_e4m3fn, jnp.float8_e4m3fn)]


@pytest.mark.parametrize("table,k", [("int32", 300), ("uint8", 256),
                                     ("packed", 16)])
@pytest.mark.parametrize("name,tdt,jdt", CW_DTYPES)
@pytest.mark.parametrize("wt", [False, True])
def test_context_loop_matches_reference(table, k, name, tdt, jdt, wt):
    ids, vals, ta, ja, cw, w_t = _loop_case(k + len(name), table, k)
    tcw, jcw, tsc, jsc = torch.from_numpy(cw), jnp.asarray(cw), None, None
    if tdt is not None:
        qt = tq.quantize_codewords(tcw, dtype=tdt)
        qj = jq.quantize_codewords(jcw, dtype=jdt)
        tcw, tsc, jcw, jsc = qt.q, qt.scale, qj.q, qj.scale
        assert np.array_equal(tsc.numpy(), np.asarray(jsc))
    tw = torch.from_numpy(w_t) if wt else None
    tids, tvals = torch.from_numpy(ids), torch.from_numpy(vals)
    got = tops._context_ell_loop(tids, tvals, ta, tcw, tw, tsc)
    want = np.asarray(jref.context_ell(jnp.asarray(ids), jnp.asarray(vals),
                                       ja, jcw, w_t=jnp.asarray(w_t)
                                       if wt else None, cw_scale=jsc))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_allclose(got.numpy(), want, **(WT_TOL if wt else TOL))
    plain = tref.context_ell(tids, tvals, ta, tcw, tw, tsc)
    if wt:
        assert_allclose(got.numpy(), plain.numpy(), **WT_TOL)
    else:
        assert torch.equal(got, plain)


@pytest.mark.parametrize("variant", ["auto", "fused", "loop"])
def test_cpu_tensors_take_the_plain_version_whatever_the_variant(env,
                                                                 variant):
    """As in the reference, the variant steers the card only: a CPU call is
    the plain version's, bit for bit, and reads no budget."""
    ids, vals, ta, _, cw, w_t = _loop_case(1, "int32", 20)
    args = (torch.from_numpy(ids), torch.from_numpy(vals), ta,
            torch.from_numpy(cw))
    env.setenv("REPRO_CONTEXT_VARIANT", variant)
    env.setenv("REPRO_CONTEXT_VMEM_BUDGET_MB", "4")
    for w in (None, torch.from_numpy(w_t)):
        assert torch.equal(tops.context_ell(*args, w),
                           tref.context_ell(*args, w))


# ---------------------------------------------------------------------------
# the tuner's cache
# ---------------------------------------------------------------------------

@pytest.fixture
def tuner_cache(env, tmp_path):
    path = tmp_path / "autotune.json"
    env.setenv("REPRO_AUTOTUNE", "1")
    env.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    autotune.clear(memory_only=True)
    return path


def test_shape_bucket():
    assert [autotune.shape_bucket(v) for v in (0, 1, 2, 3, 100, 128, 129,
                                               169343, 235868)] == \
        [0, 1, 2, 4, 128, 128, 256, 262144, 262144]


def test_cache_key_parts(env):
    key = autotune.cache_key("spmm", (100, 16, 4), torch.float32)
    kind, buckets, dtype, card, build = key.split("|")
    assert (kind, buckets, dtype) == ("spmm", "128x16x4", "float32")
    assert card == autotune.device_name() == "cpu"    # no card here
    assert build == _build.source_hash()
    # nearby shapes share a key; dtypes, cards and builds do not
    assert autotune.cache_key("spmm", (65, 16, 4), "float32") == key
    assert autotune.cache_key("spmm", (100, 16, 4), torch.int8) != key
    assert autotune.cache_key("context", (5, 4), "uint4").split("|")[2] \
        == "uint4"
    other = autotune.cache_key("spmm", (100, 16, 4), torch.float32,
                               device="NVIDIA H100 80GB HBM3")
    assert other != key and other.split("|")[3] == "NVIDIA H100 80GB HBM3"


def test_record_lookup_roundtrip(tuner_cache):
    autotune.record("k1", {"variant": "fused", "ms": {"fused": 0.1}})
    assert autotune.lookup("k1") == {"variant": "fused",
                                     "ms": {"fused": 0.1}}
    assert autotune.lookup("nope") is None
    autotune.clear(memory_only=True)          # reloads from the file
    assert autotune.lookup("k1")["variant"] == "fused"
    assert json.loads(tuner_cache.read_text())["k1"]["variant"] == "fused"
    autotune.clear()                          # and removes it
    assert not tuner_cache.exists() and autotune.lookup("k1") is None


@pytest.mark.parametrize("text", ["{not json", "[1, 2]", ""])
def test_corrupt_cache_file_is_ignored(tuner_cache, text):
    tuner_cache.write_text(text)
    autotune.clear(memory_only=True)
    assert autotune.lookup("anything") is None
    autotune.record("k", {"wgs": 2})          # recovers by rewriting
    autotune.clear(memory_only=True)
    assert autotune.lookup("k") == {"wgs": 2}


def test_default_cache_path(env):
    assert autotune.cache_path().endswith(
        "/.cache/repro_torch/autotune.json")


def test_disabled_returns_none(env):
    for value in (None, "0"):
        if value is not None:
            env.setenv("REPRO_AUTOTUNE", value)
        env.setenv("REPRO_AUTOTUNE_CACHE", "/nonexistent/at.json")
        assert not autotune.enabled()
        assert autotune.tuned_spmm(1000, 16) is None
        assert autotune.tuned_context(1000, 4) is None
        assert autotune.tuned_vq_update(256, 64, 65) is None
        # with tuning off the defaults decide
        assert tops.spmm_ell_variant(1000, 16) == "resident"
        assert tops.context_ell_variant(1000, 4) == "fused"


def test_vq_update_entry_keyed_by_its_emit(tuner_cache):
    """The wide row tile is tuned per emit: a uint8 or uint4 emit runs
    the uint8 entries, so it reads the uint8 key, never the int32 one; an
    emit that cannot index k raises before any lookup."""
    n0 = len(autotune.measured)
    k32 = autotune.cache_key("vq_update f=65", (2, 700, 200), "int32")
    k8 = autotune.cache_key("vq_update f=65", (2, 700, 200), "uint8")
    autotune.record(k32, {"wgs": 2})
    autotune.record(k8, {"wgs": 1})
    assert autotune.tuned_vq_update(700, 200, 65, nb=2) == {"wgs": 2}
    for emit in (torch.uint8, "uint8", "uint4"):
        k = 16 if emit == "uint4" else 200
        if k == 16:
            autotune.record(autotune.cache_key(
                "vq_update f=65", (2, 700, 16), "uint8"), {"wgs": 1})
        assert autotune.tuned_vq_update(700, k, 65, nb=2,
                                        emit_dtype=emit) == {"wgs": 1}
    with pytest.raises(ValueError, match="supports k <= 256"):
        autotune.tuned_vq_update(700, 300, 65, emit_dtype=torch.uint8)
    assert len(autotune.measured) == n0


def test_narrow_vq_update_has_no_knob(tuner_cache):
    assert autotune.tuned_vq_update(42335, 1024, 8, nb=32) is None
    assert autotune.measured == [] and not tuner_cache.exists()


# ---------------------------------------------------------------------------
# precedence, from a pre-seeded cache (nothing is measured here)
# ---------------------------------------------------------------------------

def test_spmm_dispatch_prefers_the_cached_winner(tuner_cache, env):
    n0 = len(autotune.measured)
    key = autotune.cache_key("spmm", (512, 16, 4), torch.float32)
    autotune.record(key, {"variant": "hbm", "bb": 64, "stripe": 256})
    assert tops.spmm_ell_variant(512, 16) == "hbm"     # default: resident
    assert tops.spmm_ell_variant(300, 16) == "hbm"     # the same bucket
    assert autotune.tuned_spmm(500, 16)["stripe"] == 256
    # the dtype keys the entry: int8 sources of itemsize 1 are another key
    key8 = autotune.cache_key("spmm", (512, 16, 1), torch.int8)
    autotune.record(key8, {"variant": "hbm", "bb": 128, "stripe": 512})
    assert tops.spmm_ell_variant(512, 16, 1, torch.int8) == "hbm"
    # a forced variant out-ranks the tuner ...
    tops.configure_spmm_dispatch(variant="resident")
    assert tops.spmm_ell_variant(512, 16) == "resident"
    # ... and so does a configured budget, programmatic or in the env
    tops.configure_spmm_dispatch(variant="auto", l2_budget_mb=64.0)
    assert tops.spmm_ell_variant(512, 16) == "resident"
    tops.configure_spmm_dispatch(reset=True)
    assert tops.spmm_ell_variant(512, 16) == "hbm"
    env.setenv("REPRO_SPMM_L2_BUDGET_MB", "64")
    assert tops.spmm_ell_variant(512, 16) == "resident"
    env.delenv("REPRO_SPMM_L2_BUDGET_MB")
    env.setenv("REPRO_SPMM_VARIANT", "resident")
    assert tops.spmm_ell_variant(512, 16) == "resident"
    assert len(autotune.measured) == n0


def test_context_dispatch_prefers_the_cached_winner(tuner_cache, env):
    n0 = len(autotune.measured)
    for dtype, item in ((torch.int32, 4), (torch.uint8, 1), ("uint4", 0.5)):
        key = autotune.cache_key("context", (4096, 4), dtype)
        autotune.record(key, {"variant": "loop"})
        assert tops.context_ell_variant(4096, 4, item, dtype) == "loop"
        # the itemsize names the same entry when no dtype is given
        assert tops.context_ell_variant(3000, 4, item) == "loop"
    tops.configure_context_dispatch(l2_budget_mb=64.0)
    assert tops.context_ell_variant(4096, 4) == "fused"
    tops.configure_context_dispatch(reset=True)
    env.setenv("REPRO_CONTEXT_L2_BUDGET_MB", "64")
    assert tops.context_ell_variant(4096, 4) == "fused"
    env.delenv("REPRO_CONTEXT_L2_BUDGET_MB")
    env.setenv("REPRO_CONTEXT_VARIANT", "fused")
    assert tops.context_ell_variant(4096, 4) == "fused"
    env.setenv("REPRO_CONTEXT_VARIANT", "auto")
    assert tops.context_ell_variant(4096, 4) == "loop"
    # an entry of another card or build never serves this one
    autotune.clear()
    autotune.record(autotune.cache_key("context", (4096, 4), torch.int32,
                                       device="another card"),
                    {"variant": "loop"})
    hit = autotune.lookup(autotune.cache_key("context", (4096, 4),
                                             torch.int32))
    assert hit is None
    assert len(autotune.measured) == n0


def test_cpu_calls_never_consult_the_tuner(tuner_cache):
    """With tuning on and an empty cache, CPU tensors still take the plain
    versions and nothing is measured or written."""
    n0 = len(autotune.measured)
    ids, vals, ta, _, cw, _ = _loop_case(2, "int32", 20)
    args = (torch.from_numpy(ids), torch.from_numpy(vals), ta,
            torch.from_numpy(cw))
    assert torch.equal(tops.context_ell(*args), tref.context_ell(*args))
    x = torch.randn((2, 40, 65), generator=torch.Generator().manual_seed(0))
    c = torch.randn((2, 9, 65), generator=torch.Generator().manual_seed(1))
    for got, want in zip(tops.vq_assign_update(x, c),
                         tref.vq_assign_update(x, c)):
        assert torch.equal(got, want)
    src = torch.randn((91, 8))
    assert torch.equal(tops.spmm_ell(args[0] % 91, args[1], src),
                       tref.spmm_ell(args[0] % 91, args[1], src))
    assert len(autotune.measured) == n0 and not tuner_cache.exists()


# ---------------------------------------------------------------------------
# hostenv
# ---------------------------------------------------------------------------

def test_hostenv_reads_are_live(env):
    name = "REPRO_TEST_HOSTENV_KNOB"
    env.delenv(name, raising=False)
    assert hostenv.env_knob(name, "d") == "d"
    assert not hostenv.env_knob_set(name)
    env.setenv(name, "1")
    assert hostenv.env_knob(name, "d") == "1" and hostenv.env_knob_set(name)
    env.setenv(name, "2")
    assert hostenv.env_knob(name) == "2"
    env.delenv(name)
    assert hostenv.env_knob(name) is None


def test_hostenv_freezes_during_a_graph_capture(env):
    """While a CUDA graph is captured a read returns the last host-side
    snapshot (the capture is stood in for here: no card)."""
    name = "REPRO_TEST_HOSTENV_KNOB"
    env.setenv(name, "before")
    assert hostenv.env_knob(name) == "before"
    env.setattr(hostenv, "_capturing", lambda: True)
    env.setenv(name, "during")
    assert hostenv.env_knob(name) == "before"
    assert hostenv.env_knob_set(name)
    # a knob first read during a capture is snapshotted there
    env.setenv("REPRO_TEST_HOSTENV_FIRST", "x")
    assert hostenv.env_knob("REPRO_TEST_HOSTENV_FIRST") == "x"
    env.setattr(hostenv, "_capturing", lambda: False)
    assert hostenv.env_knob(name) == "during"
    hostenv.reset_env_snapshot()
    assert hostenv._snapshot == {}
