"""The reference's environment variables in the PyTorch port.  The two
executor switches are honoured: ``REPRO_EPOCH_EXECUTOR=0`` and
``REPRO_INFER_EXECUTOR=0`` run the host-stepped training loop and the
eager inference loop, which must give what the executors give.  So are the
context variant (``REPRO_CONTEXT_VARIANT``), its budget (under the port's
name, ``REPRO_CONTEXT_L2_BUDGET_MB``; the reference's VMEM name raises,
naming it) and the tuner (``REPRO_AUTOTUNE=1``, ``REPRO_AUTOTUNE_CACHE``):
they steer the card, so on the CPU every call, and ``train_vq`` under
each of them, is the plain version's.  CPU only."""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

from repro_torch.core.codebook import CodebookConfig             # noqa: E402
from repro_torch.kernels import autotune                         # noqa: E402
from repro_torch.graph.datasets import synthetic_arxiv          # noqa: E402
from repro_torch.kernels import ops                              # noqa: E402
from repro_torch.kernels import ref                              # noqa: E402
from repro_torch.models.gnn import GNNConfig                     # noqa: E402
from repro_torch.train import gnn_trainer                        # noqa: E402

STEP = dict(rtol=1e-4, atol=1e-5)
SERVE = dict(rtol=1e-5, atol=1e-6)
VARS = ("REPRO_EPOCH_EXECUTOR", "REPRO_INFER_EXECUTOR",
        "REPRO_CONTEXT_VARIANT", "REPRO_CONTEXT_VMEM_BUDGET_MB",
        "REPRO_CONTEXT_L2_BUDGET_MB", "REPRO_AUTOTUNE",
        "REPRO_AUTOTUNE_CACHE")


@pytest.fixture
def env(monkeypatch):
    for var in VARS:
        monkeypatch.delenv(var, raising=False)
    ops.configure_context_dispatch(reset=True)
    return monkeypatch


def _graph():
    return synthetic_arxiv(n=200, seed=0)


def _cfg(g):
    return GNNConfig(f_in=g.f, hidden=8, n_out=40, n_layers=2,
                     codebook=CodebookConfig(k=8, f_prod=4))


def _context_args():
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 10, (6, 3)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))
    a = torch.from_numpy(rng.integers(0, 4, (2, 10)).astype(np.int32))
    cw = torch.from_numpy(rng.normal(size=(2, 4, 5)).astype(np.float32))
    return ids, vals, a, cw


def test_epoch_executor_off_raises_in_train_vq(env):
    """``REPRO_EPOCH_EXECUTOR=0`` steps the executor's batches from the
    host, each packed there: the same losses, VQ errors, params and
    states (a tail-padded epoch of 4 batches, twice)."""
    g = _graph()
    out = {}
    for value in ("0", "1"):
        env.setenv("REPRO_EPOCH_EXECUTOR", value)
        out[value] = gnn_trainer.train_vq(g, _cfg(g), epochs=2,
                                          batch_size=60, device="cpu")
    host, epoch = out["0"], out["1"]
    assert len(host["pack_s"]) == 2 and "pack_s" not in epoch
    assert host["step_losses"].shape == (8,)
    assert_allclose(host["step_losses"], epoch["step_losses"], **STEP)
    assert_allclose(host["step_vq_errs"], epoch["step_vq_errs"], **STEP)
    for a, b in zip(host["params"], epoch["params"]):
        for k in a:
            assert_allclose(a[k].numpy(), b[k].numpy(), **STEP)
    for a, b in zip(host["vq_states"], epoch["vq_states"]):
        assert torch.equal(a.assignment, b.assignment)
        assert torch.equal(a.counts, b.counts)
    for key in ("val", "test", "vq_err"):
        assert_allclose(host["final"][key], epoch["final"][key], **STEP)


def test_infer_executor_off_raises_in_vq_inference(env):
    """``REPRO_INFER_EXECUTOR=0`` runs the eager per-batch loop over the
    executor's wrap-padded batches: the same rows, plain and inductive."""
    g = _graph()
    cfg = _cfg(g)
    out = gnn_trainer.train_vq(g, cfg, epochs=1, batch_size=50, device="cpu")
    for inductive in (False, True):
        acts = {}
        for value in ("0", "1"):
            env.setenv("REPRO_INFER_EXECUTOR", value)
            acts[value] = gnn_trainer.vq_inference(
                out["params"], out["vq_states"], g, cfg, 60,
                inductive=inductive)
        assert acts["0"].shape == (g.n, 40)
        assert_allclose(acts["0"], acts["1"], **SERVE)


@pytest.mark.parametrize("variant", ["auto", "fused", "loop"])
def test_context_variant_honoured_in_context_ell(env, variant):
    """Every variant is accepted and steers the card's dispatch; a CPU call
    stays the plain version's; an unknown name raises."""
    args = _context_args()
    env.setenv("REPRO_CONTEXT_VARIANT", variant)
    assert torch.equal(ops.context_ell(*args), ref.context_ell(*args))
    assert ops.context_ell_variant(10, 2) == \
        ("fused" if variant == "auto" else variant)
    env.setenv("REPRO_CONTEXT_VARIANT", "nope")
    with pytest.raises(ValueError, match="want auto, fused or loop"):
        ops.context_ell_variant(10, 2)


def test_context_l2_budget_honoured_and_vmem_budget_named(env):
    env.setenv("REPRO_CONTEXT_L2_BUDGET_MB", "0.0001")
    assert ops.context_ell_variant(100, 2) == "loop"     # 800 B > 105 B
    env.setenv("REPRO_CONTEXT_L2_BUDGET_MB", "1")
    assert ops.context_ell_variant(100, 2) == "fused"
    env.setenv("REPRO_CONTEXT_VMEM_BUDGET_MB", "4")
    with pytest.raises(ValueError, match="REPRO_CONTEXT_L2_BUDGET_MB"):
        ops.context_ell_variant(100, 2)


@pytest.mark.parametrize("var,value", [("REPRO_AUTOTUNE", "1"),
                                       ("REPRO_AUTOTUNE_CACHE", "at.json")])
def test_autotune_variables_honoured(env, tmp_path, var, value):
    """``REPRO_AUTOTUNE=1`` turns the tuner on, ``REPRO_AUTOTUNE_CACHE``
    moves its file; an entry there steers the dispatch.  The CPU calls of
    the three tuned kernels stay the plain versions' and measure
    nothing."""
    path = tmp_path / "at.json"
    env.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    env.setenv("REPRO_AUTOTUNE", "1")
    env.setenv(var, value if var == "REPRO_AUTOTUNE" else str(path))
    autotune.clear(memory_only=True)
    try:
        assert autotune.enabled() and autotune.cache_path() == str(path)
        autotune.record(autotune.cache_key("spmm", (64, 8, 4),
                                           torch.float32),
                        {"variant": "hbm", "bb": 128, "stripe": 512})
        assert ops.spmm_ell_variant(64, 8) == "hbm"
        assert path.exists()
        n0 = len(autotune.measured)
        x = torch.randn((1, 4, 3))
        c = torch.randn((1, 2, 3))
        for got, want in zip(ops.vq_assign_update(x, c),
                             ref.vq_assign_update(x, c)):
            assert torch.equal(got, want)
        args = _context_args()
        assert torch.equal(ops.context_ell(*args), ref.context_ell(*args))
        assert len(autotune.measured) == n0
        env.setenv("REPRO_AUTOTUNE", "0")
        assert ops.spmm_ell_variant(64, 8) == "resident"
    finally:
        autotune.clear(memory_only=True)


@pytest.mark.parametrize("var,value", [("REPRO_CONTEXT_VARIANT", "loop"),
                                       ("REPRO_AUTOTUNE", "1")])
def test_train_vq_under_the_dispatch_variables(env, tmp_path, var, value):
    """``train_vq`` with the loop variant or the tuner on: on the CPU the
    same losses as without (every kernel call is the plain version's)."""
    g = _graph()
    env.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    base = gnn_trainer.train_vq(g, _cfg(g), epochs=1, batch_size=60,
                                device="cpu")
    env.setenv(var, value)
    got = gnn_trainer.train_vq(g, _cfg(g), epochs=1, batch_size=60,
                               device="cpu")
    assert np.array_equal(got["step_losses"], base["step_losses"])
    assert not (tmp_path / "at.json").exists()
