"""The reference's environment variables that the PyTorch port does not
honour yet: a value that would change what the reference runs raises a
``ValueError`` naming the ROADMAP item that brings it, where the reference
reads the variable; the default values pass.  CPU only."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.codebook import CodebookConfig             # noqa: E402
from repro_torch.graph.datasets import synthetic_arxiv          # noqa: E402
from repro_torch.kernels import ops                              # noqa: E402
from repro_torch.kernels import ref                              # noqa: E402
from repro_torch.models.gnn import GNNConfig                     # noqa: E402
from repro_torch.train import gnn_trainer                        # noqa: E402

VARS = ("REPRO_EPOCH_EXECUTOR", "REPRO_INFER_EXECUTOR",
        "REPRO_CONTEXT_VARIANT", "REPRO_CONTEXT_VMEM_BUDGET_MB",
        "REPRO_AUTOTUNE", "REPRO_AUTOTUNE_CACHE")


@pytest.fixture
def env(monkeypatch):
    for var in VARS:
        monkeypatch.delenv(var, raising=False)
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
    g = _graph()
    env.setenv("REPRO_EPOCH_EXECUTOR", "0")
    with pytest.raises(ValueError, match=r"REPRO_EPOCH_EXECUTOR=0.*item 2"):
        gnn_trainer.train_vq(g, _cfg(g), epochs=1, batch_size=50,
                             device="cpu")
    env.setenv("REPRO_EPOCH_EXECUTOR", "1")
    out = gnn_trainer.train_vq(g, _cfg(g), epochs=1, batch_size=50,
                               device="cpu")
    assert np.isfinite(out["step_losses"]).all()


def test_infer_executor_off_raises_in_vq_inference(env):
    g = _graph()
    cfg = _cfg(g)
    out = gnn_trainer.train_vq(g, cfg, epochs=1, batch_size=50, device="cpu")
    env.setenv("REPRO_INFER_EXECUTOR", "0")
    with pytest.raises(ValueError, match=r"REPRO_INFER_EXECUTOR=0.*item 3"):
        gnn_trainer.vq_inference(out["params"], out["vq_states"], g, cfg, 50)
    env.setenv("REPRO_INFER_EXECUTOR", "1")
    acts = gnn_trainer.vq_inference(out["params"], out["vq_states"], g, cfg,
                                    50)
    assert acts.shape == (g.n, 40)


def test_context_variant_loop_raises_in_context_ell(env):
    args = _context_args()
    want = ref.context_ell(*args)
    for ok in ("auto", "fused"):
        env.setenv("REPRO_CONTEXT_VARIANT", ok)
        assert torch.equal(ops.context_ell(*args), want)
    env.setenv("REPRO_CONTEXT_VARIANT", "loop")
    with pytest.raises(ValueError, match=r"CONTEXT_VARIANT=loop.*item 4"):
        ops.context_ell(*args)
    env.setenv("REPRO_CONTEXT_VARIANT", "nope")
    with pytest.raises(ValueError, match="want auto, fused or loop"):
        ops.context_ell(*args)


def test_context_vmem_budget_raises_in_context_ell(env):
    env.setenv("REPRO_CONTEXT_VMEM_BUDGET_MB", "4")
    with pytest.raises(ValueError, match=r"CONTEXT_VMEM_BUDGET_MB.*item 4"):
        ops.context_ell(*_context_args())


@pytest.mark.parametrize("var,value", [("REPRO_AUTOTUNE", "1"),
                                       ("REPRO_AUTOTUNE_CACHE", "at.json")])
def test_autotune_raises_where_the_reference_tunes(env, var, value):
    """The reference's tuners sit behind the SpMM variant, the context
    variant and the fused update; each of the three refuses."""
    env.setenv("REPRO_AUTOTUNE", "0")
    assert ops.spmm_ell_variant(64, 8) == "resident"
    env.setenv(var, value)
    x = torch.zeros((1, 4, 3))
    for call in (lambda: ops.spmm_ell_variant(64, 8),
                 lambda: ops.context_ell(*_context_args()),
                 lambda: ops.vq_assign_update(x, torch.zeros((1, 2, 3)))):
        with pytest.raises(ValueError, match=rf"{var}.*item 4"):
            call()
