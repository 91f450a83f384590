"""Shared fixtures and helpers of the training slice's parity tests
(``tests/test_torch_train.py`` and ``tests/test_torch_train_loops.py``):
the small configs (``synthetic_arxiv(n=600)``, hidden 32, 2 layers, k 32),
each backbone's reference state and its port twin on the CPU, and the
comparisons of states and params.  Not a test module: both test files
import it (``graphs`` and ``world`` are module-scoped fixtures)."""
import numpy as np
import pytest
from numpy.testing import assert_allclose

import jax

from repro.core.codebook import CodebookConfig as JCodebookConfig
from repro.graph import batching as jb
from repro.graph.datasets import synthetic_arxiv as j_arxiv
from repro.models import gnn as jgnn
from repro_torch import convert
from repro_torch.core.codebook import CodebookConfig
from repro_torch.graph import batching as tb
from repro_torch.graph.datasets import synthetic_arxiv as t_arxiv
from repro_torch.models import gnn as tgnn

STEP = dict(rtol=1e-4, atol=1e-5)
ONE = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu"
N, HIDDEN, K = 600, 32, 32


def _cfgs(backbone):
    kw = dict(backbone=backbone, f_in=128, hidden=HIDDEN, n_out=40,
              n_layers=2)
    return (jgnn.GNNConfig(codebook=JCodebookConfig(k=K, f_prod=4), **kw),
            tgnn.GNNConfig(codebook=CodebookConfig(k=K, f_prod=4), **kw))


def _np_tree(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _cb(state):
    """CodebookState -> list of numpy fields (either package)."""
    return [np.asarray(f) for f in state]


@pytest.fixture(scope="module")
def graphs():
    return j_arxiv(n=N, seed=0), t_arxiv(n=N, seed=0)


class _World:
    """One backbone's reference state and its port twin, on the CPU."""

    def __init__(self, jg, tg, backbone):
        self.jcfg, self.tcfg = _cfgs(backbone)
        self.jg, self.tg = jg, tg
        self.jops = jb.full_operands(jg)
        self.jplan = jb.build_epoch_plan(jg, full_ops=self.jops)
        self.tops = tb.full_operands(tg, device=CPU)
        self.tplan = tb.build_epoch_plan(tg, full_ops=self.tops, device=CPU)
        self.jparams = jgnn.init_gnn(jax.random.PRNGKey(0), self.jcfg)
        self.jvq = jgnn.init_vq_states(jax.random.PRNGKey(1), self.jcfg,
                                       jg.n)
        self.tparams = convert.params_from_numpy(_np_tree(self.jparams), CPU)
        self.tvq = convert.vq_states_from_numpy(self.jvq, CPU)
        mask = np.zeros(jg.n, np.float32)
        mask[jg.train_idx] = 1.0
        self.train_mask = mask


@pytest.fixture(scope="module", params=["gcn", "sage", "gin"])
def world(request, graphs):
    return _World(*graphs, request.param)


def _assert_states_close(tst, jst, tol):
    for a, b in zip(tst, jst):
        assert np.array_equal(a.assignment.numpy(), np.asarray(b.assignment))
        assert np.array_equal(a.counts.numpy(), np.asarray(b.counts))
        for fa, fb in zip(_cb(a.codebook), _cb(b.codebook)):
            assert_allclose(fa, fb, **tol)


def _assert_params_close(tp, jp, tol):
    for a, b in zip(tp, jp):
        assert a.keys() == b.keys()
        for name in a:
            assert_allclose(a[name].numpy(), np.asarray(b[name]), **tol)
