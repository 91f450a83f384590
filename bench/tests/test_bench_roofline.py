"""The operation and byte counts against the bounds of the kernel table
in PERF.md (the same shapes, the same arithmetic), and the counts of a
batch against a direct count."""
import json

import numpy as np
import pytest
import torch

from conftest import ROOT

from bench import graphgen, roofline, shapes, work
from bench.reference import graph as rgraph
from bench.reference import steps


def ms(w, rate=roofline.PRODUCT_FLOPS):
    return w.least_s(rate) * 1e3


def test_vq_update_bounds():
    w = roofline.vq_update(32, 42335, 8, 1024)
    assert round(ms(w, roofline.FP32_FLOPS), 4) == 0.3313
    assert round(ms(w), 4) == 0.1345
    assert round(ms(roofline.vq_update(8, 42335, 21, 1024),
                    roofline.FP32_FLOPS), 4) == 0.2174


def test_vq_assign_bounds():
    w = roofline.vq_assign(32, 169343, 4, 1024)
    assert round(ms(w, roofline.FP32_FLOPS), 4) == 0.6626
    assert round(ms(w), 4) == 0.2690


def test_spmm_ell_full_graph_bound():
    n = 169343
    assert round(ms(roofline.spmm_ell(n, 18, 128, n, 0)), 5) == 0.05904


def test_spmm_ell_training_batch_bound():
    """The kernel table's training batch: graph seed 0, the first 42,335
    of numpy's permutation for seed 5, the in-batch term's distinct
    source positions."""
    cfg = json.loads((ROOT / "bench/configs/gcn-arxiv.json").read_text())
    raw = graphgen.generate(cfg["graph"], 0)
    t = rgraph.tables(raw.src, raw.dst, raw.n, 18, "cpu")
    ids = torch.from_numpy(np.random.default_rng(5).permutation(raw.n)
                           [:42335])
    c = work.batch_counts(t, ids)
    assert round(ms(roofline.spmm_ell(c.b, c.deg, 128, c.rows, c.e_in)),
                 5) == 0.01335


def test_message_kernel_bounds():
    """The kernel table's training-batch rows: ``spmm_ell_t`` 0.01476 ms
    (bytes) and ``context_ell``'s ``w_t`` form 0.02362 ms (operations at
    the fp32 rate, every one of the b x D slots summed: live = b D)."""
    b, deg = 42335, 18
    assert round(ms(roofline.spmm_ell_t(b, deg, 128, b, 63936)), 5) \
        == 0.01476
    w = roofline.context_ell_wt(b, deg, 32, 4, 128, 99750, 32 * 1024,
                                b * deg)
    assert round(ms(w, roofline.FP32_FLOPS), 5) == 0.02362


def test_batch_counts_direct():
    raw = graphgen.RawGraph(
        5, np.array([0, 1, 2, 3, 3, 4]), np.array([1, 2, 1, 1, 0, 3]),
        np.zeros((5, 2), np.float32), np.zeros(5, np.int64),
        np.arange(5), np.zeros(0, np.int64), np.zeros(0, np.int64))
    t = rgraph.tables(raw.src, raw.dst, 5, 2, "cpu")
    # node 1's in-neighbours 0, 2, 3: the cap keeps 0 and 2
    assert t.in_ids[1].tolist() == [0, 2] and t.degrees[1] == 3
    c = work.batch_counts(t, torch.tensor([1, 2]))
    # in: 1 <- 0 (out), 1 <- 2 (in), 2 <- 1 (in); out-edges: 1 -> 2 (in),
    # 2 -> 1 (in)
    assert (c.e_in, c.e_out, c.e_rev, c.nodes_out) == (2, 1, 0, 1)


@pytest.mark.parametrize("name,want", [
    ("gcn-arxiv", [(32, 4, 4), (32, 4, 4), (8, 16, 5)]),
    ("gat-arxiv", [(4, 32, 33), (4, 32, 33), (4, 32, 11)])])
def test_branch_layouts(name, want):
    cfg = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
    assert [(s.nb, s.fb, s.gb) for s in shapes.layers(cfg)] == want


def test_layer_flops_by_backbone():
    """Each backbone counts its FLOPs beside its reference, found by
    name; a training layer after the first counts the input gradient and
    (GCN, Eq. 7 on) the injection."""
    c = work.BatchCounts(b=10, deg=4, e_in=3, e_out=4, e_rev=5, rows=9,
                         nodes_out=4, nodes_rev=5)
    sh = shapes.LayerShape(f_in=8, f_out=6, nb=2, fb=4, gb=3)
    gcn = steps.backbone("gcn")
    cfg = {"model": {"grad_inject": True}}
    assert gcn.layer_flops(c, sh, cfg, train=False, first=True) == \
        2 * 10 * 8 * 6 + 2 * (3 + 4 + 10) * 8
    assert gcn.layer_flops(c, sh, cfg, train=True, first=False) == \
        1232 + 960 + 960 + 2 * 13 * 8 + 2 * 5 * 2 * 3 + 2 * 10 * 2 * 3 * 8
    gat = steps.backbone("gat")
    gemm, rest = 2 * 14 * 8 * 6, 2 * 6 * 24 + 2 * 17 * 6
    assert gat.layer_flops(c, sh, cfg, train=True, first=True) == \
        2 * gemm + 3 * rest


def test_unknown_backbone_is_refused():
    with pytest.raises(ValueError, match="bench/reference/sage.py"):
        steps.backbone("sage")
