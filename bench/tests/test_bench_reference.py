"""The reference against the program on the CPU at a small size: the
first three training steps (losses, gradients, parameters, VQ state and
tables) and a whole-graph inductive pass, from the same raw inputs."""
import pytest
import torch

from conftest import small_config

from bench import graphgen, inputs, port
from bench import shapes as shp
from bench.reference import steps as rsteps
from bench.reference import vq as rvq
from bench.reference.precision import Precision

SEED = 2**31 + 7
BATCH = 300


def _setup(backbone):
    cfg = small_config(backbone)
    sh = shp.layers(cfg)
    raw = graphgen.generate(cfg["graph"], SEED)
    prog = port.build(cfg, raw, "cpu")
    params, states = inputs.model_state(cfg, sh, raw.n, SEED, "cpu")
    prob = rsteps.problem(raw, cfg["graph"]["deg_cap"], "cpu")
    rst = [rvq.VQState(s["codewords_w"], s["cluster_size"],
                       s["cluster_sum"], s["mean"], s["var"],
                       s["table"].long()) for s in states]
    return cfg, sh, raw, prog, params, states, prob, rst


@pytest.mark.parametrize("backbone", ["gcn", "gat"])
def test_train_steps_match_program(backbone):
    cfg, sh, raw, prog, params, states, prob, rst = _setup(backbone)
    vq = port.vq_states(states, cfg["codebook"]["k"])
    ost = prog.opt.init(params)
    perm = torch.randperm(raw.n, generator=inputs.generator(SEED, "t", "cpu"))
    ids, smask = inputs.epoch_ids(perm, BATCH)
    p, nu = params, [{k: torch.zeros_like(v) for k, v in d.items()}
                     for d in params]
    pp = params
    for s in range(3):
        pp, vq, ost, loss, _ = port.train_epoch(prog, pp, vq, ost,
                                                ids[s:s + 1], smask[s:s + 1])
        p, nu, rst, rloss, _, _ = rsteps.train_step(cfg, sh, p, nu, rst, prob,
                                                 ids[s], smask[s],
                                                 Precision())
        torch.testing.assert_close(loss[0], rloss, rtol=1e-6, atol=0)
        for a, b in zip(ost.nu, nu):
            for k in a:
                torch.testing.assert_close(a[k], b[k], rtol=1e-5,
                                           atol=1e-12)
    # RMSprop divides by sqrt(nu): an element whose gradient is near zero
    # carries round-off up to ~lr x 1e-3, against steps of ~lr x 10
    for a, b in zip(pp, p):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-5)
    for a, b in zip(vq, rst):
        assert torch.equal(a.assignment.long(), b.table)
        torch.testing.assert_close(a.codebook.codewords_w, b.codewords_w,
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(a.codebook.var, b.var)


@pytest.mark.parametrize("backbone", ["gcn", "gat"])
def test_infer_pass_matches_program(backbone):
    cfg, sh, raw, prog, params, states, prob, rst = _setup(backbone)
    vq = port.vq_states(states, cfg["codebook"]["k"])
    perm = torch.randperm(raw.n, generator=inputs.generator(SEED, "p", "cpu"))
    out, got = port.infer_pass(prog, params, vq,
                               *inputs.epoch_ids(perm, BATCH))
    rout, rtabs, _ = rsteps.infer_pass(cfg, sh, params, rst, prob, perm,
                                       BATCH, Precision())
    torch.testing.assert_close(out, rout, rtol=1e-5, atol=1e-6)
    for a, b in zip(got, rtabs):
        assert torch.equal(a.assignment.long(), b)
    # judged on its own choices: nearest codewords, the same outputs
    fout, _, gap = rsteps.infer_pass(cfg, sh, params, rst, prob, perm,
                                     BATCH, Precision(),
                                     [a.assignment for a in got])
    assert gap == 0.0
    torch.testing.assert_close(out, fout, rtol=1e-5, atol=1e-6)


def test_tf32_rounding():
    from bench.reference.precision import round_tf32
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0 - 2**-12])
    got = round_tf32(x)
    # ties to even at the 10-bit mantissa; below half rounds down
    assert got.tolist() == [1.0, 1.0, 1.0 + 2**-9, -3.0]
