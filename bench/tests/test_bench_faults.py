"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have (a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced, the tail batch's padding left out of the tables; one chip, so
no exchange to leave out), and the control, the
reference in TF32 in the program's place, fails the limits a sound run
keeps.  On the CPU at a small size, against the real cells' limits; the
harness's look for a card is skipped."""
import time

import pytest
import torch

from bench import harness, port
from bench.harness import Spec

SEED = 2**31 + 29
CELLS = ["small-gcn-train", "small-gat-train", "small-gcn-infer",
         "small-gat-infer"]


def run(root, cell):
    res, _ = harness.run_cell(Spec(root), cell, SEED, 0.3, False,
                              torch.device("cpu"), time.perf_counter())
    return res


def unchanged_train(real):
    def f(prog, params, states, opt_state, ids, slot_mask):
        _, _, _, losses, errs = real(prog, params, states, opt_state, ids,
                                     slot_mask)
        return params, states, opt_state, losses, errs
    return f


def half_batch_train(real):
    def f(prog, params, states, opt_state, ids, slot_mask):
        half = torch.arange(slot_mask.shape[1]) < slot_mask.shape[1] // 2
        return real(prog, params, states, opt_state, ids, slot_mask * half)
    return f


def padding_unwritten_train(real):
    """The tail batch's padding (slot mask 0) trains, but its codeword
    choices never reach the tables: its nodes keep their earlier entries."""
    def f(prog, params, states, opt_state, ids, slot_mask):
        if bool((slot_mask[-1] > 0).all()):
            return real(prog, params, states, opt_state, ids, slot_mask)
        params, states, opt_state, l1, e1 = real(
            prog, params, states, opt_state, ids[:-1], slot_mask[:-1])
        pad = ids[-1][slot_mask[-1] == 0].long()
        before = [s.assignment[:, pad].clone() for s in states]
        params, states, opt_state, l2, e2 = real(
            prog, params, states, opt_state, ids[-1:], slot_mask[-1:])
        for s, old in zip(states, before):
            s.assignment[:, pad] = old
        return (params, states, opt_state, torch.cat([l1, l2]),
                torch.cat([e1, e2]))
    return f


def altered_train(real):
    """The answer a call produces altered: the first layer's weight
    update doubled.  (A weight altered by 1 % lies inside what two sound
    runs part by after RMSprop's sign-like first step.)"""
    def f(prog, params, *a):
        before = params[0]["w"]
        new, *rest = real(prog, params, *a)
        new = [dict(p) for p in new]
        new[0]["w"] = 2 * new[0]["w"] - before
        return (new, *rest)
    return f


def unchanged_infer(real):
    def f(prog, params, states, ids, slot_mask):
        out, _ = real(prog, params, states, ids, slot_mask)
        return out, states
    return f


def half_batch_infer(real):
    def f(prog, params, states, ids, slot_mask):
        out, st = real(prog, params, states, ids, slot_mask)
        out = out.clone()
        out[ids[0][: ids.shape[1] // 2].long()] = 0.0
        return out, st
    return f


def altered_infer(real):
    def f(*a):
        out, st = real(*a)
        out = out.clone()
        out[0] = out[0] * 2.0
        return out, st
    return f


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_root, cell):
    res = run(small_root, cell)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("cell", ["small-gcn-train", "small-gat-train"])
@pytest.mark.parametrize("fault", [unchanged_train, half_batch_train,
                                   altered_train, padding_unwritten_train])
def test_training_fault_is_caught(small_root, monkeypatch, cell, fault):
    monkeypatch.setattr(port, "train_epoch", fault(port.train_epoch))
    res = run(small_root, cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["small-gcn-infer", "small-gat-infer"])
@pytest.mark.parametrize("fault", [unchanged_infer, half_batch_infer,
                                   altered_infer])
def test_inference_fault_is_caught(small_root, monkeypatch, cell, fault):
    monkeypatch.setattr(port, "infer_pass", fault(port.infer_pass))
    res = run(small_root, cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(small_root, cell):
    """The control in the program's place fails at least one limit of the
    real cell; the program's own readings keep them all."""
    spec = Spec(small_root)
    w = spec.workload(cell)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    driver = spec.driver(traffic["driver"])
    from bench import shapes
    ctx = harness.Context(cell, cfg, traffic, SEED, torch.device("cpu"),
                          shapes.layers(cfg))
    state = driver.setup(ctx)
    driver.window(ctx, state, 0.3)
    got = driver.calibrate(ctx, state)
    limits = spec.limits(cell)
    assert all(v <= limits[k] for k, v in got["program"].items())
    assert any(v > limits[k] for k, v in got["control"].items()), got
