"""On the card, at each cell's own size: the control (the reference in
TF32 in the program's place) fails at least one of the cell's limits on
three seeds while the program keeps them all, and a planted fault fails
them too.  Skips without a card; run on the chip with

    python -m pytest -q -m gpu bench/tests/test_bench_card.py
"""
import pytest
import torch

from conftest import ROOT

from bench import harness, shapes

CELLS = [w["name"] for w in harness.Spec(ROOT).data["workloads"]]
SEEDS = (2**31 + 101, 7, 90210)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_at_cell_size(cuda, cell):
    spec = harness.Spec(ROOT)
    w = spec.workload(cell)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    driver = spec.driver(traffic["driver"])
    limits = spec.limits(cell)
    for seed in SEEDS:
        ctx = harness.Context(cell, cfg, traffic, seed, cuda,
                              shapes.layers(cfg))
        state = driver.setup(ctx)
        driver.window(ctx, state, 1.0)
        got = driver.calibrate(ctx, state)
        del state
        torch.cuda.empty_cache()
        cases = {k: v for k, v in got.items()
                 if k not in ("details", "check_s")}
        assert all(v <= limits[k] for k, v in cases["program"].items()), \
            cases
        for case, readings in cases.items():
            if case != "program":
                assert any(v > limits[k] for k, v in readings.items()), \
                    (case, cases)
