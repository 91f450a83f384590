"""The harness on the CPU at a small size: names lead to files, a new
configuration, traffic mix and metric are found as new files, the result
line's keys, and the refusals (unknown cell, no card)."""
import contextlib
import io
import json
import shutil
import time

import pytest

from conftest import make_small_root

from bench import harness


def run_main(root, *args, device="cpu"):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(list(args), root, time.perf_counter(),
                          device=device)
    return rc, out.getvalue(), err.getvalue()


def last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture
def dummy_root(tmp_path):
    """A checkout with a dummy configuration, traffic mix and per-layer
    metric added as new files and named only in BENCHMARK.json."""
    root = make_small_root(tmp_path)
    b = root / "bench"
    cfg = json.loads((b / "configs/small-gcn.json").read_text())
    cfg["name"] = "dummy"
    cfg["codebook"]["k"] = 16
    (b / "configs/dummy.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic/small-train.json").read_text())
    traffic["batch"] = 400
    (b / "traffic/dummy-mix.json").write_text(json.dumps(traffic))
    (b / "metrics/dummy_metric.train.py").write_text(
        "def read(r):\n    return 42.0 + r.work['steps_per_iteration']\n")
    shutil.copy(b / "limits/gat-arxiv-train.json",
                b / "limits/dummy-cell.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy", "source": "tests",
                            "file": "bench/configs/dummy.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy",
                              "traffic": "dummy-mix", "chips": 1,
                              "why": "tests"})
    for m in spec["end_to_end"]:
        if "train_nodes_per_s" == m["name"]:
            m["workloads"].append("dummy-cell")
    spec["per_layer"].append({
        "name": "dummy_metric.train", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "tests",
        "moves": "train_nodes_per_s", "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_new_files_found_by_name(dummy_root):
    rc, out, err = run_main(dummy_root, "--workload", "dummy-cell",
                            "--seed", str(2**31 + 3), "--seconds", "0.3",
                            "--trace", "1")
    assert rc == 0, err
    res = last_json(out)
    # 1200 nodes in batches of 400: 3 steps an epoch
    assert res["metrics"]["dummy_metric.train"] == {"value": 45.0,
                                                    "unit": "ms"}
    assert res["correct"] is True


@pytest.mark.parametrize("traced", [0, 1])
def test_result_line_keys(small_root, traced):
    rc, out, err = run_main(small_root, "--workload", "small-gcn-train",
                            "--seed", "12345678901", "--seconds", "0.3",
                            "--trace", str(traced))
    assert rc == 0, err
    res = last_json(out)
    want = ["correct", "attempted", "failed", "metrics", "device"] \
        + (["breakdown"] if traced else []) + ["checks"]
    assert list(res) == want
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(res["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert len(res["breakdown"]["device_ops"]) <= 10
    else:
        assert set(res["metrics"]) == {"setup_s", "train_nodes_per_s",
                                       "peak_device_gb"}
    # the compared numbers, beside their limits, close standard error
    lines = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in lines)


def test_split_metrics_share_a_reader(small_root):
    """``<metric>.py`` where it exists, else the reader its split shares,
    ``<metric before the first dot>.py``."""
    spec = harness.Spec(small_root)
    a, b = spec.reader("step_mfu.train"), spec.reader("step_mfu.infer")
    assert a.__file__ == b.__file__
    assert a.__file__.endswith("bench/metrics/step_mfu.py")
    assert spec.reader("host_ms_per_step.train").__file__.endswith(
        "bench/metrics/host_ms_per_step.train.py")
    with pytest.raises(harness.BenchError, match="nope.py"):
        spec.reader("nope.train")


def test_unknown_workload(small_root):
    rc, out, err = run_main(small_root, "--workload", "nope", "--seed", "1",
                            "--seconds", "1")
    assert rc == 2 and out == ""
    assert "unknown workload 'nope'" in err and "gat-arxiv-train" in err


def test_no_card_no_result(small_root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, out, err = run_main(small_root, "--workload", "small-gcn-train",
                            "--seed", "1", "--seconds", "1", device=None)
    assert rc == 3 and out == "" and "CUDA" in err
