"""Fixtures of the benchmark's own tests: the repository's root and the
port on the import path, a small copy of the benchmark (the real files
plus small configurations and cells) for runs on the CPU, and the card
check of the tests marked ``gpu``."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SMALL_GRAPH = dict(n_nodes=1200, f_in=16, n_classes=6, deg_cap=12)
SMALL_CELLS = [f"small-{bk}-{tr}" for bk in ("gcn", "gat")
               for tr in ("train", "infer")]


def small_config(backbone: str) -> dict:
    """The cell's configuration at a size the CPU runs in a second."""
    c = json.loads((ROOT / f"bench/configs/{backbone}-arxiv.json")
                   .read_text())
    c["graph"].update(SMALL_GRAPH)
    c["model"]["hidden"] = 16
    c["codebook"]["k"] = 32
    c["name"] = f"small-{backbone}"
    return c


def make_small_root(dest: Path) -> Path:
    """A checkout-like directory: the benchmark's files and small cells
    (``small-<backbone>-<traffic>``), each held to the limits of the real
    cell of its traffic and reporting that cell's metrics."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for bk in ("gcn", "gat"):
        (dest / f"bench/configs/small-{bk}.json").write_text(
            json.dumps(small_config(bk)))
        spec["configs"].append({"name": f"small-{bk}", "source": "tests",
                                "file": f"bench/configs/small-{bk}.json",
                                "reduced": [], "why": "tests"})
    for tr in ("train", "infer"):
        t = json.loads((ROOT / f"bench/traffic/{tr}.json").read_text())
        t["batch"] = 350       # 4 batches, the last 150 real rows
        (dest / f"bench/traffic/small-{tr}.json").write_text(json.dumps(t))
    for name in SMALL_CELLS:
        _, bk, tr = name.split("-")
        real = f"gat-arxiv-{tr}"       # the cell whose metrics it reports
        held = f"{bk}-arxiv-{tr}"       # the limits it is held to
        if not (dest / f"bench/limits/{held}.json").exists():
            held = real
        spec["workloads"].append({"name": name, "config": f"small-{bk}",
                                  "traffic": f"small-{tr}", "chips": 1,
                                  "why": "tests"})
        shutil.copy(dest / f"bench/limits/{held}.json",
                    dest / f"bench/limits/{name}.json")
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    return make_small_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU "
                    "mode and the cells run at full size")
    return torch.device("cuda")
