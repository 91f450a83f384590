"""One run of one benchmark cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as one JSON line, last on standard output, and
the numbers the correctness check compared, last on standard error.
Needs as many CUDA devices as the cell asks for; without them it exits
with code 3 and prints no result.  The program's kernel library is built
under ``build/`` of this checkout on the first run and reused after.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    # caches at fixed paths inside the checkout; the run follows the
    # configuration files, not REPRO_* settings of the environment
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(ROOT / "build" / "torch")
    os.environ["USE_FLAX"] = "0"
    for key in [k for k in os.environ if k.startswith("REPRO_")]:
        del os.environ[key]
    sys.path.insert(0, str(ROOT))
    from bench import harness
    sys.exit(harness.main(sys.argv[1:], ROOT, T0))
