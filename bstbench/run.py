"""Run one cell of the benchmark:

    python3 bstbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bstbench/``
and the program (``src/repro_torch``).  See ``harness.py``.
"""

import time

T_START = time.perf_counter()  # the run's set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bstbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bstbench" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the checkout's root and the program, not this folder (its module
    # names would shadow the standard library's)
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    from bstbench import harness

    return harness.main(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
