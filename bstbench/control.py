"""The control of the comparison that decides ``correct``: the reference
put in the program's place and made to break the configuration's stated
guarantee (``reference/sorted_index.py``'s ``StaleIndex``: a write becomes
visible only once the configuration's high water of writes has been
buffered, as if reads skipped the delta buffer).  It runs a cell's own
traffic, at the cell's own size, through the same closed loop and the same
comparison, and must come out not correct on every seed:

    python3 bstbench/control.py --workload <cell> --seeds 1,2,3 --seconds 20

One JSON line a seed: the numbers compared and ``correct``.  The
benchmark's own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def high_water(config: dict) -> int:
    """The write path's compaction trigger as the configuration states it:
    ``delta_high_water``, by default three quarters of the capacity."""
    e = config["engine"]
    return int(e["delta_high_water"] or 3 * int(e["delta_capacity"]) // 4)


def run_control(cell, seed: int, seconds: float, t_start: float, max_rounds=None):
    from bstbench import kvloop
    from bstbench.reference.sorted_index import StaleIndex

    import torch

    def make(config, keys, values, device):
        return StaleIndex(keys, values, high_water(config))

    # the requests are drawn where the program's runs draw them, so that a
    # seed sends the control the same requests as the program
    device = "cuda" if torch.cuda.is_available() else "cpu"
    return kvloop.run(make, cell.config, cell.traffic, seed % (1 << 63), seconds, False, device,
                      t_start, lambda: {"memory_peak_bytes": 0}, lambda: None, max_rounds)


def main() -> int:
    sys.path[0:1] = [str(ROOT)]
    from bstbench import spec

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args()
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_control(cell, seed, args.seconds, time.perf_counter())
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": out.correct,
                          "attempted": out.attempted, "failed": out.failed,
                          "read_lanes_compared": out.context["read_lanes_compared"],
                          "checks": out.checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
