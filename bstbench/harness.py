"""The command line of one run: ``run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

It finds the cell by name (``spec.py``), refuses to run without the cards
the cell asks for, hands the run to the configuration's driver, and prints
the result as the last line of standard output: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, each
from its own reader in ``metrics/``.  Every number compared with the
reference goes beside its limit to the last lines of standard error and,
last, into the result line under ``checks``.  A run in whose process JAX,
its libraries or the JAX package (``repro``) was loaded prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

from bstbench import spec

# Top-level module names a run may not load, compared whole: ``repro_torch``
# (the port) begins with ``repro`` (the JAX package) and is no match.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Optional[List[str]] = None) -> List[str]:
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell: spec.Cell, outcome, trace: bool) -> dict:
    """The result object (``checks`` last)."""
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(outcome.context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = outcome.end_to_end.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(outcome.device)
    out = {"correct": outcome.correct, "attempted": outcome.attempted, "failed": outcome.failed,
           "metrics": metrics, "device": device}
    summary = outcome.context.get("trace")
    if trace and summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
        # the profiler slows the host: the traced segment's pace beside the window's
        out["rounds_per_s"] = {"window": outcome.context["rounds_per_s"],
                               "traced_segment": summary["rounds_per_s"]}
    out["checks"] = outcome.checks
    return out


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    chips = int(cell.workload["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {chips} CUDA card(s); this process sees {found}", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    print(f"process start to the card's context: {time.perf_counter() - t_start!r} s",
          file=sys.stderr, flush=True)

    def device_info() -> dict:
        torch.cuda.synchronize()
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in range(chips))}

    outcome = spec.driver(cell.config["kind"]).run(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device="cuda",
        t_start=t_start, device_info=device_info, sync=torch.cuda.synchronize,
    )
    line = result_line(cell, outcome, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"this process loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    summary = outcome.context.get("trace")
    if args.trace:
        print("trace: " + ("no window" if summary is None else
                           f"{summary['attempts']} attempt(s), complete {summary['complete']}, "
                           f"{summary['marked_kernels']} of {summary['kernel_runs']} kernels, "
                           f"{summary['orphans']} launches without device events, "
                           f"{summary['rounds_per_s']!r} rounds/s traced against "
                           f"{outcome.context['rounds_per_s']!r} in the window"),
              file=sys.stderr)
    for name, c in outcome.checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
