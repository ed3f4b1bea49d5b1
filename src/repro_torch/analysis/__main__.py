"""CLI: ``python -m repro_torch.analysis [paths...] [flags]``.

The default run is the static passes (lint, dead code) and the contracts;
``--serve-gate`` adds the serve gate: a real ``BSTServer`` drain per
strategy on the single-chip server and on the sharded server at world 1,
so it costs seconds, not milliseconds.  ``--report-dead`` prints the full
reachability classification instead of just gating it.  ``--report FILE``
writes the static-report/v1 JSON document.  ``--device`` (default
``cuda``) is where the contracts and the gate run; the CPU runs only when
``--device cpu`` is given, and ``cuda`` without a card is an error.  For
the sharded gate and the sharded contracts the CLI makes a world-1 process
group itself (gloo on the CPU, NCCL on the card, a ``file://`` store in a
temporary directory) where none exists, and destroys it at the end.

Exit code: 0 iff every selected pass is clean; otherwise the full
violation inventory prints and the process exits 1 (never first failure:
one run shows everything).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import torch

from repro_torch.analysis import deadcode, lint, report

DEFAULT_PATHS = (
    "src/repro_torch/core",
    "src/repro_torch/kernels",
    "src/repro_torch/serving",
    "src/repro_torch/launch",
    "src/repro_torch/checkpoint",
    "src/repro_torch/training",
    "src/repro_torch/graphs.py",
)


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="hot-path lint, contracts, dead code and the serve gate of the PyTorch port",
    )
    ap.add_argument(
        "paths", nargs="*", help=f"files/dirs to lint (default: {' '.join(DEFAULT_PATHS)})"
    )
    ap.add_argument(
        "--repo-root", default=os.getcwd(), help="repo root for the dead-code graph (default: cwd)"
    )
    ap.add_argument(
        "--allowlist",
        default=lint.DEFAULT_ALLOWLIST,
        help="lint allowlist file (default: analysis/allowlist.txt)",
    )
    ap.add_argument(
        "--skip-contracts", action="store_true", help="lint/dead-code only (no device, sub-second)"
    )
    ap.add_argument(
        "--report-dead", action="store_true", help="print the full module reachability classification"
    )
    ap.add_argument(
        "--serve-gate",
        action="store_true",
        help="also run the serve gate (real BSTServer drains on hrz/dup/hyb, "
        "single-chip and sharded at world 1)",
    )
    ap.add_argument("--report", metavar="FILE", help="write the static-report/v1 JSON document")
    ap.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="where the contracts and the gate run (default: cuda)",
    )
    args = ap.parse_args(argv)
    needs_device = args.serve_gate or not args.skip_contracts
    if needs_device and args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda needs a CUDA card; pass --device cpu to run on the CPU")

    hard: List[report.Violation] = []
    passes: List[str] = []

    lint_paths = args.paths or [os.path.join(args.repo_root, p) for p in DEFAULT_PATHS]
    lint_hard, lint_soft = lint.lint_paths(lint_paths, args.allowlist)
    hard.extend(lint_hard)
    passes.append(f"lint ({len(lint_soft)} allowlisted)")

    dead_hard, classes = deadcode.report_dead(args.repo_root)
    hard.extend(dead_hard)
    passes.append(f"deadcode ({len(classes)} quarantined/unreachable)")
    if args.report_dead:
        quarantine = deadcode.load_quarantine()
        for mod, kind in sorted(classes.items()):
            note = quarantine.get(mod, "<NO QUARANTINE ENTRY>")
            print(f"dead-code {kind}: {mod} -- {note}")
        if not classes:
            print("dead-code: every module reachable from an executable root")

    if needs_device:
        from repro_torch.analysis import gate

        with gate.world1_group(args.device):
            if not args.skip_contracts:
                from repro_torch.analysis import contracts

                hard.extend(contracts.run_contracts(args.device))
                passes.append(f"contracts ({args.device})")
            if args.serve_gate:
                hard.extend(gate.run_serve_gates(device=args.device))
                passes.append(f"serve-gate (hrz/dup/hyb, single-chip and sharded, {args.device})")

    if args.report:
        report.write_json(args.report, report.to_doc(hard, lint_soft, extra={"passes": passes}))
        print(f"wrote {args.report}")

    try:
        report.gate_violations(hard, "static checks OK: " + ", ".join(passes))
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
