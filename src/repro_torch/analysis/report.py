"""Violation records and the one exit-code and report helper every pass
shares: a copy of the JAX package's ``repro.analysis.report``, which the
port may not import.

``python -m repro_torch.analysis`` finishes through ``gate()``: collect
failures into a list, print what passed, and exit non-zero with the full
failure inventory -- never fail on the first finding, so one run shows
every violation.  ``write_json`` emits the machine-readable report.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding from any pass (lint / contracts / deadcode / gate)."""

    rule: str  # e.g. "ANA002"
    path: str  # repo-relative file path ("-" for non-file findings)
    line: int  # 1-based; 0 for whole-file/whole-run findings
    msg: str

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.rule}: {self.msg}"


def render_all(violations: Sequence[Violation]) -> str:
    return "\n".join(v.render() for v in violations)


def to_doc(
    violations: Sequence[Violation],
    allowlisted: Sequence[Violation] = (),
    extra: Optional[Dict] = None,
) -> Dict:
    """The static-report/v1 artifact document."""
    doc = {
        "schema": "static-report/v1",
        "violations": [dataclasses.asdict(v) for v in violations],
        "allowlisted": [dataclasses.asdict(v) for v in allowlisted],
    }
    if extra:
        doc.update(extra)
    return doc


def write_json(path: str, doc: Dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def gate(failures: Sequence[str], ok_msg: str) -> None:
    """The shared exit-code contract: print + return on success, raise
    ``SystemExit`` with the whole failure inventory otherwise."""
    if failures:
        lines = "\n".join(f"  {f}" for f in failures)
        raise SystemExit(f"{len(failures)} gate failure(s):\n{lines}")
    print(ok_msg)


def gate_violations(violations: Sequence[Violation], ok_msg: str) -> None:
    gate([v.render() for v in violations], ok_msg)
