"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix.  A configuration's ``file`` (under
``bstbench/configs/``) names its driver by ``kind``; a traffic mix is
``bstbench/traffic/<traffic>.json``; a per-layer metric ``<name>`` is read
by ``bstbench/metrics/<name>.py``.  Adding any of them is adding files and
entries: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    benchmark: dict

    @property
    def end_to_end(self) -> List[dict]:
        return [m for m in self.benchmark["end_to_end"] if _applies(m, self.name)]

    @property
    def per_layer(self) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end}
        return [m for m in self.benchmark["per_layer"]
                if _applies(m, self.name) and m["moves"] in reported]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _one(entries: List[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in BENCHMARK.json")
    return found[0]


def cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = load_benchmark(root)
    wl = _one(bench["workloads"], name, "workload")
    cfg = _one(bench["configs"], wl["config"], "config")
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(root / BENCH_DIR.name / "traffic" / f"{wl['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, wl, config, traffic, bench)


def driver(kind: str) -> ModuleType:
    """``bstbench/drivers/<kind>.py``."""
    return importlib.import_module(f"{BENCH_DIR.name}.drivers.{kind}")


def metric_reader(name: str) -> ModuleType:
    """``bstbench/metrics/<name>.py`` (names hold dots, so it is loaded by
    path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{BENCH_DIR.name}.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
