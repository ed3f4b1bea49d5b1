"""Run the PyTorch port's README.md commands, so its docs cannot drift.

The port's commands sit in README.md's fenced ```sh blocks: the JAX
package's smoke (``scripts/readme_smoke.py``) reads only the ```bash blocks,
and the machine that runs it has no torch.  Every line of an ``sh`` block
that starts with ``PYTHONPATH=src`` is a command; a trailing ``\\`` joins the
next line to it.  Each command is one of:

* ``cpu``: it carries ``--device cpu``, or is one of the dry runs
  (``NO_CARD``: traced under ``FakeTensorMode`` on the CPU, they never
  take the card), and runs by default;
* ``pytest``: a test suite, which runs as its own step, never here;
* ``card``: it takes the card, and runs with ``--card``;
* ``cards``: ``torchrun --nproc-per-node N`` with N > 1, listed and never
  run (one machine here holds one card).

The commands run in the README's order from the repo root, each must exit
0, and each one's return code and seconds are printed.  A ``--ckpt-dir``
under ``build/`` is emptied before the first command, so a ``--resume``
continues where the README says it does.

    python scripts/torch_readme_smoke.py [--card] [README.md]
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import List, NamedTuple

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 1200
NO_CARD = re.compile(r"-m repro_torch\.launch\.(dryrun|dryrun_bst|perf)(\s|$)")


class Command(NamedTuple):
    line: str  # continuation lines joined
    kind: str  # "cpu", "pytest", "card" or "cards"
    cards: int


def sh_blocks(text: str) -> List[str]:
    return re.findall(r"```sh\n(.*?)```", text, flags=re.DOTALL)


def commands(readme: Path) -> List[Command]:
    """Every ``PYTHONPATH=src`` command of the README's ``sh`` blocks, in
    order, its continuation lines joined, with its kind and the cards it
    takes."""
    out = []
    for block in sh_blocks(readme.read_text()):
        lines = [ln.strip() for ln in block.splitlines()]
        while lines:
            line = lines.pop(0)
            while line.endswith("\\") and lines:
                line = f"{line[:-1].rstrip()} {lines.pop(0)}"
            if not line.startswith("PYTHONPATH=src"):
                continue
            procs = re.search(r"torchrun\s+--nproc-per-node\s+(\d+)", line)
            cards = int(procs.group(1)) if procs else 1
            if "pytest" in line:
                kind = "pytest"
            elif "--device cpu" in line or NO_CARD.search(line):
                kind, cards = "cpu", 0
            else:
                kind = "card" if cards == 1 else "cards"
            out.append(Command(line, kind, cards))
    return out


def ckpt_dirs(cmds: List[Command]) -> List[Path]:
    """The ``--ckpt-dir`` paths under ``build/`` that the commands name."""
    dirs = {m for c in cmds for m in re.findall(r"--ckpt-dir\s+(\S+)", c.line)}
    return [ROOT / d for d in sorted(dirs) if Path(d).parts[:1] == ("build",)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("readme", nargs="?", default=str(ROOT / "README.md"))
    ap.add_argument("--card", action="store_true", help="also run the commands that take one card")
    args = ap.parse_args()
    cmds = commands(Path(args.readme))
    if not any(c.kind == "cpu" for c in cmds):
        print(f"ERROR: no PYTHONPATH=src ... --device cpu command in an sh block of {args.readme}")
        return 1
    run_kinds = ("cpu", "card") if args.card else ("cpu",)
    for d in ckpt_dirs(cmds):
        shutil.rmtree(d, ignore_errors=True)
    results = []
    for c in cmds:
        if c.kind not in run_kinds:
            why = {"pytest": "a test suite: skipped", "card": "needs the card: not run",
                   "cards": f"needs {c.cards} cards: not run"}[c.kind]
            print(f"--- {c.line}\n--- {why}", flush=True)
            continue
        print(f"--- {c.line}", flush=True)
        t0 = time.perf_counter()
        try:
            rc = subprocess.run(c.line, shell=True, cwd=ROOT, timeout=TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            rc = 124
        seconds = time.perf_counter() - t0
        results.append((c, rc, seconds))
        print(f"--- rc={rc} ({seconds:.1f} s)", flush=True)
    failed = [r for r in results if r[1] != 0]
    print(f"\n{len(results)} command(s) run, {len(failed)} failed; "
          f"{len(cmds) - len(results)} not run")
    for c, rc, seconds in results:
        print(f"  rc={rc} {seconds:8.1f} s  [{c.kind}] {c.line}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
