"""README.md's commands, split between the two packages' README smokes.

CI's ``scripts/readme_smoke.py`` runs the ``PYTHONPATH=src python`` lines of
the README's ``bash`` blocks on a machine without torch: it must find the
JAX package's commands and none of the port's.  The port's commands sit in
``sh`` blocks, which ``scripts/torch_readme_smoke.py`` reads: every one
whole (continuation lines joined), each with its kind.  No command runs
here; the two scripts run them.
"""

import importlib.util
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
README = ROOT / "README.md"
JAX_COMMANDS = (
    "examples/quickstart.py",
    "-m repro.analysis",
    "examples/serve_bst.py",
    "-m repro.launch.serve --bst",
)
PORT = re.compile(r"repro_torch|examples/torch_|tests/test_torch_")


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_jax_smoke_reads_the_jax_commands_alone():
    cmds = _script("readme_smoke").runnable_commands(README)
    assert not [c for c in cmds if PORT.search(c)]
    assert len(cmds) == len(JAX_COMMANDS)
    for want, got in zip(JAX_COMMANDS, cmds):
        assert f"PYTHONPATH=src python {want}" in got


def test_the_port_smoke_reads_every_port_command_whole():
    smoke = _script("torch_readme_smoke")
    cmds = smoke.commands(README)
    runs = [c for c in cmds if c.kind != "pytest"]
    assert all(PORT.search(c.line) for c in cmds)
    assert len(runs) >= 21  # the 20 of the port's python lines and the torchrun line
    assert {c.kind for c in cmds} == {"cpu", "pytest", "card", "cards"}
    for c in cmds:
        assert not c.line.endswith("\\") and "\\" not in c.line, c.line
        if "--device cpu" in c.line and "pytest" not in c.line:
            assert c.kind == "cpu" and c.cards == 0, c.line
    ckpt = [c for c in cmds if "--ckpt-dir" in c.line]
    assert len(ckpt) == 2 and all("--steps" in c.line and c.kind == "cpu" for c in ckpt)
    assert smoke.ckpt_dirs(cmds) == [ROOT / "build" / "ckpt"]
    torchrun = [c for c in cmds if "torchrun" in c.line]
    assert [(c.kind, c.cards) for c in torchrun] == [("cards", 4)]
    assert any("--batch 4096" in c.line and c.kind == "card" for c in cmds)
