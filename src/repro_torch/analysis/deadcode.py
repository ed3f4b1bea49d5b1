"""Dead-code report: which ``repro_torch`` modules nothing reachable imports.

The counterpart of ``repro.analysis.deadcode``.  A static import graph over
``src/repro_torch``, walked from the port's executable roots: the
``launch`` entry points, this tool's CLI (``repro_torch.analysis.__main__``),
``chip_smoke.py`` at the repo root and the port's examples
(``examples/torch_*.py``).  Modules reachable only through a
package ``__init__`` re-export (a weak edge) or only from ``tests/`` are
``TEST_ONLY``; modules reachable from nothing are ``DEAD``.  Both need an
entry in ``quarantine.txt`` (beside this file) naming why they stay --
delete the module or write the tracking note, the gate accepts nothing in
between.

The walker is deliberately simple (top-level and function-local ``import``
statements; ``importlib.import_module(f"pkg.prefix.{name}")`` as the
wildcard ``pkg.prefix.*``, which keeps the config registry's per-
architecture modules alive); its job is drift detection on this repo's
plain import style, not general Python resolution.  One refinement over
the JAX walker: ``from pkg import name``, where the package re-exports
``name`` from a submodule, is an edge to that submodule, and a package
``__init__`` stays weak even where a root imports it.  So a root that
takes ``BSTEngine`` from ``repro_torch.core`` reaches ``core.engine``, not
every module ``core`` re-exports (the JAX rule would reach all of them).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Set, Tuple

from repro_torch.analysis.report import Violation

PACKAGE = "repro_torch"
ROOT_MODULES = ("repro_torch.launch", "repro_torch.analysis.__main__")
ROOT_FILES = (
    "chip_smoke.py",
    "examples/torch_quickstart.py",
    "examples/torch_serve_bst.py",
    "examples/torch_moe_dispatch.py",
    "examples/torch_train_lm.py",
)
QUARANTINE_FILE = os.path.join(os.path.dirname(__file__), "quarantine.txt")


def _module_name(path: str, src_root: str) -> str:
    rel = os.path.relpath(path, src_root)
    mod = rel[:-3].replace(os.sep, ".")
    return mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


def _imports_of(path: str) -> Set[str]:
    """Every dotted module mentioned in import statements, best effort."""
    with open(path) as f:
        try:
            tree = ast.parse(f.read(), filename=path)
        except SyntaxError:
            return set()
    found: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                found.add(alias.name)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            found.add(node.module)
            # ``from pkg import name`` may bind the submodule pkg.name.
            for alias in node.names:
                found.add(f"{node.module}.{alias.name}")
        elif isinstance(node, ast.Call):
            fn = node.func
            is_import_module = (
                isinstance(fn, ast.Attribute) and fn.attr == "import_module"
            ) or (isinstance(fn, ast.Name) and fn.id == "import_module")
            if is_import_module and node.args:
                arg = node.args[0]
                if (
                    isinstance(arg, ast.JoinedStr)
                    and arg.values
                    and isinstance(arg.values[0], ast.Constant)
                ):
                    found.add(str(arg.values[0].value).rstrip(".") + ".*")
                elif isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    found.add(arg.value)
    return found


def _reexports(files: Dict[str, str]) -> Dict[str, str]:
    """``pkg.name`` -> the module that defines ``name``, for every name a
    package ``__init__`` imports from a submodule at its top level."""
    out: Dict[str, str] = {}
    for mod, path in files.items():
        if not path.endswith("__init__.py"):
            continue
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for alias in node.names:
                    sub = f"{node.module}.{alias.name}"
                    target = sub if sub in files else node.module
                    if target in files and target != mod:
                        out[f"{mod}.{alias.asname or alias.name}"] = target
    return out


def build_graph(
    repo_root: str,
) -> Tuple[Dict[str, str], Dict[str, Set[str]], Dict[str, Set[str]], Dict[str, str]]:
    """(module -> file, module -> deps, module -> strong deps, re-exported
    name -> defining module) over src/repro_torch.  Strong deps are the
    dynamic-import wildcards: real call-path dependencies even when they
    sit in a package ``__init__`` whose plain edges the walker treats as
    weak, and the parent package, which every import of a module runs."""
    src_root = os.path.join(repo_root, "src")
    files: Dict[str, str] = {}
    for dirpath, _dirnames, filenames in os.walk(os.path.join(src_root, PACKAGE)):
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                files[_module_name(path, src_root)] = path
    reexported = _reexports(files)
    edges: Dict[str, Set[str]] = {}
    strong: Dict[str, Set[str]] = {}
    for mod, path in files.items():
        raw = _imports_of(path)
        deps = _resolve(raw, files, reexported)
        strong[mod] = _resolve({n for n in raw if n.endswith(".*")}, files, reexported)
        # importing any submodule imports its parent packages first: a real
        # dependency, strong even out of a package ``__init__``
        parent = mod.rsplit(".", 1)[0]
        if parent in files:
            deps.add(parent)
            strong[mod].add(parent)
        edges[mod] = deps - {mod}
    return files, edges, strong, reexported


def _resolve(names: Set[str], files: Dict[str, str], reexported: Dict[str, str]) -> Set[str]:
    """Map raw import names to known modules: a package's re-exported name
    to the module that defines it, else the longest known prefix
    (pkg.sub.attr -> pkg.sub); ``pkg.prefix.*`` wildcards fan out to every
    module under the prefix; stdlib/third-party names drop out."""
    deps: Set[str] = set()
    for name in names:
        if name in reexported:
            deps.add(reexported[name])
            continue
        if name.endswith(".*"):
            prefix = name[:-1]  # keep the trailing dot
            deps.update(m for m in files if m.startswith(prefix))
            continue
        parts = name.split(".")
        for cut in range(len(parts), 0, -1):
            cand = ".".join(parts[:cut])
            if cand in files:
                deps.add(cand)
                break
    return deps


def _file_imports(paths: Iterable[str], files: Dict[str, str], reexported: Dict[str, str]) -> Set[str]:
    """Port modules imported by the given loose .py files."""
    found: Set[str] = set()
    for p in paths:
        if os.path.isfile(p):
            found |= _resolve(_imports_of(p), files, reexported)
    return found


def _dir_files(d: str) -> List[str]:
    if not os.path.isdir(d):
        return []
    return [os.path.join(d, fn) for fn in sorted(os.listdir(d)) if fn.endswith(".py")]


def _reach(
    seeds: Set[str],
    edges: Dict[str, Set[str]],
    weak: Set[str],
    strong: Dict[str, Set[str]],
) -> Set[str]:
    """Transitive closure.  Out of weak (package ``__init__``) nodes only
    the strong (dynamic-import) edges are followed, a root's own import
    of the package included: a module reachable only because a package
    re-exports it is not pulled in by real call-path imports, but a
    registry that ``import_module``s its submodules genuinely loads
    them."""
    seen: Set[str] = set()
    todo = list(seeds)
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        if mod in weak:
            todo.extend(strong.get(mod, ()))
            continue
        todo.extend(edges.get(mod, ()))
    return seen


def load_quarantine(path: str = QUARANTINE_FILE) -> Dict[str, str]:
    """``<module> <reason...>`` lines; '#' comments and blanks skipped."""
    entries: Dict[str, str] = {}
    if not os.path.exists(path):
        return entries
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            mod, _, reason = line.partition(" ")
            entries[mod] = reason.strip()
    return entries


def dead_modules(repo_root: str) -> Dict[str, str]:
    """module -> classification ('DEAD' | 'TEST_ONLY') for unreachable code.

    Roots: the ``launch`` entry points, this tool's CLI, and what the
    root files (``chip_smoke.py``, the port's examples) import.
    """
    files, edges, strong, reexported = build_graph(repo_root)
    weak = {m for m, p in files.items() if p.endswith("__init__.py")}
    seeds = {m for m in files if m.startswith(ROOT_MODULES)}
    seeds |= _file_imports((os.path.join(repo_root, f) for f in ROOT_FILES), files, reexported)
    reachable = _reach(seeds, edges, weak, strong)
    test_seeds = _file_imports(_dir_files(os.path.join(repo_root, "tests")), files, reexported)
    test_reach = _reach(test_seeds | seeds, edges, set(), strong)
    out: Dict[str, str] = {}
    for mod in sorted(files):
        if mod in reachable:
            continue
        out[mod] = "TEST_ONLY" if mod in test_reach else "DEAD"
    return out


def report_dead(repo_root: str) -> Tuple[List[Violation], Dict[str, str]]:
    """Gate form: unreachable modules missing a quarantine entry are
    violations; returns (violations, full classification map)."""
    quarantine = load_quarantine()
    classes = dead_modules(repo_root)
    errors: List[Violation] = []
    for mod, kind in classes.items():
        if mod in quarantine:
            continue
        errors.append(
            Violation(
                "DEAD001",
                "src/" + mod.replace(".", "/") + ".py",
                0,
                f"{kind}: no executable root imports this module -- delete "
                "it or add a tracked entry to analysis/quarantine.txt",
            )
        )
    for mod in quarantine:
        if mod not in classes:
            errors.append(
                Violation(
                    "DEAD002",
                    "src/repro_torch/analysis/quarantine.txt",
                    0,
                    f"stale quarantine entry {mod!r}: the module is now "
                    "reachable (or gone) -- remove the entry",
                )
            )
    return errors, classes
