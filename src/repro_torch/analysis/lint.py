"""AST lint: the PyTorch footguns that cost the port's serving path.

The counterpart of ``repro.analysis.lint``, tuned to the port's hot path
(``core/``, ``kernels/``, ``serving/``, ``launch/`` and ``graphs.py``).
Analysis is per function and deliberately shallow -- one module, no
dataflow across calls -- because every rule is a pattern gate: cheap,
deterministic and explainable in one line.  The runtime gate
(``analysis.gate``) covers what patterns cannot: a real steady-state drain
must capture nothing and move nothing unplanned.

A value is a *tensor* here when it comes from a ``torch.*`` call (but not
the host-side ones: ``torch.from_numpy``, ``torch.device``,
``torch.cuda.*``, ``torch.distributed.*``, ...), from a device API of the
port (``DEVICE_APIS``), from a method, index or arithmetic on a tensor,
from an unannotated same-module function applied to a tensor, or from a
parameter or a same-module function annotated ``torch.Tensor``;
metadata (``.shape``, ``.numel()``, ``.dtype``, ``.device``, ...) is host
data.

Rules (the JAX ids where the rule translates):
  ANA001 tensor-control-flow -- ``if``/``while``/``assert``/``bool()`` on
         a tensor: on the card an implicit sync (a copy of the flag to the
         host and a wait for the device).
  ANA002 host-op-in-graph    -- ``.item()``/``.tolist()``/``.cpu()``/
         ``.numpy()``/``np.asarray``/``np.array``/``print`` inside a step
         the engine captures as a CUDA graph (a function passed to
         ``_run`` or ``graphs.Graph``, a lambda given to ``Graph``, and the
         same-module functions such a step calls): a capture fails on the
         sync, or freezes a host value into every replay.
  ANA003 has no counterpart: the JAX rule checks Pallas kernel bodies,
         which are Python; the port's kernels are CUDA sources.
  ANA004 capture-hazard      -- ``graphs.Graph(``, ``torch.cuda.CUDAGraph(``
         or ``torch.cuda.graph(`` inside a loop body (a capture per
         iteration), and mutable default arguments on a graphed step.
  ANA005 implicit-host-pull  -- ``int()``/``float()``/``.item()``/
         ``.tolist()``/``.numpy()`` on a tensor, and ``.cpu()`` anywhere
         (only tensors have it): an implicit device -> host sync on the
         hot path.  The sanctioned spelling is
         ``analysis.runtime.device_fetch``, which ANA006 budgets.
  ANA006 explicit-sync-budget -- every ``device_fetch``, ``device_put``,
         ``block_until_ready``, ``torch.cuda.synchronize`` and
         ``<event>.synchronize()`` under ``core/``, ``kernels/`` or
         ``serving/`` needs an allowlist line that names its budget: the
         planned sync points are part of the design and anything else is a
         new stall.

The allowlist (``analysis/allowlist.txt``) has ``<path-glob> <rule|*>
<reason>`` lines, as the JAX package's.
"""

from __future__ import annotations

import ast
import fnmatch
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.report import Violation

# The port's own entry points whose results live on the device: taint
# sources for ANA001/ANA005, since one module cannot see across imports.
# Extend this set when a new device-returning entry point joins the path.
DEVICE_APIS: Set[str] = {
    "forest_descend",
    "hybrid_descend",
    "forest_descend_delta",
    "hybrid_descend_delta",
    "bst_search_forest",
    "bst_ordered_forest",
    "bst_hybrid_forest",
    "bst_search",
    "bst_delta_resolve",
    "queue_dispatch",
    "flash_attention",
    "query",
    "query_static",
    "_query_chunk",
    "_squery",
    "_ingest",
}

# torch calls that return host objects, not tensors on a device.
HOST_TORCH_CALLS = {
    "from_numpy", "device", "Size", "finfo", "iinfo", "is_tensor", "no_grad",
    "inference_mode", "manual_seed", "Generator", "get_default_dtype",
    "is_floating_point", "dtype", "set_grad_enabled",
}
HOST_TORCH_PREFIXES = (
    "torch.cuda.", "torch.distributed.", "torch.backends.", "torch.utils.",
    "torch.testing.", "torch.multiprocessing.", "torch.profiler.", "torch.version.",
)
# Tensor metadata: attributes and methods whose value is host data.
METADATA_ATTRS = {
    "shape", "dtype", "device", "ndim", "is_cuda", "is_cpu", "is_meta", "nbytes", "itemsize",
    "layout", "requires_grad",
}
METADATA_METHODS = {
    "numel", "size", "dim", "stride", "data_ptr", "element_size", "is_contiguous",
    "get_device", "storage_offset", "is_pinned", "is_floating_point",
}
# Tensor methods whose value is a host object: host ops inside a graphed
# step (ANA002), and host data after (their pulls are flagged on their own).
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
HOST_PULL_METHODS = {"item", "tolist", "numpy"}
HOST_PULL_FUNCS = {"int", "float"}
GRAPH_CTORS = {"graphs.Graph", "Graph", "torch.cuda.CUDAGraph", "torch.cuda.graph"}
SYNC_CALLS = {"device_fetch", "device_put", "block_until_ready", "synchronize"}
EXPLICIT_SYNC_DIRS = ("/core/", "/kernels/", "/serving/")


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for Attribute chains, 'f' for Names."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _mentions_tensor(annotation: Optional[ast.AST]) -> bool:
    """An annotation that names ``torch.Tensor`` (alone, in a tuple, an
    Optional, ...)."""
    if annotation is None:
        return False
    if isinstance(annotation, ast.Constant) and isinstance(annotation.value, str):
        return "Tensor" in annotation.value
    return any(
        isinstance(n, ast.Attribute) and n.attr == "Tensor"
        or isinstance(n, ast.Name) and n.id == "Tensor"
        for n in ast.walk(annotation)
    )


class Linter:
    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.violations: List[Violation] = []
        self.aliases = self._collect_aliases()
        # names of functions captured as CUDA graph steps anywhere in the
        # module, and lambdas given to a graph constructor
        self.graphed_names: Set[str] = set()
        self.graphed_lambdas: Set[int] = set()
        self._collect_graphed()
        # same-module functions without a return annotation, and those
        # annotated to return tensors (any other annotation is host data)
        defs = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        self.module_fns: Set[str] = {n.name for n in defs if n.returns is None}
        self.tensor_fns: Set[str] = {n.name for n in defs if _mentions_tensor(n.returns)}

    # ------------------------------------------------------------ discovery
    def _collect_aliases(self) -> Dict[str, str]:
        """Local name -> dotted module for ``import x.y as z`` and
        ``from x import y (as z)``."""
        out: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        out[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    def _resolve(self, node: ast.AST) -> str:
        """The dotted name of a call target, its first part de-aliased."""
        d = _dotted(node) or ""
        head, _, rest = d.partition(".")
        if head in self.aliases:
            return self.aliases[head] + ("." + rest if rest else "")
        return d

    def _is_graph_ctor(self, call: ast.Call) -> bool:
        d, r = _dotted(call.func) or "", self._resolve(call.func)
        return d in GRAPH_CTORS or r in GRAPH_CTORS or r.endswith(".graphs.Graph")

    def _collect_graphed(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func) or ""
            if d.rsplit(".", 1)[-1] == "_run" and len(node.args) > 1:
                self._mark(node.args[1])
            elif self._is_graph_ctor(node) and node.args:
                self._mark(node.args[0])
        # same-module helpers a graphed step calls are graphed too
        defs = {
            n.name: n for n in ast.walk(self.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        bodies = [defs[n] for n in self.graphed_names if n in defs]
        bodies += [n for n in ast.walk(self.tree) if id(n) in self.graphed_lambdas]
        while bodies:
            fn = bodies.pop()
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    leaf = (_dotted(node.func) or "").rsplit(".", 1)[-1]
                    if leaf in defs and leaf not in self.graphed_names:
                        self.graphed_names.add(leaf)
                        bodies.append(defs[leaf])

    def _mark(self, expr: ast.AST) -> None:
        if isinstance(expr, ast.Lambda):
            self.graphed_lambdas.add(id(expr))
            return
        d = _dotted(expr)
        if d:
            self.graphed_names.add(d.rsplit(".", 1)[-1])
        elif isinstance(expr, ast.Call):
            dd = _dotted(expr.func)
            if dd in ("functools.partial", "partial") and expr.args:
                self._mark(expr.args[0])

    def _graphed(self, fn: ast.AST, parent_graphed: bool) -> bool:
        """Whether ``fn`` runs inside a captured step (a nested def or
        lambda inherits its parent's)."""
        return (
            parent_graphed
            or getattr(fn, "name", None) in self.graphed_names
            or id(fn) in self.graphed_lambdas
        )

    # ------------------------------------------------------------------ run
    def run(self) -> List[Violation]:
        self._walk_body(self.tree.body, graphed=False)
        return self.violations

    def _walk_body(self, body: Sequence[ast.stmt], graphed: bool):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = self._graphed(stmt, graphed)
                self._check_function(stmt, inner)
                self._walk_body(stmt.body, inner)
            elif isinstance(stmt, ast.ClassDef):
                self._walk_body(stmt.body, graphed)
            else:
                # module-level statements: still subject to the loop rule
                for node in ast.walk(stmt):
                    if isinstance(node, (ast.For, ast.While)):
                        self._check_graph_in_loop(node)

    def _add(self, rule: str, node: ast.AST, msg: str) -> None:
        self.violations.append(Violation(rule, self.path, getattr(node, "lineno", 0), msg))

    # ------------------------------------------------------ per-function pass
    def _check_function(self, fn: ast.AST, graphed: bool) -> None:
        args = fn.args
        tainted: Set[str] = {
            a.arg for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]
            if _mentions_tensor(a.annotation)
        }
        self._check_defaults(fn, graphed)
        for node in self._own_nodes(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                self._track_taint(node, tainted)
            if isinstance(node, (ast.If, ast.While)):
                self._check_tensor_test(node.test, tainted, "if/while")
            if isinstance(node, ast.Assert):
                self._check_tensor_test(node.test, tainted, "assert")
            if isinstance(node, (ast.For, ast.While)):
                self._check_graph_in_loop(node)
            if isinstance(node, ast.Lambda):
                # a lambda's body runs as its own step (a graph's, where
                # it is given to one); check its calls in that context
                lam_graphed = self._graphed(node, graphed)
                for sub in ast.walk(node.body):
                    if isinstance(sub, ast.Call):
                        self._check_call(sub, lam_graphed, tainted)
            elif isinstance(node, ast.Call):
                self._check_call(node, graphed, tainted)

    def _own_nodes(self, fn: ast.AST):
        """Walk the function body but stop at nested function boundaries
        (nested defs get their own pass with inherited context; a lambda is
        yielded but not entered)."""
        stack = list(fn.body)
        while stack:
            node = stack.pop(0)
            yield node
            if isinstance(node, ast.Lambda):
                continue
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    stack.append(child)

    # ------------------------------------------------------------ taint model
    def _is_torch_call(self, call: ast.Call) -> bool:
        r = self._resolve(call.func)
        if not r.startswith("torch."):
            return False
        if r.startswith(HOST_TORCH_PREFIXES):
            return False
        return r.rsplit(".", 1)[-1] not in HOST_TORCH_CALLS

    def _is_device_expr(self, expr: ast.AST, tainted: Set[str]) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if isinstance(expr, ast.Call):
            if self._is_torch_call(expr):
                return True
            fn = expr.func
            if isinstance(fn, ast.Attribute):
                if fn.attr in METADATA_METHODS or fn.attr in HOST_METHODS:
                    return False
                if fn.attr in DEVICE_APIS:
                    return True
                return self._is_device_expr(fn.value, tainted)
            if not isinstance(fn, ast.Name):
                return False
            if fn.id in DEVICE_APIS or fn.id in self.tensor_fns:
                return True
            # a same-module helper applied to tensors returns tensors
            return fn.id in self.module_fns and any(
                self._is_device_expr(a, tainted) for a in [*expr.args, *(k.value for k in expr.keywords)]
            )
        if isinstance(expr, ast.Attribute):
            if expr.attr in METADATA_ATTRS:
                return False
            return self._is_device_expr(expr.value, tainted)
        if isinstance(expr, ast.Subscript):
            return self._is_device_expr(expr.value, tainted) or self._is_device_expr(
                expr.slice, tainted
            )
        if isinstance(expr, ast.Starred):
            return self._is_device_expr(expr.value, tainted)
        if isinstance(expr, ast.BinOp):
            return self._is_device_expr(expr.left, tainted) or self._is_device_expr(
                expr.right, tainted
            )
        if isinstance(expr, ast.UnaryOp):
            return self._is_device_expr(expr.operand, tainted)
        if isinstance(expr, ast.BoolOp):
            return any(self._is_device_expr(v, tainted) for v in expr.values)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in expr.ops):
                return False  # identity and membership are host operations
            return any(
                self._is_device_expr(v, tainted) for v in [expr.left, *expr.comparators]
            )
        if isinstance(expr, ast.IfExp):
            return self._is_device_expr(expr.body, tainted) or self._is_device_expr(
                expr.orelse, tainted
            )
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self._is_device_expr(e, tainted) for e in expr.elts)
        return False

    def _track_taint(self, node: ast.stmt, tainted: Set[str]) -> None:
        value = node.value
        if value is None:
            return
        is_dev = self._is_device_expr(value, tainted)
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for tgt in targets:
            names = []
            if isinstance(tgt, ast.Name):
                names = [tgt.id]
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                names = [e.id for e in tgt.elts if isinstance(e, ast.Name)]
            for n in names:
                if is_dev:
                    tainted.add(n)
                else:
                    tainted.discard(n)  # rebound to a host value

    # -------------------------------------------------------------- the rules
    def _check_tensor_test(self, test: ast.AST, tainted: Set[str], where: str) -> None:
        if self._is_device_expr(test, tainted):
            self._add(
                "ANA001",
                test,
                f"{where} condition on a tensor -- on the card an implicit "
                "sync per evaluation; keep the choice on the device "
                "(torch.where) or fetch explicitly first",
            )

    def _check_graph_in_loop(self, loop: ast.stmt) -> None:
        for node in ast.walk(loop):
            if node is loop or isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Call) and self._is_graph_ctor(node):
                self._add(
                    "ANA004",
                    node,
                    "CUDA graph constructed inside a loop body: a capture "
                    "per iteration -- capture once and replay",
                )

    def _check_defaults(self, fn: ast.AST, graphed: bool) -> None:
        args = getattr(fn, "args", None)
        if args is None or not graphed:
            return
        for d in list(args.defaults) + [d for d in args.kw_defaults if d is not None]:
            if isinstance(d, (ast.Dict, ast.List, ast.Set)):
                self._add(
                    "ANA004",
                    d,
                    f"mutable default argument on graphed step "
                    f"{getattr(fn, 'name', '<lambda>')!r}: a graph replays "
                    "the object its capture saw, whatever later calls pass",
                )

    def _check_call(self, call: ast.Call, graphed: bool, tainted: Set[str]) -> None:
        d = _dotted(call.func) or ""
        r = self._resolve(call.func)
        leaf = d.rsplit(".", 1)[-1]
        method = call.func.attr if isinstance(call.func, ast.Attribute) else None

        # --- host ops inside a graphed step
        if graphed:
            if r in ("numpy.asarray", "numpy.array") or d in ("np.asarray", "np.array"):
                self._add(
                    "ANA002",
                    call,
                    f"{d}() inside a graphed step: a host value frozen into "
                    "every replay (or a sync that breaks the capture)",
                )
            elif d == "print":
                self._add(
                    "ANA002",
                    call,
                    "print() inside a graphed step runs at capture only",
                )
            elif method in HOST_METHODS:
                self._add(
                    "ANA002",
                    call,
                    f".{method}() inside a graphed step: a device -> host "
                    "sync, which a capture cannot hold",
                )

        # --- bool() on a tensor: control flow in disguise
        if d == "bool" and len(call.args) == 1 and self._is_device_expr(call.args[0], tainted):
            self._add(
                "ANA001",
                call,
                "bool() of a tensor -- on the card an implicit sync",
            )

        # --- implicit host pulls
        pulled: Optional[ast.AST] = None
        if d in HOST_PULL_FUNCS and len(call.args) == 1:
            pulled = call.args[0]
        elif method in HOST_PULL_METHODS:
            pulled = call.func.value
        if method == "cpu" or (pulled is not None and self._is_device_expr(pulled, tainted)):
            self._add(
                "ANA005",
                call,
                "implicit device -> host pull of a tensor on the hot path; "
                "the sanctioned spelling is analysis.runtime.device_fetch "
                "(ANA006 budgets it)",
            )

        # --- explicit sync budget (hot-path dirs only)
        norm = "/" + self.path.replace(os.sep, "/")
        if leaf in SYNC_CALLS and any(seg in norm for seg in EXPLICIT_SYNC_DIRS):
            self._add(
                "ANA006",
                call,
                f"explicit transfer or wait ({d}) on the hot path: planned "
                "sync points must be allowlisted with their budget "
                "(analysis/allowlist.txt)",
            )


# ---------------------------------------------------------------- allowlist
def load_allowlist(path: str) -> List[Tuple[str, str, str]]:
    """Parse ``<path-glob> <rule|*> <reason...>`` lines (# comments)."""
    entries: List[Tuple[str, str, str]] = []
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(None, 2)
            if len(parts) < 2:
                raise ValueError(f"malformed allowlist line: {raw!r}")
            glob, rule = parts[0], parts[1]
            reason = parts[2] if len(parts) > 2 else ""
            entries.append((glob, rule, reason))
    return entries


def is_allowlisted(v: Violation, entries: Sequence[Tuple[str, str, str]]) -> bool:
    path = v.path.replace(os.sep, "/")
    for glob, rule, _reason in entries:
        if rule not in ("*", v.rule):
            continue
        if fnmatch.fnmatch(path, glob) or fnmatch.fnmatch(path, "*/" + glob):
            return True
    return False


DEFAULT_ALLOWLIST = os.path.join(os.path.dirname(__file__), "allowlist.txt")


def lint_paths(
    paths: Sequence[str], allowlist: Optional[str] = DEFAULT_ALLOWLIST
) -> Tuple[List[Violation], List[Violation]]:
    """Lint every .py under ``paths``; returns (violations, allowlisted)."""
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        else:
            for root, _dirs, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in sorted(names) if n.endswith(".py"))
    entries = load_allowlist(allowlist) if allowlist else []
    hard: List[Violation] = []
    soft: List[Violation] = []
    for path in sorted(set(files)):
        with open(path) as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            hard.append(Violation("ANA000", path, e.lineno or 0, f"syntax error: {e.msg}"))
            continue
        seen: Set[Tuple[str, str, int]] = set()
        for v in Linter(os.path.relpath(path), tree).run():
            key = (v.rule, v.path, v.line)
            if key in seen:
                continue  # one finding per rule and line
            seen.add(key)
            (soft if is_allowlisted(v, entries) else hard).append(v)
    return hard, soft
