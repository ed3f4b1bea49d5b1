"""Step-tagged atomic checkpoints in the JAX package's format.

The port of the JAX package's ``checkpoint/store.py``, writing and reading
the same files, so that either package restores what the other saved:

  * ``directory/step_%08d`` holds ``arrays.npz`` (one array a leaf) and
    ``manifest.json`` (``step``, ``paths``, ``dtypes``, ``extra``);
  * a save writes into a ``.tmp_save_*`` directory, fsyncs both files and
    renames the directory: a save cut short never hides or corrupts the
    latest good checkpoint;
  * bf16 leaves are stored as their ``uint16`` bits with ``dtypes[p] ==
    "bfloat16"`` (numpy has no bf16);
  * the paths and their order are the JAX package's
    ``jax.tree_util.tree_flatten_with_path``'s: NamedTuple fields in field
    order (``.params``, ``.opt/.step``), dict keys sorted (``['layers']``),
    sequence items by index (``[0]``).

The port keeps one tensor a layer where the JAX tree stacks (L, ...)
leaves, and keeps its optimizer state and error feedback as lists in
``named_parameters`` order.  ``_jax_shaped`` turns a ``Model`` or a
``TrainState`` into the JAX tree's shape first (``models.convert``:
``jax_tree``, ``train_state_tree``), each stacked leaf a ``LayerStack``:
the writer stacks its layers into one (L, ...) host array, the reader
slices the array back into them.  Other trees (dicts, lists, NamedTuples
of tensors) are saved as they are.

``restore_checkpoint`` writes into the tensors of ``like`` in place (on
their device) and returns ``like``; the stored paths must equal ``like``'s,
in order, and every leaf's dtype and shape must match.  The host snapshot
is one counted ``runtime.device_fetch_into`` a tensor a save, and the
restore one ``runtime.device_put`` a tensor, never inside a serving drain.
``CheckpointManager(save_async=True)`` copies the state to host memory
synchronously (the next step updates the device tensors in place) and
writes in a background thread; a writer's error is raised at the next
``wait()`` (or ``save``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.analysis import runtime
from repro_torch.models import convert

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
BF16 = "bfloat16"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _jax_shaped(tree: Any) -> Any:
    """``tree`` in the JAX package's shape: a ``Model`` as its parameter
    dict, a ``TrainState`` (a NamedTuple whose ``params`` is a module) as
    the JAX ``TrainState`` tree; anything else unchanged."""
    if isinstance(tree, nn.Module):
        named = list(tree.named_parameters())
        return convert.jax_tree([n for n, _ in named], [p for _, p in named])
    if _is_namedtuple(tree) and isinstance(getattr(tree, "params", None), nn.Module):
        return convert.train_state_tree(tree)
    return tree


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in the JAX package's flatten order; a leaf
    is a tensor or a ``LayerStack`` of tensors."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        keyed = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        keyed = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        keyed = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in keyed:
        out.extend(_flatten(sub, prefix + (key,)))
    return out


def tree_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """The checkpoint's ``(path, leaf)`` pairs of ``tree`` (a ``Model``,
    a ``TrainState`` or any tree of tensors), in the stored order; a
    layer leaf is a ``convert.LayerStack`` of the per-layer tensors."""
    return _flatten(_jax_shaped(tree))


def _dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a torch dtype: numpy's (``float32``,
    ``int32``, ...), and ``bfloat16``."""
    return str(dtype).replace("torch.", "")


def _host_view(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A tensor sharing ``arr``'s memory, bf16 bits as bf16."""
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class HostSnapshot:
    """A tree's leaves copied to host memory, stacked as the JAX tree
    stacks them: ``paths`` in order, ``arrays[p]`` (bf16 as ``uint16``) and
    ``dtypes[p]``, what ``save_checkpoint`` writes."""

    def __init__(self, paths: List[str], arrays: Dict[str, np.ndarray], dtypes: Dict[str, str]):
        self.paths, self.arrays, self.dtypes = paths, arrays, dtypes

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays.values())


def _parts(leaf: Any, path: str) -> Tuple[bool, List[torch.Tensor]]:
    """(whether ``leaf`` is a stacked layer leaf, its tensors)."""
    stacked = isinstance(leaf, convert.LayerStack)
    parts = leaf.parts if stacked else [leaf]
    if not all(isinstance(t, torch.Tensor) for t in parts):
        raise TypeError(f"{path}: a checkpoint holds tensors, not {type(parts[0]).__name__}")
    return stacked, parts


def _fetch_leaf(leaf: Any, path: str) -> Tuple[np.ndarray, str]:
    stacked, parts = _parts(leaf, path)
    dtype = _dtype_name(parts[0].dtype)
    host = np.empty(tuple(leaf.shape), np.uint16 if dtype == BF16 else np.dtype(dtype))
    view = _host_view(host, dtype)
    for i, part in enumerate(parts):
        runtime.device_fetch_into(part.detach(), view[i] if stacked else view)
    return host, dtype


def host_snapshot(state: Any) -> HostSnapshot:
    """Copy every leaf of ``state`` to host memory (a copy, also on the
    CPU): one counted fetch a tensor."""
    if isinstance(state, HostSnapshot):
        return state
    paths, arrays, dtypes = [], {}, {}
    for path, leaf in tree_leaves(state):
        arrays[path], dtypes[path] = _fetch_leaf(leaf, path)
        paths.append(path)
    return HostSnapshot(paths, arrays, dtypes)


def save_checkpoint(directory: str, step: int, state: Any, extra: Optional[dict] = None) -> str:
    """Atomic save of ``state`` (a tree, or a ``HostSnapshot`` of one)
    under ``directory/step_<N>``; returns that directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    snap = host_snapshot(state)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_save_")
    try:
        with open(os.path.join(tmp, _ARRAYS), "wb") as f:
            np.savez(f, **snap.arrays)
            f.flush()
            os.fsync(f.fileno())
        manifest = {"step": step, "paths": snap.paths, "dtypes": snap.dtypes, "extra": extra or {}}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and os.path.isdir(os.path.join(directory, d))
    ]
    return max(steps) if steps else None


@torch.no_grad()
def _put_leaf(leaf: Any, arr: np.ndarray, dtype: str, path: str) -> None:
    stacked, parts = _parts(leaf, path)
    want = _dtype_name(parts[0].dtype)
    shape = tuple(leaf.shape)
    if dtype != want or tuple(arr.shape) != shape:
        raise ValueError(f"{path}: stored {dtype} {tuple(arr.shape)}, restoring into {want} {shape}")
    for i, part in enumerate(parts):
        src = arr[i] if stacked else arr
        src = src if src.flags.c_contiguous else src.copy()  # 0-d arrays stay 0-d
        runtime.device_put(_host_view(src, dtype), part)


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None) -> Tuple[Any, int, dict]:
    """Restore the checkpoint of ``step`` (the latest if None) into the
    tensors of ``like``; returns ``(like, step, extra)``."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = tree_leaves(like)
    paths = [p for p, _ in leaves]
    if paths != manifest["paths"]:
        missing = set(manifest["paths"]) ^ set(paths)
        raise ValueError(f"checkpoint/pytree structure mismatch: {sorted(missing)[:5]}")
    with np.load(os.path.join(d, _ARRAYS)) as data:
        for path, leaf in leaves:
            _put_leaf(leaf, data[path], manifest["dtypes"][path], path)
    return like, step, manifest.get("extra", {})


class CheckpointManager:
    """Rolling checkpoints with optional async writes and retention."""

    def __init__(self, directory: str, keep: int = 3, save_async: bool = False):
        self.directory = directory
        self.keep = keep
        self.save_async = save_async
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state: Any, extra: Optional[dict] = None) -> HostSnapshot:
        """Snapshot ``state`` to host memory now, then write it (in the
        background with ``save_async``); returns the snapshot."""
        self.wait()
        # The device tensors change in place at the next step: copy them now.
        snap = host_snapshot(state)

        def work():
            try:
                save_checkpoint(self.directory, step, snap, extra)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if self.save_async:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()
        return snap

    def restore(self, like: Any, step: Optional[int] = None):
        return restore_checkpoint(self.directory, like, step)

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory) if d.startswith("step_")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
