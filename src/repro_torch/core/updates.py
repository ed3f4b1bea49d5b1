"""Bulk insert and delete: the paper's announced extension, as batch work.

A pointer-chasing incremental insert is hostile to the FPGA (the paper's
authors deferred it) and to the card alike.  Bulk maintenance is the batch
form: the write batch is classified by one ordered descent over the
snapshot, ingested into a transient delta buffer of the batch's size, and
compacted at once into a fresh perfect snapshot (``core.delta``): a rank
arithmetic merge and an Eytzinger re-layout on the tree's device, with one
host sync for the new key count.  Only input validation runs on the host.

A continuous write stream belongs on ``BSTEngine.apply_updates`` with a
delta buffer; these calls are the cold, snapshot-swap path.  An inserted key
that already exists REPLACES the stored value (upsert).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.analysis import runtime
from repro_torch.core import delta as delta_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.tree import TreeData
from repro_torch.kernels import ops as kops


def sorted_view(tree: TreeData) -> Tuple[np.ndarray, np.ndarray]:
    """The sorted key/value arrays of a snapshot, on the host: one counted
    fetch of the snapshot (a rebuild without a delta buffer is a host-side
    step, outside any drain)."""
    keys, values = runtime.device_fetch((tree.keys, tree.values))
    real = keys != tree_lib.SENTINEL_KEY
    order = np.argsort(keys[real], kind="stable")
    return keys[real][order], values[real][order]


def _ingest_batch(
    tree: TreeData, keys: torch.Tensor, values: torch.Tensor, deletes: torch.Tensor
) -> delta_lib.DeltaBuffer:
    """Classify one write batch against the snapshot and buffer it.

    One ordered descent through the forest kernel (its plain version for a
    CPU tree) gives each key's membership and rank, the entries' metadata;
    ``ingest`` then sorts and dedups the batch, last write wins.
    """
    res = kops.bst_ordered_forest(tree.keys[None], tree.values[None], keys[None], tree.height)
    return delta_lib.ingest(
        delta_lib.empty(int(keys.shape[0]), tree.device),
        keys,
        values,
        deletes,
        torch.ones(keys.shape, dtype=torch.bool, device=tree.device),
        res[1][0],
        res[6][0],
    )


def _apply_batch(tree: TreeData, keys, values, deletes) -> TreeData:
    def dev(x):
        return torch.from_numpy(x).to(tree.device)

    d = _ingest_batch(tree, dev(keys), dev(values), dev(deletes))
    return delta_lib.compact(tree, d)


def bulk_insert(tree: TreeData, new_keys, new_values) -> TreeData:
    """Upsert a batch of pairs; returns a freshly laid-out perfect tree."""
    new_keys = np.asarray(new_keys, dtype=np.int32)
    new_values = np.asarray(new_values, dtype=np.int32)
    if new_keys.ndim != 1 or new_keys.shape != new_values.shape:
        raise ValueError("new_keys/new_values must be equal-length 1-D")
    if new_keys.size == 0:
        return tree
    return _apply_batch(tree, new_keys, new_values, np.zeros(new_keys.size, bool))


def bulk_delete(tree: TreeData, del_keys) -> TreeData:
    """Remove a batch of keys (absent keys are ignored; scalars accepted)."""
    del_keys = np.atleast_1d(np.asarray(del_keys, dtype=np.int32))
    if del_keys.ndim != 1:
        raise ValueError("del_keys must be scalar or 1-D")
    if del_keys.size == 0:
        return tree
    try:
        return _apply_batch(
            tree, del_keys, np.zeros(del_keys.size, np.int32), np.ones(del_keys.size, bool)
        )
    except ValueError as e:
        if "empty the tree" in str(e):
            raise ValueError("bulk_delete would empty the tree") from None
        raise
