"""Key-set generators reproducing the paper's evaluation inputs (§III).

* ``equal``  -- the same key, chosen as a LEAF node: worst case, every key
  follows the same root-to-leaf path (maximal buffer conflicts).
* ``random`` -- uniformly random keys from the inserted key population.
* ``split``  -- keys cycling round-robin over the vertical subtrees: best
  case, zero conflicts for every hybrid configuration evaluated.

Sizes used by the paper: 64K and 256K.  Generated with numpy on the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import tree as tree_lib
from repro_torch.core.tree import TreeData


def make_tree_data(n_keys: int, seed: int = 0, spacing: int = 2):
    """Unique sorted int32 keys (spaced so absent keys exist) + values."""
    rng = np.random.default_rng(seed)
    keys = np.arange(1, n_keys + 1, dtype=np.int64) * spacing
    keys = keys.astype(np.int32)
    values = rng.integers(0, 2**31 - 1, size=n_keys, dtype=np.int32)
    return keys, values


def leaf_keys(tree: TreeData) -> np.ndarray:
    """Non-sentinel keys stored on the deepest level."""
    o = tree_lib.level_offset(tree.height)
    lvl = tree.keys[o:].cpu().numpy()
    return lvl[lvl != tree_lib.SENTINEL_KEY]


def make_key_sets(
    tree: TreeData, size: int, n_subtrees: int = 8, seed: int = 1
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    all_keys = tree.keys.cpu().numpy()
    real = all_keys[all_keys != tree_lib.SENTINEL_KEY]

    # Equal: one leaf key repeated (worst case).
    leaves = leaf_keys(tree)
    equal = np.full(size, leaves[len(leaves) // 2], dtype=np.int32)

    # Random: uniform over the key population.
    random = rng.choice(real, size=size, replace=True).astype(np.int32)

    # Split: round-robin over the deepest vertical split evaluated (8), in the
    # bit-reversed order (0,2,4,6,1,3,5,7), which is conflict-free for the 4-
    # and 8-subtree configs including the direct mapping's port-half layout.
    split_level = int(np.log2(n_subtrees))
    per_sub = []
    for s in range(n_subtrees):
        sk = all_keys[tree_lib.subtree_gather_indices(tree.height, split_level, s)]
        sk = sk[sk != tree_lib.SENTINEL_KEY]
        per_sub.append(rng.choice(sk, size=(size + n_subtrees - 1) // n_subtrees))
    order = [s for s in range(n_subtrees) if s % 2 == 0] + [
        s for s in range(n_subtrees) if s % 2 == 1
    ]
    split = (
        np.stack([per_sub[s] for s in order], axis=1).reshape(-1)[:size].astype(np.int32)
    )

    return {"equal": equal, "random": random, "split": split}
