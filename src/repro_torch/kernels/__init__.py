"""Hand-written Hopper kernels (``csrc/``) and their wrappers
(``bst_search``, ``queue_dispatch``, ``flash_attention``), their plain
PyTorch versions (``ref``) and the device-dispatching entry points
(``ops``).  ``LAUNCHES`` counts the BST kernels' wrapper calls,
``queue_dispatch.LAUNCHES`` K4's, ``flash_attention.LAUNCHES`` K5's: each
eager launch, and each call recorded into a CUDA graph, but not the graphs'
replays, which ``repro_torch.graphs`` counts (``REPLAYED``, and
``kernel_runs()`` for the launches that ran)."""

from repro_torch.kernels import bst_search, flash_attention, ops, queue_dispatch, ref
from repro_torch.kernels.bst_search import LAUNCHES, reset_launches

__all__ = [
    "LAUNCHES",
    "bst_search",
    "flash_attention",
    "ops",
    "queue_dispatch",
    "ref",
    "reset_launches",
]
