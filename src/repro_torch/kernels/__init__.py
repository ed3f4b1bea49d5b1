"""Hand-written Hopper kernels (``csrc/``) and their wrappers
(``bst_search``, ``flash_attention``), their plain PyTorch versions
(``ref``) and the device-dispatching entry points (``ops``).  ``LAUNCHES``
counts the BST kernels' launches, ``flash_attention.LAUNCHES`` K5's."""

from repro_torch.kernels import bst_search, flash_attention, ops, ref
from repro_torch.kernels.bst_search import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "bst_search", "flash_attention", "ops", "ref", "reset_launches"]
