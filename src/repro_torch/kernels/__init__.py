"""Hand-written Hopper kernels (``csrc/``) and their wrappers
(``bst_search``), their plain PyTorch versions (``ref``) and the
device-dispatching entry points (``ops``)."""

from repro_torch.kernels import bst_search, ops, ref
from repro_torch.kernels.bst_search import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "bst_search", "ops", "ref", "reset_launches"]
