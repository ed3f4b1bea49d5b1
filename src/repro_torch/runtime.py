"""The counted device->host fetch of the serving path.

A read chunk's results leave the device in exactly one place,
``BSTServer._fill_columns``, through ``device_fetch``; ``fetch_count`` lets a
run check that a drain made exactly one fetch per retired chunk and no other.
"""

from __future__ import annotations

import threading
from typing import Sequence, Tuple

import numpy as np
import torch

_fetch_count_lock = threading.Lock()
_fetch_count = 0


def device_fetch(values: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    """Copy a tuple of tensors to host numpy arrays, counted as one fetch."""
    global _fetch_count
    with _fetch_count_lock:
        _fetch_count += 1
    return tuple(v.cpu().numpy() for v in values)


def fetch_count() -> int:
    """Total ``device_fetch`` calls this process (monotonic counter)."""
    return _fetch_count


def block_until_ready(values: Sequence[torch.Tensor]) -> None:
    """Wait for the device work behind ``values`` (no copy, no fetch)."""
    devices = {v.device for v in values if v.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)
