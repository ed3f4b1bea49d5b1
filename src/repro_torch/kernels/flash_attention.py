"""Wrapper of kernel K5 in ``csrc/flash_attention.cu``: flash attention.

``flash_attention_cuda`` checks its operands (device, dtype, rank, shapes,
contiguity, alignment, head dim; ``check_operands`` holds the part of that
contract the plain version shares), allocates the output with ``torch.empty``,
launches the kernel on the current stream, raises if the launch was refused,
and adds one to ``LAUNCHES["flash_attention"]``.  It takes CUDA tensors
only; ``kernels.ops.flash_attention`` sends CPU tensors to the plain version
(``ref.flash_attention_ref``) instead.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

# Launches since the last ``reset_launches()``.
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEAD_ROWS = 65535  # the grid's y dimension
_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_operands(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int]
) -> Tuple[int, int, int, int, int]:
    """The attention contract on either device: q (BH, Sq, d), k and v
    (BHkv, Skv, d) of one shape, contiguous, on q's device, BH a multiple of
    BHkv, and a window of None or >= 1.  Returns ``(BH, Sq, d, BHkv, Skv)``."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("q, k and v must be 3-D: (BH, Sq, d) and (BHkv, Skv, d)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ in shape")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v lie on {q.device}, {k.device}, {v.device}")
    BH, Sq, d = q.shape
    BHkv, Skv, dk = k.shape
    if dk != d:
        raise ValueError(f"q has head dim {d}, k and v {dk}")
    if BHkv == 0 or BH % BHkv:
        raise ValueError(f"q's {BH} head rows are not a multiple of kv's {BHkv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    return BH, Sq, d, BHkv, Skv


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel K5: (BH, Sq, d) attention output in q's dtype; q row b reads
    kv row ``b // (BH // BHkv)``.  Causal and window masks align q at the
    end of kv; rows that see no key give 0.  ``scale`` defaults to
    ``d ** -0.5``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda takes CUDA tensors, got {q.device}")
    BH, Sq, d, BHkv, Skv = check_operands(q, k, v, window)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k and v must share one dtype of {DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel instantiation (have {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if BH > _MAX_HEAD_ROWS or max(Sq, Skv) > _INT32_MAX:
        raise ValueError(f"attention shape out of the kernel's range: BH={BH}, Sq={Sq}, Skv={Skv}")
    out = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return out
    scale = scale if scale is not None else d**-0.5
    built = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LAUNCHES["flash_attention"] += 1
        rc = built.lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, BHkv, Sq,
            Skv, d, int(q.dtype == torch.bfloat16), int(causal),
            0 if window is None else min(window, _INT32_MAX), float(scale), stream,
        )
    _build.check_launch(rc, "flash_attention")
    return out
