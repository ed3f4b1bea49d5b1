"""Wrapper of kernel K5: flash attention (``csrc/flash_attention.cu``) and
its backward (``csrc/flash_attention_bwd.cu``).

``flash_attention_cuda`` checks its operands (device, dtype, rank, shapes,
contiguity, alignment, head dim; ``check_operands`` holds the part of that
contract the plain version shares), allocates the output (and with
``with_lse`` the rows' log-sum-exp) with ``torch.empty``, launches the
kernel on the current stream, raises if the launch was refused, and adds one
to ``LAUNCHES["flash_attention"]``.  ``flash_attention_bwd_cuda`` does the
same for the backward (``LAUNCHES["flash_attention_bwd"]``, one a call: the
call's pre-pass, main kernel and, in bf16, cast of dq; ``bwd_stage_calls``
launches each of the three alone, to time it).  Both take CUDA
tensors only; ``kernels.ops`` sends CPU tensors to the plain versions
(``ref.flash_attention_lse_ref``, ``ref.flash_attention_bwd_ref``) instead.

A launch takes at most ``MAX_HEAD_ROWS`` head rows on a grid dimension that
bounds them: the forward's q rows, the fp32 backward's kv rows.  A call
past that makes one launch a chunk of ``head_row_chunks`` (whole GQA
groups, on views that start at the chunk's first head row: ``run_head_rows``)
and still counts one in ``LAUNCHES``; ``CHUNKS`` counts the launches.

The backward adds each kv tile's dQ into dq's fp32 rows in a fixed order,
kv tile by kv tile (the kernel's "dQ's order"), so a call gives the same
bits every time; ``bwd_visible_q_tiles`` and ``bwd_first_kv_tile`` are that
order's two halves as the kernels compute them.

``forward_work`` and ``backward_work`` are the work a call must do, its
operations and the bytes it must move, from its shapes alone: what
``chip_smoke.py`` holds the kernels' times to and what the dry run
(``launch/dryrun.py``) adds up for the calls it stands in for.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

# Wrapper calls since the last ``reset_launches()``: one a call, however
# many chunks it launches.
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}
# Launches of the C entries (chunks of head rows) since the same reset.
CHUNKS: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_ROWS = 65535  # a grid's y dimension: the forward's q rows, the fp32 backward's kv rows
_INT32_MAX = 2**31 - 1
BWD_ROW_PAD = 64  # the backward's q tile: the bf16 pre-pass pads each head's rows to it
BWD_KV_ROWS = {torch.bfloat16: 128, torch.float32: 64}  # kv rows a CTA of each body
# The backward's device kernels as bits of its C entry's stage mask: the
# pre-pass, the main kernel and, in bf16, the cast of dq.
BWD_STAGES = {"pre": 1, "main": 2, "cast": 4}
_BWD_ALL_STAGES = 7
BWD_FLOP_FACTOR = 2.5  # the backward's five products against the forward's two


def bf16_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one CTA of the bf16 body at head dim d (the
    Q tile and two stages of K and V tiles, with their mbarriers)."""
    n = _build.library().lib.flash_bf16_smem_bytes(d)
    if n < 0:
        raise ValueError(f"head dim {d} has no kernel instantiation (have {HEAD_DIMS})")
    return n


def bwd_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA of the backward's main kernel at
    head dim d: in bf16 ``flash_bwd_bf16_kernel<D>`` (K and V, a ring of Q
    and dO tiles with their lse and delta, two dS tiles, the mbarriers), in
    fp32 ``flash_bwd_kernel<float, D>`` (K, V, Q and dO as padded fp32
    tiles, P and dS)."""
    if dtype not in DTYPES:
        raise ValueError(f"no backward body for {dtype} (have {DTYPES})")
    lib = _build.library().lib
    n = (lib.flash_bwd_bf16_smem_bytes if dtype == torch.bfloat16 else lib.flash_bwd_smem_bytes)(d)
    if n < 0:
        raise ValueError(f"head dim {d} has no kernel instantiation (have {HEAD_DIMS})")
    return n


def visible_pairs(Sq: int, Skv: int, causal: bool, window: Optional[int]) -> int:
    """(q row, key) pairs one head row attends to: the work K5 must do."""
    qpos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    lo = np.zeros(Sq, np.int64) if window is None else np.maximum(0, qpos - window + 1)
    hi = np.minimum(Skv - 1, qpos) if causal else np.full(Sq, Skv - 1, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def forward_work(BH: int, BHkv: int, Sq: int, Skv: int, d: int, causal: bool,
                 window: Optional[int], itemsize: int, with_lse: bool = False) -> Tuple[int, int]:
    """``(operations, bytes)`` of one forward call: two products of d
    multiply-adds over every visible pair of each head row (4 BH d pairs),
    and q, k and v read once, the output (and the fp32 lse) written once."""
    flop = 4 * BH * d * visible_pairs(Sq, Skv, causal, window)
    n_bytes = (2 * BH * Sq * d + 2 * BHkv * Skv * d) * itemsize + (4 * BH * Sq if with_lse else 0)
    return flop, n_bytes


def backward_work(BH: int, BHkv: int, Sq: int, Skv: int, d: int, causal: bool,
                  window: Optional[int], itemsize: int) -> Tuple[float, int]:
    """``(operations, bytes)`` of one backward call: ``BWD_FLOP_FACTOR``
    times the forward's operations, and q, k, v, the output, its gradient
    and the lse read once, dq, dk and dv written once."""
    flop, _ = forward_work(BH, BHkv, Sq, Skv, d, causal, window, itemsize)
    n_bytes = (4 * BH * Sq * d + 4 * BHkv * Skv * d) * itemsize + 4 * BH * Sq
    return BWD_FLOP_FACTOR * flop, n_bytes


def reset_launches() -> None:
    for counts in (LAUNCHES, CHUNKS):
        for name in counts:
            counts[name] = 0


def head_row_chunks(BH: int, BHkv: int, whole_groups: bool = False
                    ) -> List[Tuple[int, int, int, int]]:
    """The launches of one call over BH q rows and BHkv kv rows (BH a
    positive multiple of BHkv): ``(q0, q1, kv0, kv1)`` each, in order,
    covering every row once.  A chunk is whole GQA groups, kv rows [kv0,
    kv1) and their q rows [kv0 group, kv1 group), so q row b of a chunk
    still reads its kv row b // group; the forward's chunks hold at most
    ``MAX_HEAD_ROWS`` q rows, and so as many kv rows.  Where one group
    holds more q rows than that, the forward cuts it into pieces of at most
    ``MAX_HEAD_ROWS`` q rows, each with its one kv row.  ``whole_groups``
    (the backward, whose kernels loop over a group and sum its q rows into
    one dk and dv row) never cuts a group and bounds the kv rows alone.
    One chunk where the rows fit."""
    limit, group = MAX_HEAD_ROWS, BH // BHkv
    if whole_groups:
        step = limit
    elif group <= limit:
        step = limit // group
    else:
        return [(q0, min(q0 + limit, (kv + 1) * group), kv, kv + 1)
                for kv in range(BHkv) for q0 in range(kv * group, (kv + 1) * group, limit)]
    return [(kv0 * group, kv1 * group, kv0, kv1)
            for kv0 in range(0, BHkv, step) for kv1 in (min(kv0 + step, BHkv),)]


def run_head_rows(launch: Callable[..., None], q_rows: Sequence[Optional[torch.Tensor]],
                  kv_rows: Sequence[torch.Tensor], whole_groups: bool = False) -> int:
    """``launch(*q_views, *kv_views)`` once a chunk of ``head_row_chunks``
    over ``q_rows[0]`` and ``kv_rows[0]``'s first dims: each tensor of
    ``q_rows`` (a None passes through) sliced to the chunk's q rows, each
    of ``kv_rows`` to its kv rows.  The views start at the chunk's first
    head row, so a launch on their pointers sees the chunk as a call of its
    own.  One chunk is the call itself, on the tensors as given.  Returns
    the number of chunks."""
    chunks = head_row_chunks(q_rows[0].shape[0], kv_rows[0].shape[0], whole_groups)
    if len(chunks) == 1:
        launch(*q_rows, *kv_rows)
        return 1
    for q0, q1, kv0, kv1 in chunks:
        launch(*(None if t is None else t[q0:q1] for t in q_rows),
               *(t[kv0:kv1] for t in kv_rows))
    return len(chunks)


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


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int],
                fn: str) -> Tuple[int, int, int, int, int]:
    """What the kernels take beyond ``check_operands``: CUDA tensors of one
    dtype of DTYPES, a head dim of HEAD_DIMS, 16-byte aligned, sequences
    in int32."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {q.device}")
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
    if max(Sq, Skv) > _INT32_MAX:
        raise ValueError(f"attention shape out of the kernel's range: Sq={Sq}, Skv={Skv}")
    return BH, Sq, d, BHkv, Skv


def _window_arg(window: Optional[int]) -> int:
    return 0 if window is None else min(window, _INT32_MAX)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    with_lse: bool = False,
):
    """Kernel K5: (BH, Sq, d) attention output in q's dtype; q row b reads
    kv row ``b // (BH // BHkv)``.  Causal and window masks align q at the
    end of kv; rows that see no key give 0.  ``scale`` defaults to
    ``d ** -0.5``.  With ``with_lse`` it returns ``(out, lse)``, lse (BH,
    Sq) fp32 the log-sum-exp of each row's visible scaled scores (-inf for
    a row that sees none), which ``flash_attention_bwd_cuda`` takes; the
    serving route asks for none, and the kernel then stores nothing more."""
    BH, Sq, d, BHkv, Skv = _check_cuda(q, k, v, window, "flash_attention_cuda")
    out = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    if BH > 0 and Sq > 0:
        scale = scale if scale is not None else d**-0.5
        built = _build.library()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream

            def launch(qc, oc, lc, kc, vc):
                CHUNKS["flash_attention"] += 1
                rc = built.lib.flash_attention(
                    qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), oc.data_ptr(),
                    None if lc is None else lc.data_ptr(), qc.shape[0], kc.shape[0], Sq, Skv, d,
                    int(q.dtype == torch.bfloat16), int(causal), _window_arg(window),
                    float(scale), stream,
                )
                _build.check_launch(rc, "flash_attention")

            LAUNCHES["flash_attention"] += 1
            run_head_rows(launch, (q, out, lse), (k, v))
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's backward: ``(dq, dk, dv)`` in the operands' dtype from the
    forward's operands, its output ``out``, the output's gradient ``dout``
    and its ``lse`` (``flash_attention_cuda(..., with_lse=True)``), for the
    same masks and scale.  dk and dv sum the GQA group's q rows; a row that
    sees no key gets dq 0 and adds nothing."""
    dq, dk, dv, launch = _bwd_call(q, k, v, out, dout, lse, causal, window, scale)
    if launch is not None:
        launch(_BWD_ALL_STAGES)
    return dq, dk, dv


def bwd_stage_calls(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Dict[str, Callable[[], None]]]:
    """The backward's device kernels one by one, to time each one's share of
    a launch: runs one whole backward and returns its ``(dq, dk, dv)`` and,
    for each name of ``BWD_STAGES``, a call that launches that kernel alone,
    over every chunk, on the scratch and outputs the whole one used (each
    counts in ``LAUNCHES`` as a call does; the three in order redo the
    backward, bit for bit; the main kernel alone first zeroes dQ's
    semaphores with a memset, as the pre-pass does)."""
    dq, dk, dv, launch = _bwd_call(q, k, v, out, dout, lse, causal, window, scale)
    if launch is None:
        raise ValueError("the backward has no q rows to launch its kernels on")
    launch(_BWD_ALL_STAGES)
    return (dq, dk, dv), {name: functools.partial(launch, bit) for name, bit in BWD_STAGES.items()}


def bwd_scratch(q: torch.Tensor, dq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                              torch.Tensor]:
    """The backward's scratch beside its outputs: ``(dq_acc, delta, sems)``.
    fp32 accumulates dq in place (``dq_acc`` is ``dq``); bf16 in an fp32
    scratch, (BH, Sq64, d) with each 64-row q tile of a head row contiguous
    (the bf16 body's tile layout), cast at the end.  ``delta``, (BH, 2 Sq64) with Sq64 = Sq padded
    to BWD_ROW_PAD rows, is what a launch over BH' head rows reads from its
    first row on as 2 BH' Sq64 values: delta and, for the bf16 body, each
    row's lse term (the fp32 body reads the first BH' Sq).  ``sems``, int32
    (BH, Sq64 / BWD_ROW_PAD + 1): a semaphore per (q head row, q tile) of
    dQ's order, and in column Sq64 / BWD_ROW_PAD of a launch's first row
    its ticket counter; the pre-pass zeroes them.  A chunk's rows of each
    are a launch's own."""
    BH, Sq = q.shape[0], q.shape[1]
    tiles = -(-Sq // BWD_ROW_PAD)
    dq_acc = dq if q.dtype == torch.float32 else torch.empty(
        (BH, tiles * BWD_ROW_PAD, q.shape[2]), dtype=torch.float32, device=q.device)
    delta = torch.empty((BH, 2 * tiles * BWD_ROW_PAD), dtype=torch.float32, device=q.device)
    sems = torch.empty((BH, tiles + 1), dtype=torch.int32, device=q.device)
    return dq_acc, delta, sems


def bwd_visible_q_tiles(kv_tile: int, kv_rows: int, Sq: int, Skv: int, causal: bool,
                        window: Optional[int]) -> range:
    """The BWD_ROW_PAD-row q tiles whose rows see a key of kv tile
    ``kv_tile`` (rows [kv_rows kv_tile, min(kv_rows (kv_tile + 1), Skv))),
    as the kernels' ``visible_q_tiles``: a CTA walks them from the last
    down, the GQA group's q heads inside."""
    offset = Skv - Sq
    k0 = kv_tile * kv_rows
    k_last = min(k0 + kv_rows, Skv) - 1
    i_lo = max(0, k0 - offset) if causal else 0
    i_hi = Sq if window is None else min(Sq, k_last + window - offset)
    lo = i_lo // BWD_ROW_PAD
    return range(lo, -(-i_hi // BWD_ROW_PAD) if i_hi > i_lo else lo)


def bwd_first_kv_tile(q_tile: int, kv_rows: int, Sq: int, Skv: int, window: Optional[int]) -> int:
    """The first kv tile whose ``bwd_visible_q_tiles`` hold ``q_tile``, as
    the kernels' ``first_kv_tile``: kv tile j adds the q tile's dQ as turn
    j minus this one."""
    if window is None:
        return 0
    x = BWD_ROW_PAD * q_tile + (Skv - Sq) - window  # the tile's last key must lie past x
    return max(0, (x - (kv_rows - 1)) // kv_rows + 1)


def _bwd_call(q, k, v, out, dout, lse, causal, window, scale) -> tuple:
    """The backward's checks and allocations: ``(dq, dk, dv, launch)``,
    ``launch(stages)`` launching the kernels of the mask ``stages`` on the
    current stream, or None where there are no q rows (dk and dv zeroed)."""
    BH, Sq, d, BHkv, Skv = _check_cuda(q, k, v, window, "flash_attention_bwd_cuda")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be shaped, typed and placed as q: got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start on a 16-byte boundary")
    if lse.shape != (BH, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous fp32 ({BH}, {Sq}) tensor on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    sq64 = -(-Sq // BWD_ROW_PAD) * BWD_ROW_PAD
    if BH * sq64 > _INT32_MAX:
        raise ValueError(f"the backward takes BH * Sq < 2**31 q rows, got {BH} x {Sq}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if BH == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_(), None
    scale = scale if scale is not None else d**-0.5
    dq_acc, delta, sems = bwd_scratch(q, dq)
    built = _build.library()

    def launch(stages: int) -> None:
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream

            def launch_chunk(qc, oc, doc, lc, dqc, accc, deltac, semc, kc, vc, dkc, dvc):
                CHUNKS["flash_attention_bwd"] += 1
                rc = built.lib.flash_attention_bwd(
                    qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), oc.data_ptr(), doc.data_ptr(),
                    lc.data_ptr(), dqc.data_ptr(), dkc.data_ptr(), dvc.data_ptr(),
                    accc.data_ptr(), deltac.data_ptr(), semc.data_ptr(), qc.shape[0],
                    kc.shape[0], Sq, Skv, d, int(q.dtype == torch.bfloat16), int(causal),
                    _window_arg(window), float(scale), stages, stream,
                )
                _build.check_launch(rc, "flash_attention_bwd")

            LAUNCHES["flash_attention_bwd"] += 1
            run_head_rows(launch_chunk, (q, out, dout, lse, dq, dq_acc, delta, sems),
                          (k, v, dk, dv), whole_groups=True)

    return dq, dk, dv, launch
