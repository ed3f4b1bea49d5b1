"""Build ``csrc/*.cu`` with ``nvcc`` at first use and load it with ``ctypes``.

Every source (``*.cu``) under ``csrc/`` is compiled to an object, all at
once (one ``nvcc`` process each, started together), and the objects are
linked into one shared library in ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of all sources, the
headers they share (``*.cuh``) and the flags, so an edited source or
header rebuilds and an unchanged tree loads at once; nvcc's report
(ptxas resources per kernel, every source's in turn) is kept beside it as
``.log``.  Nothing here falls back: a missing ``nvcc``, a failed compile or
a failed load raises.  Importing this module builds nothing; ``library()``
does, once per process.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3", "-lineinfo",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    "-c",
)
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
# (name, argtypes) of every C entry point of the library.
_SIGNATURES = {
    # q, k, v, o, lse (or null), BH, BHkv, Sq, Skv, d, bf16, causal, window,
    # scale, stream
    "flash_attention": [_P] * 5 + [_I] * 8 + [ctypes.c_float, _P],
    "flash_bf16_smem_bytes": [_I],  # d
    # q, k, v, o, dout, lse, dq, dk, dv, dq_acc, delta, sems, BH, BHkv, Sq,
    # Skv, d, bf16, causal, window, scale, stages, stream
    "flash_attention_bwd": [_P] * 12 + [_I] * 8 + [ctypes.c_float, _I, _P],
    "flash_bwd_smem_bytes": [_I],  # d
    "flash_bwd_bf16_smem_bytes": [_I],  # d
    "hybrid_block_q": [],
    # keys, values, n, height, shared_tree, queries, active, T, B, ordered,
    # 7 outputs, stream
    "forest_descend": [_P, _P, _I, _I, _I, _P, _P, _I, _I, _I]
    + [_P] * 7
    + [_P],
    # keys, values, n, height, split, mapping, capacity, queries, active, B,
    # ordered, 7 outputs, overflow_out, stream
    "hybrid_descend": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I]
    + [_P] * 7
    + [_P, _P],
    # forest_descend's arguments up to ordered, then the delta buffer's keys,
    # values, tombstone, weight and capacity, 7 outputs, stream
    "forest_descend_delta": [_P, _P, _I, _I, _I, _P, _P, _I, _I, _I]
    + [_P, _P, _P, _P, _I]
    + [_P] * 7
    + [_P],
    # hybrid_descend's arguments up to ordered, the delta buffer as above,
    # 7 outputs, overflow_out, stream
    "hybrid_descend_delta": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I]
    + [_P, _P, _P, _P, _I]
    + [_P] * 7
    + [_P, _P],
    "hybrid_max_queue_split": [],
    "levels_per_trip": [],
    "forest_block": [],
    "forest_staged_levels": [],
    "hybrid_staged_levels": [_I],  # split
    "delta_line": [_I, _I],  # capacity, ordered
    "forest_smem_bytes": [_I, _I],  # capacity, ordered
    "hybrid_smem_bytes": [_I, _I, _I, _I],  # split, mapping, capacity, ordered
    # dest, G, B, n_dest, capacity, slot, kept, buffers, counts, overflow,
    # stream
    "queue_dispatch": [_P, _I, _I, _I, _I] + [_P] * 5 + [_P],
    "queue_dispatch_max_dest": [],
    "queue_dispatch_ctas": [_I, _I],  # B, n_dest
    "queue_dispatch_threads": [_I, _I],  # B, n_dest
    "queue_dispatch_smem_bytes": [_I, _I],  # B, n_dest
    # next, start, steps, out, stream
    "pointer_chase": [_P, _I, _I, _P, _P],
    # grid, threads, dynamic shared memory bytes, cluster, stream
    "empty_launch": [_I, _I, _I, _I, _P],
}


@dataclasses.dataclass(frozen=True)
class Built:
    """The loaded library and what its build reported."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc's output (ptxas registers / shared memory per kernel)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of repro_torch "
            "are built from source at first use and have no CPU fallback"
        )
    return found


def sources(csrc: Path = CSRC) -> list:
    """The files nvcc compiles, one object each."""
    return sorted(csrc.glob("*.cu"))


def headers(csrc: Path = CSRC) -> list:
    """The headers the sources include: hashed, never compiled alone."""
    return sorted(csrc.glob("*.cuh"))


def library_name(csrc: Path = CSRC) -> str:
    """The library's file name: a hash of the flags and of every source and
    header under ``csrc``, so an edit of either builds a new library."""
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources(csrc) + headers(csrc):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return f"librepro_kernels-{digest.hexdigest()[:16]}.so"


def _run_all(cmds) -> list:
    """Start every command at once, wait for all of them, and return
    ``(cmd, returncode, output)`` each: no process outlives the call."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    out = []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        out.append((cmd, proc.returncode, text))
    return out


def _compile(nvcc: str, out: Path) -> str:
    objs_dir = out.with_suffix(f".{os.getpid()}.objs")
    objs_dir.mkdir(parents=True, exist_ok=True)
    try:
        objs = [objs_dir / f"{src.stem}.o" for src in sources()]
        runs = _run_all(
            [nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)
        )
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if all(rc == 0 for _, rc, _ in runs):
            runs += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
        failed = [(cmd, rc, text) for cmd, rc, text in runs if rc != 0]
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"({rc}) {' '.join(cmd)}\n{text}" for cmd, rc, text in failed
            ))
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        shutil.rmtree(objs_dir, ignore_errors=True)
    return "".join(text for _, _, text in runs)


@functools.cache
def library() -> Built:
    """Build (if needed) and load the kernels' shared library."""
    out = BUILD_DIR / library_name()
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log_path.write_text(_compile(nvcc_path(), out))
        seconds = time.perf_counter() - t0
    log = log_path.read_text() if log_path.is_file() else ""
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [_I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return Built(lib=lib, path=out, seconds=seconds, log=log)


def check_launch(rc: int, kernel: str) -> None:
    """Raise if an entry point returned a CUDA error (a refused launch)."""
    if rc != 0:
        msg = library().lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc} ({msg})")
