"""Build ``csrc/`` with ``nvcc`` at first use and load it with ``ctypes``.

The shared library goes into ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of its source and flags,
so an edited source rebuilds and an unchanged one loads at once; nvcc's
report (ptxas resources per kernel) is kept beside it as ``.log``.  Nothing
here falls back: a missing ``nvcc``, a failed compile or a failed load
raises.  Importing this module builds nothing; ``library()`` does, once per
process.
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
SOURCE = CSRC / "forest_search.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# (name, argtypes) of every C entry point of forest_search.cu.
_SIGNATURES = {
    "hybrid_block_q": [],
    # keys, values, n, height, reg_levels, shared_tree, queries, active, T, B,
    # ordered, 7 outputs, stream
    "forest_descend": [_P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I]
    + [_P] * 7
    + [_P],
    # keys, values, n, height, split, mapping, capacity, queries, active, B,
    # ordered, 7 outputs, overflow_out, stream
    "hybrid_descend": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I]
    + [_P] * 7
    + [_P, _P],
    # forest_descend's arguments up to ordered, then the delta buffer's keys,
    # values, tombstone, weight and capacity, 7 outputs, stream
    "forest_descend_delta": [_P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I]
    + [_P, _P, _P, _P, _I]
    + [_P] * 7
    + [_P],
    # hybrid_descend's arguments up to ordered, the delta buffer as above,
    # 7 outputs, overflow_out, stream
    "hybrid_descend_delta": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I]
    + [_P, _P, _P, _P, _I]
    + [_P] * 7
    + [_P, _P],
    "delta_capacity_limit": [_I],  # hybrid
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


def _compile(nvcc: str, out: Path) -> str:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return proc.stdout + proc.stderr


@functools.cache
def library() -> Built:
    """Build (if needed) and load the kernels' shared library."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libforest_search-{digest.hexdigest()[:16]}.so"
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
    lib.forest_error_string.argtypes = [_I]
    lib.forest_error_string.restype = ctypes.c_char_p
    return Built(lib=lib, path=out, seconds=seconds, log=log)
