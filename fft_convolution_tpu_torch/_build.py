"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface under ``build/kernels/`` at the repository root,
and load with ``ctypes``.  The build happens at the first CUDA use, never at
import; its file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the library already built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of every exported function: c_void_p for each pointer and
# the stream (a plain int would cut a 64-bit pointer), c_int for each int
_SIGNATURES = {
    # x, seg, ir, tw, partial, y, overlap; n, b, cur, rows, grid; stream
    "fdl_b1_step": [_P] * 7 + [_I] * 5 + [_P],
    # x, seg, h_ir, t_ir, tw, partial, y, h_ov, t_ov, out0_row,
    # tail_in_row, pre0_row, pre_row; n, b, cur, rows, grid; stream
    "fdl_b2_step": [_P] * 13 + [_I] * 5 + [_P],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources is (or will be) built."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfdl_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    Raises ``RuntimeError`` with nvcc's output when the build fails; the
    compiler's report (registers, shared memory, spills) is kept beside the
    library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fdl_error_string.argtypes = [_I]
        lib.fdl_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = library().fdl_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
