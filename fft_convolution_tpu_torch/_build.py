"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` for ``sm_90a``, all started
together, and the objects link into one shared library with a plain C
interface under ``build/kernels/`` at the repository root, loaded with
``ctypes``.  The build happens at the first CUDA use, never at
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
          "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of every exported function: c_void_p for each pointer and
# the stream (a plain int would cut a 64-bit pointer), c_int for each int,
# c_float for each float
_SIGNATURES = {
    # x, seg, ir, tw, partial, ticket, y, overlap; n, b, cur, rows, grid; stream
    "fdl_b1_step": [_P] * 8 + [_I] * 5 + [_P],
    "fdl_b1p_step": [_P] * 8 + [_I] * 5 + [_P],
    # x, seg, h_ir, t_ir, tw, partial, ticket, y, h_ov, t_ov, out0_row,
    # tail_in_row, pre0_row, pre_row; n, b, cur, rows, grid; stream
    "fdl_b2_step": [_P] * 14 + [_I] * 5 + [_P],
    # x, seg, ir_a, ir_b, tw, partial, ticket, y, ov_a, ov_b; n, b, cur, rows,
    # grid, approaching, is_b, counter, fading, mixer; mix_value, step; stream
    "fdl_b3_step": [_P] * 10 + [_I] * 10 + [_F] * 2 + [_P],
    # x, ring, irrev, tw, scratch, y, overlap; n, b, T, w0, kb, groups,
    # ring_rows, rows, splits; stream
    "fdl_b4_stream": [_P] * 7 + [_I] * 9 + [_P],
    "fdl_b4p_stream": [_P] * 7 + [_I] * 9 + [_P],
    # ring, table, specs, convs, pre; lanes, n, q, T; stream
    "fdl_b5_step": [_P] * 5 + [_I] * 4 + [_P],
    "fdl_b5p_step": [_P] * 5 + [_I] * 4 + [_P],
    # x, ring, hist, h_ir, t_ir, overlap, tw_b, tw_m, scratch, y, overlap_out,
    # pre_h, pre_t, w, d_pre, d_out, d_rows; voices, b, n, T, cur, cur_new,
    # meta, fwd_per, fin_per; stream
    "fdl_b6_heads": [_P] * 17 + [_I] * 9 + [_P],
}

_lib: ctypes.CDLL | None = None
_kernels: dict = {}


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


def _run_all(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands side by side; wait for all of them."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]  # drains each pipe, then waits
    return [subprocess.CompletedProcess(c, p.returncode, o, "")
            for c, p, o in zip(cmds, procs, outs)]


def build() -> Path:
    """Compile the kernels unless the library for these sources exists: one
    ``nvcc`` per source, all at once, then one link.  Raises
    ``RuntimeError`` with nvcc's output when a step fails; the compiler's
    report (registers, shared memory, spills) is kept beside the library as
    ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    cus = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in cus]
    tmp = out.with_name(f"{tag}.tmp")
    log = []
    try:
        steps = [[[nvcc, *_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o), str(s)]
                  for s, o in zip(cus, objs)],
                 [[nvcc, *_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]]]
        for cmds in steps:
            for proc in _run_all(cmds):
                log.append(f"$ {' '.join(proc.args)}\n{proc.stdout}")
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                       f"{' '.join(proc.args)}\n{proc.stdout}")
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
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


def kernel(name: str):
    """The loaded library's function ``name`` (argument types set), looked
    up once."""
    fn = _kernels.get(name)
    if fn is None:
        fn = _kernels[name] = getattr(library(), name)
    return fn


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = library().fdl_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
