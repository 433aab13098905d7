"""Native host runtime bindings (ctypes).

The card runs the spectral math; this package owns the host side of the
real-time path: the C++ SPSC ring buffer, block assembler and WAV codec in
``native/host_runtime.cpp``, the numpy boundary (:mod:`.host`), the
streaming front end (:mod:`.stream`) and the real-time dispatcher
(:mod:`.dispatcher`).

The library is built with ``g++`` at its first use, never at import, into
``build/host/`` at the repository root; its file name carries a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads the library already built.  A failed build raises ``RuntimeError``
with the compiler's output: there is no silent switch to Python.  The
pure-Python ring and assembler of :mod:`.chunker` run only where the caller
asks for them (``force_python=True``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent.parent / "native" / "host_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "host"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def library_path(source: Path = SOURCE) -> Path:
    """Where the library for ``source`` and :data:`FLAGS` is (or will be)
    built."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"libhost_runtime_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless its library exists; returns the path.
    Raises ``RuntimeError`` with the compiler's output when ``g++`` is
    missing or fails.  The file is written under a temporary name and moved
    into place, so a concurrent loader never sees half a library."""
    out = library_path(source)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host runtime is built with "
                           f"g++ {' '.join(FLAGS)}")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *FLAGS, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    """``argtypes`` and ``restype`` of every exported function."""
    c = ctypes
    f32p = c.POINTER(c.c_float)
    sigs = {
        "rb_create": (c.c_void_p, [c.c_uint32]),
        "rb_destroy": (None, [c.c_void_p]),
        "rb_capacity": (c.c_uint32, [c.c_void_p]),
        "rb_readable": (c.c_uint64, [c.c_void_p]),
        "rb_writable": (c.c_uint64, [c.c_void_p]),
        "rb_write": (c.c_uint32, [c.c_void_p, f32p, c.c_uint32]),
        "rb_read": (c.c_uint32, [c.c_void_p, f32p, c.c_uint32]),
        "ba_create": (c.c_void_p, [c.c_uint32]),
        "ba_destroy": (None, [c.c_void_p]),
        "ba_fill": (c.c_uint32, [c.c_void_p]),
        "ba_push": (c.c_uint32, [c.c_void_p, f32p, c.c_uint32, f32p, c.c_uint32,
                                 c.POINTER(c.c_uint32)]),
        "ba_reset": (None, [c.c_void_p]),
        "ba_peek": (None, [c.c_void_p, f32p]),
        "wav_write_mono16": (c.c_int32, [c.c_char_p, f32p, c.c_uint64, c.c_uint32]),
        "wav_read_mono16": (c.c_int64, [c.c_char_p, f32p, c.c_int64,
                                        c.POINTER(c.c_uint32)]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load() -> ctypes.CDLL:
    """The loaded native library, built on first use (see :func:`build`)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib
