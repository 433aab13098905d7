"""Block assembly and ring-buffer primitives — counterpart of
``fft_convolution_tpu/runtime/chunker.py``, numpy only.

These are the host-side pieces of the real-time path: an audio host delivers
arbitrary-size callbacks; the per-block kernels want fixed ``block_size``
blocks.  The :class:`BlockAssembler` is the standalone version of the
chunking the reference does inline in ``process``
(``src/fft_convolver.rs:222-231``: ``processing = min(remaining, block -
fill)``); the :class:`RingBuffer` is the SPSC queue between a real-time
callback thread and the dispatch thread (the concurrency the reference
leaves as a comment at ``src/fft_convolver.rs:478``).

Both run on the native library (:func:`.load`, which raises if it cannot be
built).  ``force_python=True`` runs the same semantics in numpy instead: the
caller's explicit choice (the tests hold the two against each other), never
a fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import load


def _f32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class RingBuffer:
    """Lock-free SPSC float ring buffer (native C++, or numpy with
    ``force_python=True``)."""

    def __init__(self, min_capacity: int, force_python: bool = False):
        self._lib = None if force_python else load()
        if self._lib is not None:
            self._h = self._lib.rb_create(min_capacity)
            self._cap = self._lib.rb_capacity(self._h)
        else:
            cap = 1
            while cap < max(2, min_capacity):
                cap <<= 1
            self._cap = cap
            self._data = np.zeros(cap, np.float32)
            self._head = 0
            self._tail = 0

    @property
    def capacity(self) -> int:
        return self._cap

    def readable(self) -> int:
        if self._lib is not None:
            return int(self._lib.rb_readable(self._h))
        return self._head - self._tail

    def writable(self) -> int:
        return self._cap - self.readable()

    def write(self, samples: np.ndarray) -> int:
        """Producer side: returns how many samples were taken (never blocks)."""
        samples = np.ascontiguousarray(samples, np.float32)
        if self._lib is not None:
            return int(self._lib.rb_write(self._h, _f32p(samples), len(samples)))
        n = min(len(samples), self.writable())
        idx = (self._head + np.arange(n)) & (self._cap - 1)
        self._data[idx] = samples[:n]
        self._head += n
        return n

    def read(self, n: int) -> np.ndarray:
        """Consumer side: up to ``n`` samples (never blocks)."""
        out = np.empty(n, np.float32)
        if self._lib is not None:
            got = int(self._lib.rb_read(self._h, _f32p(out), n))
            return out[:got]
        got = min(n, self.readable())
        idx = (self._tail + np.arange(got)) & (self._cap - 1)
        out[:got] = self._data[idx]
        self._tail += got
        return out[:got]

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.rb_destroy(self._h)


class BlockAssembler:
    """Arbitrary-size pushes in, fixed ``block_size`` blocks out."""

    def __init__(self, block_size: int, force_python: bool = False):
        self.block_size = block_size
        self._lib = None if force_python else load()
        if self._lib is not None:
            self._h = self._lib.ba_create(block_size)
        else:
            self._buf = np.zeros(block_size, np.float32)
            self._fill = 0

    @property
    def fill(self) -> int:
        if self._lib is not None:
            return int(self._lib.ba_fill(self._h))
        return self._fill

    def push(self, samples: np.ndarray) -> np.ndarray:
        """Returns completed blocks as ``[k, block_size]`` (k may be 0)."""
        samples = np.ascontiguousarray(samples, np.float32)
        n = len(samples)
        max_blocks = (self.fill + n) // self.block_size
        out = np.empty((max_blocks, self.block_size), np.float32)
        if self._lib is not None:
            consumed = ctypes.c_uint32(0)
            done = int(self._lib.ba_push(
                self._h, _f32p(samples), n, _f32p(out.reshape(-1)),
                max_blocks, ctypes.byref(consumed),
            ))
            if consumed.value != n:  # max_blocks is exact: the assembler never runs out
                raise RuntimeError(f"assembler took {consumed.value} of {n} samples")
            return out[:done]
        done = 0
        used = 0
        while used < n:
            take = min(n - used, self.block_size - self._fill)
            self._buf[self._fill:self._fill + take] = samples[used:used + take]
            self._fill += take
            used += take
            if self._fill == self.block_size:
                out[done] = self._buf
                # zero on completion (src/fft_convolver.rs:280): peek() of a
                # partial block is exactly the zero-padded FFT input
                self._buf[:] = 0
                self._fill = 0
                done += 1
        return out[:done]

    def peek(self) -> np.ndarray:
        """Current partial block, zero-padded to block_size."""
        if self._lib is not None:
            out = np.empty(self.block_size, np.float32)
            self._lib.ba_peek(self._h, _f32p(out))
            return out
        return self._buf.copy()

    def reset(self) -> None:
        if self._lib is not None:
            self._lib.ba_reset(self._h)
        else:
            self._buf[:] = 0
            self._fill = 0

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.ba_destroy(self._h)
