"""Public stateful API — counterpart of ``fft_convolution_tpu/api.py`` and of
the reference's ``Convolution`` trait (``src/lib.rs:5-14``):

* ``init(response, max_block_size, max_response_length)`` — constructor;
* ``update(response)`` — IR swap that keeps the input history;
* ``reset()`` — clear the input side;
* ``process(input) -> output`` — any input length, chunked against the
  internal block buffer exactly like the reference while-loop
  (``src/fft_convolver.rs:222-294``).

Inputs are anything ``torch.as_tensor`` takes; outputs are float32 tensors
on the engine's ``device``.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from .models import uniform
from .ops.fft import copy_and_pad


@runtime_checkable
class Convolution(Protocol):
    """Python protocol mirroring ``trait Convolution`` (``src/lib.rs:5-14``)."""

    def update(self, response) -> None: ...
    def reset(self) -> None: ...
    def process(self, input) -> torch.Tensor: ...


def as_signal(x, device) -> torch.Tensor:
    """A 1-D float32 tensor on ``device`` from any array-like."""
    return torch.as_tensor(x, dtype=torch.float32).to(device).reshape(-1)


class FFTConvolver:
    """Uniform partitioned convolution engine with the exact ``FFTConvolver``
    contract (``src/fft_convolver.rs:86-307``)."""

    def __init__(self, response, block_size: int, max_response_length: int,
                 device="cpu"):
        self.device = torch.device(device)
        self.cfg, self.state = uniform.init(as_signal(response, self.device),
                                            block_size, max_response_length,
                                            self.device)
        # host shadow of input_fill that drives the chunker, kept as the JAX
        # wrapper keeps it (it advances even while the engine is inactive)
        self._fill = 0

    def update(self, response) -> None:
        """IR swap (``src/fft_convolver.rs:174-213``)."""
        response = as_signal(response, self.device)
        new_len = response.shape[0]
        if new_len > self.cfg.ir_len:
            raise ValueError("New impulse response is longer than initialized length")
        if self.cfg.ir_len == 0:
            return
        padded = copy_and_pad(response, self.cfg.seg_count * self.cfg.block_size)
        uniform.update(self.cfg, self.state, padded, new_len)

    def reset(self) -> None:
        uniform.reset(self.state)
        self._fill = 0

    def process(self, input) -> torch.Tensor:
        """Any-length processing (``src/fft_convolver.rs:215-295``).  Block-
        aligned calls run the block loop; other sizes run the sub-block
        chunker.  (The JAX package's batched stream for aligned calls is
        still to port; its outputs are the same.)"""
        x = as_signal(input, self.device)
        b = self.cfg.block_size
        n = x.shape[0]
        if n == 0:
            return x
        if self._fill == 0 and n % b == 0:
            ys = [uniform.process_block(self.cfg, self.state, blk)
                  for blk in x.split(b)]
            return torch.cat(ys)
        return self._process_chunked(x)

    def _process_chunked(self, x: torch.Tensor) -> torch.Tensor:
        b = self.cfg.block_size
        n = x.shape[0]
        out = torch.empty(n, device=self.device)
        processed = 0
        while processed < n:
            offset = self._fill
            processing = min(n - processed, b - offset)
            y_full = uniform.process_partial(
                self.cfg, self.state, x[processed:processed + processing], processing)
            out[processed:processed + processing] = y_full[offset:offset + processing]
            self._fill = (offset + processing) % b
            processed += processing
        return out

    # -- state management (the reference's `Clone`, `src/lib.rs:5`) ---------

    def snapshot(self):
        """A value copy of the engine state."""
        return (self.state.clone(), self._fill)

    def restore(self, snap) -> None:
        state, self._fill = snap
        self.state = state.clone()

    def clone(self) -> "FFTConvolver":
        other = object.__new__(FFTConvolver)
        other.device = self.device
        other.cfg = self.cfg
        other.state = self.state.clone()
        other._fill = self._fill
        return other
