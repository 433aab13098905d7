"""Stateful wrapper for the two-stage convolver — counterpart of
``fft_convolution_tpu/api_two_stage.py``, the ``Convolution``
implementation of ``TwoStageFFTConvolver`` (``src/fft_convolver.rs:339-512``).
"""

from __future__ import annotations

import torch

from .api import as_signal
from .models import two_stage
from .ops.fft import copy_and_pad


class TwoStageFFTConvolver:
    """Non-uniform (head/tail) partitioned convolution engine.

    The reference restricts ``process`` to ``input.len() <= head_block_size``
    (``src/fft_convolver.rs:414``); this wrapper, like the JAX one, also
    takes longer inputs of any length (PARITY.md divergence 1).  Block-
    aligned calls run the head-block loop; the JAX package's period-aligned
    batched stream is still to port, and its outputs are the same.
    """

    def __init__(self, response, block_size: int, max_response_length: int,
                 device="cpu"):
        if block_size <= 0 or block_size & (block_size - 1):
            # the schedule indexes period buffers at head-block granularity
            # (PARITY.md divergence 2)
            raise ValueError("TwoStageFFTConvolver requires a power-of-two block_size")
        self.device = torch.device(device)
        self.cfg, self.state = two_stage.init(as_signal(response, self.device),
                                              block_size, max_response_length,
                                              self.device)
        self._fill = 0  # host shadow of tail_fill % head_block

    def _capacity(self) -> int:
        """The init ``max_response_length``, rebuilt from the stage IR caps
        (``src/fft_convolver.rs:352-384``)."""
        cfg = self.cfg
        if cfg.tail is not None:
            return 2 * cfg.tail_block + cfg.tail.ir_len
        if cfg.tail0 is not None:
            return cfg.tail_block + cfg.tail0.ir_len
        return cfg.head.ir_len

    def update(self, response) -> None:
        """``todo!()`` in the reference (``src/fft_convolver.rs:408-410``)."""
        raise NotImplementedError(
            "TwoStageFFTConvolver.update is unimplemented upstream "
            "(src/fft_convolver.rs:408-410); use update_extension"
        )

    def update_extension(self, response) -> None:
        """EXTENSION (not reference surface): stage-wise IR swap, semantics at
        :func:`models.two_stage.update`."""
        response = as_signal(response, self.device)
        cap = self._capacity()
        if response.shape[0] > cap:
            raise ValueError("New impulse response is longer than initialized length")
        two_stage.update(self.cfg, self.state, copy_and_pad(response, cap),
                         response.shape[0])

    def reset(self) -> None:
        two_stage.reset(self.cfg, self.state)
        self._fill = 0

    def process(self, input) -> torch.Tensor:
        x = as_signal(input, self.device)
        b = self.cfg.head_block
        if x.shape[0] == 0:
            return x
        if self._fill == 0 and x.shape[0] % b == 0:
            ys = [two_stage.process_block(self.cfg, self.state, blk)
                  for blk in x.split(b)]
            return torch.cat(ys)
        return self._process_chunked(x)

    def _process_chunked(self, x: torch.Tensor) -> torch.Tensor:
        b = self.cfg.head_block
        n = x.shape[0]
        out = torch.empty(n, device=self.device)
        processed = 0
        while processed < n:
            offset = self._fill
            processing = min(n - processed, b - offset)
            y_full = two_stage.process_partial(
                self.cfg, self.state, x[processed:processed + processing], processing)
            out[processed:processed + processing] = y_full[offset:offset + processing]
            self._fill = (offset + processing) % b
            processed += processing
        return out

    def snapshot(self):
        return (self.state.clone(), self._fill)

    def restore(self, snap) -> None:
        state, self._fill = snap
        self.state = state.clone()

    def clone(self) -> "TwoStageFFTConvolver":
        other = object.__new__(TwoStageFFTConvolver)
        other.device = self.device
        other.cfg = self.cfg
        other.state = self.state.clone()
        other._fill = self._fill
        return other
