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
    takes longer inputs of any length (PARITY.md divergence 1).  A block-
    aligned call is split at period boundaries: its whole periods stream at
    once (:func:`.models.two_stage.process_stream_aligned`, with the stages'
    kernel meta-spectra cached per call length), the ragged blocks before
    and after them run the head-block loop.
    """

    def __init__(self, response, block_size: int, max_response_length: int,
                 device="cuda"):
        if block_size <= 0 or block_size & (block_size - 1):
            # the schedule indexes period buffers at head-block granularity
            # (PARITY.md divergence 2)
            raise ValueError("TwoStageFFTConvolver requires a power-of-two block_size")
        self.device = torch.device(device)
        self.cfg, self.state = two_stage.init(as_signal(response, self.device),
                                              block_size, max_response_length,
                                              self.device)
        self._fill = 0  # host shadow of tail_fill % head_block
        # two_stage.stream_khats per aligned call length T: input-independent
        # between IR updates
        self._khat_cache: dict[int, dict] = {}

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
        self._khat_cache.clear()  # built from the old stage tables

    def reset(self) -> None:
        two_stage.reset(self.cfg, self.state)
        self._fill = 0

    def process(self, input) -> torch.Tensor:
        """Any-length processing.  Block-aligned calls split at period
        boundaries (JAX ``api_two_stage.py:207-228``): the blocks up to the
        next period boundary, the whole periods after it (one aligned
        stream), then the remaining blocks.  The period position is the
        state's own ``tail_fill``, a host int."""
        x = as_signal(input, self.device)
        b, tb = self.cfg.head_block, self.cfg.tail_block
        n = x.shape[0]
        if n == 0:
            return x
        if self._fill != 0 or n % b != 0:
            return self._process_chunked(x)
        fill = self.state.tail_fill
        pre = 0 if fill == 0 else min(n, tb - fill)
        mid = pre + (n - pre) // tb * tb
        ys = []
        if pre:
            ys.append(self._process_blocks(x[:pre]))
        if mid > pre:
            ys.append(self._process_aligned(x[pre:mid]))
        if n > mid:
            ys.append(self._process_blocks(x[mid:]))
        return ys[0] if len(ys) == 1 else torch.cat(ys)

    def _process_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """The head-block loop (the reference schedule, block by block)."""
        return torch.cat([two_stage.process_block(self.cfg, self.state, blk)
                          for blk in x.split(self.cfg.head_block)])

    def _process_aligned(self, x: torch.Tensor) -> torch.Tensor:
        """Whole periods at a period boundary, through the aligned stream and
        the cached :func:`.models.two_stage.stream_khats` of their length."""
        t = x.shape[0] // self.cfg.head_block
        khats = self._khat_cache.get(t)
        if khats is None:
            khats = self._khat_cache[t] = two_stage.stream_khats(self.cfg, self.state, t)
        return two_stage.process_stream_aligned(self.cfg, self.state, x.view(t, -1),
                                                khats).reshape(-1)

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
        self._khat_cache.clear()  # the snapshot may hold other stage tables

    def clone(self) -> "TwoStageFFTConvolver":
        other = object.__new__(TwoStageFFTConvolver)
        other.device = self.device
        other.cfg = self.cfg
        other.state = self.state.clone()
        other._fill = self._fill
        other._khat_cache = dict(self._khat_cache)  # entries are never written in place
        return other
