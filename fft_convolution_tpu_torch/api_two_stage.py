"""Stateful wrapper for the two-stage convolver — counterpart of
``fft_convolution_tpu/api_two_stage.py``, the ``Convolution``
implementation of ``TwoStageFFTConvolver`` (``src/fft_convolver.rs:339-512``).
"""

from __future__ import annotations

import torch

from .api import as_signal
from .models import two_stage, uniform
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

    The whole periods take the fused head+tail0 front end while its
    host-int guard holds, and the big tail keeps its history in the CHRONO
    convention (:func:`.models.two_stage.tail_to_chrono`) while its ring is
    full and the call fits the history buffer (JAX
    ``api_two_stage.py:231-281``).  Every ring consumer (the block loop,
    sub-block calls, ``update_extension``, ``reset``, ``snapshot``,
    ``restore``, ``clone``) converts the tail back first, so snapshots and
    clones hold the ring convention.
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
        # two_stage.stream_khats per (aligned call length T, CHRONO tail):
        # input-independent between IR updates
        self._khat_cache: dict[tuple[int, bool], dict] = {}
        # the big tail's CHRONO history while aligned calls run (None on the
        # ring), its row count, and whether the tail ring is full: after an
        # update that shrinks it, the reference's ring scrambles history
        # modulo the new count, which only the ring paths reproduce
        self._tail_chrono: torch.Tensor | None = None
        self._tail_pos = 0
        self._tail_full = self.cfg.tail is not None
        self._chrono_h_cap = (uniform.chrono_capacity(self.cfg.tail)
                              if self.cfg.tail is not None and self.cfg.tail.seg_count > 1
                              else 0)

    def _capacity(self) -> int:
        """The init ``max_response_length``, rebuilt from the stage IR caps
        (``src/fft_convolver.rs:352-384``)."""
        cfg = self.cfg
        if cfg.tail is not None:
            return 2 * cfg.tail_block + cfg.tail.ir_len
        if cfg.tail0 is not None:
            return cfg.tail_block + cfg.tail0.ir_len
        return cfg.head.ir_len

    def _exit_chrono(self) -> None:
        """The big tail back to its ring before any ring consumer."""
        if self._tail_chrono is not None:
            two_stage.tail_from_chrono(self.cfg, self.state,
                                       (self._tail_chrono, self._tail_pos))
            self._tail_chrono = None
            self._tail_pos = 0

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
        self._exit_chrono()
        two_stage.update(self.cfg, self.state, copy_and_pad(response, cap),
                         response.shape[0])
        self._khat_cache.clear()  # built from the old stage tables
        if self.cfg.tail is not None:
            t_len = max(response.shape[0] - 2 * self.cfg.tail_block, 0)
            self._tail_full = -(-t_len // self.cfg.tail_block) == self.cfg.tail.seg_count

    def reset(self) -> None:
        self._exit_chrono()
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
        self._exit_chrono()
        return torch.cat([two_stage.process_block(self.cfg, self.state, blk)
                          for blk in x.split(self.cfg.head_block)])

    def _process_aligned(self, x: torch.Tensor) -> torch.Tensor:
        """Whole periods at a period boundary, through the aligned stream and
        the cached :func:`.models.two_stage.stream_khats` of their length:
        the big tail on its CHRONO history when the tail ring is full and the
        call fits the buffer after a compaction, on its ring otherwise."""
        cfg = self.cfg
        t = x.shape[0] // cfg.head_block
        q = t // cfg.period
        h_cap = self._chrono_h_cap
        use_chrono = (h_cap > 0 and self._tail_full
                      and uniform.chrono_fits(cfg.tail, h_cap, cfg.tail.seg_count - 1, q))
        khats = self._khat_cache.get((t, use_chrono))
        if khats is None:
            khats = self._khat_cache[(t, use_chrono)] = two_stage.stream_khats(
                cfg, self.state, t, want_tail=True if use_chrono else None)
        if not use_chrono:
            self._exit_chrono()
            return two_stage.process_stream_aligned(cfg, self.state, x.view(t, -1),
                                                    khats).reshape(-1)
        if self._tail_chrono is None:
            self._tail_chrono, self._tail_pos = two_stage.tail_to_chrono(cfg, self.state, h_cap)
        elif not uniform.chrono_fits(cfg.tail, h_cap, self._tail_pos, q):
            self._tail_pos = two_stage.tail_chrono_compact(cfg, (self._tail_chrono,
                                                                 self._tail_pos))
        y = two_stage.process_stream_aligned(cfg, self.state, x.view(t, -1), khats,
                                             tail_chrono=(self._tail_chrono, self._tail_pos))
        self._tail_pos += q
        return y.reshape(-1)

    def _process_chunked(self, x: torch.Tensor) -> torch.Tensor:
        self._exit_chrono()
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
        self._exit_chrono()
        return (self.state.clone(), self._fill)

    def restore(self, snap) -> None:
        state, self._fill = snap
        self.state = state.clone()
        self._tail_chrono, self._tail_pos = None, 0  # the snapshot holds the ring
        self._tail_full = (self.cfg.tail is not None
                           and state.tail.active_segs == self.cfg.tail.seg_count)
        self._khat_cache.clear()  # the snapshot may hold other stage tables

    def clone(self) -> "TwoStageFFTConvolver":
        self._exit_chrono()  # a shared history would be written by both
        other = object.__new__(TwoStageFFTConvolver)
        other.__dict__.update(self.__dict__)
        other.state = self.state.clone()
        other._khat_cache = dict(self._khat_cache)  # entries are never written in place
        return other
