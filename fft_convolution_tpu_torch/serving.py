"""Serving wrappers over the hand-written CUDA kernels — counterpart of
``fft_convolution_tpu/serving.py``, ported whole:

* :class:`CudaFFTConvolver` — one block per call, kernel B1
  (:mod:`.ops.cuda_engine`), or B1p with ``storage="bf16_packed"``;
* :class:`CudaTwoStageConvolver` — one block per call, kernel B2
  (:mod:`.ops.cuda_two_stage`) plus the big tail once per period;
* :class:`CudaCrossfadeConvolver` — one block per call, kernel B3
  (:mod:`.ops.cuda_crossfade`): IR morphing with the crossfade mix folded in;
* :class:`CudaStreamingConvolver` — any block-aligned length per call,
  kernel B4 (:mod:`.ops.cuda_stream`), for IRs of tens of seconds.

On a CPU device the same wrappers run the kernels' plain PyTorch versions.
Outputs are float32 tensors on the wrapper's device; no call synchronises
with the card.

The kernel step each wrapper calls is the attribute ``_step``; setting it to
the module's plain version (``block_step_plain``, ``stream_plain``) runs the
same wrapper through it on the same device, which is how the kernels are
held against it.
"""

from __future__ import annotations

import dataclasses

import torch

from .api import as_signal
from .models import crossfade, two_stage, uniform
from .ops import cuda_crossfade, cuda_engine, cuda_stream, cuda_two_stage
from .ops.fft import copy_and_pad, ir_to_spectra


def resolve_storage(storage: str, streaming: bool) -> str:
    """The table storage a wrapper runs: ``"float32"``, ``"bf16_packed"``,
    or ``"auto"``, resolved here for both wrappers by one rule.

    Rule: ``auto`` stores bf16 where a call waits on the card reading the
    table, and float32 where it waits on the host.  The streaming wrapper
    (``streaming``) reads its whole table once per 16-block tile of a
    device-bound call: with a 30 s IR at block 128, 64-block calls took
    0.230 ms with the f32 table and 0.189 ms with bf16.  The per-block
    wrapper is host-bound: at the 10 s flagship a one-launch step takes 8.3
    (B1p) and 8.7 (B1) us on the card inside a call of 0.039-0.041 (B1p)
    and 0.041-0.064 ms (B1), so bf16 would cost precision and buy nothing.
    (CUDA-event medians and profiler device time, NVIDIA H100 80GB HBM3,
    700.00 W; PERF.md §6.)
    """
    if storage == "auto":
        return "bf16_packed" if streaming else "float32"
    if storage not in cuda_engine.STORAGES:
        raise ValueError(f"storage must be 'float32', 'bf16_packed' or 'auto', "
                         f"got {storage!r}")
    return storage


def _block(x, b: int, device, name: str) -> torch.Tensor:
    x = as_signal(x, device).contiguous()
    if x.shape[0] != b:
        raise ValueError(f"{name}.process takes exactly one {b}-sample block "
                         f"(got {x.shape[0]})")
    return x


class CudaTwoStageConvolver:
    """Fused-kernel two-stage convolver for single-block real-time serving.

    Head and tail0 share one input-spectra ring inside kernel B2; the big
    tail runs as the plain PyTorch uniform engine (``torch.fft`` at the tail
    block) on the block that completes a period, as the JAX package runs it
    outside any Pallas kernel (``src/fft_convolver.rs:427-494``).

    Requires ``max_response_length > tail_block`` (otherwise use
    :class:`CudaFFTConvolver`) and a power-of-two ``block_size``.
    """

    def __init__(self, response, block_size: int, max_response_length: int,
                 device="cuda"):
        cuda_engine.check_block(block_size)
        self.device = torch.device(device)
        cfg, state = two_stage.init(as_signal(response, self.device), block_size,
                                    max_response_length, self.device)
        if cfg.tail0 is None:
            raise ValueError("IR shorter than one tail block: use CudaFFTConvolver")
        self.cfg = cfg
        n, b, p = cfg.head.seg_count, cfg.head_block, cfg.period
        assert n == p, "head ring must span exactly one tail period"
        self.consts = cuda_two_stage.build_consts(state.head.segments_ir,
                                                  state.tail0.segments_ir)
        self.fstate = cuda_two_stage.zero_state(n, b, self.device)
        self.tail_state = state.tail   # uniform engine at the tail block (may be empty)
        self.buffers = {k: torch.zeros((p, b), device=self.device)
                        for k in cuda_two_stage.BUFFERS}
        self.row = 0  # host shadow of the intra-period position
        self._step = cuda_two_stage.block_step

    def process(self, input) -> torch.Tensor:
        cfg = self.cfg
        x = _block(input, cfg.head_block, self.device, "CudaTwoStageConvolver")
        bufs = self.buffers
        y = self._step(self.consts, self.fstate, bufs, self.row, x)
        if self.row == cfg.period - 1:
            # period end (serving.py:146-167 of the JAX package): swap tail0's
            # double buffer, then run the big tail over the period input
            bufs["precalc0"], bufs["tail_output0"] = bufs["tail_output0"], bufs["precalc0"]
            if cfg.tail is not None:
                big = uniform.process_block(cfg.tail, self.tail_state,
                                            bufs["tail_input"].reshape(-1))
                bufs["precalc"] = bufs["tail_output"]
                bufs["tail_output"] = big.reshape(cfg.period, cfg.head_block)
        self.row = (self.row + 1) % cfg.period
        return y

    def update(self, response) -> None:
        raise NotImplementedError(
            "update is unimplemented upstream (src/fft_convolver.rs:408-410)"
        )

    def reset(self) -> None:
        self.fstate = cuda_two_stage.zero_state(self.cfg.head.seg_count,
                                                self.cfg.head_block, self.device)
        uniform.reset(self.tail_state)
        for v in self.buffers.values():
            v.zero_()
        self.row = 0

    def snapshot(self):
        """A value copy of the serving state."""
        return (self.fstate.clone(), self.tail_state.clone(),
                {k: v.clone() for k, v in self.buffers.items()}, self.row)

    def restore(self, snap) -> None:
        fstate, tail_state, bufs, self.row = snap
        self.fstate, self.tail_state = fstate.clone(), tail_state.clone()
        self.buffers = {k: v.clone() for k, v in bufs.items()}

    def clone(self) -> "CudaTwoStageConvolver":
        other = object.__new__(CudaTwoStageConvolver)
        other.__dict__.update(self.__dict__)
        other.restore(self.snapshot())
        return other


class CudaFFTConvolver:
    """Fused-kernel uniform convolver for single-block real-time serving.

    The ring must stay full (``active == seg_count``, kernel B1's
    precondition): ``update`` rebuilds the IR table with the new response
    zero-padded to the same segment count and zeroes the pending overlap.
    ``storage="bf16_packed"`` keeps ring and table as bf16 pairs (kernel
    B1p, half the bytes per step, ~1e-3 relative on the output's history
    terms); ``"auto"`` follows :func:`resolve_storage`.
    """

    def __init__(self, response, block_size: int, max_response_length: int,
                 device="cuda", storage: str = "float32"):
        self.storage = resolve_storage(storage, streaming=False)
        self.device = torch.device(device)
        self.cfg, state = uniform.init(as_signal(response, self.device), block_size,
                                       max_response_length, self.device)
        cuda_engine.check_block(self.cfg.block_size)
        self.consts, self.state = cuda_engine.from_uniform(self.cfg, state, self.storage)
        self._step = (cuda_engine.block_step_packed if self.storage == "bf16_packed"
                      else cuda_engine.block_step)

    def update(self, response) -> None:
        """IR swap (``src/fft_convolver.rs:174-213``) at full ring."""
        response = as_signal(response, self.device)
        if response.shape[0] > self.cfg.ir_len:
            raise ValueError("New impulse response is longer than initialized length")
        padded = copy_and_pad(response, self.cfg.seg_count * self.cfg.block_size)
        self.consts.ir = cuda_engine.store(
            ir_to_spectra(padded, self.cfg.block_size, self.cfg.seg_count), self.storage)
        self.state.overlap.zero_()

    def reset(self) -> None:
        # in place: the state keeps its own arrival counter (0 between steps);
        # snapshots and clones start without one
        self.state.segments.zero_()
        self.state.overlap.zero_()
        self.state.current = 0

    def process(self, input) -> torch.Tensor:
        x = _block(input, self.cfg.block_size, self.device, "CudaFFTConvolver")
        return self._step(self.consts, self.state, x)

    def snapshot(self) -> cuda_engine.FDLState:
        return self.state.clone()

    def restore(self, snap: cuda_engine.FDLState) -> None:
        self.state = snap.clone()

    def clone(self) -> "CudaFFTConvolver":
        other = object.__new__(CudaFFTConvolver)
        other.__dict__.update(self.__dict__)
        other.consts = dataclasses.replace(self.consts)  # update replaces, never writes, ir
        other.state = self.state.clone()
        return other


class CudaCrossfadeConvolver:
    """Morph-while-serving: kernel B3 runs both engines over one shared ring
    and mixes them per sample, one kernel step per block — counterpart of
    ``PallasCrossfadeConvolver`` and the serving form of
    :class:`~.api_crossfade.CrossfadeConvolver`
    (``src/crossfade_convolver.rs:3-105``).

    ``update`` rebuilds only the INACTIVE engine's table, zeroes only its
    overlap, keeps the shared ring (the input history) and fades toward it;
    an update that lands mid-fade parks in the single pending slot
    (``:51-64``).  ``hold_samples = min(block_size, max_response_length)``:
    the hold block covers the updated engine's zeroed overlap.  The ring
    plus two tables must fit the card's memory, nothing smaller: the
    flagship 10 s / 48 kHz IR at block 128 is 11.6 MB.
    """

    def __init__(self, response, block_size: int, max_response_length: int,
                 crossfade_samples: int, device="cuda", mixer: str = "raised_cosine"):
        self.device = torch.device(device)
        self.cfg, state = uniform.init(as_signal(response, self.device), block_size,
                                       max_response_length, self.device)
        cuda_engine.check_block(self.cfg.block_size)
        self.consts = cuda_crossfade.build_consts(state.segments_ir, state.segments_ir)
        self.state = cuda_crossfade.zero_state(self.cfg.seg_count, self.cfg.block_size,
                                               self.device)
        self.cf_cfg = crossfade.CrossfaderConfig(
            fading_samples=crossfade_samples,
            hold_samples=min(self.cfg.block_size, max_response_length), mixer=mixer)
        self.cf_state = crossfade.new_state(self.cf_cfg)
        self.stored_response = torch.zeros(max_response_length, device=self.device)
        self.response_pending = False
        self._step = cuda_crossfade.block_step

    def is_crossfading(self) -> bool:
        return self.cf_state.approaching

    def _swap(self, response) -> None:
        """Rebuild the inactive table, zero its overlap, fade toward it
        (``src/crossfade_convolver.rs:94-105``)."""
        response = as_signal(response, self.device)
        if response.shape[0] > self.cfg.ir_len:
            raise ValueError("New impulse response is longer than initialized length")
        padded = copy_and_pad(response, self.cfg.seg_count * self.cfg.block_size)
        spec = ir_to_spectra(padded, self.cfg.block_size, self.cfg.seg_count)
        if self.cf_state.target == crossfade.TARGET_A:
            self.consts.ir_b = spec
            self.state.overlap_b.zero_()
            target = crossfade.TARGET_B
        else:
            self.consts.ir_a = spec
            self.state.overlap_a.zero_()
            target = crossfade.TARGET_A
        self.cf_state = crossfade.fade_into(self.cf_cfg, self.cf_state, target)

    def update(self, response) -> None:
        """(``src/crossfade_convolver.rs:51-64``) — single pending slot;
        updates while fading overwrite the stored response."""
        if not self.is_crossfading():
            self._swap(response)
            self.response_pending = False
            return
        response = as_signal(response, self.device)
        if response.shape[0] > self.stored_response.shape[0]:
            raise ValueError("response longer than stored-response capacity")
        self.stored_response.zero_()
        self.stored_response[:response.shape[0]] = response
        self.response_pending = True

    def process(self, input) -> torch.Tensor:
        """One block in, one mixed block out (``:66-78``): a pending swap
        applies at block top."""
        if not self.is_crossfading() and self.response_pending:
            self._swap(self.stored_response)
            self.response_pending = False
        x = _block(input, self.cfg.block_size, self.device, "CudaCrossfadeConvolver")
        self.cf_state, y = self._step(self.consts, self.state, self.cf_cfg,
                                      self.cf_state, x)
        return y

    def reset(self) -> None:
        """``todo!()`` upstream (``src/crossfade_convolver.rs:80-82``)."""
        raise NotImplementedError(
            "CrossfadeConvolver.reset is unimplemented upstream "
            "(src/crossfade_convolver.rs:80-82); reset_extension() is the "
            "documented extension")

    def reset_extension(self) -> None:
        """EXTENSION (not reference surface): zero ring and overlaps, return
        the crossfader to Reached(A), drop any pending response; the tables
        stay as they are, as in the JAX package."""
        self.state = cuda_crossfade.zero_state(self.cfg.seg_count, self.cfg.block_size,
                                               self.device)
        self.cf_state = crossfade.new_state(self.cf_cfg)
        self.stored_response.zero_()
        self.response_pending = False

    def snapshot(self):
        return (dataclasses.replace(self.consts), self.state.clone(), self.cf_state,
                self.stored_response.clone(), self.response_pending)

    def restore(self, snap) -> None:
        consts, state, self.cf_state, stored, self.response_pending = snap
        self.consts = dataclasses.replace(consts)
        self.state = state.clone()
        self.stored_response = stored.clone()

    def clone(self) -> "CudaCrossfadeConvolver":
        other = object.__new__(CudaCrossfadeConvolver)
        other.__dict__.update(self.__dict__)
        other.restore(self.snapshot())  # _swap replaces, never writes, the tables
        return other


class CudaStreamingConvolver:
    """Long-IR uniform convolver over kernel B4: ``process`` takes any
    block-aligned length (T blocks in one kernel call), for IRs of tens of
    seconds — counterpart of ``PallasStreamingConvolver``.

    ``seg_count`` pads to a multiple of ``chunk`` with zero-IR rows,
    equivalent to a reference convolver with a padded
    ``max_response_length`` (``src/fft_convolver.rs:111-118``), and keeps
    the JAX package's state layout.  ``storage="bf16_packed"`` stores only
    the table in bf16 (the ring stays complex64); ``"auto"`` follows
    :func:`resolve_storage`.  No limit on the IR besides the card's memory.
    """

    def __init__(self, response, block_size: int, max_response_length: int,
                 chunk: int = 512, device="cuda", storage: str = "float32"):
        self.storage = resolve_storage(storage, streaming=True)
        self.device = torch.device(device)
        response = as_signal(response, self.device)
        if max_response_length < response.shape[0]:
            raise ValueError("max_response_length must be at least the length of the "
                             "initial impulse response")
        cfg0 = uniform.make_config(block_size, max_response_length)
        cuda_engine.check_block(cfg0.block_size)
        self.chunk = min(chunk, cfg0.seg_count)
        n = cuda_stream.padded_seg_count(cfg0.seg_count, self.chunk)
        self.cfg, ustate = uniform.init(response, block_size, n * cfg0.block_size,
                                        self.device)
        self._declared_max = max_response_length
        self.consts = cuda_stream.build_consts(ustate.segments_ir,
                                               self.storage == "bf16_packed")
        self.state = cuda_stream.zero_state(n, self.cfg.block_size, self.device)
        self._step = (cuda_stream.stream_packed if self.storage == "bf16_packed"
                      else cuda_stream.stream)

    def process(self, input) -> torch.Tensor:
        x = as_signal(input, self.device).contiguous()
        b = self.cfg.block_size
        if x.shape[0] % b:
            raise ValueError(f"CudaStreamingConvolver.process takes block-aligned input "
                             f"(multiples of {b} samples, got {x.shape[0]})")
        if x.shape[0] == 0:
            return x
        return self._step(self.consts, self.state, x.reshape(-1, b)).reshape(-1)

    def update(self, response) -> None:
        """IR swap (``src/fft_convolver.rs:174-213``): rebuild the reversed
        table over the full padded segment budget (the full-ring
        precondition), zero the pending overlap, keep the ring."""
        response = as_signal(response, self.device)
        if response.shape[0] > self._declared_max:
            raise ValueError("New impulse response is longer than initialized length")
        padded = copy_and_pad(response, self.cfg.seg_count * self.cfg.block_size)
        self.consts = cuda_stream.build_consts(
            ir_to_spectra(padded, self.cfg.block_size, self.cfg.seg_count),
            self.storage == "bf16_packed")
        self.state.overlap.zero_()

    def reset(self) -> None:
        self.state = cuda_stream.zero_state(self.cfg.seg_count, self.cfg.block_size,
                                            self.device)

    def snapshot(self) -> cuda_stream.StreamState:
        return self.state.clone()

    def restore(self, snap: cuda_stream.StreamState) -> None:
        self.state = snap.clone()

    def clone(self) -> "CudaStreamingConvolver":
        other = object.__new__(CudaStreamingConvolver)
        other.__dict__.update(self.__dict__)  # update replaces, never writes, consts
        other.state = self.state.clone()
        return other
