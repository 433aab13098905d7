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
Outputs are float32 tensors on the wrapper's device; no ``process`` call
synchronises with the card (the two-stage wrapper's construction, ``reset``,
``restore`` and ``clone`` do, around its CUDA-graph capture).  Each wrapper
checks the tensors it owns where it sets them and launches its kernel
through the ops module's ``block_step_prepared`` form, which checks only
the host ints.

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
    block) at the block that completes a period, as the JAX package runs it
    outside any Pallas kernel (``src/fft_convolver.rs:427-494``).  Its output
    is first read one period later (through ``precalc``), so on the card it
    runs off the caller's stream (``src/fft_convolver.rs:478``: "background
    thread"):

    * at a period end the current stream records an event after B2's step;
      the wrapper's own ``side_stream`` waits on it, replays the big-tail
      step as a CUDA graph (``uniform.process_block_at``: the tail ring's
      head lives in a one-element card tensor, so one graph serves every
      ring position; one graph for each of the two period-buffer phases),
      and records ``tail done``;
    * the current stream waits on ``tail done`` (a device-side wait, never a
      host sync) at the next period end, before the first step that reads
      that output or refills that input; a host sync of the current stream
      (``runtime.HostEngine``) therefore never waits on the big tail;
    * every period buffer is a fixed pair that rotates by a phase index:
      tail0's output and precalc, the big tail's, and the period input
      (B2 writes one half while the side stream reads the other);
    * ``reset``, ``snapshot``, ``restore`` and ``clone`` first make the
      current stream wait on ``tail done``, so a snapshot holds the state
      after the last big-tail step; ``reset`` and ``restore`` take fresh
      tensors, check them, and capture the graphs again over them.

    ``tail_replays`` counts big-tail graph replays and ``tail_inline`` the
    big-tail steps run in line, which happens only on a CPU device (no
    stream, no graph; the same buffer rotation).  A failed capture, replay or
    launch raises; nothing falls back to the eager form.

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
        self._step = cuda_two_stage.block_step_prepared
        self.tail_replays = self.tail_inline = 0
        self._new_stream()
        self._install(cuda_two_stage.zero_state(n, b, self.device), state.tail,
                      {k: torch.zeros((p, b), device=self.device)
                       for k in cuda_two_stage.BUFFERS}, 0)

    def _new_stream(self) -> None:
        """The wrapper's own side stream and ``tail done`` event (none on
        the CPU); no graph yet."""
        cuda = self.device.type == "cuda"
        self.side_stream = torch.cuda.Stream(self.device) if cuda else None
        self._tail_done = torch.cuda.Event() if cuda else None
        self._ready = torch.cuda.Event() if cuda else None
        self._graphs = None

    @property
    def buffers(self) -> dict:
        """The period buffers of the current phase, by the names of
        :data:`~.ops.cuda_two_stage.BUFFERS` (views of the owned pairs)."""
        return self._views[self._phase]

    def _settle(self) -> None:
        """Make the current stream wait until the last big-tail step is done."""
        if self._tail_done is not None:
            torch.cuda.current_stream(self.device).wait_event(self._tail_done)

    def _install(self, fstate, tail_state, bufs: dict, row: int) -> None:
        """Take ``fstate``, ``tail_state`` and the period buffers ``bufs``
        (copies) as the serving state at period row ``row``, after checking
        them; then capture the big-tail graphs over them.  Raises
        ``ValueError`` before anything is replaced."""
        cfg, dev = self.cfg, self.device
        p, b = cfg.period, cfg.head_block
        if not 0 <= row < p:
            raise ValueError(f"row {row} outside the period of {p}")
        cuda_two_stage.check_operands(self.consts, fstate, bufs, dev)
        if cfg.tail is not None:
            _check_tail(cfg.tail, tail_state, cuda_engine.tensor_device(dev))
        if self._graphs is not None:  # no replay of the old graphs in flight
            self.side_stream.synchronize()
        self._graphs = None
        self.fstate, self.tail_state, self.row = fstate.clone(), tail_state.clone(), row
        # [2, p, b] pairs; phase h: precalc0 = t0[h], tail_output0 = t0[1 - h],
        # precalc = big[h], tail_output = big[1 - h], tail_input = tin[h].
        # The period end flips h; the big tail of phase h reads tin[h] and
        # writes big[h] (the precalc B2 has just finished reading).
        self._t0 = torch.stack([bufs["precalc0"], bufs["tail_output0"]])
        self._big = torch.stack([bufs["precalc"], bufs["tail_output"]])
        self._tin = torch.stack([bufs["tail_input"], bufs["tail_input"]])
        self._views = [{"tail_output0": self._t0[1 - h], "precalc0": self._t0[h],
                        "tail_output": self._big[1 - h], "precalc": self._big[h],
                        "tail_input": self._tin[h]} for h in (0, 1)]
        self._phase = 0
        self._tail_head = torch.tensor([self.tail_state.current], device=dev)
        if self.side_stream is not None and cfg.tail is not None:
            self._capture()

    def _tail_step(self, h: int) -> None:
        """The big-tail step of phase ``h``: the period input ``tin[h]``
        through the tail engine into ``big[h]``."""
        uniform.process_block_at(self.cfg.tail, self.tail_state, self._tail_head,
                                 self._tin[h].reshape(-1), self._big[h].reshape(-1))

    def _capture(self) -> None:
        """One CUDA graph a phase of :meth:`_tail_step`, captured on the
        side stream after a warm-up there on copies (cuFFT plans and the
        allocator's blocks are made outside the capture)."""
        side, cur = self.side_stream, torch.cuda.current_stream(self.device)
        tail = self.cfg.tail
        warm = (self.tail_state.clone(), self._tail_head.clone(), self._tin[0].clone(),
                torch.empty_like(self._big[0]))
        side.wait_stream(cur)  # the copies and the installed tensors are made on cur
        with torch.cuda.stream(side):
            for _ in range(2):
                uniform.process_block_at(tail, warm[0], warm[1], warm[2].reshape(-1),
                                         warm[3].reshape(-1))
        side.synchronize()
        graphs = []
        for h in (0, 1):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=side):
                self._tail_step(h)
            graphs.append(g)
        st = self.tail_state
        # the tensors the graphs read and write: kept alive with them, and
        # marked as used on the side stream for the allocator
        owned = (st.segments, st.segments_ir, st.pre_multiplied, st.overlap,
                 self._tail_head, self._tin, self._big)
        for t in owned:
            t.record_stream(side)
        self._graphs = (graphs, owned)

    def _period_end(self) -> None:
        """Swap the period buffers; run the big tail over the period's input."""
        h = self._phase
        self._phase = 1 - h
        if self.cfg.tail is None:
            return
        st = self.tail_state
        st.current = st.current - 1 if st.current > 0 else st.active_segs - 1  # host shadow
        if self.side_stream is None:  # CPU: in line, in order
            self._tail_step(h)
            self.tail_inline += 1
            return
        cur, side = torch.cuda.current_stream(self.device), self.side_stream
        # the last period's big tail: its output is the next period's precalc,
        # its input half is the next period's to write
        cur.wait_event(self._tail_done)
        self._ready.record(cur)  # B2 has written tin[h]'s last row and read big[h]
        side.wait_event(self._ready)
        # a replay launches on the current stream: set it and back (a few us
        # of host time; the torch.cuda.stream context costs several times more)
        torch.cuda.set_stream(side)
        try:
            self._graphs[0][h].replay()
            self._tail_done.record(side)
        finally:
            torch.cuda.set_stream(cur)
        self.tail_replays += 1

    def process(self, input) -> torch.Tensor:
        cfg = self.cfg
        x = _block(input, cfg.head_block, self.device, "CudaTwoStageConvolver")
        y = self._step(self.consts, self.fstate, self._views[self._phase], self.row, x)
        if self.row == cfg.period - 1:
            self._period_end()
        self.row = (self.row + 1) % cfg.period
        return y

    def update(self, response) -> None:
        raise NotImplementedError(
            "update is unimplemented upstream (src/fft_convolver.rs:408-410)"
        )

    def reset(self) -> None:
        self._settle()
        tail_state = self.tail_state.clone()
        uniform.reset(tail_state)
        p, b = self.cfg.period, self.cfg.head_block
        self._install(cuda_two_stage.zero_state(self.cfg.head.seg_count, b, self.device),
                      tail_state, {k: torch.zeros((p, b), device=self.device)
                                   for k in cuda_two_stage.BUFFERS}, 0)

    def snapshot(self):
        """A value copy of the serving state, after the last big-tail step:
        ``(fstate, tail_state, buffers, row)``.  ``tail_input`` holds the
        latest input of each period row."""
        self._settle()
        bufs = {k: v.clone() for k, v in self.buffers.items()}
        # rows not yet written this period hold the last period's input
        bufs["tail_input"][self.row:] = self._tin[1 - self._phase][self.row:]
        return self.fstate.clone(), self.tail_state.clone(), bufs, self.row

    def restore(self, snap) -> None:
        """Take a :meth:`snapshot`'s state (copies); raises ``ValueError``,
        and keeps the current state, where a tensor is not what the kernel
        and the big tail read."""
        fstate, tail_state, bufs, row = snap
        self._settle()
        self._install(fstate, tail_state, bufs, row)

    def clone(self) -> "CudaTwoStageConvolver":
        """An independent copy: its own state, side stream and graphs."""
        other = object.__new__(CudaTwoStageConvolver)
        other.__dict__.update(self.__dict__)
        other._new_stream()
        other.tail_replays = other.tail_inline = 0
        other.restore(self.snapshot())
        return other


def _check_tail(cfg: uniform.UniformConfig, state: uniform.UniformState, device) -> None:
    """Raise unless ``state`` is a full-block state of the big tail ``cfg``
    on ``device``: what its graphs read."""
    spec, nb = (cfg.seg_count, cfg.bins), cfg.bins
    for name, shape, dtype in (("segments", spec, torch.complex64),
                               ("segments_ir", spec, torch.complex64),
                               ("pre_multiplied", (nb,), torch.complex64),
                               ("overlap", (cfg.block_size,), torch.float32),
                               ("input_buffer", (cfg.block_size,), torch.float32)):
        cuda_engine.require(getattr(state, name), f"tail {name}", shape, dtype, device)
    if not (0 < state.active_segs <= cfg.seg_count and 0 <= state.current < state.active_segs
            and state.input_fill == 0):
        raise ValueError(f"tail: current {state.current}, active {state.active_segs}, input "
                         f"fill {state.input_fill} outside a full-block ring of "
                         f"{cfg.seg_count}")


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
        self._dtype = torch.bfloat16 if self.storage == "bf16_packed" else torch.complex64
        self._check()
        self._step = (cuda_engine.block_step_packed_prepared if self.storage == "bf16_packed"
                      else cuda_engine.block_step_prepared)

    def _check(self) -> None:
        """The kernel's own operands, checked where they are set; per block
        only the input is (``_block``)."""
        cuda_engine.check_operands(self.consts, self.state, self._dtype, self.device)

    def update(self, response) -> None:
        """IR swap (``src/fft_convolver.rs:174-213``) at full ring."""
        response = as_signal(response, self.device)
        if response.shape[0] > self.cfg.ir_len:
            raise ValueError("New impulse response is longer than initialized length")
        padded = copy_and_pad(response, self.cfg.seg_count * self.cfg.block_size)
        self.consts.ir = cuda_engine.store(
            ir_to_spectra(padded, self.cfg.block_size, self.cfg.seg_count), self.storage)
        self.state.overlap.zero_()
        self._check()

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
        """Take ``snap`` (a copy); raises ``ValueError``, and keeps the
        current state, where it is not what the kernel reads."""
        cuda_engine.check_operands(self.consts, snap, self._dtype, self.device)
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
        cuda_crossfade.check_operands(self.consts, self.state, self.device)
        self.cf_cfg = crossfade.CrossfaderConfig(
            fading_samples=crossfade_samples,
            hold_samples=min(self.cfg.block_size, max_response_length), mixer=mixer)
        self.cf_state = crossfade.new_state(self.cf_cfg)
        self.stored_response = torch.zeros(max_response_length, device=self.device)
        self.response_pending = False
        self._step = cuda_crossfade.block_step_prepared

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
        cuda_crossfade.check_operands(self.consts, self.state, self.device)
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
        cuda_crossfade.check_operands(self.consts, self.state, self.device)
        self.cf_state = crossfade.new_state(self.cf_cfg)
        self.stored_response.zero_()
        self.response_pending = False

    def snapshot(self):
        return (dataclasses.replace(self.consts), self.state.clone(), self.cf_state,
                self.stored_response.clone(), self.response_pending)

    def restore(self, snap) -> None:
        """Take a :meth:`snapshot`'s state (copies); raises ``ValueError``,
        and keeps the current state, where a tensor is not what the kernel
        reads."""
        consts, state, cf_state, stored, pending = snap
        cuda_crossfade.check_operands(consts, state, self.device)
        cuda_engine.require(stored, "stored_response", tuple(self.stored_response.shape),
                            torch.float32, self.stored_response.device)
        self.consts = dataclasses.replace(consts)
        self.state = state.clone()
        self.cf_state, self.response_pending = cf_state, pending
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
