"""Low-latency serving wrappers over the hand-written CUDA kernels —
counterpart of ``fft_convolution_tpu/serving.py`` (``PallasFFTConvolver``
and ``PallasTwoStageConvolver``).

Each ``process`` call takes exactly one block (the real-time callback shape)
and runs one fused kernel step: B1 (:mod:`.ops.cuda_engine`) for the uniform
wrapper, B2 (:mod:`.ops.cuda_two_stage`) for the two-stage one.  On a CPU
device the same wrappers run the kernels' plain PyTorch versions.  Outputs
are float32 tensors on the wrapper's device; no call synchronises with the
card.

The kernel step each wrapper calls is the attribute ``_step``; setting it to
the module's ``block_step_plain`` runs the same wrapper through the plain
version on the same device, which is how the kernels are held against it.
"""

from __future__ import annotations

import torch

from .api import as_signal
from .models import two_stage, uniform
from .ops import cuda_engine, cuda_two_stage
from .ops.fft import copy_and_pad, ir_to_spectra


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
                 device="cpu"):
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
    ``storage`` takes only ``"float32"``; the JAX package's
    ``"bf16_packed"`` storage (kernel B1p) is still to port.
    """

    def __init__(self, response, block_size: int, max_response_length: int,
                 device="cpu", storage: str = "float32"):
        if storage != "float32":
            raise NotImplementedError(
                f"storage={storage!r}: only 'float32' is ported; the packed "
                "bf16 step is ROADMAP kernel B1p")
        self.device = torch.device(device)
        self.cfg, state = uniform.init(as_signal(response, self.device), block_size,
                                       max_response_length, self.device)
        cuda_engine.check_block(self.cfg.block_size)
        self.consts, self.state = cuda_engine.from_uniform(self.cfg, state)
        self._step = cuda_engine.block_step

    def update(self, response) -> None:
        """IR swap (``src/fft_convolver.rs:174-213``) at full ring."""
        response = as_signal(response, self.device)
        if response.shape[0] > self.cfg.ir_len:
            raise ValueError("New impulse response is longer than initialized length")
        padded = copy_and_pad(response, self.cfg.seg_count * self.cfg.block_size)
        self.consts.ir = ir_to_spectra(padded, self.cfg.block_size, self.cfg.seg_count)
        self.state.overlap.zero_()

    def reset(self) -> None:
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
        other.consts = cuda_engine.FDLConsts(self.consts.ir, self.consts.tw)
        other.state = self.state.clone()
        return other
