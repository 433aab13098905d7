"""Whole tracks through one ``TwoStageFFTConvolver``: a call is
``reset()`` and ``process`` of one whole track, on the card.  The tracks
are block-aligned whole periods, so each streams through the wrapper's
aligned path in one call.

The check regenerates the response and the kept tracks from the seed and
compares every sample of each with the float64 convolution of the track by
the response (each track starts after a ``reset()``, from silence).
"""

from __future__ import annotations

import torch
from torch.autograd.profiler import record_function

from .. import generator, inputs, shapes
from ..reference.conv import conv_tail, conv_tail_bf16
from . import widest


class _Bf16Reference:
    """The control: the reference one precision down, in the program's
    place (the two-stage wrapper has no bfloat16 path of its own)."""

    def __init__(self, ir: torch.Tensor):
        self.ir = ir[None]

    def reset(self) -> None:
        pass

    def process(self, x: torch.Tensor) -> torch.Tensor:
        return conv_tail_bf16(x[None], self.ir, x.shape[0])[0]


class Engine:
    voices = 1

    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        from fft_convolution_tpu_torch import TwoStageFFTConvolver

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        b, sr = config["block_size"], config["sample_rate"]
        self.ir_len = shapes.ir_len(config)
        ir = self._response()
        conv = TwoStageFFTConvolver(ir, b, self.ir_len, device=self.device)
        shapes.check_program(config, conv.cfg)
        self.conv = _Bf16Reference(ir) if control else conv
        del ir
        self.t = traffic["periods_per_call"] * conv.cfg.period
        self.in_flight = traffic["in_flight"]
        self.audio_s_per_call = self.t * b / sr
        self.tracks = [self._track(i) for i in range(traffic["dry_buffers"])]

    def _response(self) -> torch.Tensor:
        return inputs.randn((self.ir_len,), self.seed, inputs.IRS, scale=self.config["ir_scale"],
                            device=self.device)

    def _track(self, i: int) -> torch.Tensor:
        return inputs.randn((self.t * self.config["block_size"],), self.seed, inputs.DRY, i,
                            device=self.device)

    def call(self, index: int) -> torch.Tensor:
        c = generator.call(self.traffic, self.seed, index, self.voices)
        if c.reset:
            with record_function("portbench.reset"):
                self.conv.reset()
        with record_function("portbench.process"):
            return self.conv.process(self.tracks[c.dry])

    def free(self) -> None:
        self.conv = self.tracks = None

    def check(self, kept: dict[int, torch.Tensor]) -> dict:
        """``out_err``: the widest gap between a kept track's sample and the
        reference's, over the reference's peak in that track."""
        h = self._response()[None]
        worst = 0.0
        for g, y in sorted(kept.items()):
            x = self._track(generator.call(self.traffic, self.seed, g, self.voices).dry)
            ref = conv_tail(x[None], h, x.shape[0])[0]
            peak = widest(ref.abs())
            gap = widest((y.double() - ref).abs())
            worst = max(worst, gap / peak if peak > 0 else float("inf"))
        return {"out_err": worst}
