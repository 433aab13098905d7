"""``ReverbFarm`` over V voices, each with its own long response: a call
is ``ReverbFarm.process`` of whole tail periods, on the card, with
``update_voices`` before it where the traffic gives updates.

The check regenerates the inputs from the seed and compares, for every
voice, the whole of each kept call with the float64 convolution of the
voice's dry stream by its response.  After a voice's update the farm
gives ``TwoStageFFTConvolver.update_extension``'s transient: for three tail
periods the stages' in-flight outputs are dropped (the head's first block,
tail0's first period, the big tail's first two periods and its first
overlap), and from then on the stream is exactly the new response over the
whole kept input history.  So a voice's samples from three tail periods
after its last update on are compared exactly with the new response
(``out_err``).  The transient itself is held to a bound, not an exact
value (``transient_peak``): each of its samples has to be finite and
within the larger peak, over the transient, of the old response's
reference and the new one's, times the limit.  That catches a NaN, an
infinity or a click in the switch; an error smaller than the signal there
is not seen.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.profiler import record_function

from .. import generator, inputs, shapes
from ..reference.conv import conv_tail
from . import widest

SETTLE_PERIODS = 3  # tail periods of update_extension's transient
CHECK_VOICES = 16   # voices the reference convolves at once


class Engine:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        from fft_convolution_tpu_torch import ReverbFarm

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.voices = v = config["voices"]
        b, sr = config["block_size"], config["sample_rate"]
        self.ir_len = shapes.ir_len(config)
        # the control: the program's own bf16 tail, one precision below float32
        dtype = torch.bfloat16 if control or config["tail_dtype"] == "bfloat16" else torch.float32
        # the capacity guard sees the card as the farm will: without the
        # harness's copy of the responses, freed once the farm is built
        budget = (torch.cuda.mem_get_info(self.device)[0] if self.device.type == "cuda"
                  else None)
        irs = inputs.responses(seed, inputs.IRS, v, self.ir_len, config["ir_scale"],
                               self.device)
        self.farm = ReverbFarm(irs, b, self.ir_len, tail_dtype=dtype,
                               hbm_budget_bytes=budget, device=self.device)
        del irs
        shapes.check_program(config, self.farm.cfg)
        self.period = self.farm.period
        self.t = traffic["periods_per_call"] * self.period
        self.in_flight = traffic["in_flight"]
        self.audio_s_per_call = self.t * b / sr
        self.dry = [inputs.randn((self.t, v, b), seed, inputs.DRY, i, device=self.device)
                    for i in range(traffic["dry_buffers"])]
        k = traffic.get("updates_per_call", 0)
        self.pool = (inputs.responses(seed, inputs.POOL, k, self.ir_len, config["ir_scale"],
                                      self.device) if k else None)

    def call(self, index: int) -> torch.Tensor:
        c = generator.call(self.traffic, self.seed, index, self.voices)
        if c.update is not None:
            with record_function("portbench.update"):
                self.farm.update_voices(c.update, self.pool)
        with record_function("portbench.process"):
            return self.farm.process(self.dry[c.dry])

    def free(self) -> None:
        self.farm = self.dry = self.pool = None

    def check(self, kept: dict[int, torch.Tensor]) -> dict:
        """``out_err``: the widest gap between a kept output sample and the
        reference's, over the reference's peak in that call, outside the
        transients; where the traffic updates voices, ``transient_peak``: the
        largest of a transient's samples over the larger peak there of the
        old response's reference and the new one's, voice by voice."""
        v, b, tb = self.voices, self.config["block_size"], self.period * self.config["block_size"]
        span = self.t * b  # samples a call streams for each voice
        last = max(kept)
        # each voice's response in force at each kept call, the one before
        # its last update, and where its exact comparison starts:
        # (pool row or -1, the row before, first compared sample)
        src = np.full(v, -1)
        prev = np.full(v, -1)
        since = np.zeros(v, np.int64)
        at = {}
        for g in range(last + 1):
            c = generator.call(self.traffic, self.seed, g, v)
            if c.update is not None:
                prev[c.update] = src[c.update]
                src[c.update] = np.arange(len(c.update))
                since[c.update] = g * span + SETTLE_PERIODS * tb
            if g in kept:
                at[g] = (src.copy(), prev.copy(), since.copy())
        dry = [inputs.randn((self.t, v, b), self.seed, inputs.DRY, i, device=self.device)
               for i in range(self.traffic["dry_buffers"])]
        k = self.traffic.get("updates_per_call", 0)
        pool = (inputs.responses(self.seed, inputs.POOL, k, self.ir_len, self.config["ir_scale"],
                                 self.device) if k else None)
        worst = transient = 0.0
        for g, y in sorted(kept.items()):
            s0 = g * span
            x0 = max(0, s0 - (self.ir_len - 1))
            g0 = x0 // span
            gap = peak = 0.0
            for c0 in range(0, v, inputs.IR_CHUNK):
                chunk = slice(c0, min(v, c0 + inputs.IR_CHUNK))
                h_all = inputs.responses(self.seed, inputs.IRS, v, self.ir_len,
                                         self.config["ir_scale"], self.device,
                                         chunks=range(c0 // inputs.IR_CHUNK,
                                                      c0 // inputs.IR_CHUNK + 1))

                def response(rows, sl):
                    h = h_all[sl.start - c0:sl.stop - c0].clone()
                    for i in np.nonzero(rows >= 0)[0]:
                        h[i] = pool[rows[i]]
                    return h

                for s in range(chunk.start, chunk.stop, CHECK_VOICES):
                    vs = slice(s, min(chunk.stop, s + CHECK_VOICES))
                    rows, before, starts = (a[vs] for a in at[g])
                    x = torch.cat([dry[generator.call(self.traffic, self.seed, gi, v).dry]
                                   [:, vs].permute(1, 0, 2).reshape(vs.stop - vs.start, span)
                                   for gi in range(g0, g + 1)], dim=1)[:, x0 - g0 * span:]
                    ref = conv_tail(x, response(rows, vs), span)
                    got = y[:, vs].permute(1, 0, 2).reshape(vs.stop - vs.start, span).double()
                    # samples before a voice's settle point: the transient
                    pos = torch.arange(s0, s0 + span, device=ref.device)
                    mask = pos[None, :] >= torch.as_tensor(starts, device=ref.device)[:, None]
                    gap = max(gap, widest(torch.where(mask, (got - ref).abs(), 0.0)))
                    peak = max(peak, widest(torch.where(mask, ref.abs(), 0.0)))
                    tv = torch.nonzero(~mask.all(dim=1)).flatten().tolist()
                    if tv:
                        old = conv_tail(x[tv], response(before, vs)[tv], span)
                        m = ~mask[tv]
                        top = torch.maximum(torch.where(m, ref[tv].abs(), 0.0).amax(dim=1),
                                            torch.where(m, old.abs(), 0.0).amax(dim=1))
                        seen = torch.where(m, got[tv].abs(), 0.0)
                        seen = torch.where(torch.isfinite(seen), seen, float("inf"))
                        transient = max(transient, widest(seen.amax(dim=1) / top))
            worst = max(worst, gap / peak if peak > 0 else float("inf"))
        return {"out_err": worst, **({"transient_peak": transient} if k else {})}
