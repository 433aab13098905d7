"""Crossfader: the sample-accurate fade state machine and its mixers —
counterpart of ``fft_convolution_tpu/models/crossfade.py`` and of the
reference ``Crossfader`` (``src/crossfade_convolver.rs:126-279``).

The state is five host scalars.  They follow from the call sequence alone,
so keeping them on the host costs no device round trip, and kernel B3
(:mod:`..ops.cuda_crossfade`) takes them as launch arguments.  ``mix_value``
and ``step`` are ``numpy.float32`` and every update to them is float32
arithmetic, so the ramp values are the ones the JAX package computes.

A block is mixed in closed form, as in the JAX package: with entry counter
``c0``, sample ``i`` sees counter ``c_i = c0 + i + 1`` and mix value
``v_i = v0 + step * (max(0, c_i) - max(0, c0))``.  Semantics reproduced
exactly (quirks included):

* ``fade_into`` flips the sign of ``step`` each fade (``:216-240``), so
  ``mix_value`` ramps 0 -> -1 -> 0 -> ...; the raised-cosine gain is even;
* hold phase: while ``c <= 0`` the OLD side is output (``:251-257``);
* endpoint snap when ``c >= fading_samples``: ``Reached`` and ``mix_value``
  snaps to 0 or 1 (``:261-273``);
* ``Reached`` passes the target through (``:244-247``).

Mixers: ``raised_cosine`` is the reference's active one (``:162-169``);
``linear``, ``sqrt`` and ``cosine`` are its dead code (``:130-158``),
selectable here as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

# Target encoding: 0 = A, 1 = B (``Target``, src/crossfade_convolver.rs:171-175)
TARGET_A = 0
TARGET_B = 1

# Mixer names in the order of the ids kernel B3 takes (csrc/b3_crossfade_step.cu).
MIXERS = ("raised_cosine", "linear", "sqrt", "cosine")

_HALF_PI = math.pi / 2.0


def _gains(mixer: str, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(gain1, gain2)`` of the mixer at mix values ``v`` (``:130-169``)."""
    if mixer == "raised_cosine":
        c = torch.cos(_HALF_PI * v)
        g1 = c * c
        return g1, 1.0 - g1
    if mixer == "linear":
        g1 = 1.0 - v
        return g1, 1.0 - g1
    if mixer == "sqrt":  # not complementary upstream
        return torch.sqrt((1.0 - v).clamp(min=0.0)), torch.sqrt(v.clamp(min=0.0))
    if mixer == "cosine":
        return torch.cos(_HALF_PI * v), torch.sin(_HALF_PI * v)
    raise ValueError(f"unknown mixer {mixer!r}; choose from {MIXERS}")


@dataclasses.dataclass(frozen=True)
class CrossfaderConfig:
    fading_samples: int   # ``:195``
    hold_samples: int     # ``:196``
    mixer: str = "raised_cosine"

    def __post_init__(self):
        # The reference accepts fading_samples == 0 (Rust's 1.0/0 is inf);
        # as in the JAX package it clamps to an instant 1-sample switch.
        if self.fading_samples < 1:
            object.__setattr__(self, "fading_samples", 1)
        if self.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {self.mixer!r}; choose from {MIXERS}")

    @property
    def mixer_id(self) -> int:
        return MIXERS.index(self.mixer)


class CrossfaderState(NamedTuple):
    """``Crossfader`` runtime fields (``src/crossfade_convolver.rs:192-201``)."""

    target: int              # 0 = A, 1 = B
    approaching: bool        # FadingState::Approaching vs Reached
    counter: int
    mix_value: np.float32
    step: np.float32         # mix_value_step (sign flips per fade)


def new_state(cfg: CrossfaderConfig) -> CrossfaderState:
    """``Crossfader::new`` (``:203-214``): Reached(A), step = 1/fading."""
    return CrossfaderState(target=TARGET_A, approaching=False, counter=0,
                           mix_value=np.float32(0.0),
                           step=np.float32(1.0 / cfg.fading_samples))


def fade_into(cfg: CrossfaderConfig, st: CrossfaderState, target: int) -> CrossfaderState:
    """``Crossfader::fade_into`` (``:216-240``)."""
    if st.target == target:
        return st
    if not st.approaching:
        # Reached -> hold, then ramp (:223-227)
        return st._replace(target=target, approaching=True,
                           counter=-cfg.hold_samples, step=-st.step)
    if st.counter >= 0:
        # mid-ramp reversal (:231-234)
        return st._replace(target=target, counter=cfg.fading_samples - st.counter,
                           step=-st.step)
    # reversal during hold: instantly Reached(new target) (:235-237)
    return st._replace(target=target, approaching=False)


def advance(cfg: CrossfaderConfig, st: CrossfaderState, n: int) -> CrossfaderState:
    """The state after mixing ``n`` samples (``:259-273``): the counter stops
    at ``fading_samples``, where the fade is reached and ``mix_value``
    snaps to the target's endpoint."""
    if not st.approaching:
        return st
    fading = cfg.fading_samples
    c_end = st.counter + n
    if c_end >= fading:
        return st._replace(approaching=False, counter=fading,
                           mix_value=np.float32(1.0 if st.target == TARGET_B else 0.0))
    inc = max(0, c_end) - max(0, st.counter)
    return st._replace(counter=c_end,
                       mix_value=np.float32(st.mix_value + st.step * np.float32(inc)))


def mix_samples(cfg: CrossfaderConfig, st: CrossfaderState, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The mixed block for ``a``/``b`` ``[n]`` under state ``st``
    (``Crossfader::mix`` over a block, ``:242-278``)."""
    new_side, old_side = (b, a) if st.target == TARGET_B else (a, b)
    if not st.approaching:
        return new_side
    c = st.counter + 1 + torch.arange(a.shape[0], device=a.device)
    inc = c.clamp(min=0) - max(0, st.counter)
    # float32 tensor ops with exact float32 scalars: v_i rounds as in JAX
    v = float(st.mix_value) + float(st.step) * inc.to(torch.float32)
    g1, g2 = _gains(cfg.mixer, v)
    ramped = a * g1 + b * g2
    return torch.where(c <= 0, old_side,
                       torch.where(c >= cfg.fading_samples, new_side, ramped))


def mix_block(cfg: CrossfaderConfig, st: CrossfaderState, a: torch.Tensor,
              b: torch.Tensor) -> tuple[CrossfaderState, torch.Tensor]:
    """Vectorized ``Crossfader::mix`` over a block: ``(state', y)``."""
    return advance(cfg, st, a.shape[0]), mix_samples(cfg, st, a, b)
