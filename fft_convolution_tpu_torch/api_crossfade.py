"""Crossfade convolver — counterpart of ``fft_convolution_tpu/api_crossfade.py``
and of the reference ``CrossfadeConvolver<T>``
(``src/crossfade_convolver.rs:3-105``): two instances of any wrapped
``Convolution`` engine run every block and the sample-accurate crossfader
(:mod:`.models.crossfade`) mixes between them; ``update`` re-inits the
inactive engine and fades into it, with a single pending-response slot for
an update that arrives mid-fade (``:51-64``).

A block-aligned call on two uniform engines of one configuration runs both
engines' batched streams (:func:`.models.uniform.process_stream`, each with
its cached kernel meta-spectra) and one mix over the whole call, as the JAX
package's fused stream does (``api_crossfade.py:29-52,118-153`` there).
Other calls run the two engines' own ``process`` one after the other, the
reference's schedule.  For one kernel launch per block use
:class:`~fft_convolution_tpu_torch.serving.CudaCrossfadeConvolver`.
"""

from __future__ import annotations

import torch

from .api import FFTConvolver, as_signal
from .models import crossfade, uniform


class CrossfadeConvolver:
    """Generic over the wrapped engine (``CrossfadeConvolver<Convolver>``):
    any object with the ``Convolution`` protocol plus ``snapshot``,
    ``restore`` and ``clone`` works — :class:`~.api.FFTConvolver`,
    :class:`~.api_two_stage.TwoStageFFTConvolver` (whose ``update`` raises,
    as the generic would panic upstream) or the serving wrappers of
    :mod:`.serving` (one block per call)."""

    def __init__(self, convolver, max_response_length: int,
                 max_buffer_size: int, crossfade_samples: int):
        """``CrossfadeConvolver::new`` (``src/crossfade_convolver.rs:20-43``):
        hold_samples = min(max_buffer_size, max_response_length)."""
        self.convolver_a = convolver.clone()
        self.convolver_b = convolver
        self.cf_cfg = crossfade.CrossfaderConfig(
            fading_samples=crossfade_samples,
            hold_samples=min(max_buffer_size, max_response_length))
        self.cf_state = crossfade.new_state(self.cf_cfg)
        self.stored_response = torch.zeros(max_response_length)
        self.response_pending = False

    @classmethod
    def init(cls, engine_cls, response, max_block_size: int,
             max_response_length: int) -> "CrossfadeConvolver":
        """``Convolution::init`` (``src/crossfade_convolver.rs:46-49``), with
        the upstream quirk: the crossfade length and the stored-response
        capacity are ``response.len()``, not ``max_response_length``."""
        convolver = engine_cls(response, max_block_size, max_response_length)
        n = as_signal(response, "cpu").shape[0]
        return cls(convolver, n, max_block_size, n)

    @property
    def device(self) -> torch.device:
        """The wrapped engines' device."""
        return self.convolver_a.device

    @property
    def cfg(self):
        """The wrapped engines' configuration (both engines have the same)."""
        return self.convolver_a.cfg

    def is_crossfading(self) -> bool:
        """(``src/crossfade_convolver.rs:85-92``)"""
        return self.cf_state.approaching

    def _swap(self, response) -> None:
        """``swap`` (``src/crossfade_convolver.rs:94-105``): update the
        INACTIVE engine, fade toward it."""
        if self.cf_state.target == crossfade.TARGET_A:
            self.convolver_b.update(response)
            target = crossfade.TARGET_B
        else:
            self.convolver_a.update(response)
            target = crossfade.TARGET_A
        self.cf_state = crossfade.fade_into(self.cf_cfg, self.cf_state, target)

    def update(self, response) -> None:
        """(``src/crossfade_convolver.rs:51-64``) — single pending slot;
        updates while fading overwrite the stored response."""
        if not self.is_crossfading():
            self._swap(response)
            self.response_pending = False
            return
        response = as_signal(response, "cpu")
        if response.shape[0] > self.stored_response.shape[0]:
            raise ValueError("response longer than stored-response capacity")
        self.stored_response.zero_()
        self.stored_response[:response.shape[0]] = response
        self.response_pending = True

    def _can_fuse(self, n: int) -> bool:
        """Whether an ``n``-sample call takes the fused stream: two uniform
        engines of one configuration, both at a block boundary, and a
        non-empty block-aligned call (JAX ``api_crossfade.py:118-129``)."""
        a, b = self.convolver_a, self.convolver_b
        return (type(a) is FFTConvolver and type(b) is FFTConvolver and a.cfg == b.cfg
                and a._fill == 0 and b._fill == 0 and n > 0
                and n % a.cfg.block_size == 0)

    def process(self, input) -> torch.Tensor:
        """(``src/crossfade_convolver.rs:66-78``): apply a pending swap at
        block top, run BOTH engines, mix per sample."""
        if not self.is_crossfading() and self.response_pending:
            self._swap(self.stored_response)
            self.response_pending = False
        a, b = self.convolver_a, self.convolver_b
        x = as_signal(input, a.device)
        if self._can_fuse(x.shape[0]):
            blocks = x.view(-1, a.cfg.block_size)
            t = blocks.shape[0]
            buffer_a = uniform.process_stream(a.cfg, a.state, blocks, a._get_khat(t))
            buffer_b = uniform.process_stream(b.cfg, b.state, blocks, b._get_khat(t))
            buffer_a, buffer_b = buffer_a.reshape(-1), buffer_b.reshape(-1)
        else:
            buffer_a = a.process(x)
            buffer_b = b.process(x)
        self.cf_state, y = crossfade.mix_block(self.cf_cfg, self.cf_state,
                                               buffer_a, buffer_b)
        return y

    def reset(self) -> None:
        """``todo!()`` upstream (``src/crossfade_convolver.rs:80-82``);
        :meth:`reset_extension` is the implemented extension."""
        raise NotImplementedError(
            "CrossfadeConvolver.reset is unimplemented upstream "
            "(src/crossfade_convolver.rs:80-82); reset_extension() is the "
            "documented extension")

    def reset_extension(self) -> None:
        """EXTENSION (not reference surface): reset both engines, return the
        crossfader to Reached(A), drop any pending response."""
        self.convolver_a.reset()
        self.convolver_b.reset()
        self.cf_state = crossfade.new_state(self.cf_cfg)
        self.stored_response.zero_()
        self.response_pending = False

    def snapshot(self):
        return (self.convolver_a.snapshot(), self.convolver_b.snapshot(),
                self.cf_state, self.stored_response.clone(), self.response_pending)

    def restore(self, snap) -> None:
        a, b, self.cf_state, stored, self.response_pending = snap
        self.convolver_a.restore(a)
        self.convolver_b.restore(b)
        self.stored_response = stored.clone()

    def clone(self) -> "CrossfadeConvolver":
        """Value copy of the whole wrapper (the reference derives ``Clone``,
        ``src/crossfade_convolver.rs:10``)."""
        other = object.__new__(CrossfadeConvolver)
        other.__dict__.update(self.__dict__)
        other.convolver_a = self.convolver_a.clone()
        other.convolver_b = self.convolver_b.clone()
        other.stored_response = self.stored_response.clone()
        return other
