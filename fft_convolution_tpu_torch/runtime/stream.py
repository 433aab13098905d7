"""Streaming front end: the audio-callback-facing runtime — counterpart of
``fft_convolution_tpu/runtime/stream.py``.

Lets an audio host push arbitrary-size buffers to a convolution engine and
pull processed audio with zero added latency.  The engine's own chunker
takes any length: whole blocks at a block boundary go to its batched route,
anything else to its sub-block path (``src/fft_convolver.rs:222-294``).  The
engine runs behind :class:`~.host.HostEngine`: numpy in, numpy out.

``StreamingConvolver`` is the deployment-shaped wrapper: the reference
leaves this role to the caller's audio callback
(``examples/compare_partitioned.rs:30-48``).
"""

from __future__ import annotations

import numpy as np

from ..api import FFTConvolver
from ..api_crossfade import CrossfadeConvolver
from ..api_two_stage import TwoStageFFTConvolver
from .host import HostEngine


def takes_any_length(engine) -> bool:
    """Whether ``engine.process`` takes an input of any length: the ``api``
    engines, and a ``CrossfadeConvolver`` over them.  The serving wrappers
    take one block (or, for the streaming one, whole blocks) a call, and
    ``ReverbFarm`` takes ``[T, V, B]``."""
    if isinstance(engine, HostEngine):
        engine = engine.engine
    if isinstance(engine, CrossfadeConvolver):
        return takes_any_length(engine.convolver_a) and takes_any_length(engine.convolver_b)
    return isinstance(engine, (FFTConvolver, TwoStageFFTConvolver))


class StreamingConvolver:
    """Push/pull streaming around an engine that takes any input length:
    :class:`~..api.FFTConvolver`, :class:`~..api_two_stage.TwoStageFFTConvolver`
    or a :class:`~..api_crossfade.CrossfadeConvolver` over them.

    ``push(x)`` accepts any number of samples and returns the same number of
    processed samples as a numpy array (the engine produces output with zero
    added latency).  The engine picks its route itself: whole blocks at a
    block boundary take its batched path, ragged pushes its sub-block path.
    A per-block engine (the serving wrappers, ``ReverbFarm``) raises
    ``ValueError`` here, at construction, not in the middle of a stream:
    drive those one block a call through
    :class:`~.dispatcher.RealTimeDispatcher`.
    """

    def __init__(self, engine):
        if not takes_any_length(engine):
            inner = engine.engine if isinstance(engine, HostEngine) else engine
            raise ValueError(
                f"StreamingConvolver needs an engine that takes any input length "
                f"(FFTConvolver, TwoStageFFTConvolver, or a CrossfadeConvolver over "
                f"them); {type(inner).__name__} does not: drive it one block a call "
                f"through RealTimeDispatcher")
        self.engine = HostEngine(engine)

    def push(self, samples) -> np.ndarray:
        """Process ``samples`` (any length), returning processed audio of the
        same length."""
        return self.engine.process(np.ascontiguousarray(samples, np.float32))

    def update(self, response) -> None:
        self.engine.update(response)

    def reset(self) -> None:
        self.engine.reset()
