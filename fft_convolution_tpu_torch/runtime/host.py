"""The numpy boundary of the port: :class:`HostEngine`.

The port's engines take tensors and return float32 tensors on their device,
and never synchronise with the card (``serving.py``, ``api.py``).  An audio
host works in numpy: a block in, a block out, ready when the call returns.
:class:`HostEngine` gives any engine of the port that contract, so the
host-side runtime (:mod:`.stream`, :mod:`.dispatcher`) and the examples
drive every engine the same way.
"""

from __future__ import annotations

import numpy as np
import torch

# Engine extensions passed through where the engine has them
_EXTENSIONS = ("update_extension", "reset_extension", "is_crossfading")


class HostEngine:
    """Numpy in, numpy out, around any engine of the port: the ``api``
    engines, the four serving wrappers and ``ReverbFarm``.

    :meth:`process` copies the input into a pinned host buffer, copies that
    to the engine's device (``non_blocking``), runs ``engine.process``,
    copies the output back into a pinned host buffer, synchronises once, and
    returns a numpy array the caller owns.  On a CPU engine the same happens
    with plain host buffers and no copy to a device.  The staging buffers
    are kept per input shape, so the steady state allocates only the array
    it returns.

    ``cfg``, ``update``, ``reset``, ``snapshot``, ``restore`` and ``clone``
    are the engine's; ``update_extension``, ``reset_extension`` and
    ``is_crossfading`` pass through where the engine has them.  Wrapping a
    ``HostEngine`` again wraps its engine, so wrapping twice is harmless.
    """

    def __init__(self, engine):
        if isinstance(engine, HostEngine):
            engine = engine.engine
        self.engine = engine
        self.device = torch.device(engine.device)
        self._pinned = self.device.type == "cuda"
        # input shape -> (host input, device input, host output or None)
        self._staging: dict[tuple, list] = {}

    @property
    def cfg(self):
        return self.engine.cfg

    def __getattr__(self, name):
        if name in _EXTENSIONS:
            return getattr(self.engine, name)
        raise AttributeError(f"{type(self).__name__!s} has no attribute {name!r}")

    def _buffers(self, shape: tuple) -> list:
        bufs = self._staging.get(shape)
        if bufs is None:
            host_in = torch.empty(shape, pin_memory=self._pinned)
            dev_in = (torch.empty(shape, device=self.device) if self._pinned
                      else host_in)
            bufs = self._staging[shape] = [host_in, dev_in, None]
        return bufs

    def process(self, x) -> np.ndarray:
        """Run one ``engine.process`` call on ``x`` (array-like, the shape
        the engine takes); returns its float32 output as a numpy array."""
        x = np.asarray(x, np.float32)
        bufs = self._buffers(x.shape)
        host_in, dev_in, host_out = bufs
        host_in.numpy()[...] = x
        if dev_in is not host_in:
            dev_in.copy_(host_in, non_blocking=True)
        y = self.engine.process(dev_in)
        if host_out is None or host_out.shape != y.shape:
            host_out = bufs[2] = torch.empty(y.shape, pin_memory=self._pinned)
        host_out.copy_(y, non_blocking=self._pinned)
        if self._pinned:
            torch.cuda.current_stream(self.device).synchronize()
        return host_out.numpy().copy()

    def update(self, response) -> None:
        self.engine.update(response)

    def reset(self) -> None:
        self.engine.reset()

    def snapshot(self):
        return self.engine.snapshot()

    def restore(self, snap) -> None:
        self.engine.restore(snap)

    def clone(self) -> "HostEngine":
        return HostEngine(self.engine.clone())
