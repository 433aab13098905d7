"""The one traffic generator: a traffic file's parameters and the run's
seed give every call of a run, warm-up and window alike.

Keys a traffic file sets (``traffic/*.json``):

* ``engine``: the engine kind the mix drives (a file in ``engines/``);
* ``in_flight``: calls enqueued before the host waits on the oldest (1: a
  closed loop with one call in flight);
* ``periods_per_call``: tail periods a call streams;
* ``dry_buffers``: distinct dry inputs made at set-up and used in turn;
* ``updates_per_call``: voices given a new response before each call, the
  i-th of them row i of a pool of that many made at set-up (0: none);
* ``reset_before_call``: a ``reset()`` before each call (whole tracks);
* ``warmup_calls``: calls of set-up, before the window;
* ``check_calls``: calls of the window kept, drawn from the seed, for the
  comparison with the reference (the window's last call is kept besides);
* ``trace_seconds``: the traced window's length (``--trace 1``), at most
  ``--seconds``;
* ``trace_host``: whether the traced window records host events and the
  harness's spans (default true); false traces the device alone, for a mix
  whose host work would be slowed by the profiler's own cost.  Its readers
  then take every device operation of the window, and a span filter raises;
* ``assumed``: what the mix assumes of its users, key by key, with the
  reason (not read by the generator).

Every seed gets the same sizes and the same number of updates a call; the
seed picks the values and which voices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import inputs


@dataclasses.dataclass(frozen=True)
class Call:
    index: int                  # the call's place in the run, warm-up included
    dry: int                    # which dry buffer it streams
    update: np.ndarray | None   # voices given pool rows 0..k-1 before it, in order
    reset: bool


def call(traffic: dict, seed: int, index: int, voices: int) -> Call:
    """Call ``index`` of a run of ``traffic`` with ``seed``."""
    k = traffic.get("updates_per_call", 0)
    update = None
    if k:
        update = inputs.rng(seed, inputs.PLAN, index).choice(voices, size=k, replace=False)
    return Call(index, index % traffic["dry_buffers"], update,
                bool(traffic.get("reset_before_call", False)))


class Reservoir:
    """A uniform sample of ``size`` of the calls offered, drawn from the
    seed (Algorithm R): :meth:`offer` says which slot the call takes, or
    None."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.seen = 0
        self._rng = inputs.rng(seed, inputs.KEEP)

    def offer(self) -> int | None:
        self.seen += 1
        if self.seen <= self.size:
            return self.seen - 1
        j = int(self._rng.integers(self.seen))
        return j if j < self.size else None
