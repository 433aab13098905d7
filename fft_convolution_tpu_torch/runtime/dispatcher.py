"""Real-time dispatcher: the thread structure of a deployed convolver —
counterpart of ``fft_convolution_tpu/runtime/dispatcher.py``.

The reference leaves concurrency as a comment ("might be done in some
background thread", ``src/fft_convolver.rs:478``); this module implements
the production shape:

    audio callback ──lock-free ring──► dispatcher thread ──ring──► callback
       (RT thread,      (C++ SPSC)      (owns the engine and           out
        never blocks)                    the card, runs one block
                                         a call)

The callback side touches only the native lock-free rings and the pending
update slot, never the engine.  The dispatcher thread assembles fixed
blocks, runs the engine one block a call through
:class:`~.host.HostEngine` (so any engine of the port works, the per-block
kernels B1, B1p, B2 and B3 included), and publishes the output.  Underruns
are observable, not fatal: the consumer reads zeros when output is not
ready yet and the dispatcher keeps a count.

IR updates go through :meth:`RealTimeDispatcher.update`, never to the
engine from the callback thread.  The port's engines change their state in
place (``CudaCrossfadeConvolver.update`` rebuilds a table and zeroes an
overlap; ``process`` reassigns the crossfader state), so an update made
while the dispatcher thread is inside ``process`` could be lost or land
half way through a step.  The dispatcher keeps one pending slot, as the
reference's crossfade convolver does (``src/crossfade_convolver.rs:51-64``),
and its own thread applies the update between two blocks.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from .chunker import BlockAssembler, RingBuffer
from .host import HostEngine


class RealTimeDispatcher:
    """Push/pull streaming through a background dispatch thread."""

    def __init__(self, engine, capacity_blocks: int = 64):
        self.engine = HostEngine(engine)
        cfg = self.engine.cfg
        self.block_size = getattr(cfg, "block_size", None) or cfg.head_block
        cap = capacity_blocks * self.block_size
        self.in_ring = RingBuffer(cap)
        # room for all the input ring holds, the block in flight and what the
        # consumer has not pulled yet, so that a consumer that pulls what is
        # available after each push never leaves drain() waiting on a full
        # output ring
        self.out_ring = RingBuffer(2 * cap + self.block_size)
        self.assembler = BlockAssembler(self.block_size)
        self.samples_pushed = 0
        self.blocks_processed = 0
        self.underruns = 0
        # block index before which the last update was applied (None: none yet)
        self.update_applied_at: int | None = None
        self._pending = None
        self._pending_lock = threading.Lock()
        self._error: Exception | None = None
        self._running = False
        self._thread: threading.Thread | None = None

    # -- producer side (the audio callback; never blocks) -------------------

    def push(self, samples) -> int:
        """Offer input samples; returns how many were accepted."""
        accepted = self.in_ring.write(np.ascontiguousarray(samples, np.float32))
        self.samples_pushed += accepted
        return accepted

    def update(self, response) -> None:
        """Post an IR update.  It waits in a single pending slot (a later
        update replaces one not yet applied) until the dispatcher thread
        applies it between two blocks, and records the index of the first
        block processed with it in ``update_applied_at``."""
        response = np.array(response, np.float32)  # a copy the caller cannot change
        with self._pending_lock:
            self._pending = response

    # -- consumer side -------------------------------------------------------

    def pull(self, n: int) -> np.ndarray:
        """Take up to ``n`` processed samples (zero-padded on underrun)."""
        got = self.out_ring.read(n)
        if len(got) < n:
            self.underruns += 1
            got = np.concatenate([got, np.zeros(n - len(got), np.float32)])
        return got

    def available(self) -> int:
        return self.out_ring.readable()

    # -- dispatcher thread ----------------------------------------------------

    def _apply_pending(self) -> None:
        with self._pending_lock:
            response, self._pending = self._pending, None
        if response is not None:
            self.engine.update(response)
            self.update_applied_at = self.blocks_processed

    def _loop(self) -> None:
        b = self.block_size
        try:
            while self._running:
                chunk = self.in_ring.read(b)
                if len(chunk) == 0:
                    time.sleep(0.0002)
                    continue
                for block in self.assembler.push(chunk):
                    self._apply_pending()
                    y = self.engine.process(block)
                    written = 0
                    while written < b and self._running:
                        written += self.out_ring.write(y[written:])
                    self.blocks_processed += 1
        except Exception as exc:  # the thread's boundary: drain and stop raise it
            self._error = exc
            self._running = False

    def _raise_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("the dispatcher thread failed") from self._error

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._raise_error()

    def drain(self, timeout: float = 10.0) -> None:
        """Block until every whole block's worth of pushed samples has been
        processed AND its output published.

        ``blocks_processed`` is incremented only after the engine output is
        fully written to the output ring, so the condition
        ``blocks_processed >= samples_pushed // block_size`` is exact — no
        "counter settled across one poll" heuristic (which raced with an
        engine step slower than the poll interval: input ring drained,
        counter static, block mid-``engine.process``)."""
        deadline = time.monotonic() + timeout
        expected = self.samples_pushed // self.block_size
        while time.monotonic() < deadline:
            self._raise_error()
            if self.blocks_processed >= expected:
                return
            time.sleep(0.002)
        self._raise_error()
        raise TimeoutError("dispatcher did not drain in time")

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
