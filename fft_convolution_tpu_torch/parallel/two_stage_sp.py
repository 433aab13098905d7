"""Sharded long-IR two-stage convolution: one voice, a multi-minute IR, the
big tail spanning ranks — counterpart of
``fft_convolution_tpu/parallel/two_stage_sp.py``.

The two-stage engine (``src/fft_convolver.rs:323-526``) with its main tail
built as the segment-sharded frequency-delay line of :mod:`.partition`:

* **head + tail0** are replicated on every rank: both run at the head block
  over at most one tail block of taps, so duplicating them is cheap and
  keeps the low-latency path free of collectives;
* **the main tail**, where a 60 s IR keeps its partition spectra, is a
  :class:`.partition.ShardedFDLState`: each rank owns a slab of tail
  segments, and one :func:`.partition.step` a tail period merges the
  partial spectra with one all-reduce of ``complex64 [tail_block + 1]``.

The schedule is :func:`..models.two_stage.process_stream_aligned`'s
three-stream decomposition with the big tail's stream replaced:

    y = head(x) + delay_1_period(tail0(x)) + delay_2_periods(tail_sp(x))

so the collective runs once every ``period`` head blocks, and each rank's
share of the tail's memory falls as ``1 / |sp|``.  Head and tail0 take the
fused front end under its host-int guard, as the JAX engine's aligned
stream does (``fft_convolution_tpu/parallel/two_stage_sp.py:123``); the
CHRONO tail history stays the single-device wrapper's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..api import as_signal
from ..models import two_stage, uniform
from ..ops.fft import copy_and_pad
from . import partition
from .mesh import make_mesh, mesh_device


def init(mesh, response, block_size: int, max_response_length: int
         ) -> tuple[two_stage.TwoStageConfig, two_stage.TwoStageState]:
    """Two-stage ``init`` (``src/fft_convolver.rs:340-406``) with the main
    tail a sharded FDL over ``mesh``'s ``"sp"`` dimension (``init``,
    ``fft_convolution_tpu/parallel/two_stage_sp.py:45``).  The state's
    ``tail`` is a :class:`.partition.ShardedFDLState` and ``cfg.tail`` its
    mesh-padded config.  Raises ``ValueError`` when the IR never reaches the
    main tail (``max_response_length <= 2 * tail_block``): there is nothing
    to shard, use the single-device engine."""
    dev = mesh_device(mesh)
    response = as_signal(response, dev)
    if max_response_length < response.shape[0]:
        raise ValueError(
            "max_response_length must be at least the length of the initial "
            "impulse response"
        )
    head_block = block_size
    tail_block = two_stage.compute_tail_block_size(block_size, max_response_length)
    if max_response_length <= 2 * tail_block:
        raise ValueError(
            f"IR of {max_response_length} taps never reaches the main tail "
            f"(tail_block={tail_block}); nothing to shard — use "
            "TwoStageFFTConvolver on one device"
        )
    padded = copy_and_pad(response, max_response_length)
    head_cfg, head_state = uniform.init(padded[:tail_block], head_block, tail_block, dev)
    t0_len = min(max_response_length - tail_block, tail_block)
    tail0_cfg, tail0_state = uniform.init(padded[tail_block:tail_block + t0_len], head_block,
                                          t0_len, dev)
    tail_cfg, tail_state = partition.init(mesh, padded[2 * tail_block:], tail_block,
                                          max_response_length - 2 * tail_block)
    cfg = two_stage.TwoStageConfig(head_block=head_block, tail_block=tail_block,
                                   head=head_cfg, tail0=tail0_cfg, tail=tail_cfg)
    state = two_stage.TwoStageState(
        head=head_state, tail0=tail0_state, tail=tail_state,
        **{k: torch.zeros(tail_block, device=dev) for k in two_stage._BUFFERS},
        tail_fill=0, precalc_pos=0,
    )
    return cfg, state


def stream_aligned(cfg: two_stage.TwoStageConfig, mesh, state: two_stage.TwoStageState,
                   blocks: torch.Tensor, khats: dict | None = None) -> torch.Tensor:
    """Period-aligned stream ``blocks [T, head_block] -> y`` with the main
    tail stepped through :func:`.partition.step`, one all-reduce a period
    (``_raw_stream_aligned``,
    ``fft_convolution_tpu/parallel/two_stage_sp.py:113``).  ``khats``:
    :func:`..models.two_stage.stream_khats` without the tail entry."""
    def big_stream(tail_cfg, tail_state, rows):
        return partition.stream(tail_cfg, mesh, tail_state, rows)

    return two_stage.process_stream_aligned(cfg, state, blocks, khats, big_stream=big_stream)


def update(cfg: two_stage.TwoStageConfig, state: two_stage.TwoStageState,
           response_padded: torch.Tensor, new_len: int) -> None:
    """EXTENSION (the reference's ``update`` is ``todo!()``,
    ``src/fft_convolver.rs:408-410``): the stage-wise RT-safe swap of
    :func:`..models.two_stage.update` with the sharded tail through
    :func:`.partition.update`, in place (``update``,
    ``fft_convolution_tpu/parallel/two_stage_sp.py:135``).
    ``response_padded`` is zero-padded to the init ``max_response_length``."""
    two_stage.update(cfg, state, response_padded, new_len, tail_update=partition.update)


def reset(cfg: two_stage.TwoStageConfig, state: two_stage.TwoStageState) -> None:
    """``Convolution::reset`` (``src/fft_convolver.rs:497-511``) with the
    sharded tail cleared by :func:`.partition.reset`."""
    two_stage.reset(cfg, state, tail_reset=partition.reset)


class ShardedTwoStageConvolver:
    """``TwoStageFFTConvolver`` for IRs too long for one device: the
    ``Convolution`` surface (``src/lib.rs:5-14``) with the main tail's
    frequency-delay line sharded over the mesh's ``"sp"`` dimension
    (``ShardedTwoStageConvolver``,
    ``fft_convolution_tpu/parallel/two_stage_sp.py:210``).

    Every rank constructs it with the same full IR and makes the same calls
    with the same input; each gets the whole output.  ``process`` takes
    period-aligned input (multiples of ``tail_block`` samples).  ``update``
    raises like the reference's ``todo!()`` (``src/fft_convolver.rs:408-410``);
    ``update_extension`` is the implemented variant.  ``mesh=None`` makes a
    1-D ``"sp"`` mesh over the whole process group on the card."""

    def __init__(self, response, block_size: int, max_response_length: int, mesh=None):
        self.mesh = mesh if mesh is not None else make_mesh((dist.get_world_size(),), ("sp",))
        self.device = mesh_device(self.mesh)
        self.cfg, self.state = init(self.mesh, response, block_size, max_response_length)
        self._declared_max = max_response_length
        # head and tail0 meta-spectra (fused and separate) per aligned call
        # length T
        self._khat_cache: dict[int, dict] = {}

    def process(self, input) -> torch.Tensor:
        x = as_signal(input, self.device)
        tb = self.cfg.tail_block
        if x.shape[0] % tb:
            raise ValueError(
                f"ShardedTwoStageConvolver.process takes period-aligned input "
                f"(multiples of tail_block={tb} samples, got {x.shape[0]})"
            )
        if x.shape[0] == 0:
            return x
        t = x.shape[0] // self.cfg.head_block
        if t not in self._khat_cache:
            self._khat_cache[t] = two_stage.stream_khats(self.cfg, self.state, t,
                                                         want_tail=False)
        return stream_aligned(self.cfg, self.mesh, self.state, x.view(t, -1),
                              self._khat_cache[t]).reshape(-1)

    def update(self, response) -> None:
        raise NotImplementedError(
            "TwoStageFFTConvolver::update is todo!() in the reference "
            "(src/fft_convolver.rs:408-410); use update_extension() or the "
            "crossfade wrapper"
        )

    def update_extension(self, response) -> None:
        response = as_signal(response, self.device)
        if response.shape[0] > self._declared_max:
            raise ValueError("New impulse response is longer than initialized length")
        if response.shape[0] == 0:
            return
        update(self.cfg, self.state, copy_and_pad(response, self._declared_max),
               response.shape[0])
        self._khat_cache.clear()  # built from the old stage tables

    def reset(self) -> None:
        reset(self.cfg, self.state)

    def snapshot(self) -> two_stage.TwoStageState:
        return self.state.clone()

    def restore(self, snap: two_stage.TwoStageState) -> None:
        self.state = snap.clone()
        self._khat_cache.clear()  # the snapshot may hold other stage tables

    def clone(self) -> "ShardedTwoStageConvolver":
        other = object.__new__(ShardedTwoStageConvolver)
        other.__dict__.update(self.__dict__)
        other.state = self.state.clone()
        other._khat_cache = dict(self._khat_cache)  # entries are never written in place
        return other
