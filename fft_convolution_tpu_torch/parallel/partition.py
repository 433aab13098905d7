"""Segment-axis sharding: one voice, one giant IR, several ranks —
counterpart of ``fft_convolution_tpu/parallel/partition.py``.

The frequency-delay line is partitioned by ring row over the mesh's ``"sp"``
dimension (:mod:`.mesh`):

* ``segments`` (the input-spectra ring): rank ``r`` of ``"sp"`` keeps rows
  ``[r L, (r + 1) L)``, ``L = N / |sp|``;
* ``segments_ir`` is replicated: one ``complex64 [N, B+1]`` table on every
  rank (each reads only a window of it a block, and it changes only at an
  update);
* each rank computes its masked spectral MAC over its own rows, and one
  ``dist.all_reduce`` of the ``complex64 [B+1]`` partial over the ``"sp"``
  group merges them: the only collective of the audio path;
* the fresh block's spectrum is computed on every rank (one small rFFT), so
  the current partition's product ``spec * ir[0]`` needs no collective; only
  the owner of row ``current`` writes the spectrum into its slab.

Stored row ``j`` pairs IR row ``(j - current) mod active`` (the reference
reads ring row ``(current + i) % active`` for IR row ``i``,
``src/fft_convolver.rs:248``).  With a full ring (``active == N``, the
steady state) a rank's rows pair one window of the table that wraps at most
once: two slices, no gather.  To make the full ring the steady state,
:func:`init` pads the segment count up to a multiple of ``|sp|`` and
declares ``active = N``: a reference convolver whose ``max_response_length``
is padded to that multiple (trailing zero segments are live and silent,
``src/fft_convolver.rs:118``).  After an :func:`update` shrinks ``active``
the step takes the exact masked gather for the shrunk-ring transient.

The JAX package stores the IR table doubled, ``[2N, 2, B]``, so that its TPU
reads the window as one dynamic slice and never gathers: a TPU workaround.
The port keeps one table and reads the window modulo ``N``.

On a 2-D ``(dp, sp)`` mesh the line is sharded over ``"sp"`` and replicated
over ``"dp"``: the slab is sized by the ``"sp"`` dimension, not the world.
Every rank of an ``"sp"`` group runs the same calls in the same order.

:func:`update` and :func:`reset` complete the ``Convolution`` contract
(``src/fft_convolver.rs:174-213,296-307``): update keeps the sharded input
history and ``current``, re-transforms the replicated table, zeroes
``overlap`` and shrinks ``active``; reset clears the input side and keeps
the IR.  As in :mod:`..models.uniform`, the state is updated in place and
its scalars are host ints.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..api import as_signal
from ..models import uniform
from ..ops.fft import copy_and_pad, ir_to_spectra, irdft_block, rdft_block
from .mesh import dim_size, make_mesh, mesh_device


@dataclasses.dataclass
class ShardedFDLState:
    """A rank's part of the distributed uniform-convolver state."""

    segments: torch.Tensor     # complex64 [N / |sp|, B+1]: this rank's ring rows
    segments_ir: torch.Tensor  # complex64 [N, B+1]: replicated IR partition spectra
    overlap: torch.Tensor      # f32 [B]: replicated overlap-add tail
    current: int               # ring head, a global row
    active_segs: int           # active partition count

    def clone(self) -> "ShardedFDLState":
        return ShardedFDLState(self.segments.clone(), self.segments_ir.clone(),
                               self.overlap.clone(), self.current, self.active_segs)


def init(mesh, response, block_size: int, max_response_length: int
         ) -> tuple[uniform.UniformConfig, ShardedFDLState]:
    """A sharded FDL on ``mesh`` (``init``,
    ``fft_convolution_tpu/parallel/partition.py:76``): the segment count is
    padded up to a multiple of the ``"sp"`` size, and the whole padded ring
    is live."""
    n_shards = dim_size(mesh, "sp")
    cfg0 = uniform.make_config(block_size, max_response_length)
    seg_count = -(-cfg0.seg_count // n_shards) * n_shards
    cfg = uniform.UniformConfig(block_size=cfg0.block_size, seg_count=seg_count,
                                ir_len=cfg0.ir_len)
    dev = mesh_device(mesh)
    response = as_signal(response, dev)
    if max_response_length < response.shape[0]:
        raise ValueError(
            "max_response_length must be at least the length of the initial "
            "impulse response"
        )
    padded = copy_and_pad(response, seg_count * cfg.block_size)
    state = ShardedFDLState(
        segments=torch.zeros((seg_count // n_shards, cfg.bins), dtype=torch.complex64,
                             device=dev),
        segments_ir=ir_to_spectra(padded, cfg.block_size, seg_count),
        overlap=torch.zeros(cfg.block_size, device=dev),
        current=0, active_segs=seg_count,
    )
    return cfg, state


def update(cfg: uniform.UniformConfig, state: ShardedFDLState,
           response_padded: torch.Tensor, new_len: int) -> None:
    """RT-safe IR swap on the sharded FDL (``src/fft_convolver.rs:174-213``),
    in place.  ``response_padded`` is zero-padded to ``seg_count *
    block_size`` (zero rows past the new active count are the reference's
    explicit clear, ``:210-212``); ``new_len`` is its true length."""
    state.segments_ir = ir_to_spectra(response_padded, cfg.block_size, cfg.seg_count)
    state.overlap.zero_()
    state.active_segs = -(-new_len // cfg.block_size)


def reset(state: ShardedFDLState) -> None:
    """``Convolution::reset`` (``src/fft_convolver.rs:296-307``): clears the
    input side, keeps the IR table and ``active_segs``."""
    state.segments.zero_()
    state.overlap.zero_()
    state.current = 0


def step(cfg: uniform.UniformConfig, mesh, state: ShardedFDLState,
         x: torch.Tensor) -> torch.Tensor:
    """One block ``x [B] -> y [B]`` (``_build_raw_step``,
    ``fft_convolution_tpu/parallel/partition.py:154``): the local MAC, one
    all-reduce of the ``[B+1]`` partial over ``"sp"``, then ``conv = pre +
    spec * ir[0]``, the inverse transform, the overlap-add and ``current``
    decremented modulo ``active``."""
    b, n = cfg.block_size, cfg.seg_count
    table, seg = state.segments_ir, state.segments
    rows = seg.shape[0]
    row0 = mesh.get_local_rank("sp") * rows
    cur, active = state.current, state.active_segs
    spec = rdft_block(x, cfg.fft_size)
    mine = row0 <= cur < row0 + rows
    if mine:
        seg[cur - row0] = spec
    if active == n:
        # full ring: rows row0.. pair IR rows (row0 - cur) mod n.., a window
        # that wraps at most once
        start = (row0 - cur) % n
        end = start + rows
        window = table[start:end] if end <= n else torch.cat([table[start:], table[:end - n]])
        prod = window * seg
        if mine:
            prod[cur - row0] = 0  # row `current` pairs ir[0]: added below
    else:
        # shrunk ring after an update: the exact masked gather
        j = torch.arange(row0, row0 + rows, device=seg.device)
        ir_idx = (j - cur) % max(active, 1)
        prod = table[ir_idx] * seg
        prod[(j >= active) | (ir_idx < 1)] = 0
    pre = prod.sum(dim=0)
    dist.all_reduce(pre, group=mesh.get_group("sp"))
    out = irdft_block(pre + spec * table[0], cfg.fft_size)
    y = out[:b] + state.overlap
    state.overlap = out[b:].contiguous()
    state.current = cur - 1 if cur > 0 else active - 1
    return y


def stream(cfg: uniform.UniformConfig, mesh, state: ShardedFDLState,
           blocks: torch.Tensor) -> torch.Tensor:
    """``blocks [T, B] -> y [T, B]``, one :func:`step` (one all-reduce) a
    block (``build_stream``, ``fft_convolution_tpu/parallel/partition.py:233``)."""
    return torch.stack([step(cfg, mesh, state, xb) for xb in blocks])


class ShardedFFTConvolver:
    """The ``Convolution`` contract over an ``"sp"`` mesh: one voice, one
    giant IR, the frequency-delay line's rows sharded over the ranks
    (``ShardedFFTConvolver``, ``fft_convolution_tpu/parallel/partition.py:249``).

    Every rank of the mesh constructs it with the same full IR and makes the
    same calls with the same input; each gets the whole output.  ``process``
    takes block-aligned input (any multiple of ``block_size``): this is the
    serving path for IRs too long for one device, not the arbitrary-chunk
    host API (:class:`~..api.FFTConvolver`).  Equivalent to a single-device
    ``FFTConvolver`` whose ``max_response_length`` is padded up to a mesh
    multiple of segments.  ``mesh=None`` makes a 1-D ``"sp"`` mesh over the
    whole process group on the card.  Tensors live on the mesh's device
    (``device``)."""

    def __init__(self, response, block_size: int, max_response_length: int, mesh=None):
        self.mesh = mesh if mesh is not None else make_mesh((dist.get_world_size(),), ("sp",))
        self.device = mesh_device(self.mesh)
        self.cfg, self.state = init(self.mesh, response, block_size, max_response_length)
        self._declared_max = max_response_length

    def process(self, input) -> torch.Tensor:
        x = as_signal(input, self.device)
        b = self.cfg.block_size
        if x.shape[0] % b:
            raise ValueError(
                f"ShardedFFTConvolver.process takes block-aligned input "
                f"(multiples of {b} samples, got {x.shape[0]})"
            )
        if x.shape[0] == 0:
            return x
        return stream(self.cfg, self.mesh, self.state, x.view(-1, b)).reshape(-1)

    def update(self, response) -> None:
        """RT-safe IR swap (``src/fft_convolver.rs:174-213``)."""
        response = as_signal(response, self.device)
        if response.shape[0] > self._declared_max:
            raise ValueError("New impulse response is longer than initialized length")
        if self._declared_max == 0:
            return
        update(self.cfg, self.state,
               copy_and_pad(response, self.cfg.seg_count * self.cfg.block_size),
               response.shape[0])

    def reset(self) -> None:
        reset(self.state)

    def snapshot(self) -> ShardedFDLState:
        return self.state.clone()

    def restore(self, snap: ShardedFDLState) -> None:
        self.state = snap.clone()

    def clone(self) -> "ShardedFFTConvolver":
        other = object.__new__(ShardedFFTConvolver)
        other.__dict__.update(self.__dict__)
        other.state = self.state.clone()
        return other
