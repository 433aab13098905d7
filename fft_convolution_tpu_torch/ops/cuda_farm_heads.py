"""Kernel B6: the reverb farm's head + tail0 path, hand-written in CUDA C++
for Hopper (``csrc/b6_farm_heads.cu``) — counterpart of ``_heads_fused`` and
``_heads_state_out`` (``fft_convolution_tpu/parallel/farm2.py:931,891``),
which the JAX package computes in jnp, with no Pallas kernel.

For ``blocks [T, V, B]`` (``T`` a positive multiple of the head's segment
count ``n``, which is the farm's period) and the voice-stacked head and
tail0 stages, one call computes ``y [T, V, B] = head(x) +
delay_1_period(tail0(x))`` through the combined ``2n``-segment table
(:func:`..models.two_stage.combined_head_kernel`) over the input history
``[hist (n - 1 rows), the ring read oldest first, the new spectra]``, and
the exit state: the head ring rebuilt at ``current' = (current - T) mod
n`` and ``hist`` (both in place), both stages' ``current`` and
``pre_multiplied`` and the head's overlap (new tensors).  tail0's ring and
overlap are dead in the farm and stay untouched.

``suppress`` (a host bool tensor ``[V]``, so reading it never waits on the
card): voices updated right before this call get no tail0 contribution in
their first period.  :func:`suppress_rows` computes the masked remainder
``w [V, n, B+1]`` in torch from the ring before the call writes it; it is
subtracted from the first ``n`` rows of the block-axis convolution, before
the inverse and the overlap-add.  ``delay``: optional ``(precalc [V, n B],
output [V, n B], rows [q, V, n B])``, the big tail's pending precalc (added
in period 0), its pending output (period 1) and this call's tail rows (row
``j - 2`` in period ``j``), so the farm's delay line costs no extra pass.

:func:`heads_step` launches the kernel for CUDA tensors (three launches: the
forward transforms, one thread block a (voice, bin) column for the
block-axis convolution and the exit state, the inverse transforms; shaped
by :func:`heads_plan`, a pure function the CPU tests cover) and takes the
plain PyTorch version :func:`heads_step_plain` only for CPU tensors; it
never falls back.  ``heads_step.launches`` counts its calls.  The plain
version takes an optional ``khat`` (the table's cached meta-spectra,
:func:`..parallel.farm2.farm2_head_khat`; a caller binds it with
``functools.partial``); the kernel transforms the raw table column by
column, in registers, and takes none.

Limits of the kernel (:func:`heads_plan`): ``4 <= B <= 2048`` and at most
1024 head segments; :func:`..parallel.farm2.farm2_init` checks them when it
builds a farm on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from ..models import uniform
from ..models.two_stage import combined_head_kernel
from .cuda_engine import check_block, require
from .fft import causal_conv_time, irdft_block, rdft_block, twiddles

METAS = (256, 1024, 4096)  # the column transform's sizes (radix-16 stages and one radix-4)
MAX_TILE = 16      # blocks a forward or finishing thread block, at most
MAX_THREADS = 1024
MAX_SMEM = 232448  # dynamic shared memory a thread block may opt into (227 KB)


def column_smem(meta: int, n: int) -> int:
    """Dynamic shared memory of a column thread block (``column_smem`` of
    ``csrc/b6_farm_heads.cu``): two exchange buffers padded one float2 in
    seventeen, the table's spectrum, the raw table column and 64 warp
    sums."""
    return 8 * (2 * (meta + meta // 16) + meta + 2 * n + 64)


@dataclasses.dataclass(frozen=True)
class HeadsPlan:
    meta: int      # M: the column transform, the least of METAS >= 4n
    step: int      # conv rows a segment of the overlap-save: M - 2n
    segments: int  # segments a column: ceil(T / step)
    fwd_tile: int  # blocks a forward thread block
    fin_tile: int  # blocks a finishing thread block (it also inverts the one before)


def heads_plan(n: int, b: int, t: int) -> HeadsPlan:
    """The launch shape for ``n`` head segments, block ``b`` and ``T = t``
    blocks; raises ``ValueError`` for a shape the kernel cannot run.  A
    block transform runs on a team of ``b / 16`` threads (at least one); a
    thread block holds at most 1024 threads, for teams of more than a warp
    at most 15 teams (one named barrier each), and as many teams as leave
    the forward's exchange buffers (``b + b/16`` complex a team) and its
    staging tile (``b + 1`` a team and one more) in shared memory."""
    check_block(b)
    if b < 4:
        raise ValueError(f"B6 takes blocks of at least 4 samples, got {b}")
    if n < 1:
        raise ValueError(f"B6 needs at least one head segment, got {n}")
    if t < n or t % n:
        raise ValueError(f"T={t} must be a positive multiple of the period {n}")
    meta = next((m for m in METAS if m >= 4 * n), None)
    if meta is None:
        raise ValueError(f"B6 takes at most {METAS[-1] // 4} head segments (its column "
                         f"transform of at most {METAS[-1]} points), got n={n}")
    team = max(b // 16, 1)
    teams = min(MAX_THREADS // team if team <= 32 else min(MAX_THREADS // team, 15),
                (MAX_SMEM // 8 - (b + 1)) // (b + b // 16 + b + 1))
    step = meta - 2 * n
    return HeadsPlan(meta=meta, step=step, segments=-(-t // step),
                     fwd_tile=min(MAX_TILE, teams), fin_tile=min(MAX_TILE, teams - 1))


def suppress_rows(st_h: uniform.UniformState, st_t0: uniform.UniformState,
                  suppress: torch.Tensor) -> torch.Tensor | None:
    """tail0's first-period remainder for the voices flagged in ``suppress``
    (their update zeroed ``hist``; this removes the ring-sourced rest): a
    small causal convolution of tail0's table with the ring, ``[V, n, B+1]``,
    zero for unflagged voices; None when no voice is flagged.  Read the ring
    before a call rewrites it."""
    if not bool(suppress.any()):
        return None
    n = st_h.segments.shape[-2]
    ring = uniform.ring_window(st_h.segments, st_h.current)
    ext_w = torch.cat([torch.zeros_like(ring[:, 1:]), ring], dim=1)  # [V, 2n-1, B+1]
    w = causal_conv_time(ext_w, st_t0.segments_ir, n, m=2 * n)
    return w * suppress.to(w.device)[:, None, None]


def _state_out(st_h: uniform.UniformState, st_t0: uniform.UniformState, ext: torch.Tensor,
               outs: torch.Tensor, t: int, hist: torch.Tensor) -> None:
    """The exit state from ``ext`` (``hist``, ring window, new spectra) and
    the inverse transforms ``outs`` (``_heads_state_out``): the head ring
    rebuilt from the last ``n`` rows and ``hist`` from the ``n - 1`` before
    them (in place), both stages' ``current`` and ``pre_multiplied``, the
    head overlap."""
    n, b = st_h.segments.shape[-2], st_h.overlap.shape[-1]
    cur = (st_h.current - t) % n
    ring, byd = uniform.ring_from_ext(ext, 2 * n - 1 + t, n, cur)
    st_h.segments.copy_(ring)
    st_h.pre_multiplied = (st_h.segments_ir[:, 1:] * byd[:, 1:]).sum(dim=1)
    st_t0.pre_multiplied = (st_t0.segments_ir[:, 1:] * byd[:, 1:]).sum(dim=1)
    st_h.current = st_t0.current = cur
    st_h.overlap = outs[:, -1, b:].contiguous()
    hist.copy_(ext[:, t:t + n - 1])


def _add_delay(y: torch.Tensor, delay: tuple, n: int) -> None:
    """The big tail's delay line into ``y [T, V, B]``, in place."""
    pre, out, rows = delay
    t, v, b = y.shape
    q = t // n
    yq = y.view(q, n, v, b)
    yq[0] += pre.view(v, n, b).transpose(0, 1)
    if q >= 2:
        yq[1] += out.view(v, n, b).transpose(0, 1)
    if q > 2:
        yq[2:] += rows[:q - 2].view(q - 2, v, n, b).transpose(1, 2)


def heads_step_plain(st_h: uniform.UniformState, st_t0: uniform.UniformState,
                     blocks: torch.Tensor, hist: torch.Tensor, suppress: torch.Tensor,
                     delay: tuple | None = None, khat: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """The plain PyTorch version of the call, on any device: one causal
    convolution along the block axis (:func:`..ops.fft.causal_conv_time`)
    against the combined table, or against its meta-spectra ``khat``."""
    n, b = st_h.segments.shape[-2], st_h.overlap.shape[-1]
    t = blocks.shape[0]
    w = suppress_rows(st_h, st_t0, suppress)
    specs = rdft_block(blocks.transpose(0, 1), 2 * b)                # [V, T, B+1]
    ring = uniform.ring_window(st_h.segments, st_h.current)          # blocks -n..-1
    ext = torch.cat([hist, ring, specs], dim=1)                      # [V, 2n-1+T, B+1]
    conv = causal_conv_time(ext, combined_head_kernel(st_h, st_t0), t, kern_hat=khat)
    if w is not None:
        conv[:, :n] -= w
    outs = irdft_block(conv, 2 * b)                                  # [V, T, 2B]
    y = outs[:, :, :b] + torch.cat([st_h.overlap[:, None], outs[:, :-1, b:]], dim=1)
    _state_out(st_h, st_t0, ext, outs, t, hist)
    y = y.transpose(0, 1).contiguous()
    if delay is not None:
        _add_delay(y, delay, n)
    return y


_TWIDDLES: dict = {}


def _twiddles(size: int, device: torch.device) -> torch.Tensor:
    """The twiddle table for ``size``-point real transforms, kept on the card
    (one copy to the card per size and device)."""
    key = (size, device)
    if key not in _TWIDDLES:
        _TWIDDLES[key] = twiddles(size, device)
    return _TWIDDLES[key]


def heads_step(st_h: uniform.UniformState, st_t0: uniform.UniformState,
               blocks: torch.Tensor, hist: torch.Tensor, suppress: torch.Tensor,
               delay: tuple | None = None) -> torch.Tensor:
    """One call (module docstring).  CUDA tensors launch kernel B6, CPU
    tensors take :func:`heads_step_plain`.  Returns ``y [T, V, B]``."""
    if blocks.device.type == "cpu":
        return heads_step_plain(st_h, st_t0, blocks, hist, suppress, delay)
    dev = blocks.device
    v, n, nb = st_h.segments.shape
    b, t = nb - 1, blocks.shape[0]
    plan = heads_plan(n, b, t)
    blocks = blocks.contiguous()
    c64 = torch.complex64
    require(blocks, "blocks", (t, v, b), torch.float32, dev)
    require(st_h.segments, "head ring", (v, n, nb), c64, dev)
    require(st_h.segments_ir, "head table", (v, n, nb), c64, dev)
    require(st_t0.segments_ir, "tail0 table", (v, n, nb), c64, dev)
    require(hist, "hist", (v, n - 1, nb), c64, dev)
    require(st_h.overlap, "head overlap", (v, b), torch.float32, dev)
    if not 0 <= st_h.current < n:
        raise ValueError(f"heads_step: ring head {st_h.current} outside the ring of {n}")
    ptrs = [None] * 3
    if delay is not None:
        for name, tensor, shape in zip(("precalc", "output", "rows"), delay,
                                       ((v, n * b), (v, n * b), (t // n, v, n * b))):
            require(tensor, f"delay {name}", shape, torch.float32, dev)
        ptrs = [d.data_ptr() for d in delay]
    w = suppress_rows(st_h, st_t0, suppress)  # from the ring before the kernel writes it
    w = None if w is None else w.mT.contiguous()  # bins-major [V, B+1, n]
    scratch = torch.empty((2, v, nb, t), dtype=c64, device=dev)
    y = torch.empty((t, v, b), device=dev)
    overlap = torch.empty((v, b), device=dev)
    pre_h = torch.empty((v, nb), dtype=c64, device=dev)
    pre_t = torch.empty((v, nb), dtype=c64, device=dev)
    cur_new = (st_h.current - t) % n
    err = _build.kernel("fdl_b6_heads")(
        blocks.data_ptr(), st_h.segments.data_ptr(), hist.data_ptr(),
        st_h.segments_ir.data_ptr(), st_t0.segments_ir.data_ptr(), st_h.overlap.data_ptr(),
        _twiddles(2 * b, dev).data_ptr(), _twiddles(2 * plan.meta, dev).data_ptr(),
        scratch.data_ptr(), y.data_ptr(), overlap.data_ptr(), pre_h.data_ptr(),
        pre_t.data_ptr(), None if w is None else w.data_ptr(), *ptrs,
        v, b, n, t, st_h.current, cur_new, plan.meta, plan.fwd_tile, plan.fin_tile,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fdl_b6_heads")
    st_h.overlap, st_h.pre_multiplied, st_t0.pre_multiplied = overlap, pre_h, pre_t
    st_h.current = st_t0.current = cur_new
    heads_step.launches += 1
    return y


heads_step.launches = 0
