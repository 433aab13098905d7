"""Roofline accounting on the H100: the least time the card could take for
the work of each path the port runs, and a measured time's share of it —
counterpart of ``fft_convolution_tpu/utils/roofline.py``, written afresh
for the H100, not transcribed.

The JAX module counts its own implementation (DFT-as-matmul, packed
spectra, each materialised intermediate) against TPU v5e peaks.  This one
counts the work of the FUNCTION a path computes, so that any two
implementations of one function share one bound and no correct
implementation can read above 100 %:

* **Bytes**: each input the function must read, counted once (the IR
  spectrum tables; the carried state: rings and histories, overlaps,
  period buffers; the input blocks), and each output and each new state
  counted once as a write (of a ring, the rows a call replaces).
  Intermediates, scratch partials and re-reads are not counted.  Block
  transforms also read their twiddle table (``2B`` complex64) once, as the
  per-block kernels' counts always had it.  A complex64 bin is 8 bytes, a
  bf16 (re, im) pair 4, a float32 sample 4.
* **FLOPs**: the fewer of the algorithms the port implements for the
  function.  The reference's per-block form: a real FFT of ``2B`` points
  at 2.5·N·log2 N (:func:`fft_cost`), 8 FLOPs a complex MAC per segment
  and bin, one inverse per output stage.  The block-axis form of
  ``models/uniform._stream_conv`` / ``ops/fft.causal_conv_time``: a
  complex FFT of ``m`` points at 5·m·log2 m per bin lane over the history
  and the new spectra, 6 FLOPs a complex product, one inverse a table,
  with the IR's meta-spectrum cached as every wrapper caches it; for head
  + tail0, also the combined ``2n``-segment kernel of the fused front end
  and the farm's heads (one inverse a block), by overlap-save at the
  cheapest meta size (kernel B6's form; one transform is the largest).

So the count does not depend on the route: the fused MULTI, fused
SEPARATE and separate-streams forms of an aligned two-stage call, its
CHRONO and ring big tails, kernel B4 and the conv core at B4's shape, a
kernel and its plain version, all get one :class:`Cost` from the same
shapes.  Every segment is counted live: the engines the port costs run
with full rings (an engine shrunk by ``update`` is costed at capacity).

**Peaks come from the card** (:func:`peaks`): one entry, the H100 SXM
part, at NVIDIA's data-sheet rates for the full 700 W power limit.  Any
other card, or a CPU device, raises ``ValueError``: no guessed peaks.  A
card set below 700 W runs slower under load, so a caller prints the power
limit (``nvidia-smi --query-gpu=name,power.limit``) beside every share.

**L2 residency.**  The byte term is taken at the HBM rate.  A working set
that stays in the 50 MB L2 between calls (the per-block tables, 0.2-11.6
MB; B4's ring and table, 23.4 MB) can be read faster than that, so a
future implementation could read near or above 1 against it.
:attr:`Cost.carried` holds the bytes of tables and state a call reads,
and :meth:`Cost.l2_resident` says whether they fit the card's L2; the
rate is not lowered by guesswork.

What the JAX module has and this one does not: the v5e peaks;
``_rdft_cost``, ``_cdft4_cost`` and ``stream_scan_sliced_cost`` (counts
of the DFT-as-matmul stack and the scan cores, neither of which the port
has).  JAX's ``fused_heads_cost`` is the head + tail0 term of
:func:`two_stage_stream_cost`, the same for every form.  Kept by name:
:class:`Cost` (with ``+`` and ``scaled``), :func:`stream_conv_cost`,
:func:`two_stage_stream_cost`, :func:`utilization` (JAX's keys, plus
``bound_us``, ``bound_by`` and ``share``).

The paths, and the call that costs each (configs from ``models/``; counts
are Python numbers, exact at the farm's size):

* B1 / B1p step: ``stream_conv_cost(cfg, 1)`` (B1p: ``ring_item=4,
  table_item=4``); B4 / B4p call: ``stream_conv_cost(cfg, t)`` (B4p:
  ``table_item=4``); B2's big-tail step at a period end:
  ``stream_conv_cost(cfg.tail, 1)``;
* B2 step: :func:`two_stage_step_cost`; B3 step:
  ``crossfade_stream_cost(cfg, 1)``;
* B5 / B5p step: :func:`farm_tail_step_cost`; B6 call:
  :func:`farm_heads_cost`; B7's two launches: :func:`farm_tail_dft_cost`;
* aligned ``FFTConvolver.process`` and ``farm.farm_stream``:
  :func:`stream_conv_cost` (``voices``); aligned two-stage call:
  :func:`two_stage_stream_cost`; two-engine crossfade:
  :func:`crossfade_stream_cost`; ``ReverbFarm.process`` (the short-IR
  farm included): :func:`farm_cost`.

Imports ``torch`` only (for :func:`peaks`), nothing of the port, so a
script can load this file by path and cost another checkout's engines: a
cost function reads only the config attributes it names.
"""

from __future__ import annotations

import dataclasses
import math

import torch

C64, BF16_PAIR, F32 = 8, 4, 4  # bytes: a complex64 bin, a bf16 (re, im) pair, a float32


@dataclasses.dataclass(frozen=True)
class Cost:
    """FLOPs and compulsory bytes of one call; ``carried``: the bytes of IR
    tables and state among them, the working set a stream carries across
    calls (see :meth:`l2_resident`)."""

    flops: float = 0.0
    bytes: float = 0.0
    carried: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes, self.carried + o.carried)

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k, self.carried * k)

    def l2_resident(self, pk: "Peaks") -> bool:
        """Whether the carried working set fits the card's L2, where it can
        stay between calls and be read faster than the HBM rate."""
        return 0 < self.carried <= pk.l2_bytes


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str                # torch.cuda.get_device_properties(...).name
    hbm_bytes_per_s: float
    fp32_flops_per_s: float  # FP32 outside the tensor cores
    l2_bytes: int


# NVIDIA's H100 SXM data sheet, at the full 700 W power limit: 3.35 TB/s of
# HBM3, 67 TFLOP/s FP32 outside the tensor cores, 50 MB of L2
H100_SXM = Peaks("NVIDIA H100 80GB HBM3", 3.35e12, 67e12, 50 * 2**20)
PEAKS = {H100_SXM.name: H100_SXM}


def peaks(device) -> Peaks:
    """The peaks of the card ``device`` (a ``torch.device``, a string or an
    index), looked up by its name.  Raises ``ValueError`` for a CPU device
    or a card not in :data:`PEAKS`."""
    dev = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no roofline peaks for {dev}: the bound is a CUDA card's")
    name = torch.cuda.get_device_properties(dev).name
    if name not in PEAKS:
        raise ValueError(f"no roofline peaks for the card {name!r} ({dev}); known: "
                         f"{sorted(PEAKS)}")
    return PEAKS[name]


def fft_cost(n: int, count: int = 1, real: bool = True) -> Cost:
    """FLOPs of ``count`` FFTs of ``n`` points: 2.5·n·log2 n for a real
    transform, 5·n·log2 n for a complex one.  No bytes: the operands are
    the caller's."""
    per = (2.5 if real else 5.0) * n * math.log2(n) if n > 1 else 0.0
    return Cost(flops=count * per)


def bound(cost: Cost, pk: Peaks) -> dict:
    """The least time the card could take for ``cost``: the larger of its
    bytes over the HBM rate and its FLOPs over the FP32 peak, which of the
    two bounds it, and whether the working set is L2-resident."""
    t_bytes, t_ops = cost.bytes / pk.hbm_bytes_per_s, cost.flops / pk.fp32_flops_per_s
    t = max(t_bytes, t_ops)
    return {"bound_ms": t * 1e3, "bound_us": t * 1e6,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "l2_resident": cost.l2_resident(pk)}


def utilization(cost: Cost, seconds: float, pk: Peaks) -> dict:
    """Rates of ``cost`` done in ``seconds`` (JAX's keys: ``mfu`` against
    the FP32 peak, ``hbm_util``, ``gflops``, ``gbps``), its bound
    (``bound_us``, ``bound_by``) and ``share`` = bound / ``seconds``.  A
    share above 1 means the count is wrong."""
    b = bound(cost, pk)
    return {"mfu": cost.flops / seconds / pk.fp32_flops_per_s,
            "hbm_util": cost.bytes / seconds / pk.hbm_bytes_per_s,
            "gflops": cost.flops / seconds / 1e9, "gbps": cost.bytes / seconds / 1e9,
            "bound_us": b["bound_us"], "bound_by": b["bound_by"],
            "share": b["bound_ms"] / 1e3 / seconds}


def _npo2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _twiddles(b: int) -> Cost:
    """The real transform's twiddle table at block ``b`` (2b complex64),
    read once a call."""
    return Cost(bytes=2 * b * C64)


def _mac_flops(rows: list[int], bins: int, t: int) -> float:
    """The MAC of ``t`` blocks against tables of ``rows`` segments over one
    history, for ``bins`` lanes: the fewer of the per-block form (8 a
    complex MAC) and the block-axis form (one transform of the history and
    the new spectra at ``m = npo2(max(rows) - 1 + t)``, a product and an
    inverse a table)."""
    direct = 8.0 * sum(rows) * bins * t
    m = _npo2(max(rows) - 1 + t)
    axis = bins * ((1 + len(rows)) * fft_cost(m, real=False).flops + 6.0 * len(rows) * m)
    return min(direct, axis)


def _overlap_save_flops(taps: int, bins: int, t: int) -> float:
    """A causal convolution of ``t`` new rows with a ``taps``-row kernel
    along the block axis, its meta-spectrum held, for ``bins`` lanes: the
    fewest FLOPs over overlap-save at meta sizes ``M`` (powers of two from
    ``npo2(taps)`` to ``npo2(t + taps - 1)``, the last one transform), each
    ``ceil(t / (M - taps + 1))`` segments of a forward and an inverse
    complex transform and a product."""
    best, m = math.inf, _npo2(taps)
    while True:
        segs = -(-t // (m - taps + 1))
        best = min(best, segs * (2 * fft_cost(m, real=False).flops + 6.0 * m))
        if segs == 1:
            return bins * best
        m *= 2


def _history(rows_kept: int, tables: list[int], bins: int, t: int,
             ring_item: int = C64, table_item: int = C64) -> Cost:
    """A frequency-delay line's state for ``t`` blocks, without the MAC:
    the ``rows_kept`` history rows and the tables read once, the rows a
    call replaces (``min(t, rows_kept)``) written."""
    read = rows_kept * bins * ring_item + sum(tables) * bins * table_item
    return Cost(bytes=read + min(t, rows_kept) * bins * ring_item, carried=read)


def _vectors(read: int, written: int, carried: int = 0) -> Cost:
    """``read`` and ``written`` float32 samples; ``carried`` of the read
    ones are state."""
    return Cost(bytes=(read + written) * F32, carried=carried * F32)


def stream_conv_cost(cfg, t: int, voices: int = 1, ring_item: int = C64,
                     table_item: int = C64) -> Cost:
    """A ``t``-block call of a uniform engine (``cfg``: a
    ``UniformConfig``) on each of ``voices`` lockstep voices: the ring and
    the table read, ``min(t, N)`` ring rows written, the blocks in and out,
    the overlap in and out; a forward and an inverse transform a block and
    the MAC (:func:`_mac_flops`).  Covers the aligned ``FFTConvolver`` call
    and ``farm.farm_stream`` (``voices``), kernels B1 (``t = 1``), B1p
    (``t = 1``, bf16 ring and table: ``ring_item = table_item = 4``), B4
    and B4p (a call; B4p's bf16 table: ``table_item = 4``) and B2's
    big-tail step at a period end (``cfg.tail``, ``t = 1``)."""
    n, b = cfg.seg_count, cfg.block_size
    one = (_history(n, [n], b + 1, t, ring_item, table_item)
           + Cost(flops=_mac_flops([n], b + 1, t) + fft_cost(2 * b, 2 * t).flops)
           + _vectors(t * b + b, t * b + b, carried=b))
    return one.scaled(voices) + _twiddles(b)


def crossfade_stream_cost(cfg, t: int) -> Cost:
    """A ``t``-block call of the crossfade morph over two uniform engines of
    one config ``cfg`` fed the same input: one history, the A and B tables,
    both overlaps, one forward and two inverse transforms a block.  The
    mix's few FLOPs a sample are not counted, as B3's never were.  Kernel
    B3 is ``t = 1``; the two-engine ``CrossfadeConvolver``'s aligned call
    is any ``t``."""
    n, b = cfg.seg_count, cfg.block_size
    return (_history(n, [n, n], b + 1, t)
            + Cost(flops=_mac_flops([n, n], b + 1, t) + fft_cost(2 * b, 3 * t).flops)
            + _vectors(t * b + 2 * b, t * b + 2 * b, carried=2 * b) + _twiddles(b))


def _heads(cfg, t: int, history: int, overlaps: int) -> Cost:
    """Head and tail0 of a two-stage config over ``t`` head blocks of one
    input history, without the twiddles and without the period buffers:
    the ``history`` rows and both tables read, the replaced rows written,
    the blocks in, the output out, ``overlaps`` overlaps in and out.
    FLOPs: the forward transforms, then the fewest of the per-block and
    block-axis MACs with one inverse a stage and (tail0 of the head's
    config) the combined ``2n``-segment kernel by overlap-save
    (:func:`_overlap_save_flops`; kernel B6's form, its single transform
    included) with one inverse a block."""
    h, z = cfg.head, cfg.tail0
    n, b = h.seg_count, h.block_size
    tables = [n] + ([z.seg_count] if z is not None else [])
    inv = fft_cost(2 * b, t).flops
    flops = _mac_flops(tables, b + 1, t) + len(tables) * inv
    if z is not None and z.seg_count == n:
        flops = min(flops, _overlap_save_flops(2 * n, b + 1, t) + inv)
    ov = overlaps * b
    return (_history(history, tables, b + 1, t)
            + Cost(flops=fft_cost(2 * b, t).flops + flops)
            + _vectors(t * b + ov, t * b + ov, carried=ov))


def _big_tail(tcfg, q: int, item: int = C64) -> Cost:
    """The big tail over ``q`` tail blocks (one a period) of the input,
    without the twiddles: its ring and table read, ``min(q, N)`` rows
    written, the overlap in and out, a forward and an inverse transform a
    tail block and the MAC.  Its input blocks are the call's and its
    outputs land in the call's output and period buffers, counted there."""
    n, tb = tcfg.seg_count, tcfg.block_size
    return (_history(n, [n], tb + 1, q, item, item)
            + Cost(flops=_mac_flops([n], tb + 1, q) + fft_cost(2 * tb, 2 * q).flops)
            + _vectors(tb, tb, carried=tb))


def _tail_buffers(tb: int, q: int) -> Cost:
    """The big tail's two pending period outputs: the first period reads
    ``tail_precalc``, the second ``tail_output``; the call leaves
    ``min(q, 2)`` new ones."""
    read = tb + (tb if q >= 2 else 0)
    return _vectors(read, min(q, 2) * tb, carried=read)


def _two_stage_heads(cfg, t: int) -> Cost:
    """:func:`_heads` of a two-stage engine: the head's ring, an overlap a
    stage."""
    return _heads(cfg, t, cfg.head.seg_count, 1 + (cfg.tail0 is not None))


def _aligned_t(cfg, t: int) -> int:
    p = cfg.period
    if t <= 0 or t % p:
        raise ValueError(f"T={t} must be a positive multiple of the period {p}")
    return t // p


def two_stage_step_cost(cfg) -> Cost:
    """Kernel B2: one head block through head and tail0 over their one
    ring (``cfg``: a ``TwoStageConfig``): the ring and both tables read,
    the ring row written; in the block, both overlaps and both
    precalculated tail rows, out the output, both overlaps, tail0's output
    row and the period input row.  The big tail at a period end is apart:
    ``stream_conv_cost(cfg.tail, 1)``."""
    b = cfg.head_block
    pending = (cfg.tail0 is not None) + (cfg.tail is not None)
    out0 = cfg.tail0 is not None
    return (_two_stage_heads(cfg, 1) + _vectors(pending * b, (out0 + 1) * b, carried=pending * b)
            + _twiddles(b))


def two_stage_stream_cost(cfg, t: int, voices: int = 1) -> Cost:
    """An aligned two-stage call of ``t`` head blocks (a positive multiple
    of the period; ``cfg``: a ``TwoStageConfig``) on each of ``voices``
    lockstep voices (the short-IR ``ReverbFarm``): head and tail0 over one
    input history (:func:`_heads`: JAX's ``fused_heads_cost`` and its
    separate streams alike), the big tail over ``t / period`` tail blocks
    (CHRONO and ring alike) and the period buffers: tail0's pending output
    read for the first period, its last two periods' outputs written, the
    period input written, the big tail's pending outputs
    (:func:`_tail_buffers`), the stage outputs summed."""
    q = _aligned_t(cfg, t)
    b, p = cfg.head_block, cfg.period
    stages = 1 + (cfg.tail0 is not None) + (cfg.tail is not None)
    one = _two_stage_heads(cfg, t) + _vectors(0, min(t, p) * b) + Cost(flops=(stages - 1) * t * b)
    if cfg.tail0 is not None:
        one += _vectors(min(t, p) * b, min(t, 2 * p) * b, carried=min(t, p) * b)
    c = _twiddles(b)
    if cfg.tail is not None:
        one += _big_tail(cfg.tail, q) + _tail_buffers(cfg.tail_block, q)
        c += _twiddles(cfg.tail_block)
    return one.scaled(voices) + c


def farm_tail_step_cost(cfg, voices: int, t: int, tail_item: int = C64) -> Cost:
    """Kernel B5 (``tail_item = 8``) or B5p (bf16 ring and table,
    ``tail_item = 4``): ``t`` phased MAC steps of the farm's big tail
    (``cfg.tail``) over ``voices`` fused voices: the ring and the table
    read, ``min(t, N)`` ring rows written, the ``t`` new spectra in, the
    ``t`` convolutions and the new ``pre`` out (complex64)."""
    n, tb = cfg.tail.seg_count, cfg.tail_block
    one = (_history(n, [n], tb + 1, t, tail_item, tail_item)
           + Cost(flops=_mac_flops([n], tb + 1, t), bytes=(2 * t + 1) * (tb + 1) * C64))
    return one.scaled(voices)


def farm_cost(cfg, voices: int, t: int, tail_item: int = C64) -> Cost:
    """A ``ReverbFarm.process`` call (``farm2_stream``) of ``t`` head
    blocks on ``voices`` voices.  With a big tail: the heads read the
    farm's ``2n - 1``-row history (ring and ``hist``; the farm keeps no
    tail0 period buffers) and both tables, write the rows a call replaces,
    the blocks and the head overlap; the big tail at ``tail_item`` bytes a
    bin (B5 / B5p) also writes its ``pre``; the pending period outputs;
    the stage outputs summed.  The short-IR farm (no big tail) is
    :func:`two_stage_stream_cost` over the voices."""
    if cfg.tail is None:
        return two_stage_stream_cost(cfg, t, voices)
    q = _aligned_t(cfg, t)
    b, tb = cfg.head_block, cfg.tail_block
    tail = (_big_tail(cfg.tail, q, tail_item) + Cost(bytes=(tb + 1) * C64)
            + _tail_buffers(tb, q))
    return (farm_heads_cost(cfg, voices, t) + (tail + Cost(flops=2 * t * b)).scaled(voices)
            + _twiddles(tb))


def farm_tail_dft_cost(cfg, voices: int, t: int, forward: bool = True,
                       inverse: bool = True) -> Cost:
    """Kernel B7: the farm's big-tail transforms over ``t`` head blocks (a
    positive multiple of the period: ``q = t / period`` tail rows) on
    ``voices`` voices.  The forward reads the rows' samples (``q x tb``
    f32) and writes their spectra (``q x (tb+1)`` complex64); the inverse
    reads the B5 sums (``q x (tb+1)`` complex64), writes ``y`` (``q x tb``
    f32) and reads and writes the overlap (``tb`` f32); each reads the
    twiddle table (``2 tb`` complex64) once and does a real FFT of ``2 tb``
    points a row.  ``forward`` / ``inverse`` pick one launch's share."""
    q = _aligned_t(cfg, t)
    tb = cfg.tail_block
    row = Cost(bytes=q * (tb + 1) * C64) + fft_cost(2 * tb, q)
    c = Cost()
    if forward:
        c += (row + _vectors(q * tb, 0)).scaled(voices) + _twiddles(tb)
    if inverse:
        c += (row + _vectors(tb, q * tb + tb, carried=tb)).scaled(voices) + _twiddles(tb)
    return c


def farm_heads_cost(cfg, voices: int, t: int) -> Cost:
    """Kernel B6: the farm's head path over ``t`` head blocks (a positive
    multiple of the period) on ``voices`` voices (``farm_cost``'s head
    term): the ``2n - 1``-row history (ring and ``hist``) and both tables
    read, the replaced rows written, the blocks in and the output out, the
    head overlap in and out (tail0's is dead in the farm), the block
    transforms' twiddles; FLOPs as :func:`_heads`."""
    _aligned_t(cfg, t)
    n = cfg.head.seg_count
    return _heads(cfg, t, 2 * n - 1, 1).scaled(voices) + _twiddles(cfg.head_block)
