"""Voice-stacked uniform stages — counterpart of the single-device part of
``fft_convolution_tpu/parallel/farm.py``.

A farm stage holds V uniform engines that share one :class:`UniformConfig`
and advance in lockstep: the tensors of :class:`UniformState` carry a
leading voice axis (``segments``/``segments_ir`` ``complex64 [V, N, B+1]``,
``overlap``/``input_buffer`` ``[V, B]``, ``pre_multiplied`` ``[V, B+1]``),
and the scalars (``current``, ``input_fill``, ``active_segs``) are one host
int for all voices.  :mod:`.farm2` builds its head and tail0 stages here.

:func:`farm_stream` runs the voices' clean lockstep rings through the
uniform engine's conv core over the voice axis (the JAX package's
``uniform.stream_conv_farm``).

Across ranks: the voice axis is split over the mesh's ``"dp"`` dimension.
Each rank keeps :func:`voice_slab` of its ``mesh.voice_range`` (the JAX
package's ``shard_farm``) and streams it through :func:`farm_stream`
(``sharded_farm_stream``); the audio path has no collective.
"""

from __future__ import annotations

import dataclasses
import torch

from ..models import uniform
from ..ops.fft import rdft_block


def device_budget(device: torch.device) -> int | None:
    """Bytes the guards of :func:`farm_init` and ``farm2_init`` allow under
    ``"auto"``: the CUDA device's free memory at construction, or None (no
    check) for a host device, whose memory is the machine's."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0]


def farm_bytes_per_voice(block_size: int, max_response_length: int) -> int:
    """Device bytes per uniform-farm voice, from the stage's shapes: the
    input-spectra ring and the IR table (``complex64 [N, B+1]`` each), one
    table-sized temporary in :func:`farm_step`'s MAC (the products before
    their sum), and the per-voice buffers."""
    cfg = uniform.make_config(block_size, max_response_length)
    table = cfg.seg_count * cfg.bins * 8
    return 3 * table + 2 * cfg.block_size * 4 + cfg.bins * 8


def stage_spectra(cfg: uniform.UniformConfig, irs_padded: torch.Tensor) -> torch.Tensor:
    """``[K, seg_count * B]`` zero-padded IRs -> ``complex64 [K, N, B+1]``
    partition spectra (``ir_to_spectra`` batched over voices)."""
    k = irs_padded.shape[0]
    return rdft_block(irs_padded.reshape(k, cfg.seg_count, cfg.block_size), cfg.fft_size)


def farm_init(irs, block_size: int, max_response_length: int,
              device=None) -> tuple[uniform.UniformConfig, uniform.UniformState]:
    """V voices from ``irs [V, ir_len]`` (``farm_init``,
    ``fft_convolution_tpu/parallel/farm.py:47``); returns the shared config
    and the voice-stacked state, on ``device`` (default: where ``irs`` is).

    Raises ``ValueError`` when the estimate (:func:`farm_bytes_per_voice`
    x V) exceeds the CUDA device's free memory; a long-IR farm should use
    the two-stage ``ReverbFarm`` instead."""
    irs = torch.as_tensor(irs, dtype=torch.float32, device=device)
    v = irs.shape[0]
    budget = device_budget(irs.device)
    est = v * farm_bytes_per_voice(block_size, max_response_length)
    if budget is not None and est > budget:
        raise ValueError(
            f"uniform farm of {v} voices x {max_response_length} samples needs "
            f"~{est / 1e9:.2f} GB > the {budget / 1e9:.2f} GB free on {irs.device}. "
            "Long-IR farms should use the two-stage ReverbFarm (parallel/farm2).")
    if max_response_length < irs.shape[-1]:
        raise ValueError(
            "max_response_length must be at least the length of the initial "
            "impulse response"
        )
    cfg = uniform.make_config(block_size, max_response_length)
    total = cfg.seg_count * cfg.block_size
    spec = (v, cfg.seg_count, cfg.bins)
    state = uniform.UniformState(
        segments=torch.zeros(spec, dtype=torch.complex64, device=irs.device),
        segments_ir=torch.zeros(spec, dtype=torch.complex64, device=irs.device),
        overlap=torch.zeros((v, cfg.block_size), device=irs.device),
        input_buffer=torch.zeros((v, cfg.block_size), device=irs.device),
        pre_multiplied=torch.zeros((v, cfg.bins), dtype=torch.complex64,
                                   device=irs.device),
        current=0, input_fill=0, active_segs=0,
    )
    farm_update(cfg, state, torch.nn.functional.pad(irs, (0, total - irs.shape[-1])),
                cfg.ir_len)
    return cfg, state


def farm_update(cfg: uniform.UniformConfig, state: uniform.UniformState,
                irs_padded: torch.Tensor, new_len: int) -> None:
    """RT-safe IR swap for all voices at once (``farm_update``,
    ``fft_convolution_tpu/parallel/farm.py:92``), in place: ``irs_padded``
    is ``[V, seg_count * B]``; ``new_len`` is one length for every voice
    (the active count is a lockstep host int, where the JAX package takes a
    ``[V]`` array)."""
    state.segments_ir = stage_spectra(cfg, irs_padded)
    state.overlap.zero_()
    state.pre_multiplied.zero_()
    state.active_segs = -(-new_len // cfg.block_size)


def farm_step(cfg: uniform.UniformConfig, state: uniform.UniformState,
              x: torch.Tensor) -> torch.Tensor:
    """One block for every voice (``farm_step``,
    ``fft_convolution_tpu/parallel/farm.py:98``): ``x [V, B] -> y [V, B]``,
    :func:`uniform.process_block` over the voice axis."""
    return uniform.process_block(cfg, state, x)


def farm_khat(cfg: uniform.UniformConfig, state: uniform.UniformState,
              t: int) -> torch.Tensor:
    """Every voice's stream kernel meta-spectra for ``t``-block calls
    (``farm_khat``, ``fft_convolution_tpu/parallel/farm.py:128``):
    :func:`uniform.stream_khat` over the voice axis, ``[V, m, B+1]``.
    Rebuild after :func:`farm_update`; pass to :func:`farm_stream`."""
    return uniform.stream_khat(cfg, state, t)


def farm_stream(cfg: uniform.UniformConfig, state: uniform.UniformState,
                blocks: torch.Tensor, kern_hat: torch.Tensor | None = None) -> torch.Tensor:
    """Stream ``blocks [T, V, B] -> [T, V, B]`` (``farm_stream``,
    ``fft_convolution_tpu/parallel/farm.py:143``); the state advances in
    place.  Full clean rings (``active_segs == seg_count``, ``current <
    active_segs``; the lockstep scalars are shared) take the conv core
    over the voice axis (:func:`uniform.stream_conv`) whatever ``T``;
    otherwise the per-block :func:`farm_step` loop."""
    if state.active_segs == cfg.seg_count and state.current < state.active_segs:
        return uniform.stream_conv(cfg, state, blocks.transpose(0, 1),
                                   kern_hat).transpose(0, 1).contiguous()
    return torch.stack([farm_step(cfg, state, xt) for xt in blocks])


def voice_slab(state: uniform.UniformState, voices: range) -> uniform.UniformState:
    """A copy of ``voices`` of a voice-stacked stage; the lockstep scalars
    as they are."""
    sl = slice(voices.start, voices.stop)
    return dataclasses.replace(
        state, **{f.name: getattr(state, f.name)[sl].clone()
                  for f in dataclasses.fields(state)
                  if isinstance(getattr(state, f.name), torch.Tensor)})
