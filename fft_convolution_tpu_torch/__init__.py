"""fft_convolution_tpu_torch — the PyTorch and CUDA port of
``fft_convolution_tpu`` for NVIDIA Hopper.

Real-time-safe uniform, non-uniform (two-stage) and crossfading
partitioned convolution with the reference's ``Convolution`` surface
(``src/lib.rs:5-14``), serving wrappers over hand-written CUDA kernels, and
the many-voice reverb farm.
Imports ``torch`` and never ``jax``; kernels are built with ``nvcc`` at
their first CUDA use.

Public surface ported so far:

* :class:`~fft_convolution_tpu_torch.api.Convolution` — the protocol
* :class:`~fft_convolution_tpu_torch.api.FFTConvolver` — uniform partitions
* :class:`~fft_convolution_tpu_torch.api_two_stage.TwoStageFFTConvolver`
* :class:`~fft_convolution_tpu_torch.api_crossfade.CrossfadeConvolver` —
  IR switching over any engine
* :class:`~fft_convolution_tpu_torch.serving.CudaFFTConvolver` — kernel B1,
  or B1p with ``storage="bf16_packed"``
* :class:`~fft_convolution_tpu_torch.serving.CudaTwoStageConvolver` — kernel B2
* :class:`~fft_convolution_tpu_torch.serving.CudaCrossfadeConvolver` — kernel B3
* :class:`~fft_convolution_tpu_torch.serving.CudaStreamingConvolver` — kernel B4
* :class:`~fft_convolution_tpu_torch.api_farm.ReverbFarm` — many voices with
  long IRs on one device, big tail on kernel B5; with ``mesh=``, the voices
  split over the ranks of a ``"dp"`` mesh
* :class:`~fft_convolution_tpu_torch.parallel.partition.ShardedFFTConvolver`
  and :class:`~fft_convolution_tpu_torch.parallel.two_stage_sp.
  ShardedTwoStageConvolver` — one giant IR, its frequency-delay line sharded
  over the ranks of an ``"sp"`` mesh (:mod:`.parallel.mesh`)

The host side: :mod:`.runtime` (the numpy boundary ``HostEngine``, the
native ring and block assembler, ``StreamingConvolver`` and the real-time
dispatcher), :mod:`.utils` (WAV, checkpoints, timing, profiling) and
:mod:`.examples`.
"""

from .api import Convolution, FFTConvolver

_LAZY = {
    "TwoStageFFTConvolver": "api_two_stage",
    "CrossfadeConvolver": "api_crossfade",
    "CudaFFTConvolver": "serving",
    "CudaTwoStageConvolver": "serving",
    "CudaCrossfadeConvolver": "serving",
    "CudaStreamingConvolver": "serving",
    "ReverbFarm": "api_farm",
    "ShardedFFTConvolver": "parallel.partition",
    "ShardedTwoStageConvolver": "parallel.two_stage_sp",
}

__all__ = ["Convolution", "FFTConvolver", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(name)
