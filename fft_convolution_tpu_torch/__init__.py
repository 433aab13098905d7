"""fft_convolution_tpu_torch — the PyTorch and CUDA port of
``fft_convolution_tpu`` for NVIDIA Hopper.

Real-time-safe uniform and non-uniform (two-stage) partitioned convolution
with the reference's ``Convolution`` surface (``src/lib.rs:5-14``), and
single-block serving wrappers over hand-written CUDA kernels.  Imports
``torch`` and never ``jax``; kernels are built with ``nvcc`` at their first
CUDA use.

Public surface ported so far:

* :class:`~fft_convolution_tpu_torch.api.Convolution` — the protocol
* :class:`~fft_convolution_tpu_torch.api.FFTConvolver` — uniform partitions
* :class:`~fft_convolution_tpu_torch.api_two_stage.TwoStageFFTConvolver`
* :class:`~fft_convolution_tpu_torch.serving.CudaFFTConvolver` — kernel B1
* :class:`~fft_convolution_tpu_torch.serving.CudaTwoStageConvolver` — kernel B2
"""

from .api import Convolution, FFTConvolver

__all__ = [
    "Convolution",
    "FFTConvolver",
    "TwoStageFFTConvolver",
    "CudaFFTConvolver",
    "CudaTwoStageConvolver",
]


def __getattr__(name):
    if name == "TwoStageFFTConvolver":
        from .api_two_stage import TwoStageFFTConvolver
        return TwoStageFFTConvolver
    if name == "CudaFFTConvolver":
        from .serving import CudaFFTConvolver
        return CudaFFTConvolver
    if name == "CudaTwoStageConvolver":
        from .serving import CudaTwoStageConvolver
        return CudaTwoStageConvolver
    raise AttributeError(name)
