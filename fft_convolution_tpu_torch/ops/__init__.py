"""FFT + DSP primitives (the reference's L0 layer,
``src/fft_convolver.rs:8-84``) on ``torch.fft``, plus the hand-written CUDA
kernels B1 (:mod:`.cuda_engine`) and B2 (:mod:`.cuda_two_stage`).

Public L0 surface (mirroring the reference's ``pub`` items, as far as
ported): ``Fft``, ``complex_size``, ``copy_and_pad``, ``next_power_of_two``
(src/fft_convolver.rs:29-60).
"""

from .fft import Fft, complex_size, copy_and_pad, next_power_of_two

__all__ = ["Fft", "complex_size", "copy_and_pad", "next_power_of_two"]
