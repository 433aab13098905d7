"""FFT + DSP primitives (the reference's L0 layer,
``src/fft_convolver.rs:8-84``) on ``torch.fft``, plus the wrappers of the
hand-written CUDA kernels: B1 and B1p (:mod:`.cuda_engine`), B2
(:mod:`.cuda_two_stage`), B3 (:mod:`.cuda_crossfade`), B4
(:mod:`.cuda_stream`), B5 (:mod:`.cuda_farm_mac`) and B6
(:mod:`.cuda_farm_heads`).

Public L0 surface (mirroring the reference's ``pub`` items, as far as
ported): ``Fft``, ``complex_size``, ``copy_and_pad``, ``next_power_of_two``
(src/fft_convolver.rs:29-60).
"""

from .fft import Fft, complex_size, copy_and_pad, next_power_of_two

__all__ = ["Fft", "complex_size", "copy_and_pad", "next_power_of_two"]
