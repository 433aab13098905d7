"""Linear convolution of the dry input with each voice's impulse response,
in float64, by one FFT of the whole span: ``y[n] = sum_k x[k] h[n - k]``.

A partitioned convolver at block ``B`` streams exactly this, with no added
delay (``src/fft_convolver.rs``'s contract; the recorded golden of this
repository holds it to 1e-5).  The caller hands the input span that the
outputs depend on and says which outputs it wants.
"""

from __future__ import annotations

import torch


def _npo2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def conv_tail(x: torch.Tensor, h: torch.Tensor, count: int) -> torch.Tensor:
    """The last ``count`` samples of ``x * h`` cut at ``x``'s length:
    ``x [V, n]`` (the stream from its start, or from at least
    ``h.shape[-1] - 1`` samples before the first wanted output), ``h [V, L]``.
    Computed in float64 whatever the inputs' type."""
    n, taps = x.shape[-1], h.shape[-1]
    m = _npo2(n + taps - 1)
    spec = torch.fft.rfft(x.double(), m) * torch.fft.rfft(h.double(), m)
    return torch.fft.irfft(spec, m)[..., n - count:n]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (a complex tensor part by part), back in
    float32."""
    if t.is_complex():
        return torch.complex(_bf16(t.real), _bf16(t.imag))
    return t.to(torch.bfloat16).to(torch.float32)


def conv_tail_bf16(x: torch.Tensor, h: torch.Tensor, count: int) -> torch.Tensor:
    """:func:`conv_tail` one precision down from the configuration's float32:
    the input, the response, both spectra, their product and the output
    rounded to bfloat16, the transforms in float32.  The control of a
    configuration whose program has no bfloat16 path of its own."""
    n, taps = x.shape[-1], h.shape[-1]
    m = _npo2(n + taps - 1)
    spec = _bf16(torch.fft.rfft(_bf16(x.float()), m)) * _bf16(torch.fft.rfft(_bf16(h.float()), m))
    return _bf16(torch.fft.irfft(_bf16(spec), m)[..., n - count:n])
