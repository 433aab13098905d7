"""Audio I/O and signal generation — counterpart of
``fft_convolution_tpu/utils/audio.py`` and of ``examples/util/mod.rs``.

The reference uses the ``hound`` crate for 16-bit mono WAV output
(``examples/util/mod.rs:21-40``); here the stdlib ``wave`` module does the
same job with the same sample conversion (f32 [-1, 1] -> i16), byte for
byte what the native writer (``native/host_runtime.cpp``) writes.
"""

from __future__ import annotations

import wave

import numpy as np

from ..ops.fft import generate_sinusoid  # re-export: examples/util/mod.rs:7-19

__all__ = ["generate_sinusoid", "save_wav", "load_wav"]


def save_wav(filename: str, samples, sample_rate: int) -> None:
    """Mono 16-bit PCM writer matching ``save_wav``
    (``examples/util/mod.rs:21-40``): scale by i16::MAX and truncate."""
    samples = np.asarray(samples, np.float32)
    scaled = (samples * np.float32(np.iinfo(np.int16).max)).astype(np.int16)
    with wave.open(filename, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(scaled.tobytes())


def load_wav(filename: str) -> tuple[np.ndarray, int]:
    """Read a 16-bit PCM WAV (the first channel) back to f32 in [-1, 1]."""
    with wave.open(filename, "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{filename}: only 16-bit PCM is supported "
                             f"(sample width {w.getsampwidth()} bytes)")
        n = w.getnframes()
        data = np.frombuffer(w.readframes(n), dtype=np.int16)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels())[:, 0]
        return data.astype(np.float32) / np.iinfo(np.int16).max, w.getframerate()
