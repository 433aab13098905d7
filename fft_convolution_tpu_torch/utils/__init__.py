"""Host-side utilities of the port: audio I/O, checkpoints, timing and
profiling (counterparts of ``fft_convolution_tpu/utils``)."""
