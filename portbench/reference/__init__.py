"""The plain reference: float64 convolution in plain PyTorch.  Imports
neither ``jax`` nor anything of ``fft_convolution_tpu`` or
``fft_convolution_tpu_torch``."""
