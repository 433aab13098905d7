"""The port's entry points run on the card unless the caller asks for the CPU.

Built without ``device``, each of the seven entry points of
``fft_convolution_tpu_torch`` puts its tables on the card; where there is
none, building one raises PyTorch's own "no CUDA" error rather than falling
back to the CPU.  Built with ``device="cpu"``, the same call runs on the CPU.
These tests skip where a card is present.  No JAX.
"""

import numpy as np
import pytest
import torch

from fft_convolution_tpu_torch import ReverbFarm
from fft_convolution_tpu_torch.api import FFTConvolver
from fft_convolution_tpu_torch.api_two_stage import TwoStageFFTConvolver
from fft_convolution_tpu_torch.serving import (CudaCrossfadeConvolver, CudaFFTConvolver,
                                               CudaStreamingConvolver, CudaTwoStageConvolver)

BLOCK = 64
IR = (np.random.default_rng(160).standard_normal(9000) * 0.05).astype(np.float32)

# name: a constructor at a small shape, taking the device keyword or not
ENTRY_POINTS = {
    "FFTConvolver": lambda **kw: FFTConvolver(IR, BLOCK, len(IR), **kw),
    "TwoStageFFTConvolver": lambda **kw: TwoStageFFTConvolver(IR, BLOCK, len(IR), **kw),
    "CudaFFTConvolver": lambda **kw: CudaFFTConvolver(IR, BLOCK, len(IR), **kw),
    "CudaTwoStageConvolver": lambda **kw: CudaTwoStageConvolver(IR, BLOCK, len(IR), **kw),
    "CudaCrossfadeConvolver": lambda **kw: CudaCrossfadeConvolver(IR, BLOCK, len(IR),
                                                                  2 * BLOCK, **kw),
    "CudaStreamingConvolver": lambda **kw: CudaStreamingConvolver(IR, BLOCK, len(IR), chunk=8,
                                                                  **kw),
    "ReverbFarm": lambda **kw: ReverbFarm(np.stack([IR, IR[::-1]]), BLOCK, len(IR), **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    make = ENTRY_POINTS[name]
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        make()
    conv = make(device="cpu")
    assert conv.device == torch.device("cpu")
