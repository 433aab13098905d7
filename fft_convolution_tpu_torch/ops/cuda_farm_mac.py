"""Kernel B5: the reverb farm's big-tail phased correlation step,
hand-written in CUDA C++ for Hopper (``csrc/b5_farm_tail.cu``) — counterpart
of ``fft_convolution_tpu/ops/pallas_farm_mac.py`` (``_kernel_v2`` and
``_kernel_packed_v2`` via ``phased_step``).

Operands, per lane of the fused axis (``V`` voices of ``B+1`` bins):

* ``ring``: the phased input-spectra ring, ``complex64 [N, V, B+1]`` or bf16
  pairs ``[N, V, B+1, 2]``; updated in place;
* ``table``: the big tail's IR partition spectra, same shape and dtype (one
  copy, indexed mod N; the JAX package's doubled table is a DMA-window
  device);
* ``specs``: ``complex64 [T, V, B+1]``, this call's new tail spectra;
* ``q``: the phase, a host int in ``[0, N)``.

Computed, with ``row_s = (N - q - s) mod N``::

    conv[t] = sum_{x<N} ring[x] * table[(q + t + x) mod N]
            + sum_{s<=t} (specs[s] - ring[row_s]) * table[t - s]
    pre     = conv[T-1] - specs[T-1] * table[0]
    ring[row_s] <- specs[s]  for every s < T

— the index math of ``parallel/farm2.py:_tail_corr_phased_fused``.  With
bf16 storage the sums read the widened stored rows and the new rows are
rounded to nearest even.  ``T <= min(N, MAX_BLOCKS)``.

:func:`phased_step` launches the kernel for CUDA tensors, its complex64 form
``fdl_b5_step`` or its bf16 form ``fdl_b5p_step`` by the table's dtype, and
takes the plain PyTorch version :func:`phased_step_plain` only for CPU
tensors; ``phased_step.launches`` counts the launches of both forms.  It
returns ``(convs [T, V, B+1], pre [V, B+1])``.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .cuda_engine import as_c64, require, to_bf16

# The kernel keeps T accumulators and a T-row table window in registers;
# the JAX jnp core's per-call bound (``uniform.CORR_EXTRA_ROWS``) is the same.
MAX_BLOCKS = 16


def _rolled_mac(u: torch.Tensor, k: torch.Tensor, start: int) -> torch.Tensor:
    """``sum_x u[x] * k[(start + x) mod N]`` as two contiguous slices: one
    table-sized product at a time, never a gathered ``[T, N, ...]`` copy."""
    n = u.shape[0]
    return (u[:n - start] * k[start:]).sum(dim=0) + (u[n - start:] * k[:start]).sum(dim=0)


def phased_step_plain(ring: torch.Tensor, table: torch.Tensor, specs: torch.Tensor,
                      q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the step (both storages), on any device."""
    n, t_len = ring.shape[0], specs.shape[0]
    u, k = as_c64(ring), as_c64(table)  # the tensors, or widened copies
    rows = [(n - q - s) % n for s in range(t_len)]
    convs = []
    for t in range(t_len):
        acc = _rolled_mac(u, k, (q + t) % n)
        for s in range(t + 1):
            acc = acc + (specs[s] - u[rows[s]]) * k[t - s]
        convs.append(acc)
    convs = torch.stack(convs)
    pre = convs[-1] - specs[-1] * k[0]
    idx = torch.tensor(rows, device=ring.device)
    ring[idx] = specs if ring.is_complex() else to_bf16(specs)
    return convs, pre


def phased_step(ring: torch.Tensor, table: torch.Tensor, specs: torch.Tensor,
                q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One step (module docstring).  CUDA tensors launch kernel B5, its bf16
    form for a bf16 table; CPU tensors take :func:`phased_step_plain`."""
    if specs.device.type == "cpu":
        return phased_step_plain(ring, table, specs, q)
    dev = specs.device
    packed = table.dtype == torch.bfloat16
    dtype, name = (torch.bfloat16, "fdl_b5p_step") if packed else (torch.complex64, "fdl_b5_step")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    n, t_len, lanes_shape = ring.shape[0], specs.shape[0], tuple(specs.shape[1:])
    if not 1 <= t_len <= min(n, MAX_BLOCKS):
        raise ValueError(f"{name}: T={t_len} outside [1, min(N={n}, {MAX_BLOCKS})]")
    if not 0 <= q < n:
        raise ValueError(f"{name}: phase {q} outside the ring of {n}")
    lanes = math.prod(lanes_shape)
    if not 0 < lanes < 2 ** 31:
        raise ValueError(f"{name}: {lanes} lanes (the kernel indexes lanes with int)")
    shape = (n, *lanes_shape, 2) if packed else (n, *lanes_shape)
    require(specs, "specs", (t_len, *lanes_shape), torch.complex64, dev)
    require(ring, "ring", shape, dtype, dev)
    require(table, "table", shape, dtype, dev)
    convs = torch.empty_like(specs)
    pre = torch.empty(lanes_shape, dtype=torch.complex64, device=dev)
    err = _build.kernel(name)(
        ring.data_ptr(), table.data_ptr(), specs.data_ptr(), convs.data_ptr(),
        pre.data_ptr(), lanes, n, q, t_len, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, name)
    phased_step.launches += 1
    return convs, pre


phased_step.launches = 0
