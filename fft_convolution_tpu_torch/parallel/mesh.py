"""Process meshes for the multi-device forms — the port's counterpart of the
JAX package's device meshes (``partition.make_mesh``,
``fft_convolution_tpu/parallel/partition.py:71``; ``farm.make_farm_mesh``,
``fft_convolution_tpu/parallel/farm.py:181``).

The JAX package runs one program over a mesh of devices (``shard_map``).
The port runs one process a rank (SPMD): every rank runs the same code on
its own slab, the ranks are joined by one ``torch.distributed`` process
group, and a :class:`~torch.distributed.device_mesh.DeviceMesh` names the
mesh's dimensions as the JAX meshes do, ``"sp"`` for segments and ``"dp"``
for voices.  Where JAX calls ``psum`` over a mesh axis, the port calls
``dist.all_reduce`` on that dimension's group (``mesh.get_group(name)``).

Backend: gloo, on the CPU and on the card alike.  NCCL refuses two ranks on
one device, and a machine with one card runs a mesh as several ranks on
``cuda:0``.

Transport of CUDA tensors: gloo's own all-reduce of the CUDA tensor, which
stages it through host memory inside the collective.  The port has no
second path.

:func:`run_ranks` starts the ranks of one program: ``spawn``ed processes
(CUDA needs a fresh interpreter), joined by a ``file://`` store in a new
temporary directory, so concurrent programs never share a port or a store.
A rank imports the module that holds its function: keep rank functions in
modules that import ``torch`` and not ``jax``.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# A collective that waits longer than this has lost a rank.
COLLECTIVE_TIMEOUT_S = 300


def make_mesh(shape: Sequence[int], dim_names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``dim_names`` over the initialised process
    group (every rank calls it, in the same order as every other collective
    call).  ``device_type`` is where the mesh's engines keep their tensors:
    ``"cuda"`` (the default) or ``"cpu"``."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(dim_names))


def dim_size(mesh: DeviceMesh, name: str) -> int:
    """The number of ranks along the mesh dimension ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def voice_range(mesh: DeviceMesh, voices: int) -> range:
    """This rank's voices of a ``voices``-voice farm on ``mesh``: ``[r V/w,
    (r + 1) V/w)`` with ``r`` its index along the ``"dp"`` dimension of
    size ``w``.  ``V`` must divide by ``w`` (the JAX package's fused tail
    axis splits voice-chunked, ``fft_convolution_tpu/api_farm.py:145-150``).
    A rank's slab of a farm state is ``farm.voice_slab`` or
    ``farm2.voice_slab`` of this range (the JAX package's ``shard_farm`` and
    ``farm2_shard``), and it streams that slab through ``farm_stream`` or
    ``farm2_stream`` itself (``sharded_farm_stream``,
    ``farm2_stream_sharded``): the audio path has no collective."""
    w = dim_size(mesh, "dp")
    if voices % w:
        raise ValueError(f"voices ({voices}) must divide by the mesh's 'dp' size ({w})")
    n = voices // w
    r = mesh.get_local_rank("dp")
    return range(r * n, (r + 1) * n)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """Where the engines on ``mesh`` keep their tensors: ``cuda:0`` (every
    rank of a one-card mesh shares it) or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rank_main(rank: int, fn: Callable, world: int, tmp: str, device_type: str,
               args: tuple) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)  # the ranks are the parallelism
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))


def run_ranks(fn: Callable, world: int, *args, device: str = "cuda",
              timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes joined in
    one gloo process group, and return what each returned, in rank order
    (``torch.save``/``torch.load`` carry it, so return CPU tensors, numpy
    arrays or plain values).

    ``device="cuda"`` (the default) puts every rank on ``cuda:0``;
    ``"cpu"`` gives each rank one intra-op thread.  ``fn`` and ``args`` are pickled: ``fn`` must
    be a module-level function of a module that does not import JAX.  A
    rank that raises or dies raises here (the others are stopped); ranks
    still running after ``timeout`` seconds are killed and ``TimeoutError``
    is raised.  Without a card, ``device="cuda"`` raises before any rank
    starts."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks: no CUDA device is available for device='cuda'; "
                           "pass device='cpu' to run the ranks on the CPU")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, tmp, device, args), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} still running "
                                       f"after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
