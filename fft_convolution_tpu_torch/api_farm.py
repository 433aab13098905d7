"""ReverbFarm — the many-voice serving engine, a stateful wrapper over
:mod:`.parallel.farm2` (counterpart of ``fft_convolution_tpu/api_farm.py``).

V two-stage voices with distinct long IRs are batched on one device: the
head and tail0 stages as one combined causal convolution along the block
axis on kernel B6 (:mod:`.ops.cuda_farm_heads`, which reads the raw tables:
no meta-spectra are cached), the big tail on kernel B5
(:mod:`.ops.cuda_farm_mac`).  A short-IR farm (IRs of at most two
tail blocks: no big tail) streams through the two-stage engine's aligned
path over the voice axis, its stages' meta-spectra cached per call length.
The contract mirrors the per-voice
``TwoStageFFTConvolver`` where it can: ``process`` streams audio, ``update``
is the batched RT-safe IR swap (``update_extension`` semantics, at full
stage capacity), ``reset`` clears the input state and keeps the IR tables,
``snapshot``/``restore``/``clone`` copy the state.  The farm-specific
constraint: ``process`` takes whole tail periods.

With ``mesh=`` the voices are split over the mesh's ``"dp"`` dimension
(:mod:`.parallel.mesh`): every rank constructs the farm with all ``V`` IRs
and keeps the voices of ``local_voices``.  ``process`` takes and returns
the rank's own ``[T, V/w, B]`` slab, so the audio path has no collective
and no rank receives another's input.  ``update`` and ``update_voices``
take the full ``[V, L]`` responses and global voice indices, and a rank
applies the rows it owns.  ``snapshot``, ``restore`` and ``clone`` act on
the rank's slab.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import two_stage
from .ops import cuda_farm_heads, cuda_farm_mac
from .parallel import farm2

# The JAX package's transform tiers; they count TPU matrix-unit passes
PRECISIONS = ("highest", "high", "default", "bf16")


def _check_precision(name: str, what: str) -> None:
    if name != "auto" and name not in PRECISIONS:
        raise ValueError(f"{what} {name!r} not one of {sorted(PRECISIONS)} (or 'auto')")


class ReverbFarm:
    """V-voice two-stage convolution farm on one device.

    Parameters
    ----------
    irs : ``[V, ir_len]`` float array or tensor, one impulse response per
        voice.
    block_size : head block size in samples (a power of two).
    max_response_length : IR capacity per voice; ``update`` accepts any
        length up to it.  At most two tail blocks makes a short-IR farm.
    tail_dtype : ``torch.float32`` (default) or ``torch.bfloat16``: bf16
        pairs for the big tail's ring and table, half the bytes kernel B5
        reads, with ~1e-3 relative error on the tail contribution.
    tail_mac : ``"auto"`` only: kernels B5 and B6 for a farm on a CUDA
        device, their plain PyTorch versions on the CPU.  The big tail's
        step is the attribute ``_step`` and the head path ``_heads``;
        setting them to ``cuda_farm_mac.phased_step_plain`` and
        ``cuda_farm_heads.heads_step_plain`` runs the plain versions on the
        card.  B6 takes ``4 <= block_size <= 2048`` and at most 1024 head
        segments (``tail_block / block_size``); a card farm with a big tail
        of another shape raises ``ValueError`` at construction.
    dft_precision, tail_dft_precision : accepted and checked for the JAX
        package's names (``"auto"``, ``"highest"``, ``"high"``,
        ``"default"``, ``"bf16"``).  Those tiers count a TPU's matrix-unit
        passes; here every transform is a float32 ``torch.fft`` whatever
        the name.
    mesh : a :class:`~torch.distributed.device_mesh.DeviceMesh` with a
        ``"dp"`` dimension whose size divides ``V`` (``parallel.mesh.
        make_mesh``), or None for one device.  With a mesh, this rank keeps
        the voices of :attr:`local_voices` (module docstring).
    hbm_budget_bytes : the eager capacity guard of
        :func:`.parallel.farm2.farm2_init`: ``"auto"`` (the CUDA device's
        free memory; no check on the CPU), a byte budget, or None.
    device : where the farm lives.  None (the default) means the card:
        where ``irs`` is if it is a CUDA tensor, else ``"cuda"``, for a
        numpy array too.  Pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, irs, block_size: int, max_response_length: int, *,
                 tail_dtype: torch.dtype = torch.float32, tail_mac: str = "auto",
                 tail_dft_precision: str = "auto", dft_precision: str = "auto",
                 mesh=None, hbm_budget_bytes="auto", device=None):
        if tail_mac != "auto":
            raise ValueError(f"tail_mac must be 'auto' (kernel B5 on a CUDA device, its "
                             f"plain version on the CPU), got {tail_mac!r}")
        _check_precision(dft_precision, "dft_precision")
        _check_precision(tail_dft_precision, "tail_dft_precision")
        if device is None:
            on_card = isinstance(irs, torch.Tensor) and irs.is_cuda
            device = irs.device if on_card else "cuda"
        irs = torch.as_tensor(irs, dtype=torch.float32, device=device)
        if mesh is not None and "dp" not in mesh.mesh_dim_names:
            raise ValueError("farm mesh needs a 'dp' axis")
        self.mesh = mesh
        self.voices = irs.shape[0]
        if mesh is None:
            self._local = range(self.voices)
        else:
            from .parallel.mesh import voice_range  # the mesh layer only with a mesh
            self._local = voice_range(mesh, self.voices)
        # voices are independent: a rank builds only its own
        self.cfg, self.state = farm2.farm2_init(
            irs[self._own], block_size, max_response_length, tail_dtype=tail_dtype,
            hbm_budget_bytes=hbm_budget_bytes)
        self.device = irs.device
        self.block_size = self.cfg.head_block
        self.max_response_length = max_response_length
        # the phased big tail bounds a call; the short-IR farm takes any length
        self.max_blocks_per_call = (
            None if self.cfg.tail is None
            else farm2.max_blocks_per_call(self.cfg.period, self.cfg.tail.seg_count))
        self._step = (cuda_farm_mac.phased_step_packed if tail_dtype == torch.bfloat16
                      else cuda_farm_mac.phased_step)
        self._heads = cuda_farm_heads.heads_step
        # the short-IR farm's stage meta-spectra per call length T
        # (two_stage.small_stream_khats): input-independent between IR
        # updates.  The big-tail farm caches none: B6 reads the raw tables.
        self._khat_cache: dict[int, dict] = {}

    @property
    def local_voices(self) -> range:
        """The global indices of the voices this farm keeps: all ``V``
        without a mesh, this rank's ``V/w`` with one."""
        return self._local

    @property
    def _own(self) -> slice:
        return slice(self._local.start, self._local.stop)

    @property
    def period(self) -> int:
        """Head blocks per tail period: ``process`` length granularity."""
        return self.cfg.period

    @property
    def tail_block(self) -> int:
        return self.cfg.tail_block

    def process(self, blocks) -> torch.Tensor:
        """Stream ``[T, V, block_size] -> [T, V, block_size]``, a tensor on
        the farm's device; with a mesh, ``V`` is this rank's
        ``len(local_voices)``.  ``T`` must be a positive multiple of
        ``period`` and at most ``max_blocks_per_call`` where that is not None
        (split longer streams into consecutive calls)."""
        x = torch.as_tensor(blocks, dtype=torch.float32, device=self.device)
        t = x.shape[0]
        v = len(self._local)
        if x.ndim != 3 or tuple(x.shape[1:]) != (v, self.block_size):
            raise ValueError(f"expected [T, {v}, {self.block_size}] blocks, "
                             f"got {tuple(x.shape)}")
        if t == 0 or t % self.period != 0:
            raise ValueError(
                f"T={t} must be a positive multiple of the tail period "
                f"({self.period} blocks) — the aligned farm consumes whole tail periods")
        if self.max_blocks_per_call is not None and t > self.max_blocks_per_call:
            raise ValueError(
                f"T={t} exceeds the farm's per-call ceiling of "
                f"{self.max_blocks_per_call} blocks "
                f"({self.max_blocks_per_call // self.period} tail periods) — split the "
                "stream into consecutive process() calls")
        if self.cfg.tail is None:
            if t not in self._khat_cache:
                self._khat_cache[t] = two_stage.small_stream_khats(self.cfg, self.state, t)
            return farm2.farm2_stream(self.cfg, self.state, x, head_khat=self._khat_cache[t])
        return farm2.farm2_stream(self.cfg, self.state, x, self._step, heads=self._heads)

    def _check_irs(self, new_irs, count: int) -> torch.Tensor:
        new_irs = torch.as_tensor(new_irs, dtype=torch.float32, device=self.device)
        if new_irs.ndim != 2 or new_irs.shape[0] != count:
            raise ValueError(f"expected [{count}, L] new responses, got "
                             f"{tuple(new_irs.shape)}")
        if new_irs.shape[1] > self.max_response_length:
            raise ValueError(f"new responses ({new_irs.shape[1]}) exceed the farm's "
                             f"response capacity ({self.max_response_length})")
        return new_irs

    def update(self, new_irs) -> None:
        """Batched RT-safe IR swap at a period boundary: keeps every voice's
        input history, zeroes pending tail outputs
        (``TwoStageFFTConvolver.update_extension`` semantics per voice; the
        reference ``update`` is ``todo!()``, ``src/fft_convolver.rs:408``)."""
        farm2.farm2_update(self.cfg, self.state,
                           self._check_irs(new_irs, self.voices)[self._own])
        self._khat_cache.clear()  # built from the old tables

    def update_voice(self, voice: int, new_ir) -> None:
        """Per-voice RT-safe IR swap (:meth:`update_voices` of one voice)."""
        self.update_voices([voice], torch.as_tensor(new_ir, dtype=torch.float32)[None])

    def update_voices(self, voice_idx, new_irs) -> None:
        """RT-safe IR swap for a subset of voices at a period boundary
        (:func:`.parallel.farm2.farm2_update_voices`): only the touched
        voices' tables and pending rows are rewritten; the other voices
        continue bit-identically.
        All ``V`` voices at once take :meth:`update`.  With a mesh,
        ``voice_idx`` are global indices and this rank applies those of
        :attr:`local_voices`."""
        idx = np.asarray(voice_idx, np.int64).reshape(-1)
        new_irs = self._check_irs(new_irs, idx.size)
        if idx.size == 0:
            return
        if len(np.unique(idx)) != idx.size:
            raise ValueError("voice_idx must be distinct")
        if idx.min() < 0 or idx.max() >= self.voices:
            raise ValueError(f"voice_idx out of range [0, {self.voices})")
        if idx.size == self.voices:
            full = torch.empty_like(new_irs)
            full[torch.from_numpy(idx).to(self.device)] = new_irs
            self.update(full)
            return
        own = (idx >= self._local.start) & (idx < self._local.stop)
        if not own.any():
            return
        idx, new_irs = idx[own] - self._local.start, new_irs[torch.from_numpy(own).to(self.device)]
        farm2.farm2_update_voices(self.cfg, self.state, idx, new_irs)
        self._khat_cache.clear()  # the short-IR farm's, rebuilt whole at the next call

    def reset(self) -> None:
        """Clear all input state; keep the IR tables (``FFTConvolver::reset``
        semantics, ``src/fft_convolver.rs:296``)."""
        st = self.state
        for stage in (st.head, st.tail0):
            for buf in (stage.segments, stage.overlap, stage.input_buffer,
                        stage.pre_multiplied):
                buf.zero_()
            stage.current = stage.input_fill = 0
        if self.cfg.tail is None:
            for k in two_stage._BUFFERS:
                getattr(st, k).zero_()
            return
        for buf in (st.tail.ring, st.tail.overlap, st.tail.pre, st.hist, st.tail_output,
                    st.tail_precalc):
            buf.zero_()
        st.tail.q = 0
        st.suppress.fill_(False)

    # --- Clone surface (reference `Clone`) ---------------------------------
    def snapshot(self) -> farm2.Farm2State:
        return self.state.clone()

    def restore(self, snap: farm2.Farm2State) -> None:
        self.state = snap.clone()
        self._khat_cache.clear()  # the snapshot may hold other IR tables

    def clone(self) -> "ReverbFarm":
        c = object.__new__(ReverbFarm)
        c.__dict__.update(self.__dict__)
        c.state = self.snapshot()
        c._khat_cache = dict(self._khat_cache)  # entries are never written in place
        return c
