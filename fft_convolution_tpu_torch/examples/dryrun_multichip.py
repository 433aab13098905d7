"""Multi-device dry run — the port's counterpart of
``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:33-219``).

:func:`dryrun_multichip` spawns ``n`` ranks (:func:`..parallel.mesh.
run_ranks`) and checks on every rank each sharded form against the
single-device engine on the same inputs (1e-5), on tiny shapes (block 8):

* on a 2-D ``(dp, sp)`` mesh (dp = 2 when ``n`` is even): one block of a
  voice-sharded uniform farm; one block of the segment-sharded FDL with its
  all-reduce, an ``update`` and one more block; two tail periods of the
  sharded two-stage engine;
* on a 1-D ``"dp"`` mesh of all ``n`` ranks: the two-stage farm (each
  rank's ``voice_slab`` through ``farm2_stream``), then ``farm2_update_voices``
  of one voice on the sharded farm, the bf16 tail, and the cached head
  meta-spectra cut to the rank's voices (through the plain head path, which
  takes them; kernel B6 reads the raw tables).  Each rank steps its own
  voices through kernels B5 (B5p for bf16) and B6 on the card, their plain
  versions on the CPU.

Run: ``python -m fft_convolution_tpu_torch.examples.dryrun_multichip
[--ranks 4] [--device cuda|cpu]`` (the card by default, every rank on
``cuda:0``; ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from ..models import two_stage, uniform
from ..ops import cuda_farm_heads, cuda_farm_mac
from ..parallel import farm, farm2, partition, two_stage_sp
from ..parallel.mesh import make_mesh, mesh_device, run_ranks, voice_range

TOL = 1e-5
B = 8  # the JAX dry run's tiny block


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _rank(rank: int, world: int, device: str) -> dict:
    dp = 2 if world % 2 == 0 and world > 1 else 1
    sp = world // dp
    mesh = make_mesh((dp, sp), ("dp", "sp"), device)
    dev = mesh_device(mesh)
    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    errs = {}
    # dp: one block of a voice-sharded uniform farm
    v = dp * 2
    fcfg, fstate = farm.farm_init(randn(v, 4 * B, scale=0.1), B, 4 * B)
    lv = voice_range(mesh, v)
    slab = farm.voice_slab(fstate, lv)
    xf = randn(v, B)
    errs["dp farm step"] = _err(farm.farm_step(fcfg, slab, xf[lv.start:lv.stop]),
                                farm.farm_step(fcfg, fstate, xf)[lv.start:lv.stop])

    # sp: the segment-sharded FDL, its all-reduce, an update
    ir = randn(B * 2 * sp, scale=0.1)
    pcfg, pstate = partition.init(mesh, ir, B, len(ir))
    ucfg, ustate = uniform.init(ir, B, len(ir), dev)
    xp = randn(B)
    errs["sp step"] = _err(partition.step(pcfg, mesh, pstate, xp),
                           uniform.process_block(ucfg, ustate, xp))
    padded = torch.zeros(pcfg.seg_count * B, device=dev)
    padded[:B] = randn(B, scale=0.1)
    partition.update(pcfg, pstate, padded, B)
    uniform.update(ucfg, ustate, padded, B)
    errs["sp update"] = _err(partition.step(pcfg, mesh, pstate, xp),
                             uniform.process_block(ucfg, ustate, xp))

    # sp: the sharded two-stage engine, two tail periods
    ir_long = randn(64 * B, scale=0.1)
    tcfg, tstate = two_stage_sp.init(mesh, ir_long, B, len(ir_long))
    xs = randn(2 * tcfg.period, B)
    rcfg, rstate = two_stage.init(ir_long, B, len(ir_long), dev)
    errs["sp two-stage"] = _err(
        two_stage_sp.stream_aligned(tcfg, mesh, tstate, xs),
        torch.stack([two_stage.process_block(rcfg, rstate, xb) for xb in xs]))

    # dp over all ranks: the two-stage farm, its kernel on each rank's voices
    flat = make_mesh((world,), ("dp",), device)
    vf, ir_len2 = 2 * world, 640  # long enough for a big tail
    irs2 = randn(vf, ir_len2, scale=0.05)
    f2cfg, f2state = farm2.farm2_init(irs2, B, ir_len2)
    if f2cfg.tail is None:
        raise AssertionError("the dry run's farm has no big tail")
    lv2 = voice_range(flat, vf)
    own = slice(lv2.start, lv2.stop)
    xf2 = randn(2 * f2cfg.period, vf, B, scale=0.5)
    khat = farm2.farm2_head_khat(f2cfg, f2state, xf2.shape[0])
    fresh = farm2.voice_slab(f2state, lv2)
    ref = f2state.clone()
    sstate = farm2.voice_slab(f2state, lv2)
    y_ref = farm2.farm2_stream(f2cfg, ref, xf2)
    errs["dp farm2"] = _err(farm2.farm2_stream(f2cfg, sstate, xf2[:, own]), y_ref[:, own])
    # one voice's IR swapped on the sharded farm: only its owner applies it
    new1 = randn(1, ir_len2, scale=0.05)
    farm2.farm2_update_voices(f2cfg, ref, [1], new1)
    if 1 in lv2:
        farm2.farm2_update_voices(f2cfg, sstate, [1 - lv2.start], new1)
    errs["dp farm2 update_voices"] = _err(
        farm2.farm2_stream(f2cfg, sstate, xf2[:, own]),
        farm2.farm2_stream(f2cfg, ref, xf2)[:, own])
    # the bf16 tail
    b2cfg, b2state = farm2.farm2_init(irs2, B, ir_len2, tail_dtype=torch.bfloat16)
    packed = cuda_farm_mac.phased_step_packed
    sb = farm2.voice_slab(b2state, lv2)
    errs["dp farm2 bf16"] = _err(farm2.farm2_stream(b2cfg, sb, xf2[:, own], packed),
                                 farm2.farm2_stream(b2cfg, b2state, xf2, packed)[:, own])
    # the head meta-spectra of the whole farm, cut to the rank's voices
    errs["dp farm2 head khat"] = _err(
        farm2.farm2_stream(f2cfg, fresh, xf2[:, own],
                           heads=functools.partial(cuda_farm_heads.heads_step_plain,
                                                   khat=khat[own])),
        y_ref[:, own])
    return errs


def dryrun_multichip(n: int, device: str = "cuda") -> dict:
    """Run the dry run on ``n`` ranks; returns each check's largest error
    over the ranks and raises ``AssertionError`` if one exceeds 1e-5."""
    per_rank = run_ranks(_rank, n, device, device=device)
    worst = {k: max(r[k] for r in per_rank) for k in per_rank[0]}
    for k, err in worst.items():
        print(f"{k}: max abs err over {n} ranks {err:.2e}")
    bad = {k: e for k, e in worst.items() if not e <= TOL}
    if bad:
        raise AssertionError(f"sharded forms differ from the single-device engines: {bad}")
    return worst


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    main()
