"""The harness's inputs, made on the run's device from ``--seed``.

Every tensor comes from its own ``torch.Generator`` seeded with a
sub-seed of the run's seed and a tag, so the reference can make the same
tensor again after the window without keeping it.  Host-side draws (which
voices an update touches, which calls the check keeps) use numpy's
generator on a sub-seed the same way.  Seeds may be any integer.
"""

from __future__ import annotations

import numpy as np
import torch

# tags of the sub-seeds
IRS, DRY, POOL, PLAN, KEEP = 1, 2, 3, 4, 5
IR_CHUNK = 64  # voices an IR draw makes at once


def subseed(seed: int, *tags: int) -> int:
    """A 64-bit seed for the stream ``tags`` of the run ``seed``."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *tags])
    return int(ss.generate_state(1, np.uint64)[0])


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, *tags))


def randn(shape, seed: int, *tags: int, scale: float = 1.0, device="cpu") -> torch.Tensor:
    """Standard normal float32 samples times ``scale``, drawn on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, *tags))
    x = torch.randn(shape, generator=g, device=device)
    return x.mul_(scale) if scale != 1.0 else x


def responses(seed: int, tag: int, count: int, length: int, scale: float,
              device, chunks: range | None = None) -> torch.Tensor:
    """``[count, length]`` impulse responses, :data:`IR_CHUNK` rows a draw;
    ``chunks`` makes only those draws (rows ``IR_CHUNK * c`` on)."""
    n_chunks = -(-count // IR_CHUNK)
    chunks = range(n_chunks) if chunks is None else chunks
    rows = [randn((min(IR_CHUNK, count - c * IR_CHUNK), length), seed, tag, c, scale=scale,
                  device=device) for c in chunks]
    return torch.cat(rows) if len(rows) > 1 else rows[0]
