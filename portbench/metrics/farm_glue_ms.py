"""Device ms a call of every kernel and memcpy ``ReverbFarm.process``
launched that is neither B5 nor B6: the tail's transforms, overlap and
copies, the suppress pass."""

from portbench.metrics import is_b5, is_b6


def read(ctx):
    s = ctx.trace.device_s("portbench.process", match=lambda n: not (is_b5(n) or is_b6(n)))
    return s / ctx.calls * 1e3 if ctx.trace.count("portbench.process", kernels_only=False) else None
