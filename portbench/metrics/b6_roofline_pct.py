"""Kernel B6's share of its roofline: the bound of the farm's head path
(head and tail0) at the call's blocks and voices over the device time of
B6's three kernels a call."""

from portbench.metrics import is_b6, roofline, share_pct


def read(ctx):
    per_call = ctx.trace.device_s(match=is_b6) / ctx.calls
    cost = roofline.farm_heads_cost(ctx.shapes, ctx.voices, ctx.blocks_per_call)
    return share_pct(cost, per_call, ctx.peaks)
