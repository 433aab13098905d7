"""Kernel B5's share of its roofline: the bound of the farm's big-tail
step at the call's tail blocks and voices over B5's device time a call."""

from portbench.metrics import is_b5, roofline, share_pct, tail_item


def read(ctx):
    per_call = ctx.trace.device_s(match=is_b5) / ctx.calls
    q = ctx.blocks_per_call // ctx.shapes.period
    cost = roofline.farm_tail_step_cost(ctx.shapes, ctx.voices, q, tail_item(ctx.config))
    return share_pct(cost, per_call, ctx.peaks)
