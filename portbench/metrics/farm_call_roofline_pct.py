"""The whole farm call's share of its roofline: the bound of
``ReverbFarm.process`` at the call's blocks and voices over the device time
of every operation it launched.  It bounds the kernels' shares: a kernel
taken off the path leaves its own share silent, not this one."""

from portbench.metrics import roofline, share_pct, tail_item


def read(ctx):
    per_call = ctx.trace.device_s("portbench.process") / ctx.calls
    cost = roofline.farm_cost(ctx.shapes, ctx.voices, ctx.blocks_per_call, tail_item(ctx.config))
    return share_pct(cost, per_call, ctx.peaks)
