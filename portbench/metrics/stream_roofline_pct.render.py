"""The whole track's share of its roofline: the bound of the aligned
two-stage call at the track's blocks over the device time a track of the
traced window.  The render's trace records the device alone, so this is
every device operation of the window over the tracks completed in it: the
tracks' ``reset`` and ``process``, and the harness's copies of the tracks
the check keeps (a memcpy of one track each, some 20 in a 3 s window of
some 1000 tracks; under 0.1 % of the window's device time)."""

from portbench.metrics import roofline, share_pct


def read(ctx):
    if not ctx.trace.ops:
        return None
    per_track = ctx.trace.device_s() / ctx.calls
    cost = roofline.two_stage_stream_cost(ctx.shapes, ctx.blocks_per_call)
    return share_pct(cost, per_track, ctx.peaks)
