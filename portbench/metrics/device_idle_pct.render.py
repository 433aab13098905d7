"""Share of the traced window with no kernel, memcpy or memset on the card."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s) if ctx.trace.ops else None
