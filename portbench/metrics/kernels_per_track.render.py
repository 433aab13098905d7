"""CUDA kernels a track launches, counted by the profiler: every kernel of
the traced window over the tracks completed in it.  The render's trace
records the device alone, so it has no spans to filter by; the window
holds only the tracks' ``reset`` and ``process`` and the harness's copies
of the tracks the check keeps, which are memcpys and no kernels."""


def read(ctx):
    n = ctx.trace.count()
    return n / ctx.calls if n else None
