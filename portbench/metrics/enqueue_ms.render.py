"""Host ms from the start of a track's ``reset`` to the return of its
``process``, before any wait: the mean over the traced window's tracks."""


def read(ctx):
    return sum(ctx.enqueue_s) / len(ctx.enqueue_s) * 1e3 if ctx.enqueue_s else None
