"""Device ms a call of the work ``ReverbFarm.update_voices`` launched."""


def read(ctx):
    if not ctx.trace.count("portbench.update", kernels_only=False):
        return None
    return ctx.trace.device_s("portbench.update") / ctx.calls * 1e3
