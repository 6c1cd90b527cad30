"""CPU seconds (user + system, every thread) of the process that runs the
timed call, over the call, per 1000 reads fed: the kit runner, the host
stages, the engine's host work and everything else on the host.  The
feeder and the digester are other processes and are not counted."""


def read(ctx):
    if not ctx["reads"]:
        return None
    return ctx["cpu_s"] / (ctx["reads"] / 1000)
