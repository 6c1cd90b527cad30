"""Per cent of the timed call in which the card ran no kernel, copy or
set (100 x (1 - union of their intervals / the call's seconds)), from the
in-memory profiler trace of the call."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx["window_s"] <= 0:
        return None
    return 100 * (1 - tr.busy_s / ctx["window_s"])
