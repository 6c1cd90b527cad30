"""Per cent of the timed call in which no engine call was between the
start of its upload and the end of its last fetch (100 x (1 -
``engine.inflight`` seconds / the call's seconds), ``BARBELL_TIMING=1``):
the card had no batch to work on.  The engine's device work all falls
inside those periods, so this is at most ``device.idle_share``; the
difference is idle time with a batch queued."""


def read(ctx):
    acc = ctx["timings"].get("engine.inflight")
    if not acc or ctx["window_s"] <= 0:
        return None
    return 100 * (1 - acc[0] / ctx["window_s"])
