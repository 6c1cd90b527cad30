"""Device calls of the engine per 1000 reads fed: the count of
``demux_call.dispatch`` (every batch's call, the deep tier's rescue
calls among them) plus that of ``demux_call.retry`` (overflow retries),
``BARBELL_TIMING=1``."""


def read(ctx):
    t = ctx["timings"]
    disp = t.get("demux_call.dispatch")
    # a span of the recorder that also times retries carries thread CPU
    if not disp or len(disp) < 3 or not ctx["reads"]:
        return None
    retry = t.get("demux_call.retry", (0.0, 0))[1]
    return (disp[1] + retry) / (ctx["reads"] / 1000)
