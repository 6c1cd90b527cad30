"""Wall seconds of the kit runner's own stages on its thread (the spans
``runner.parse``, ``runner.annotate``, ``runner.filter`` and
``runner.trim``, ``BARBELL_TIMING=1``) per 1000 reads fed.  With
``runner.result_wait_s_per_kread`` it covers the runner's thread: the
larger of the two says whether the runner or the engine sets the pace."""

SPANS = ("runner.parse", "runner.annotate", "runner.filter", "runner.trim")


def read(ctx):
    t = ctx["timings"]
    if not ctx["reads"] or not any(s in t for s in SPANS):
        return None
    return sum(t[s][0] for s in SPANS if s in t) / (ctx["reads"] / 1000)
