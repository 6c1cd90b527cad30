"""Seconds of the engine's host phases ``encode``, ``pack_upload`` and
``assemble.host`` (``BARBELL_TIMING=1``, summed over the pipeline's
threads) per 1000 reads fed."""

PHASES = ("encode", "pack_upload", "assemble.host")


def read(ctx):
    t = ctx["timings"]
    if not ctx["reads"] or not any(p in t for p in PHASES):
        return None
    return sum(t[p][0] for p in PHASES if p in t) / (ctx["reads"] / 1000)
