"""Seconds the engine's threads spent inside their host phases
``encode``, ``pack_upload`` and ``assemble.host`` without running: each
span's wall seconds less its thread CPU seconds (``BARBELL_TIMING=1``),
summed over the threads, per 1000 reads fed.  Waits for the interpreter
lock, other locks and blocking copies."""

PHASES = ("encode", "pack_upload", "assemble.host")


def read(ctx):
    t = ctx["timings"]
    # the thread CPU seconds are the third element of a span's entry
    have = [t[p] for p in PHASES if len(t.get(p, ())) > 2]
    if not ctx["reads"] or not have:
        return None
    return sum(acc[0] - acc[2] for acc in have) / (ctx["reads"] / 1000)
