"""Share of the kit runner's batch takes (span ``runner.parse``) that
found the batch already read by the reader thread: 100 x the counter
``reader.ready`` over the count of the span ``reader.read`` (each native
batch call, the one that finds the end of input among them),
``BARBELL_TIMING=1``.  None where the program has no reader thread."""


def read(ctx):
    t = ctx["timings"]
    calls = t.get("reader.read")
    if not calls or not calls[1]:
        return None
    return 100.0 * t.get("reader.ready", (0.0, 0))[1] / calls[1]
