"""Share of the kit runner's reads with rows whose run the native call
closed in a batch (the counter ``trim.batch_reads``) against those the
object path took (``trim.object_reads``: duplicate ids, other cut
shapes, the run a batch leaves open), ``BARBELL_TIMING=1``: 100 x batch
/ (batch + object).  None where the program has neither counter."""


def read(ctx):
    t = ctx["timings"]
    batch = t.get("trim.batch_reads", (0.0, 0))[1]
    obj = t.get("trim.object_reads", (0.0, 0))[1]
    if not batch + obj:
        return None
    return 100.0 * batch / (batch + obj)
