"""Wall seconds the kit runner's thread waited for the engine's next
batch (the span ``runner.result_wait`` around each ``fut.result()`` in
``engine_map_batches``, ``BARBELL_TIMING=1``) per 1000 reads fed."""


def read(ctx):
    acc = ctx["timings"].get("runner.result_wait")
    if not acc or not ctx["reads"]:
        return None
    return acc[0] / (ctx["reads"] / 1000)
