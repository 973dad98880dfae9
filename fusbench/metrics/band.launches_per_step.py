"""band.launches_per_step: device operations launched inside the slab
correction K6 in the traced periods, over their steps: inside the port's
span ``fus.band`` where the trace was read for it (``fusbench.spans``),
else inside the span the benchmark puts around the same call
(``ops.band_correction_rows``, ``ctx["band_span"]``). Nothing to read where
the model has no slab correction."""


def read(ctx):
    tr = ctx["trace"]
    name = "fus.band" if "fus.band" in tr["spans_found"] else ctx["band_span"]
    if name not in tr["spans_found"]:
        return None
    return sum(1 for o in tr["ops"] if name in o["spans"]) / ctx["steps"]
