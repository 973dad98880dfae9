"""band.ms_per_step: device milliseconds a step of the operations launched
inside the span the benchmark puts around the model's slab correction
(``ops.band_correction_rows``). Nothing to read where the model has no slab
correction: the span never opened."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["band_span"] not in tr["spans_found"]:
        return None
    us = sum(o["dur"] for o in tr["ops"] if ctx["band_span"] in o["spans"])
    return us * 1e-3 / ctx["steps"]
