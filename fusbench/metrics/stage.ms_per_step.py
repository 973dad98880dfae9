"""stage.ms_per_step: device milliseconds a step of the operations launched
outside the slab correction's span (the stage kernels and the sensor
reads)."""


def read(ctx):
    ops = ctx["trace"]["ops"]
    if not ops:
        return None
    us = sum(o["dur"] for o in ops if ctx["band_span"] not in o["spans"])
    return us * 1e-3 / ctx["steps"]
