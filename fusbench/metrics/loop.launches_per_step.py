"""loop.launches_per_step: device operations (kernels, copies, fills) in the
traced periods over the steps they hold."""


def read(ctx):
    ops = ctx["trace"]["ops"]
    return len(ops) / ctx["steps"] if ops else None
