"""kernels_roofline: the least time one RK4 step of the cell could take
(``fusbench.bounds.step_floor``, from its shapes) over the device's busy
time a step in the traced periods, in percent."""


def read(ctx):
    busy_ms = ctx["trace"]["busy_s"] * 1e3 / ctx["steps"]
    if busy_ms <= 0:
        return None
    return 100.0 * ctx["floor_ms"] / busy_ms
