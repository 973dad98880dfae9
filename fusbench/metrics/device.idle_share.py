"""device.idle_share: 1 - device busy seconds over the host seconds of the
traced periods."""


def read(ctx):
    tr = ctx["trace"]
    if tr["window_s"] <= 0 or not tr["ops"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
