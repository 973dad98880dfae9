"""setup.stable_dt_s: host seconds of the port's span ``fus.setup.stable_dt``
less its children's, summed over its calls (``ctx["spans"]``, the port's
registry after the traced periods): ``utils.estimate_stable_dt``, the bowl's
measured-spectrum dt clamp."""


def read(ctx):
    s = (ctx.get("spans") or {}).get("fus.setup.stable_dt")
    return None if s is None else s["self_s"]
