"""setup.upload_s: host seconds of the port's span ``fus.setup.upload`` less
its children's, summed over its calls (``ctx["spans"]``, the port's registry
after the traced periods): ``SEMOperators.to_device``, host-to-device copies
ending in a sync."""


def read(ctx):
    s = (ctx.get("spans") or {}).get("fus.setup.upload")
    return None if s is None else s["self_s"]
