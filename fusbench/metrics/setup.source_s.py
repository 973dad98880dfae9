"""setup.source_s: host seconds of the port's span ``fus.setup.source`` less
its children's, summed over its calls (``ctx["spans"]``, the port's registry
after the traced periods): the transducer's drive vectors: on the flat
aperture the delays over every node."""


def read(ctx):
    s = (ctx.get("spans") or {}).get("fus.setup.source")
    return None if s is None else s["self_s"]
