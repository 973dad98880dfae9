"""setup.assembly_s: host seconds of the port's span ``fus.setup.assembly``
less its children's, summed over its calls (``ctx["spans"]``, the port's
registry after the traced periods): media, lumped mass and ABC vectors,
stiffness packing, the step's build and ``init()``."""


def read(ctx):
    s = (ctx.get("spans") or {}).get("fus.setup.assembly")
    return None if s is None else s["self_s"]
