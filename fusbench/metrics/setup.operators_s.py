"""setup.operators_s: host seconds of the port's span ``fus.setup.operators``
less its children's, summed over its calls (``ctx["spans"]``, the port's
registry after the traced periods): ``SEMOperators.__init__``: space,
dofmap, geometry factors, lattice, the slab's factors."""


def read(ctx):
    s = (ctx.get("spans") or {}).get("fus.setup.operators")
    return None if s is None else s["self_s"]
