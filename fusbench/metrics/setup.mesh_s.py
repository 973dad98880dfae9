"""setup.mesh_s: host seconds of the port's span ``fus.setup.mesh`` less its
children's, summed over its calls (``ctx["spans"]``, the port's registry
after the traced periods): the mesh: box or bowl-fitted lattice and its
facet tags."""


def read(ctx):
    s = (ctx.get("spans") or {}).get("fus.setup.mesh")
    return None if s is None else s["self_s"]
