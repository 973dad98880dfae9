"""setup.library_s: host seconds of the port's span ``fus.setup.library`` less
its children's, summed over its calls (``ctx["spans"]``, the port's registry
after the traced periods): the port's library loads (CUDA kernels and native
geometry): source hash, a compile if needed, the ctypes load."""


def read(ctx):
    s = (ctx.get("spans") or {}).get("fus.setup.library")
    return None if s is None else s["self_s"]
