"""The examples' output files: the ``.npz`` always, the XDMF only where
``h5py`` imports (the card's machine has none)."""

from ..io.xdmf import save_field_npz, write_xdmf_field


def have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def save(out: str, ops, u, t: float, xdmf: bool) -> list:
    """Write ``{out}.npz`` and, with ``xdmf`` and h5py, ``{out}.xdmf``;
    print and return the paths written."""
    paths = [f"{out}.npz"]
    save_field_npz(paths[0], ops, {"u": u}, t=t)
    if xdmf and have_h5py():
        paths.append(f"{out}.xdmf")
        write_xdmf_field(paths[1], ops, u, name="pressure")
    elif xdmf:
        print("h5py does not import here: no XDMF written")
    print("wrote " + " / ".join(paths))
    return paths
