"""Whether two checkouts compile the kernels of K1, K2, K3, K4a, K4b, K5a and
K5b (the tiled stencil, the wavefront and the two walks) to the same machine code
(SASS), kernel by kernel, on a machine with ``nvcc`` and ``cuobjdump``.

    python3 fenicsxfus_tpu_torch/tools/same_sass.py <tree_a> <tree_b>

Each tree's kernel library is built by its own ``_build.py`` (in its own
process); then ``cuobjdump -sass`` dumps both, and every kernel whose
mangled name contains one of ``KERNELS`` is compared instruction for
instruction (the encodings included). Prints one line per kernel and exits
1 if a kernel differs or is missing from the second library; kernels only
the second has (the compiled tiles of ``csrc/tiles.cuh`` against a tree
before them) are listed as new.
"""

import re
import subprocess
import sys
from pathlib import Path

KERNELS = ("stiffness_tile_kernel", "stage_tile_kernel", "step_wave_kernel", "stage_a_kernel",
           "stage_b_kernel", "stiffness_axis0_kernel", "stiffness_axes12_kernel",
           "stage_band_kernel", "stiffness_fixed_kernel", "stage_fixed_kernel",
           "stage_band_fixed_kernel")


def library(tree: str) -> Path:
    """The kernel library of the checkout ``tree``, built if needed."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from fenicsxfus_tpu_torch import _build; print(_build.build()[0])")
    out = subprocess.run([sys.executable, "-c", code, tree], capture_output=True, text=True,
                         check=True)
    return Path(out.stdout.strip().splitlines()[-1])


def sass(lib: Path, cuobjdump: str) -> dict:
    """The SASS text of every kernel in ``lib`` named by ``KERNELS``, by
    mangled name."""
    dump = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", dump)[1:]:
        name, _, body = part.partition("\n")
        if any(k in name for k in KERNELS):
            out[name.strip()] = [line.strip() for line in body.splitlines()
                                 if line.strip().startswith("/*")]
    return out


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from fenicsxfus_tpu_torch._build import nvcc_path

    cuobjdump = str(Path(nvcc_path()).parent / "cuobjdump")
    a, b = (sass(library(tree), cuobjdump) for tree in sys.argv[1:3])
    same = True
    for name in sorted(set(a) | set(b)):
        if name not in b:
            print(f"missing in the second: {name}")
            same = False
            continue
        if name not in a:
            print(f"new in the second ({len(b[name])} lines): {name}")
            continue
        equal = a[name] == b[name]
        same &= equal
        print(f"{'same' if equal else 'DIFFERENT'} ({len(a[name])} / {len(b[name])} lines): "
              f"{name}")
    print(f"{len(set(a) & set(b))} kernels compared, {len(set(b) - set(a))} new: "
          f"{'all compared the same' if same else 'some differ'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
