"""The tiled K1/K2 kernels (``csrc/tile.cuh``) and variants of their design
on one CUDA device, at the shapes of their main paths: K2 ``focused``
non-final on the HITU lattice (80,47,47) p=4 (unit cells), K2 ``linear``
non-final and K1 constant on the 104³ p=4 headline lattice, fp32.

    python3 fenicsxfus_tpu_torch/tools/tile_variants.py [variant ...]
    python3 fenicsxfus_tpu_torch/tools/tile_variants.py --in <tree> general

The second form times the package of the checkout ``<tree>`` (``.`` for
this one, or an unpacked ``git archive`` of the parent) at the shapes of the
compiled tiles of ``csrc/tiles.cuh`` (``GENERAL_SHAPES``: PH1 SC2-BM7's K2
``focused`` at p = 5, the headline's fp64 K1, HITU's two-field fp64 K1,
``operator_speed``'s fp32 K1 at p = 2, 3, 5, 6, the fp64 K2 band stage of
``bowl_convergence`` at nx = 36, HITU's fp32 K2 ``focused`` and band stage
at p = 6), on operands seeded the same in every tree:
per shape three medians of 10 launches (CUDA events), the device's time
alone (``variants.device_ms``), the kernel each launch took where the tree
counts it, and the SHA-256 of the output, so that two trees run in turns
(parent, change, change, parent) compare in time and bit for bit.

A source variant (``SOURCE_VARIANTS``) is a copy of this package with one
change to the kernel sources, built and run in its own process by the
harness of ``variants.py``. The committed sources also run the plan variants
(``PLAN_VARIANTS``: the plan's module sizes ``TILE_NODES`` and
``SLAB_CELLS`` of ``ops/stiffness.py``, set in that process). Every row holds
the kernels to their plain versions first, then prints three medians of 10
launches each (CUDA events). The committed process ends with the host time
of one ``stage_apply`` call (enqueue only, the kernel queue not full), the
floor under the step time once the kernels are faster than the host.
"""

import time

from variants import device_ms, main, median_ms

# thread 0 of each block adds the clock cycles of each phase of a cell
# (copy wait, form + sync, sums, closing sync) to a device array; K2 only
CLOCKED = [
    ("tile.cuh", "namespace fus {\n", "namespace fus {\n__device__ unsigned long long tile_clk[5];\n"),
    ("tile.cuh", "  for (int c = c_first; c < c_end; ++c) {\n",
     "  for (int c = c_first; c < c_end; ++c) {\n    const long long t0 = clock64();\n"),
    ("tile.cuh", "    __pipeline_wait_prior(0);\n",
     "    __pipeline_wait_prior(0);\n    const long long t1 = clock64();\n"),
    ("tile.cuh", "    __syncthreads();  // the ring holds the cell's N planes\n",
     "    __syncthreads();  // the ring holds the cell's N planes\n"
     "    const long long t2 = clock64();\n"),
    ("tile.cuh", "    __syncthreads();  // every thread is done with the ring before the next cell's planes\n",
     "    const long long t3 = clock64();\n"
     "    __syncthreads();  // every thread is done with the ring before the next cell's planes\n"
     "    if (threadIdx.x == 0) {\n"
     "      atomicAdd(&tile_clk[0], (unsigned long long)(t1 - t0));\n"
     "      atomicAdd(&tile_clk[1], (unsigned long long)(t2 - t1));\n"
     "      atomicAdd(&tile_clk[2], (unsigned long long)(t3 - t2));\n"
     "      atomicAdd(&tile_clk[3], (unsigned long long)(clock64() - t3));\n"
     "      atomicAdd(&tile_clk[4], 1ULL);\n    }\n"),
    ("stage.cu", 'extern "C" {\n',
     'extern "C" {\n\nint fus_tile_clk(unsigned long long* out) {\n'
     '  cudaMemcpyFromSymbol(out, fus::tile_clk, sizeof(unsigned long long) * 5);\n'
     '  const unsigned long long z[5] = {};\n'
     '  return (int)cudaMemcpyToSymbol(fus::tile_clk, z, sizeof(z));\n}\n'),
]
# name: [(file, relative to csrc/, old text, new text), ...]
SOURCE_VARIANTS = {
    "committed": [],
    "64 registers": [("tile.cuh", "kTileMinBlocks = 1;", "kTileMinBlocks = 2;")],
    "80 registers (384 threads a block)": [
        ("tile.cuh", "kTileMinBlocks = 1;", "kTileMinBlocks = 2;"),
        ("tile.cuh", "kTileMaxThreads = 512;", "kTileMaxThreads = 384;"),
        ("../ops/stiffness.py", "MAX_THREADS = 512  # threads of a block",
         "MAX_THREADS = 384  # threads of a block")],
    "clocked": CLOCKED,
    # ablations: each leaves out one part of the work, so its result is wrong
    # and not checked; the time it saves is that part's share
    "ablation: no axes 1, 2": [
        ("tile.cuh", "            y = add_rn(y, axis1.term(plane, a1, p, Kw));\n"
         "            y = add_rn(y, axis2.term(plane, a2, p, Kw));\n", "")],
    "ablation: every plane copies plane 0": [
        ("tile.cuh", "const long long base = (long long)g0 * P12;",
         "const long long base = 0;")],
    "ablation: K2 stores acc, no epilogue": [
        ("stage_tile.cuh", "const Vals<T, Tr::NF>& x, const Pre& pre) const {\n",
         "const Vals<T, Tr::NF>& x, const Pre& pre) const {\n"
         "    if (!a.final_stage) { a.kv_out[node] = acc; return; }\n")],
}
# (label, TILE_NODES, SLAB_CELLS), run on the committed sources
PLAN_VARIANTS = [
    ("tile 8x16", (8, 16), 8),
    ("slab 4", (8, 32), 4),
    ("slab 16", (8, 32), 16),
]
PTXAS = ("stage_tile_kernelIfLi3ELb1E", "stage_tile_kernelIfLi0ELb1E",
         "stiffness_tile_kernelIfLi1ELb1E")
# (label, kernel, dtype, degree, cells, fields or kind, DG-0): the general
# mode's shapes, at their runs' lattices
GENERAL_SHAPES = [
    ("PH1 SC2-BM7 K2 focused DG-0 p=5", "K2", "float32", 5, (80, 47, 47), "focused", True),
    ("headline K1 fp64 1 field", "K1", "float64", 4, (104, 104, 104), 1, False),
    ("HITU K1 fp64 2 fields", "K1", "float64", 4, (80, 47, 47), 2, True),
    ("operator_speed K1 p=2", "K1", "float32", 2, (169, 169, 169), 1, False),
    ("operator_speed K1 p=3", "K1", "float32", 3, (112, 112, 112), 1, False),
    ("operator_speed K1 p=5", "K1", "float32", 5, (67, 67, 67), 1, False),
    ("operator_speed K1 p=6", "K1", "float32", 6, (56, 56, 56), 1, False),
    ("bowl_convergence nx=36 K2+band westervelt fp64", "K2+band", "float64", 4, (36, 21, 21),
     "westervelt", False),
    ("HITU flat K2 focused p=6", "K2", "float32", 6, (80, 47, 47), "focused", False),
    ("HITU bowl K2+band westervelt p=6", "K2+band", "float32", 6, (80, 47, 47), "westervelt",
     False),
]
# the bowl mesh's slab along x in cells (drivers/hitu.py, nx = 80): its band has
# BAND_LAYERS * p + 1 rows
BAND_LAYERS = 16


def measure_general() -> None:
    """The general mode (see above), in the process of the tree first on
    ``sys.path``."""
    import hashlib

    import numpy as np
    import torch

    from fenicsxfus_tpu_torch.ops import stage, stiffness
    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
    from fenicsxfus_tpu_torch.ops.stage import (
        KIND_DENSE, KIND_FACET, KIND_FIELDS, pack_facet_vector, stage_apply,
    )

    dev = torch.device("cuda", 0)
    for label, kernel, dtn, p, cells, what, dg0 in GENERAL_SHAPES:
        dt = getattr(torch, dtn)
        gen = torch.Generator(device=dev).manual_seed(18)
        rng = np.random.default_rng(18)
        lat = LatticeStiffness(cells, p, [0.12 / n for n in cells], dt)
        gd = lat.gdims

        def field():
            return torch.randn(gd, generator=gen, device=dev, dtype=dt)

        def coeff(c):
            if dg0:
                return stiffness.pack_field(lat, rng.uniform(0.5, 2.0, int(np.prod(cells))) * c,
                                            dev)
            return stiffness.pack_const(lat, c, dev)

        if kernel == "K1":
            xs = [field() for _ in range(what)]
            Fs = [coeff(1.0 - 0.5 * f) for f in range(what)]

            def fn():
                return stiffness.stiffness_apply(xs, Fs, p)
        else:
            nfa = len(KIND_FACET[what])
            facets = []
            for _ in range(nfa):
                f = np.zeros(gd)
                for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0],
                           np.s_[:, :, -1]):
                    f[sl] = rng.uniform(0.5, 1.5, f[sl].shape)
                facets.append({k: torch.as_tensor(v, dtype=dt, device=dev)
                               for k, v in pack_facet_vector(f, gd).items()})
            args = dict(kind=what, u0=field(), v0=field(), kvp=field(), kvpp=field(), prev=None,
                        Fs=[coeff(1e-3 * (1.0 - 0.5 * f)) for f in range(KIND_FIELDS[what])],
                        dense=[torch.rand(gd, generator=gen, device=dev, dtype=dt)
                               * (0.05 if n == "d2" else 1.0) + (0.0 if n == "d2" else 0.5)
                               for n in KIND_DENSE[what]],
                        facets=facets, scal=[0.3, 0.05] + [1.7, -0.6, 0.9, 0.4][: nfa - 1],
                        p=p, final=False)
            if kernel == "K2+band":
                args["band"] = torch.randn((BAND_LAYERS * p + 1, gd[1], gd[2]), generator=gen,
                                           device=dev, dtype=dt)

            def fn():
                return stage_apply(**args)
        # the kernel the launch took, where the tree counts it (``tiles``)
        counter = getattr(stiffness.stiffness_apply if kernel == "K1" else stage_apply, "tiles",
                          {})
        before = dict(counter)
        y = fn()
        torch.cuda.synchronize()
        took = [k for k, v in counter.items() if v != before.get(k, 0)]
        sha = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
        ms = " / ".join(f"{median_ms(fn):.4f}" for _ in range(3))
        print(f"  {label} {gd}: {ms} ms, alone {device_ms(fn):.4f} ms; sha256 {sha}; "
              f"kernel {took[-1] if took else 'general (not counted)'}", flush=True)
        del y


def measure(mode: str) -> None:
    """Run in a variant's process: the timings of its kernels (see above);
    ``mode`` "plans" adds the plan variants, "ablation" skips the check."""
    import numpy as np
    import torch

    from fenicsxfus_tpu_torch.ops import stiffness
    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
    from fenicsxfus_tpu_torch.ops.stage import (
        KIND_DENSE, KIND_FACET, KIND_FIELDS, pack_facet_vector, stage_apply, stage_plain,
    )

    if mode == "general":
        measure_general()
        return
    plans, check = mode == "plans", mode != "ablation"
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)

    def stage_args(kind, grid, h, coeff):
        lat = LatticeStiffness(grid, 4, (h, h, h), torch.float32)
        gd = lat.gdims

        def field():
            return torch.randn(gd, generator=gen, device=dev)

        def facets():
            f = np.zeros(gd, np.float32)
            for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0],
                       np.s_[:, :, -1]):
                f[sl] = rng.uniform(0.5, 1.5, f[sl].shape)
            return {k: torch.as_tensor(v, device=dev)
                    for k, v in pack_facet_vector(f, gd).items()}

        nfa = len(KIND_FACET[kind])
        return dict(kind=kind, u0=field(), v0=field(), kvp=field(), kvpp=field(), prev=None,
                    Fs=[stiffness.pack_const(lat, coeff * (1.0 - 0.5 * f), dev)
                        for f in range(KIND_FIELDS[kind])],
                    dense=[torch.rand(gd, generator=gen, device=dev)
                           * (0.05 if n == "d2" else 1.0) + (0.0 if n == "d2" else 0.5)
                           for n in KIND_DENSE[kind]],
                    facets=[facets() for _ in range(nfa)],
                    scal=[0.3, 0.05] + [1.7, -0.6, 0.9, 0.4][: nfa - 1], p=4, final=False)

    def rel(a, b) -> float:
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    hitu = stage_args("focused", (80, 47, 47), 1.0, 1.0)
    head = stage_args("linear", (104,) * 3, 0.12 / 104, 1e-3)
    x, F = head["u0"], head["Fs"][0]
    calls = {
        "K2 focused HITU": (lambda: stage_apply(**hitu), lambda: stage_plain(**hitu)),
        "K2 linear headline": (lambda: stage_apply(**head), lambda: stage_plain(**head)),
        "K1 const headline": (lambda: stiffness.stiffness_apply([x], [F], 4),
                              lambda: stiffness.stiffness_plain([x], [F], 4)),
    }
    import ctypes

    from fenicsxfus_tpu_torch._build import library

    clk = getattr(library(), "fus_tile_clk", None)  # the "clocked" variant's
    rows = [("as built", stiffness.TILE_NODES, stiffness.SLAB_CELLS)]
    rows += PLAN_VARIANTS if plans else []
    for label, nodes, slab in rows:
        stiffness.TILE_NODES, stiffness.SLAB_CELLS = nodes, slab
        out = []
        for name, (fn, plain) in calls.items():
            err = rel(fn(), plain())
            if check and not err <= 1e-5:
                raise AssertionError(f"{label} {name}: {err:.3e} against the plain version")
            buf = (ctypes.c_ulonglong * 5)()
            if clk is not None:
                torch.cuda.synchronize()
                clk(buf)
            out.append(f"{name} " + " / ".join(f"{median_ms(fn):.4f}" for _ in range(3)) + " ms")
            if clk is not None and name.startswith("K2"):
                torch.cuda.synchronize()
                clk(buf)
                n = max(buf[4], 1)
                out.append("cycles per cell of thread 0: wait %.0f, form+sync %.0f, sums %.0f, "
                           "sync %.0f" % tuple(buf[i] / n for i in range(4)))
        print(f"  {label}: " + "; ".join(out), flush=True)
    if plans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            stage_apply(**hitu)
        host = (time.perf_counter() - t0) / 200
        torch.cuda.synchronize()
        print(f"  host time of one stage_apply call (HITU focused, enqueue only): "
              f"{host * 1e6:.1f} us", flush=True)


if __name__ == "__main__":
    main(__file__, SOURCE_VARIANTS, PTXAS, measure,
         lambda n: "plans" if n == "committed" else "ablation" if "ablation" in n else "time")
