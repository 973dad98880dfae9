"""The split kernels and variants of their design on one CUDA device, at the
shapes of their main paths, fp32: K5a and K5b (the two-kernel RK stage)
``lossy``, ``westervelt`` and ``focused`` non-final on the HITU lattice
(80,47,47) p=4 (unit cells) and ``linear`` non-final on the 104³ p=4
headline lattice, beside the tiled K2 on the same operands; K4a and K4b (the
two-kernel stiffness) on the headline lattice, one field with a constant
coefficient and two fields (constant and DG-0), beside the tiled K1. K4a
and K5a run the column march of ``csrc/column.cuh``, K4b and K5b the plane
tile of ``csrc/plane.cuh``.

    python3 fenicsxfus_tpu_torch/tools/split_variants.py [variant ...]
    python3 fenicsxfus_tpu_torch/tools/split_variants.py --in <tree> time|k4

A source variant (``SOURCE_VARIANTS``) is a copy of this package with a few
changes to the kernel sources or the plans' module sizes, built and run in
its own process by the harness of ``variants.py``; a variant whose name
starts with "K4" times K4 alone, the others K5. The committed sources time
both and also run the plan variants (``PLAN_VARIANTS``: the module sizes of
``ops/stiffness.py`` that keep the compile-time main-path kernels: columns
and slab of the column march, planes of a plane-tile run). Every row holds
the kernels to their plain versions first (and K5a -> K5b to K2, K4a -> K4b
to K1, bit for bit), then prints three medians of 10 launches each (CUDA
events; for K4 also the device's time alone, ``variants.device_ms``). The
second form times the package of another checkout (``<tree>``, e.g. an
unpacked ``git archive`` of the parent) on the same operands, K5 (``time``)
or K4 (``k4``), so that two commits compare in one process each, in turns.
"""

from variants import device_ms, main, median_ms

PLANS = "../ops/stiffness.py"
# thread 0 of each K5b block adds the clock cycles of each phase of a plane
# (the output operands' loads issued and the copy wait, form and the next
# copies, barrier, sums and epilogue)
CLOCKED = [
    ("plane.cuh", "namespace fus {\n",
     "namespace fus {\n__device__ unsigned long long plane_clk[5];\n"),
    ("plane.cuh", "    // the node's output operands and coefficients, in flight over the barrier\n",
     "    const long long t0 = clock64();\n"
     "    // the node's output operands and coefficients, in flight over the barrier\n"),
    ("plane.cuh", "    __pipeline_wait_prior(0);  // this thread's copies of plane g0\n",
     "    __pipeline_wait_prior(0);  // this thread's copies of plane g0\n"
     "    const long long t1 = clock64();\n"),
    ("plane.cuh", "    __syncthreads();  // field plane b holds plane g0\n",
     "    const long long t2 = clock64();\n"
     "    __syncthreads();  // field plane b holds plane g0\n"
     "    const long long t3 = clock64();\n"),
    ("plane.cuh", "      out(node, g0, g1, g2, y, plane(col), pre);\n    }\n",
     "      out(node, g0, g1, g2, y, plane(col), pre);\n    }\n"
     "    if (threadIdx.x == 0) {\n"
     "      atomicAdd(&plane_clk[0], (unsigned long long)(t1 - t0));\n"
     "      atomicAdd(&plane_clk[1], (unsigned long long)(t2 - t1));\n"
     "      atomicAdd(&plane_clk[2], (unsigned long long)(t3 - t2));\n"
     "      atomicAdd(&plane_clk[3], (unsigned long long)(clock64() - t3));\n"
     "      atomicAdd(&plane_clk[4], 1ULL);\n    }\n"),
    ("stage_ab.cu", 'extern "C" {\n',
     'extern "C" {\n\nint fus_plane_clk(unsigned long long* out) {\n'
     '  cudaMemcpyFromSymbol(out, fus::plane_clk, sizeof(unsigned long long) * 5);\n'
     '  const unsigned long long z[5] = {};\n'
     '  return (int)cudaMemcpyToSymbol(fus::plane_clk, z, sizeof(z));\n}\n'),
]
# name: [(file, relative to csrc/, old text, new text), ...]
SOURCE_VARIANTS = {
    "committed": [],
    "K5b tile 16x32": [
        ("plane.cuh", "kPlaneMainT1 = 8, kPlaneMainT2 = 32;", "kPlaneMainT1 = 16, kPlaneMainT2 = 32;"),
        (PLANS, "PLANE_TILE = (8, 32)", "PLANE_TILE = (16, 32)")],
    "K5b two-field kinds in 64 registers": [
        ("stage_ab.cuh", "NF == 1 && MAIN ? 2 : 1;", "MAIN ? 2 : 1;")],
    "K5b one-field kind in 128 registers": [
        ("stage_ab.cuh", "NF == 1 && MAIN ? 2 : 1;", "1;")],
    "K5b two-field kinds in 85 registers (3 blocks of 256 per SM)": [
        ("stage_ab.cuh", "NF == 1 && MAIN ? 2 : 1;", "NF == 1 && MAIN ? 4 : 3;"),
        ("plane.cuh", "kPlaneMaxThreads = 512;", "kPlaneMaxThreads = 256;"),
        (PLANS, "PLANE_MAX_THREADS = 512", "PLANE_MAX_THREADS = 256")],
    "K5b without the next plane in flight": [
        ("plane.cuh",
         "        __pipeline_commit();\n      }\n    }\n    __syncthreads();  // field plane b",
         "        __pipeline_commit();\n        __pipeline_wait_prior(0);\n      }\n    }\n"
         "    __syncthreads();  // field plane b")],
    "K5a 40 registers (3 blocks of 512 per SM)": [
        ("column.cuh", "kColumnMinBlocks = 1;", "kColumnMinBlocks = 3;")],
    "K5a without the next cell in flight": [
        ("column.cuh", "    if (more) {\n#pragma unroll\n      for (int j = 1; j < NMAX; ++j)\n"
         "        if (j < N) load((c + 1) * p + j, q[j - 1]);\n      coeff0(c + 1, f0next);\n    }\n",
         ""),
        ("column.cuh", "      column_cell_sum<T, NF, NMAX>(x, p, N, Kw, sprev);\n",
         "#pragma unroll\n      for (int j = 1; j < NMAX; ++j)\n"
         "        if (j < N) load((c + 1) * p + j, q[j - 1]);\n      coeff0(c + 1, f0next);\n"
         "      column_cell_sum<T, NF, NMAX>(x, p, N, Kw, sprev);\n")],
    "clocked": CLOCKED,
    # K4 alone: the committed sources, then one change each
    "K4 as committed": [],
    "K4a slab 4": [(PLANS, "COLUMN_SLAB = 8", "COLUMN_SLAB = 4")],
    # K4b's source copied into planes of raw operands and formed from them
    # (the identity) into the field planes, as K5b's are
    "K4b raw planes formed": [
        ("lattice.cuh", "static constexpr bool kRawIsField = true;",
         "static constexpr bool kRawIsField = false;"),
        (PLANS, "return plane_plan(gdims, p, nf, dtype, nr=0)",
         "return plane_plan(gdims, p, nf, dtype)")],
    "K4b in 128 registers": [
        ("stiffness_ab.cu", "kAxes12MinBlocks = MAIN ? 2 : 1;", "kAxes12MinBlocks = 1;")],
    "K4b two fields in 128 registers": [
        ("stiffness_ab.cu", "__launch_bounds__(kPlaneMaxThreads, kAxes12MinBlocks<MAIN>)",
         "__launch_bounds__(kPlaneMaxThreads, (NF == 1 && MAIN ? 2 : 1))")],
    "K4a 40 registers (3 blocks of 512 per SM)": [
        ("column.cuh", "kColumnMinBlocks = 1;", "kColumnMinBlocks = 3;")],
}
# (label, {module size of ops/stiffness.py: value}), run on the committed sources
PLAN_VARIANTS = [
    ("K5a 128 columns", {"COLUMN_THREADS": 128}),
    ("K5a 512 columns", {"COLUMN_THREADS": 512}),
    ("K5a slab 4", {"COLUMN_SLAB": 4}),
    ("K5a slab 16", {"COLUMN_SLAB": 16}),
    ("K5b run 8", {"PLANE_RUN": 8}),
    ("K5b run 32", {"PLANE_RUN": 32}),
]
PTXAS = ("stage_a_kernelIfLi3ELb1E", "stage_a_kernelIfLi0ELb1E", "stage_b_kernelIfLi3ELb1E",
         "stage_b_kernelIfLi0ELb1E", "stiffness_axis0_kernelIfLi1ELb1E",
         "stiffness_axis0_kernelIfLi2ELb1E", "stiffness_axes12_kernelIfLi1ELb1E",
         "stiffness_axes12_kernelIfLi2ELb1E")


def measure(mode: str) -> None:
    """Run in a variant's process: the timings of K5a, K5b and K2 (mode
    "time"), of K4a, K4b and K1 (mode "k4"), or of both and under each plan
    variant (mode "plans"; see above)."""
    import ctypes

    import numpy as np
    import torch

    from fenicsxfus_tpu_torch._build import library
    from fenicsxfus_tpu_torch.ops import stage_ab, stiffness
    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
    from fenicsxfus_tpu_torch.ops.stage import (
        KIND_DENSE, KIND_FACET, KIND_FIELDS, pack_facet_vector, stage_apply,
    )
    from fenicsxfus_tpu_torch.ops.stiffness import pack_const, pack_field

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
                    Fs=[pack_const(lat, coeff * (1.0 - 0.5 * f), dev)
                        for f in range(KIND_FIELDS[kind])],
                    dense=[torch.rand(gd, generator=gen, device=dev)
                           * (0.05 if n == "d2" else 1.0) + (0.0 if n == "d2" else 0.5)
                           for n in KIND_DENSE[kind]],
                    facets=[facets() for _ in range(nfa)],
                    scal=[0.3, 0.05] + [1.7, -0.6, 0.9, 0.4][: nfa - 1], p=4, final=False)

    def rel(a, b) -> float:
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    def medians(fn) -> str:
        return " / ".join(f"{median_ms(fn):.4f}" for _ in range(3)) + " ms"

    k5_cases, k4_cases = {}, {}
    if mode in ("time", "plans"):
        k5_cases = {f"{kind} HITU": stage_args(kind, (80, 47, 47), 1.0, 1.0)
                    for kind in ("lossy", "westervelt", "focused")}
        k5_cases["linear headline"] = stage_args("linear", (104,) * 3, 0.12 / 104, 1e-3)
    if mode in ("k4", "plans"):  # chip_smoke.py [9]'s headline lattice and coefficient
        lat = LatticeStiffness((104,) * 3, 4, (0.12 / 104,) * 3, torch.float32)
        xs = [torch.randn(lat.gdims, generator=gen, device=dev) for _ in range(2)]
        F = [pack_const(lat, 1e-3, dev), pack_field(lat, rng.uniform(0.5, 2.0, 104**3) * 1e-3, dev)]
        k4_cases = {"1 field headline": ([xs[0]], F[:1]), "2 fields headline": (xs, F)}
    clk = getattr(library(), "fus_plane_clk", None)  # the "clocked" variant's
    rows = [("as built", {})] + (PLAN_VARIANTS if mode == "plans" else [])
    # the plans' module sizes: in ops/stiffness.py, or in ops/stage_ab.py in
    # a checkout from before they moved
    home = stiffness if hasattr(stiffness, "COLUMN_THREADS") else stage_ab
    base = {name: getattr(home, name) for name in ("COLUMN_THREADS", "COLUMN_SLAB", "PLANE_RUN")}
    for label, sizes in rows:
        for name, value in dict(base, **sizes).items():
            setattr(home, name, value)
        out = []
        for case, a in k5_cases.items():
            ka = {k: a[k] for k in ("kind", "u0", "v0", "kvp", "kvpp", "Fs", "scal", "p")}
            yA = stage_ab.stage_a_apply(**ka)
            kv = stage_ab.stage_b_apply(yA=yA, **a)
            errs = (rel(yA, stage_ab.stage_a_plain(**ka)),
                    rel(kv, stage_ab.stage_b_plain(yA=yA, **a)))
            if not max(errs) <= 1e-5:
                raise AssertionError(f"{label} {case}: {errs} against the plain versions")
            if not torch.equal(kv, stage_apply(**a)):
                raise AssertionError(f"{label} {case}: K5a -> K5b differs from K2")
            buf = (ctypes.c_ulonglong * 5)()
            if clk is not None:
                torch.cuda.synchronize()
                clk(buf)
            for name, fn in (("K5a", lambda: stage_ab.stage_a_apply(**ka)),
                             ("K5b", lambda: stage_ab.stage_b_apply(yA=yA, **a)),
                             ("K2", lambda: stage_apply(**a))):
                out.append(f"{name} {case} {medians(fn)}")
                if clk is not None and name == "K5b":
                    torch.cuda.synchronize()
                    clk(buf)
                    n = max(buf[4], 1)
                    out.append("K5b cycles per plane of thread 0: wait %.0f, form+copy %.0f, "
                               "barrier %.0f, sums+epilogue %.0f" % tuple(buf[i] / n for i in range(4)))
        for case, (x, Fs) in k4_cases.items():
            yA = stiffness.stiffness_axis0_apply(x, Fs, 4)
            ref = stiffness.stiffness_axes12_plain(x, Fs, yA.clone(), 4)
            errs = (rel(yA, stiffness.stiffness_axis0_plain(x, Fs, 4)),
                    rel(stiffness.stiffness_axes12_apply(x, Fs, yA, 4), ref))
            if not max(errs) <= 1e-5:
                raise AssertionError(f"{label} {case}: {errs} against the plain versions")
            if not torch.equal(yA, stiffness.stiffness_apply(x, Fs, 4)):
                raise AssertionError(f"{label} {case}: K4a -> K4b differs from K1")
            # K4b in place on one scratch yA, as the two-kernel path runs it;
            # the device's time alone after the three medians
            for name, fn in (("K4a", lambda: stiffness.stiffness_axis0_apply(x, Fs, 4)),
                             ("K4b", lambda: stiffness.stiffness_axes12_apply(x, Fs, yA, 4)),
                             ("K1", lambda: stiffness.stiffness_apply(x, Fs, 4))):
                out.append(f"{name} {case} {medians(fn)} (device {device_ms(fn):.4f})")
        print(f"  {label}: " + "; ".join(out), flush=True)


def mode(name: str) -> str:
    """What a variant's process times: everything (the committed sources),
    K4 (the K4 variants) or K5."""
    return "plans" if name == "committed" else "k4" if name.startswith("K4") else "time"


if __name__ == "__main__":
    main(__file__, SOURCE_VARIANTS, PTXAS, measure, mode)
