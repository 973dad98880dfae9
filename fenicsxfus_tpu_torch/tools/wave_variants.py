"""K3 (the whole-step wavefront) and variants of its design, on one CUDA
device. Each variant is a copy of this package with a few changes to the K3
sources or to its plan's module constants (``VARIANTS``), built and run in
its own process by the harness of ``variants.py``, on the same inputs: K3
``focused`` at the HITU lattice (80,47,47) p=4 (unit cells, dense m0/d2) and
K3 ``linear`` at the 104³ headline lattice (inv_m separable), three medians
of 10 launches by CUDA events each, beside four K2 launches of the same
step, and whether K3 equals them bit for bit; with the plan and its ring
bytes.

    python3 fenicsxfus_tpu_torch/tools/wave_variants.py [variant ...]

Variants marked "timing only" may give wrong steps: "no waits" races, and
"__ldg slopes" may read a slope through a stale non-coherent line. "clocked"
also prints clock counts of thread 0: per item the ticket and its waits and
the tile walk, and per cell of the walk the phases of ``tile_variants.py``.
"""

from tile_variants import CLOCKED
from variants import main, median_ms

STEP = "../ops/step_wave.py"
# thread 0 adds the cycles of each item's ticket and waits and of its walk
WAVE_CLOCKED = CLOCKED + [
    ("wave.cuh", "constexpr int kWaveStages = 4;\n",
     "constexpr int kWaveStages = 4;\n__device__ unsigned long long wave_clk[3];\n"),
    ("wave.cuh", "    if (threadIdx.x < 32) {  // the first thread takes a ticket, the first warp waits\n",
     "    const long long c0 = clock64();\n"
     "    if (threadIdx.x < 32) {  // the first thread takes a ticket, the first warp waits\n"),
    ("wave.cuh", "    if (threadIdx.x == 0) wave_release(w, s, Z);\n",
     "    if (threadIdx.x == 0) {\n"
     "      atomicAdd(&wave_clk[0], (unsigned long long)(c1 - c0));\n"
     "      atomicAdd(&wave_clk[1], (unsigned long long)(clock64() - c1));\n"
     "      atomicAdd(&wave_clk[2], 1ULL);\n    }\n"
     "    if (threadIdx.x == 0) wave_release(w, s, Z);\n"),
    ("wave.cuh", "    const int s = item[0], Z = item[1], tile = item[2];\n",
     "    const int s = item[0], Z = item[1], tile = item[2];\n    const long long c1 = clock64();\n"),
    ("step_wave.cu", 'extern "C" {\n',
     'extern "C" {\n\nint fus_wave_clk(unsigned long long* out) {\n'
     '  cudaMemcpyFromSymbol(out, fus::wave_clk, sizeof(unsigned long long) * 3);\n'
     '  cudaMemcpyFromSymbol(out + 3, fus::tile_clk, sizeof(unsigned long long) * 5);\n'
     '  const unsigned long long z[5] = {};\n'
     '  cudaMemcpyToSymbol(fus::tile_clk, z, sizeof(z));\n'
     '  return (int)cudaMemcpyToSymbol(fus::wave_clk, z, sizeof(unsigned long long) * 3);\n}\n'),
]
ITEM = ("    wave_item<T, KIND, SEP, MAIN>(args.st[s], args.ring, cf, L, K, S,\n"
        "                                  dim3(tile % w.gx, tile / w.gx, Z));\n")
# the rings of kv0, kv1, kv2 (one allocation) kept in L2 by an access-policy
# window on the stream
L2_WINDOW = """  const K1Mat<T> K = make_k1<T>(K1, p);
  {
    cudaStreamAttrValue at = {};
    at.accessPolicyWindow.base_ptr = kv[0];
    at.accessPolicyWindow.num_bytes =
        (size_t)3 * (w.ring * P.shape.slab * p + 1) * L.G1 * L.G2 * sizeof(T);
    at.accessPolicyWindow.hitRatio = 1.0f;
    at.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    at.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, at.accessPolicyWindow.num_bytes);
    cudaStreamSetAttribute(stream, cudaStreamAttributeAccessPolicyWindow, &at);
    cudaGetLastError();
  }
"""
COPY = ("          __pipeline_memcpy_async(dst + r * PE + soff[i], from + at_plane + goff[i], "
        "sizeof(T));")
# name: [(file under csrc/, old text, new text), ...]
VARIANTS = {
    "committed": [],
    "lag 1": [(STEP, "WAVE_LAG = 2", "WAVE_LAG = 1")],
    "lag 3": [(STEP, "WAVE_LAG = 2", "WAVE_LAG = 3")],
    "slab 1": [(STEP, "WAVE_SLAB = 4", "WAVE_SLAB = 1")],
    "slab 2": [(STEP, "WAVE_SLAB = 4", "WAVE_SLAB = 2")],
    "slab 8": [(STEP, "WAVE_SLAB = 4", "WAVE_SLAB = 8")],
    "stage arguments by switch (constant indices)": [
        ("wave.cuh", ITEM,
         "    switch (s) {\n" + "".join(
             f"      case {i}: " + ITEM.strip().replace("args.st[s]", f"args.st[{i}]") + " break;\n"
             for i in range(4)) + "    }\n")],
    "stage arguments in shared memory": [
        ("wave.cuh", ITEM,
         "    __shared__ StageArgs<T> sa;\n"
         "    for (int i = threadIdx.x; i < (int)(sizeof(sa) / 4); i += blockDim.x)\n"
         "      reinterpret_cast<int*>(&sa)[i] = reinterpret_cast<const int*>(&args.st[s])[i];\n"
         "    __syncthreads();\n" + ITEM.replace("args.st[s]", "sa"))],
    "smallest ring": [(STEP, "RING_SPARE = 1", "RING_SPARE = 0")],
    "ring + 4 slabs": [(STEP, "RING_SPARE = 1", "RING_SPARE = 5")],
    "slopes copied by ld.global.cg": [
        ("tile.cuh", COPY,
         "          if (r >= 2) dst[r * PE + soff[i]] = __ldcg(from + at_plane + goff[i]);\n"
         "          else" + COPY[9:])],
    "L2 persisting window on the rings": [
        ("wave.cuh", "  const K1Mat<T> K = make_k1<T>(K1, p);\n", L2_WINDOW)],
    "no waits (timing only)": [
        ("wave.cuh", "__device__ inline bool wave_wait(const WaveSchedule& w, int s, int Z) {\n",
         "__device__ inline bool wave_wait(const WaveSchedule& w, int s, int Z) {\n"
         "  if (s >= 0) return true;\n")],
    "__ldg slopes in the epilogue (timing only)": [
        ("wave.cuh", "stage_epilogue<T, KIND, SEP, PlainLoad>(a, L, node, sidx, g0, g1, g2, acc, "
         "x.v[0],", "stage_epilogue<T, KIND, SEP, ReadOnlyLoad>(a, L, node, sidx, g0, g1, g2, acc, "
         "x.v[0],")],
    "clocked": WAVE_CLOCKED,
}

# the focused fp32 K3 kernel on the main tile
PTXAS = ("step_wave_kernelIfLi3ELb0ELb1E",)


def measure(mode: str) -> None:
    """Run in a variant's process: the timings of its K3 (see above)."""
    import ctypes

    import numpy as np
    import torch

    from fenicsxfus_tpu_torch._build import library
    from fenicsxfus_tpu_torch.models.common import explicit_tables
    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
    from fenicsxfus_tpu_torch.ops.stage import (
        KIND_DENSE, KIND_FACET, KIND_FIELDS, KIND_RAW, pack_facet_vector, stage_apply,
    )
    from fenicsxfus_tpu_torch.ops.step_wave import (
        ring_bytes, step_table, step_wave_apply, step_wave_check, step_wave_plain, wave_plan,
    )
    from fenicsxfus_tpu_torch.ops.stiffness import pack_const

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(12)
    lib = library()
    clock = getattr(lib, "fus_wave_clk", None)

    def read_clocks():
        buf = (ctypes.c_ulonglong * 8)()
        if clock is not None:
            torch.cuda.synchronize()
            clock(buf)
        return list(buf[:3]), list(buf[3:])

    out = []
    for kind, grid, h, coeff in (("focused", (80, 47, 47), (1.0,) * 3, 1.0),
                                 ("linear", (104,) * 3, (0.12 / 104,) * 3, 1e-3)):
        lat = LatticeStiffness(grid, 4, h, torch.float32)
        gd = lat.gdims
        f = np.zeros(gd, np.float32)
        for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
            f[sl] = 1.0
        facets = [{k: torch.as_tensor(v, device=dev) for k, v in pack_facet_vector(f, gd).items()}
                  for _ in KIND_FACET[kind]]
        if kind == "linear":  # separable inv_m, as the headline takes it
            dense = [torch.rand((gd[0],), generator=gen, device=dev) + 0.5,
                     torch.rand((1,) + gd[1:], generator=gen, device=dev) + 0.5]
        else:
            dense = [torch.rand(gd, generator=gen, device=dev) * (0.05 if n == "d2" else 1.0)
                     + (0.0 if n == "d2" else 0.5) for n in KIND_DENSE[kind]]
        nsrc = len(KIND_FACET[kind]) - 1
        args = dict(kind=kind, u0=torch.randn(gd, generator=gen, device=dev),
                    v0=torch.randn(gd, generator=gen, device=dev),
                    scal4=step_table(kind, explicit_tables(4), 0.02, [[1.0] * nsrc] * 4),
                    Fs=[pack_const(lat, coeff * (1.0 - 0.5 * i), dev)
                        for i in range(1 if kind == "linear" else 2)],
                    dense=dense, facets=facets, p=4)
        nf = KIND_FIELDS[kind]
        plan = wave_plan(gd, 4, nf, torch.float32, nr=KIND_RAW[nf])
        got = step_wave_apply(**args)
        k2 = step_wave_plain(**args, stage_fn=stage_apply)
        step_wave_check()
        same = all(torch.equal(a, b) for a, b in zip(got, k2))
        read_clocks()
        ms = [median_ms(lambda: step_wave_apply(**args)) for _ in range(3)]
        (wclk, tclk) = read_clocks()
        k2_ms = median_ms(lambda: step_wave_plain(**args, stage_fn=stage_apply))
        step_wave_check()
        row = (f"{kind} {grid}: K3 " + " / ".join(f"{m:.3f}" for m in ms)
               + f" ms, four K2 launches {k2_ms:.3f} ms, bit for bit {same}; plan tile "
               f"{plan['tile']} slab {plan['slab']} lag {plan['lag']} ring {plan['ring']} "
               f"({ring_bytes(plan, gd, torch.float32) / 1e6:.1f} MB)")
        if clock is not None:
            n, c = max(wclk[2], 1), max(tclk[4], 1)
            row += (f"; cycles of thread 0 per item: ticket+waits {wclk[0] / n:.0f}, walk "
                    f"{wclk[1] / n:.0f}; per cell: copy wait {tclk[0] / c:.0f}, form+sync "
                    f"{tclk[1] / c:.0f}, sums {tclk[2] / c:.0f}, sync {tclk[3] / c:.0f}")
        out.append(row)
        del args, got, k2, dense, facets
        torch.cuda.synchronize()
    print("; ".join(out), flush=True)


if __name__ == "__main__":
    main(__file__, VARIANTS, PTXAS, measure)
