"""K3 (the whole-step wavefront) and variants of its design, on one CUDA
device. Each variant is a copy of this package with one change to the K3
sources (``VARIANTS``), built and run in its own process by the harness of
``variants.py``, on the same inputs: K3 ``focused`` at the HITU lattice
(80,47,47) p=4 (unit cells, dense m0/d2) and K3 ``linear`` at the 104³
headline lattice (inv_m separable), three medians of 10 launches by CUDA
events each, beside four K2 launches of the same step, and whether K3
equals them bit for bit.

    python3 fenicsxfus_tpu_torch/tools/wave_variants.py [variant ...]

Two variants are for timing only and give wrong steps: "no waits" races,
and "__ldg slopes" may read slopes through a stale non-coherent line.
"""

from variants import main, median_ms

L2_LOAD = """struct L2Load {
  template <typename T>
  __device__ __forceinline__ T operator()(const T* p, long long i) const {
    return __ldcg(p + i);
  }
};

template <typename T>
struct WaveArgs {"""
SLOPE_LOADS = ("stage_fields<T, KIND, PlainLoad>", "stage_finish<T, KIND, SEP, PlainLoad>")
NODE_LOOP = ("    if (node >= end) break;\n", "    if (node >= end) continue;\n")
# name: [(file under csrc/, old text, new text), ...]
VARIANTS = {
    "committed": [],
    "L2-only slopes (ld.global.cg)": [
        ("step_wave.cu", "template <typename T>\nstruct WaveArgs {", L2_LOAD),
        *[("step_wave.cu", s, s.replace("PlainLoad", "L2Load")) for s in SLOPE_LOADS]],
    "__ldg slopes": [("step_wave.cu", s, s.replace("PlainLoad", "ReadOnlyLoad"))
                     for s in SLOPE_LOADS],
    "no waits": [("wave.cuh", "__device__ inline bool wave_wait(const WaveSchedule& w, int s, "
                  "int q) {\n", "__device__ inline bool wave_wait(const WaveSchedule& w, int s, "
                  "int q) {\n  if (s >= 0) return true;\n")],
    "lag 1": [("wave.cuh", "kWaveLag = 2;", "kWaveLag = 1;")],
    "lag 3": [("wave.cuh", "kWaveLag = 2;", "kWaveLag = 3;")],
    "1 node per thread": [("wave.cuh", "kWaveNodesPerThread = 4;", "kWaveNodesPerThread = 1;")],
    "2 nodes per thread": [("wave.cuh", "kWaveNodesPerThread = 4;", "kWaveNodesPerThread = 2;")],
    "unrolled node loop": [("step_wave.cu", "  for (int j = 0; j < kWaveNodesPerThread; ++j) {",
                            "#pragma unroll\n  for (int j = 0; j < kWaveNodesPerThread; ++j) {"),
                           ("step_wave.cu", *NODE_LOOP)],
    "3 blocks per SM": [("step_wave.cu", "__launch_bounds__(kWaveThreads)",
                         "__launch_bounds__(kWaveThreads, 3)")],
}

# the focused fp32 K3 kernel
PTXAS = ("step_wave_kernelIfLi3ELb0",)


def measure(mode: str) -> None:
    """Run in a variant's process: the timings of its K3 (see above)."""
    import numpy as np
    import torch

    from fenicsxfus_tpu_torch.models.common import explicit_tables
    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
    from fenicsxfus_tpu_torch.ops.stage import (
        KIND_DENSE, KIND_FACET, pack_facet_vector, stage_apply,
    )
    from fenicsxfus_tpu_torch.ops.step_wave import (
        step_table, step_wave_apply, step_wave_check, step_wave_plain,
    )
    from fenicsxfus_tpu_torch.ops.stiffness import pack_const

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(12)

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
        got = step_wave_apply(**args)
        k2 = step_wave_plain(**args, stage_fn=stage_apply)
        step_wave_check()
        same = all(torch.equal(a, b) for a, b in zip(got, k2))
        ms = [median_ms(lambda: step_wave_apply(**args)) for _ in range(3)]
        k2_ms = median_ms(lambda: step_wave_plain(**args, stage_fn=stage_apply))
        step_wave_check()
        out.append(f"{kind} {grid}: K3 " + " / ".join(f"{m:.3f}" for m in ms)
                   + f" ms, four K2 launches {k2_ms:.3f} ms, bit for bit {same}")
        del args, got, k2, dense, facets
        torch.cuda.synchronize()
    print("; ".join(out), flush=True)


if __name__ == "__main__":
    main(__file__, VARIANTS, PTXAS, measure)
