"""K3 (the whole-step wavefront) and variants of its design, on one CUDA
device. Each variant is a copy of this package with one change to the K3
sources (``VARIANTS``), made under ``_build/variants/`` and built there (all
builds at once); then each runs in its own process, in turn, on the same
inputs: K3 ``focused`` at the HITU lattice (80,47,47) p=4 (unit cells, dense
m0/d2) and K3 ``linear`` at the 104³ headline lattice (inv_m separable),
three medians of 10 launches by CUDA events each, beside four K2 launches
of the same step, and whether K3 equals them bit for bit.

    python3 fenicsxfus_tpu_torch/tools/wave_variants.py [variant ...]

Two variants are for timing only and give wrong steps: "no waits" races,
and "__ldg slopes" may read slopes through a stale non-coherent line.
"""

import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
VARIANT_DIR = PKG / "_build" / "variants"

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


def make(name: str) -> Path:
    """The variant's copy of the package (its root directory)."""
    root = VARIANT_DIR / name.replace(" ", "_").replace("/", "_")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for fname, old, new in VARIANTS[name]:
        src = root / PKG.name / "csrc" / fname
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} is not once in {fname}")
        src.write_text(text.replace(old, new))
    return root


def measure() -> str:
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

    def median_ms(fn, runs=10):
        fn()
        ts = []
        for _ in range(runs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

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
    return "; ".join(out)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--in":  # a variant's own process
        sys.path.insert(0, sys.argv[2])
        from fenicsxfus_tpu_torch import _build

        if sys.argv[3] == "build":  # print the focused fp32 kernel's ptxas lines
            entry = ""
            for line in _build.build()[2].splitlines():
                if "Compiling entry function" in line:
                    entry = line.split("'")[1]
                elif "step_wave_kernelIfLi3ELb0" in entry and ("registers" in line
                                                                  or "spill" in line):
                    print(line.replace("ptxas info    :", "").strip(), flush=True)
        else:
            print(measure(), flush=True)
        return
    names = sys.argv[1:] or list(VARIANTS)
    roots = {n: make(n) for n in names}
    builds = {n: subprocess.Popen([sys.executable, __file__, "--in", str(r), "build"],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for n, r in roots.items()}
    ptxas = {}
    for n, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {n!r} did not build:\n{log}")
        ptxas[n] = "; ".join(line for line in log.splitlines() if line)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    for n, r in roots.items():
        res = subprocess.run([sys.executable, __file__, "--in", str(r), "time"],
                             capture_output=True, text=True, timeout=900)
        line = res.stdout.strip() or res.stderr.strip().splitlines()[-1]
        print(f"{n}: {line} [K3 focused fp32: {ptxas[n]}]", flush=True)


if __name__ == "__main__":
    main()
