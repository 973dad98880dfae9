"""K1 and K2 ``linear`` at the 104³ p=4 headline, and the headline rate, for
the port tree given as the first argument (a checkout of the repository, or
an unpacked ``git archive`` of another commit). Needs one CUDA device.

    python3 fenicsxfus_tpu_torch/tools/ab_headline.py <tree> [label]

Prints one ``AB`` line: CUDA-event medians of 20 launches of K2 ``linear``
(non-final, final) and K1 (constant coefficient) on ``chip_smoke.py`` phase
[2]/[3] operands, then the rate of 101 RK4 steps of ``bench.py``'s problem
through ``LinearSpectralExplicit.rk`` (after a 4-step warm-up). To compare two
commits, alternate the two trees in one session (parent, change, change,
parent, ...): each process builds its tree's kernels once.
"""

import sys
import time

import numpy as np
import torch

sys.path.insert(0, sys.argv[1])
import fenicsxfus_tpu_torch as ft  # noqa: E402
from fenicsxfus_tpu_torch.models.common import step_sizes  # noqa: E402
from fenicsxfus_tpu_torch.ops import stage as st  # noqa: E402
from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness  # noqa: E402
from fenicsxfus_tpu_torch.ops.stiffness import pack_const, stiffness_apply  # noqa: E402

NX, P, STEPS = 104, 4, 101
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(1)
rng = np.random.default_rng(1)


def med(fn, runs=20) -> float:
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


def kernels() -> tuple[float, float, float]:
    lat = LatticeStiffness((NX,) * 3, P, [0.12 / NX] * 3, torch.float32)
    gd = lat.gdims

    def field():
        return torch.randn(gd, generator=gen, device=dev)

    def facets():
        f = np.zeros(gd, np.float32)
        for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
            f[sl] = rng.uniform(0.5, 1.5, f[sl].shape)
        return {k: torch.as_tensor(v, device=dev) for k, v in st.pack_facet_vector(f, gd).items()}

    u0, v0, kvp, kvpp, prev = (field() for _ in range(5))
    F = pack_const(lat, 1e-3, dev)
    inv_m = torch.rand(gd, generator=gen, device=dev) + 0.5
    src, abc = facets(), facets()
    tail = [1.0, 0.02, 0.03, 0.01, 0.15, 0.3, 0.3, 0.15]

    def k2(final):
        scal = [0.3, 0.05, 1.7] + (tail if final else [])
        pv = prev if final else None
        if hasattr(st, "KIND_CODES"):  # the four-kind wrapper
            return st.stage_apply("linear", u0, v0, kvp, kvpp, pv, [F], [inv_m], [src, abc],
                                  scal, P, final)
        return st.stage_apply(u0, v0, kvp, kvpp, pv, F, inv_m, src, abc, scal, P, final)

    out = med(lambda: k2(False)), med(lambda: k2(True)), med(lambda: stiffness_apply([u0], [F], P))
    del u0, v0, kvp, kvpp, prev, inv_m
    torch.cuda.synchronize()
    return out


def headline() -> float:
    c0, rho0, f0, p0, L = 1500.0, 1000.0, 0.5e6, 60000.0, 0.12
    mesh = ft.create_box((NX,) * 3, (0, 0, 0), (L, L, L))
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > L - 1e-9})
    dt = 0.9 * (L / NX) / (c0 * P**2)
    model = ft.LinearSpectralExplicit(mesh, None, P, c0, rho0, f0, p0, c0, 4, dt,
                                      dtype=torch.float32, device=dev)
    model.init()
    model.rk(0.0, 4 * dt)
    model.init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.rk(0.0, STEPS * dt)
    torch.cuda.synchronize()
    solve = time.perf_counter() - t0
    return model.number_of_dofs() * len(step_sizes(0.0, STEPS * dt, dt)) / solve / 1e9


k2n, k2f, k1 = kernels()
rate = headline()
label = sys.argv[2] if len(sys.argv) > 2 else sys.argv[1]
print(f"AB {label}: K2 linear non-final {k2n:.4f} ms, final {k2f:.4f} ms, K1 const "
      f"{k1:.4f} ms, headline {rate:.4f} GDOF-RK4-updates/s", flush=True)
