"""The port's CUDA kernels on the card, against their plain torch twins.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports no jax, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py

fp64 cases hold the kernels to 1e-12 relative (the same sums in another
order); fp32 cases to 1e-5 (``chip_smoke.py``'s tolerance).
"""

import numpy as np
import pytest
import torch

from fenicsxfus_tpu_torch import (
    LinearSpectralExplicit,
    WesterveltSpectralFocused,
    create_box,
    tag_boundaries,
)
from fenicsxfus_tpu_torch.convert import state_from_numpy
from fenicsxfus_tpu_torch.models.common import make_scan_from_step
from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
from fenicsxfus_tpu_torch.ops.stage import (
    KIND_DENSE,
    KIND_FACET,
    KIND_FIELDS,
    pack_facet_vector,
    stage_apply,
    stage_plain,
)
from fenicsxfus_tpu_torch.ops.stage_ab import (
    stage_a_apply,
    stage_a_plain,
    stage_b_apply,
    stage_b_plain,
)
from fenicsxfus_tpu_torch.ops.stiffness import (
    pack_const,
    pack_field,
    stiffness_apply,
    stiffness_axes12_apply,
    stiffness_axes12_plain,
    stiffness_axis0_apply,
    stiffness_axis0_plain,
    stiffness_plain,
)

pytestmark = pytest.mark.gpu

GRID = (9, 5, 7)
# (5, 1, 1): one cell across y and z, as the channel runs of chip_smoke.py,
# so every node lies on two facet planes and the stencil folds on itself
GRIDS = [GRID, (5, 1, 1)]
TOLS = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("degree", [2, 3, 4])
@pytest.mark.parametrize("grid", GRIDS)
def test_k1_matches_plain(grid, degree, dtype, cuda):
    lat = LatticeStiffness(grid, degree, (0.1, 0.14, 0.07), dtype)
    rng = np.random.default_rng(degree)
    Fs = [pack_const(lat, 1.7, cuda),
          pack_field(lat, rng.uniform(0.5, 2.0, int(np.prod(grid))), cuda)]
    xs = [torch.as_tensor(rng.standard_normal(lat.gdims), dtype=dtype, device=cuda)
          for _ in range(2)]
    for x_in, F_in in (([xs[0]], Fs[:1]), ([xs[1]], Fs[1:]), (xs, Fs)):
        before = stiffness_apply.launches
        y = stiffness_apply(x_in, F_in, degree)
        assert stiffness_apply.launches == before + 1
        assert _rel(y, stiffness_plain(x_in, F_in, degree)) < TOLS[dtype]


def _stage_args(kind, lat, rng, device, present, final, dg0):
    gd = lat.gdims
    dt = lat.dtype

    def field():
        return torch.as_tensor(rng.standard_normal(gd), dtype=dt, device=device)

    def facets():
        f = np.zeros(gd)
        for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
            f[sl] = rng.uniform(0.5, 1.5, f[sl].shape)
        return {k: torch.as_tensor(v, dtype=dt, device=device)
                for k, v in pack_facet_vector(f, gd).items()}

    kvp, kvpp, prev = (field() if p else None for p in present)
    ns = 1 + sum(present)
    nfa = len(KIND_FACET[kind])
    scal = [0.3, 0.05] + list(rng.uniform(-2.0, 2.0, nfa - 1))
    scal += list(rng.uniform(0.01, 1.0, 2 * ns)) if final else []
    ncells = int(np.prod(lat.grid))
    Fs = [pack_field(lat, rng.uniform(0.5, 2.0, ncells), device) if dg0 and f == 0
          else pack_const(lat, 1.7 - 0.5 * f, device) for f in range(KIND_FIELDS[kind])]
    dense = [torch.as_tensor(rng.uniform(0.0, 0.05, gd) if n == "d2" else rng.uniform(0.5, 1.5, gd),
                             dtype=dt, device=device) for n in KIND_DENSE[kind]]
    return (kind, field(), field(), kvp, kvpp, prev, Fs, dense,
            [facets() for _ in range(nfa)], scal, lat.p, final)


# (kvp, kvpp, prev) present, final: every stage shape of the RK1-RK4 tables
STAGES = [((0, 0, 0), False), ((1, 0, 0), False), ((1, 1, 0), False),
          ((0, 0, 0), True), ((1, 0, 0), True), ((1, 1, 0), True), ((1, 1, 1), True)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("present,final", STAGES)
@pytest.mark.parametrize("kind", sorted(KIND_FIELDS))
@pytest.mark.parametrize("grid", GRIDS)
def test_k2_matches_plain(grid, kind, present, final, dtype, cuda):
    lat = LatticeStiffness(grid, 4, (0.1, 0.14, 0.07), dtype)
    rng = np.random.default_rng(sum(present) + 4 * final)
    for dg0 in (False, True):
        args = _stage_args(kind, lat, rng, cuda, present, final, dg0)
        before = stage_apply.launches[kind]
        got = stage_apply(*args)
        assert stage_apply.launches[kind] == before + 1
        ref = stage_plain(*args)
        for a, b in (zip(got, ref) if final else [(got, ref)]):
            assert _rel(a, b) < TOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("degree", [2, 3, 4])
@pytest.mark.parametrize("grid", GRIDS)
def test_k4_matches_plain(grid, degree, dtype, cuda, monkeypatch):
    """K4a, K4b and their composition against the plain versions, and the
    ``FUS_V3=0`` dispatch of ``stiffness_apply`` through K4a and K4b."""
    lat = LatticeStiffness(grid, degree, (0.1, 0.14, 0.07), dtype)
    rng = np.random.default_rng(degree)
    Fs = [pack_const(lat, 1.7, cuda),
          pack_field(lat, rng.uniform(0.5, 2.0, int(np.prod(grid))), cuda)]
    xs = [torch.as_tensor(rng.standard_normal(lat.gdims), dtype=dtype, device=cuda)
          for _ in range(2)]
    for x_in, F_in in (([xs[0]], Fs[:1]), ([xs[1]], Fs[1:]), (xs, Fs)):
        before = stiffness_axis0_apply.launches, stiffness_axes12_apply.launches
        yA = stiffness_axis0_apply(x_in, F_in, degree)
        assert _rel(yA, stiffness_axis0_plain(x_in, F_in, degree)) < TOLS[dtype]
        y = stiffness_axes12_apply(x_in, F_in, yA.clone(), degree)
        assert _rel(y, stiffness_axes12_plain(x_in, F_in, yA.clone(), degree)) < TOLS[dtype]
        assert _rel(y, stiffness_plain(x_in, F_in, degree)) < TOLS[dtype]
        assert (stiffness_axis0_apply.launches, stiffness_axes12_apply.launches) == (
            before[0] + 1, before[1] + 1)
    monkeypatch.setenv("FUS_V3", "0")
    k1, k4a, k4b = (stiffness_apply.launches, stiffness_axis0_apply.launches,
                    stiffness_axes12_apply.launches)
    y = stiffness_apply(xs, Fs, degree)
    assert (stiffness_apply.launches, stiffness_axis0_apply.launches,
            stiffness_axes12_apply.launches) == (k1, k4a + 1, k4b + 1)
    assert _rel(y, stiffness_plain(xs, Fs, degree)) < TOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("present,final", STAGES)
@pytest.mark.parametrize("kind", sorted(KIND_FIELDS))
@pytest.mark.parametrize("grid", GRIDS)
def test_k5_matches_plain(grid, kind, present, final, dtype, cuda):
    """K5a and K5b against their plain versions (K5b on K5a's output), and
    the pair against the one-kernel stage's plain version."""
    lat = LatticeStiffness(grid, 4, (0.1, 0.14, 0.07), dtype)
    rng = np.random.default_rng(sum(present) + 4 * final)
    for dg0 in (False, True):
        args = _stage_args(kind, lat, rng, cuda, present, final, dg0)
        _, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, _ = args
        before = stage_a_apply.launches[kind], stage_b_apply.launches[kind]
        yA = stage_a_apply(kind, u0, v0, kvp, kvpp, Fs, scal, p)
        assert _rel(yA, stage_a_plain(kind, u0, v0, kvp, kvpp, Fs, scal, p)) < TOLS[dtype]
        got = stage_b_apply(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p, final)
        assert (stage_a_apply.launches[kind], stage_b_apply.launches[kind]) == (
            before[0] + 1, before[1] + 1)
        ref = stage_b_plain(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p, final)
        whole = stage_plain(*args)
        for a, b, c in (zip(got, ref, whole) if final else [(got, ref, whole)]):
            assert _rel(a, b) < TOLS[dtype]
            assert _rel(a, c) < TOLS[dtype]


def test_wrappers_refuse_bad_cuda_input(cuda):
    lat = LatticeStiffness(GRID, 2, (0.1, 0.1, 0.1), torch.float32)
    F = pack_const(lat, 1.0, cuda)
    x = torch.zeros(lat.gdims, device=cuda)
    for bad in (x.transpose(0, 1).contiguous().transpose(0, 1), x.cpu(), x.double()):
        with pytest.raises(ValueError):
            stiffness_apply([bad], [F], 2)
    with pytest.raises(ValueError):
        stiffness_apply([x], [pack_const(lat, 1.0, "cpu")], 2)  # coefficient on the CPU
    for bad in (x.cpu(), x.double()):
        with pytest.raises(ValueError):
            stiffness_axis0_apply([bad], [F], 2)
        with pytest.raises(ValueError):
            stiffness_axes12_apply([x], [F], bad, 2)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_model_on_gpu_matches_cpu(order, cuda):
    """The same fp64 model on the card (K2 per stage) and on the CPU (plain)."""
    rng = np.random.default_rng(order)
    c0, rho0 = rng.uniform(1400, 1600, 96), rng.uniform(900, 1100, 96)
    models = []
    for dev in ("cpu", cuda):
        mesh = create_box((6, 4, 4), (0, 0, 0), (1.0, 0.5, 0.5))
        tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
        models.append(LinearSpectralExplicit(mesh, None, 3, c0, rho0, 0.5e6, 6e4, 1500.0,
                                             order, 1e-8, dtype=torch.float64, device=dev))
    u0, v0 = (rng.standard_normal(models[0].number_of_dofs()) for _ in range(2))
    outs = []
    for m in models:
        assert m.step_kind == "fused"
        m.u_n, m.v_n = state_from_numpy(u0, v0, m.device)
        before = stage_apply.launches["linear"]
        u, v, _ = m.rk(0.0, 5e-8)
        launched = stage_apply.launches["linear"] - before
        outs.append((u.cpu(), v.cpu(), launched, m.energy()))
    assert outs[0][2] == 0 and outs[1][2] == 5 * order
    assert _rel(outs[1][0], outs[0][0]) < 1e-12
    assert _rel(outs[1][1], outs[0][1]) < 1e-12
    assert abs(outs[1][3] - outs[0][3]) < 1e-12 * abs(outs[0][3])


def test_focused_model_on_gpu_matches_cpu(cuda):
    """The fp64 focused model (K2 kind ``focused``, heterogeneous medium, the
    HITU facet layout) on the card and on the CPU, 5 RK4 steps."""
    rng = np.random.default_rng(9)
    c0, rho0 = rng.uniform(1400, 1600, 96), rng.uniform(900, 1100, 96)
    models = []
    for dev in ("cpu", cuda):
        mesh = create_box((6, 4, 4), (0, 0, 0), (1.0, 0.5, 0.5))
        tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12}, default=2)
        models.append(WesterveltSpectralFocused(
            mesh, None, 3, c0, rho0, 4e-3, 3.5, 0.5e6, 6e4, 1500.0, 4, 1e-8,
            aperture_radius=0.2, focal_distance=0.6, center=np.array([0.0, 0.25, 0.25]),
            dtype=torch.float64, device=dev))
    u0, v0 = (rng.standard_normal(models[0].number_of_dofs()) for _ in range(2))
    outs = []
    for m in models:
        assert m.step_kind == "fused"
        m.u_n, m.v_n = state_from_numpy(u0, v0, m.device)
        before = stage_apply.launches["focused"]
        u, v, _ = m.rk(0.0, 5e-8)
        outs.append((u.cpu(), v.cpu(), stage_apply.launches["focused"] - before))
    assert outs[0][2] == 0 and outs[1][2] == 20
    assert _rel(outs[1][0], outs[0][0]) < 1e-12
    assert _rel(outs[1][1], outs[0][1]) < 1e-12


def test_two_kernel_focused_model_on_gpu_matches_cpu(cuda, monkeypatch):
    """``FUS_STAGE_V3=0``: the fp64 focused model through K5a and K5b on the
    card (20 launches of each for 5 RK4 steps, none of K2) equals the CPU
    run; ``FUS_V3=0``: its unfused step through K4a and K4b too."""
    monkeypatch.setenv("FUS_STAGE_V3", "0")
    monkeypatch.setenv("FUS_V3", "0")
    rng = np.random.default_rng(9)
    c0, rho0 = rng.uniform(1400, 1600, 96), rng.uniform(900, 1100, 96)
    models = []
    for dev in ("cpu", cuda):
        mesh = create_box((6, 4, 4), (0, 0, 0), (1.0, 0.5, 0.5))
        tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12}, default=2)
        models.append(WesterveltSpectralFocused(
            mesh, None, 3, c0, rho0, 4e-3, 3.5, 0.5e6, 6e4, 1500.0, 4, 1e-8,
            aperture_radius=0.2, focal_distance=0.6, center=np.array([0.0, 0.25, 0.25]),
            dtype=torch.float64, device=dev))
    u0, v0 = (rng.standard_normal(models[0].number_of_dofs()) for _ in range(2))
    outs = []
    for m in models:
        assert m.step_kind == "fused"
        m.u_n, m.v_n = state_from_numpy(u0, v0, m.device)
        before = (stage_a_apply.launches["focused"], stage_b_apply.launches["focused"],
                  stage_apply.launches["focused"])
        u, v, _ = m.rk(0.0, 5e-8)
        after = (stage_a_apply.launches["focused"], stage_b_apply.launches["focused"],
                 stage_apply.launches["focused"])
        x, y = state_from_numpy(u0, v0, m.device)
        k4 = stiffness_axis0_apply.launches
        uu, _, _ = make_scan_from_step(m.unfused_step())(m.consts, x, y, 0.0, 5e-8, 1e-8)
        outs.append((u.cpu(), v.cpu(), [b - a for a, b in zip(before, after)], uu.cpu(),
                     stiffness_axis0_apply.launches - k4))
    assert outs[0][2] == [0, 0, 0] and outs[1][2] == [20, 20, 0]
    assert outs[0][4] == 0 and outs[1][4] == 20
    assert _rel(outs[1][0], outs[0][0]) < 1e-12
    assert _rel(outs[1][1], outs[0][1]) < 1e-12
    assert _rel(outs[1][3], outs[0][3]) < 1e-12
    assert _rel(outs[1][3], outs[1][0]) < 1e-12
