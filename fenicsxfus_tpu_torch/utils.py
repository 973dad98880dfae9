"""Utility functions (port of ``fenicsxfus_tpu/utils.py``, reference
``python/src/fenicsxfus/utils.py``): the device resolution of the port's
entry points and the card's context (``init_device``), the diffusivity of sound, the point location of sensors on
deformed cells (``compute_eval_params``), the evaluation of a field at
points (``eval_function``) and the spectral stable time step
(``estimate_stable_dt``)."""

from __future__ import annotations

import numpy as np
import torch

from .analysis.timing import span, traced


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device with an explicit index; raises when CUDA
    is asked for and is not available (the port's entry points default to
    ``"cuda"``, and CPU runs ask for ``"cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_device(device) -> None:
    """Make the CUDA context of a card here (span ``fus.setup.context``),
    so that the set-up's uploads are copies only; nothing on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        with span("fus.setup.context", sync=dev):
            torch.zeros(1, device=dev)


def compute_diffusivity_of_sound(frequency: float, speed: float, attenuationdB: float) -> float:
    """Convert attenuation in dB/m to the diffusivity-of-sound δ
    (reference ``utils.py:50-55``): δ = 2 α_Np c³ / ω²."""
    attenuationNp = attenuationdB / 20 * np.log(10)
    return 2 * attenuationNp * speed**3 / frequency / frequency


def compute_eval_params(mesh, points: np.ndarray):
    """Locate evaluation points in cells (reference ``utils.py:10-47`` uses a
    DOLFINx BB-tree; here a direct multilinear inverse-map search).

    Parameters: ``points`` [dim, n] (or [3, n] with trailing zeros, matching
    the reference convention). Returns (points_found [n_found, dim],
    cells [n_found], xi [n_found, dim] reference coordinates).
    """
    pts = np.asarray(points, dtype=np.float64).T[:, : mesh.dim]  # [n, dim]
    verts = mesh.cell_vertices()  # [Nc, 2**d, dim]
    lo = verts.min(axis=1)  # [Nc, dim]
    hi = verts.max(axis=1)
    found_pts, found_cells, found_xi = [], [], []
    tol = 1e-10 * max(float(np.max(hi - lo)), 1.0)
    for p in pts:
        inside = np.all((p >= lo - tol) & (p <= hi + tol), axis=1)
        hit = -1
        for c in np.where(inside)[0]:
            xi = _inverse_map(verts[c], p, mesh.dim)
            if xi is not None:
                hit = c
                found_xi.append(xi)
                break
        if hit >= 0:
            found_pts.append(p)
            found_cells.append(hit)
    return (
        np.array(found_pts).reshape(-1, mesh.dim),
        np.array(found_cells, dtype=np.int64),
        np.array(found_xi).reshape(-1, mesh.dim),
    )


def _inverse_map(cell_verts: np.ndarray, p: np.ndarray, d: int, iters: int = 30):
    """Newton inversion of the multilinear cell map; returns xi in [0,1]^d or
    None if the point lies outside this cell."""
    from .core.geometry import _geom_grad_tensor

    xi = np.full(d, 0.5)
    for _ in range(iters):
        phi = np.ones(2**d)
        for a in range(d):
            bit = (np.arange(2**d) >> (d - 1 - a)) & 1
            phi *= np.where(bit == 1, xi[a], 1.0 - xi[a])
        x = phi @ cell_verts
        r = p - x
        if np.linalg.norm(r) < 1e-13 * max(np.max(np.abs(cell_verts)), 1.0):
            break
        dshape = _geom_grad_tensor([np.array([v]) for v in xi])[0]  # [2**d, d]
        J = cell_verts.T @ dshape  # [dim, d]
        xi = xi + np.linalg.solve(J, r)
    if np.all(xi > -1e-8) and np.all(xi < 1 + 1e-8):
        return np.clip(xi, 0.0, 1.0)
    return None


def eval_function(ops, u, points: np.ndarray):
    """Evaluate a nodal field at physical points ``points`` [dim, n]: the
    sensor-extraction analogue of DOLFINx ``Function.eval`` (reference
    ``exp2.py`` tail). ``u`` is a flat field (tensor or array) on ``ops``'s
    space; only the nodes of the cells holding the points are read from its
    device. Returns (points found [n_found, dim], values [n_found]) as
    float64 numpy."""
    from .core.gll import lagrange_eval_gll

    pts, cells, xis = compute_eval_params(ops.mesh, points)
    rows = np.asarray(ops.space.dofmap_for_cells(cells), np.int64)  # [n, N**d]
    flat = torch.as_tensor(u).reshape(-1)
    uc = flat[torch.as_tensor(rows, device=flat.device)].double().cpu().numpy()
    N, d = ops.N, ops.d
    vals = np.zeros(len(cells))
    for i in range(len(cells)):
        tab = [lagrange_eval_gll(N, np.array([xis[i, a]]))[0] for a in range(d)]
        w = tab[0]
        for t in tab[1:]:
            w = np.multiply.outer(w, t).reshape(-1)
        vals[i] = w @ uc[i]
    return pts, vals


@traced("fus.setup.stable_dt")
def estimate_stable_dt(ops, c0, rho0, rk_order: int = 4, safety: float = 0.85,
                       iters: int = 40, seed: int = 0) -> float:
    """Spectral-radius-based stable time step for the explicit wave solvers.

    Power-iterates λ_max of M⁻¹K_{c²/ρ} (the first-order system's
    eigenfrequencies are ω = √λ) and returns ``safety · s_rk / ω_max``, with
    ``s_rk`` the RK method's imaginary-axis stability extent (2√2 for
    classical RK4). On deformed (bowl-fitted) lattices the skewed blend-band
    cells raise the spectral radius beyond what the shortest edge implies,
    so the h_min CFL rule of the reference is not enough there.

    The same iteration as the JAX package's: the start vector from
    ``numpy.random.default_rng(seed)``, ``iters`` normalised applies of the
    operator's own ``stiffness_apply`` (on the operator's device and dtype),
    then one Rayleigh quotient; the norms and the quotient are summed in
    float64.
    """
    s_rk = {1: 0.0, 2: 0.0, 3: 1.7320508, 4: 2.8284271}.get(int(rk_order))
    if not s_rk:
        # RK1/RK2 have no imaginary-axis interval: the RK3 extent scaled
        # down (the ABC terms keep the spectrum slightly off the axis)
        s_rk = 1.0
    nc = ops.num_cells
    c_arr = np.broadcast_to(np.asarray(c0, np.float64).reshape(-1), (nc,))
    r_arr = np.broadcast_to(np.asarray(rho0, np.float64).reshape(-1), (nc,))
    kcoef = ops.stiff_coeff(c_arr**2 / r_arr)
    m = ops.assemble_diag(1.0 / r_arr)
    minv = ops.to_device(1.0 / np.maximum(m, np.finfo(m.dtype).tiny))
    rng = np.random.default_rng(seed)
    z = ops.to_device(rng.standard_normal(ops.ndofs))
    lam = 0.0
    for _ in range(iters):
        w = minv * ops.stiffness_apply([z], [kcoef])
        nrm = float(torch.linalg.vector_norm(w.double()))
        lam = nrm / float(torch.linalg.vector_norm(z.double()))
        z = w / nrm
    # one Rayleigh refinement
    w = minv * ops.stiffness_apply([z], [kcoef])
    lam = float(torch.dot(z.double(), w.double()))
    omega = float(np.sqrt(max(lam, 1e-300)))
    return safety * s_rk / omega
