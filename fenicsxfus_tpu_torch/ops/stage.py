"""K2: one fused explicit-RK stage of the wave models, all four kinds.

Port of ``fenicsxfus_tpu/ops/pallas_stage_v3.py::FusedRKStageV3`` (the TPU
kernel ``_stage_call`` and the ``make_step`` driver) and of the helpers in
``ops/pallas_stage.py`` (``KIND_*``, ``source_coefs``, ``pack_facet_vector``,
``_facet_corrections``, ``_epilogue``, ``_stage_fields``).

A stage of the a-vector RK tables reads only the step state and the two
previous slopes (reference ``_linear.py:40-65``):

    vn_i = v0 + aᵢ·dt·kv_{i-1}
    un_i = u0 + aᵢ·dt·v0 + aᵢa_{i-1}·dt²·kv_{i-2}
    acc  = K_u(un_i) [+ K_v(vn_i)]                      (1 or 2 fields)
    corr = Σ_j s_j(tᵢ)·F_j − abc∘vn_i                    (packed facets)
    kv_i = (−acc + corr) ∘ inv_m                         (linear, lossy)
    kv_i = (d2∘vn_i² − acc + corr) / (m0 − d2∘un_i)      (westervelt, focused)

and the last stage emits the step update directly:
u1 = u0 + dt(Σbᵢ)v0 + dt²Σᵢ bᵢaᵢ kv_{i-1},  v1 = v0 + dtΣᵢ bᵢ kv_i.

The boundary vectors (sources, ABC) are nonzero only on the six box faces
and travel packed (``pack_facet_vector``): ``xp`` [2, G1, G2], ``ye``
[G0, 2, G2], ``ze`` [G0, G1, 2]. A vector with interior support cannot be
packed, and the model then takes the unfused step.

On a hybrid (bowl-fitted) lattice a stage also takes a band operand, the
slab correction K_{c·(G_cell − G_uniform)} of its stage fields on the first
lattice planes (``ops/band.py``, K6; ``band`` [slab_x, G1, G2]), added to the
assembled stiffness before the facet terms and the epilogue, as the TPU
kernel adds its band (``pallas_stage_v3.py:191-194``); ``make_step``'s
``band_fn`` forms it before each stage.

``stage_apply`` is the wrapper: CUDA tensors launch ``csrc/stage.cu`` (the
tiled stencil of ``csrc/tile.cuh``, shaped by ``stiffness.tile_plan``); CPU
tensors run ``stage_plain``.
"""

from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

from .stiffness import (  # noqa: F401 (KIND_FIELDS, KIND_RAW: this module's tables)
    KIND_FIELDS,
    KIND_RAW,
    DTYPE_CODES,
    check_coeffs,
    check_fields,
    check_launch,
    lattice_grid,
    launch_args,
    plan_ints,
    pointer_array,
    stiffness_plain,
    tile_kernel,
    tile_plan,
)

# dense per-DOF extras read by the epilogue, in operand order
KIND_DENSE = {
    "linear": ("inv_m",),
    "lossy": ("inv_m",),
    "westervelt": ("m0", "d2"),
    "focused": ("m0", "d2"),
}
# packed facet vectors; the last entry is always the ABC diagonal (pointwise
# −vn coefficient), the others take the scalars of ``source_coefs``
KIND_FACET = {
    "linear": ("src_vec", "abc_diag"),
    "lossy": ("src_vec", "src_vec_d", "abc_diag"),
    "westervelt": ("src_vec", "src_vec_d", "abc_diag"),
    # phased-aperture (bowl) source: cos/sin phase-split pairs for g and dg
    "focused": ("src_cos", "src_sin", "src_cos_d", "src_sin_d", "abc_diag"),
}
# kinds whose lumped mass depends on the stage field: m = m0 − d2∘un
NONLINEAR_KINDS = ("westervelt", "focused")
# kind codes of the C entry ``fus_stage`` (csrc/stage.cu, enum Kind)
KIND_CODES = {"linear": 0, "lossy": 1, "westervelt": 2, "focused": 3}


def source_coefs(kind: str, consts: dict, t: float) -> list[float]:
    """Scalar time coefficients of the non-ABC facet vectors of ``kind``, on
    the host in float64: [g] (linear), [g, dg] (lossy, Westervelt), or the
    phase-split pairs of the focused source,
    [win·amp·cos, win·amp·sin, dwin·amp·cos − win·amp·w0·sin,
    dwin·amp·sin + win·amp·w0·cos] at ω0·t (``models/focused.py``)."""
    from ..models.base import source_amplitudes
    from ..models.common import source_window

    if kind == "focused":
        w0 = consts["w0"]
        amp = consts["p0"] * w0 / consts["s0"]
        win, dwin = source_window(t, consts["freq"], consts["alpha"])
        cos_t, sin_t = math.cos(w0 * t), math.sin(w0 * t)
        return [
            (win * amp) * cos_t,
            (win * amp) * sin_t,
            (dwin * amp) * cos_t - (win * amp * w0) * sin_t,
            (dwin * amp) * sin_t + (win * amp * w0) * cos_t,
        ]
    g, dg = source_amplitudes(consts, t)
    return [g] if kind == "linear" else [g, dg]


def pack_facet_vector(vec, gdims):
    """Decompose a facet vector (nonzero only on the 6 box faces) into
    2 x-planes + y-row strips + z-column strips, additively exclusive:

    * ``xp`` [2, G1, G2]  — the g0 = 0 / G0-1 planes (edges included);
    * ``ye`` [G0, 2, G2]  — rows g1 = 0 / G1-1 per plane, x-faces zeroed;
    * ``ze`` [G0, G1, 2]  — cols g2 = 0 / G2-1 per plane, x/y-faces zeroed.

    Returns None if the vector has interior support (caller falls back to
    the unfused step)."""
    f = np.asarray(vec).reshape(gdims)
    if f[1:-1, 1:-1, 1:-1].any():
        return None
    xp = np.stack([f[0], f[-1]])
    ye = np.stack([f[:, 0, :], f[:, -1, :]], axis=1).copy()
    ye[0] = 0
    ye[-1] = 0
    ze = np.stack([f[:, :, 0], f[:, :, -1]], axis=2).copy()
    ze[0] = 0
    ze[-1] = 0
    ze[:, 0] = 0
    ze[:, -1] = 0
    return {"xp": xp, "ye": ye, "ze": ze}


def unpack_facet_vector(pf: dict) -> torch.Tensor:
    """Dense lattice vector of a packed facet vector (sum of its parts)."""
    xp, ye, ze = pf["xp"], pf["ye"], pf["ze"]
    f = xp.new_zeros(ye.shape[0], xp.shape[1], xp.shape[2])
    f[0] += xp[0]
    f[-1] += xp[1]
    f[:, 0, :] += ye[:, 0, :]
    f[:, -1, :] += ye[:, 1, :]
    f[:, :, 0] += ze[:, :, 0]
    f[:, :, -1] += ze[:, :, 1]
    return f


def stage_fields(u0, v0, kvp, kvpp, alpha, beta):
    """(un, vn) of a stage from the step state and the previous slopes."""
    un = u0 + alpha * v0
    if kvpp is not None:
        un = un + beta * kvpp
    vn = v0 + alpha * kvp if kvp is not None else v0
    return un, vn


def step_update(u0, v0, kvs, tail):
    """Final-stage step update from the slopes ``kvs`` in stage order.
    ``tail``: [dt·Σb, cu_0..cu_{n-2}, db_0..db_{n-1}]."""
    ns = len(kvs)
    u1 = u0 + tail[0] * v0
    for j in range(ns - 1):
        u1 = u1 + tail[1 + j] * kvs[j]
    v1 = v0
    for i in range(ns):
        v1 = v1 + tail[ns + i] * kvs[i]
    return u1, v1


def stage_plain(kind, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final,
                band=None):
    """Plain torch version of the K2 kernel for ``kind``.

    ``Fs``: the packed stiffness coefficients of un (and vn); ``dense``: the
    tensors named by ``KIND_DENSE[kind]``; ``facets``: the packed vectors
    named by ``KIND_FACET[kind]``. ``scal``: host floats [alpha, beta,
    source_coefs...] (+ the step-update tail when ``final``). ``band``: None,
    or the band operand [rows, G1, G2] added to the stiffness of the first
    ``rows`` lattice planes. Returns kv, or (u1, v1) on the final stage."""
    un, vn = stage_fields(u0, v0, kvp, kvpp, scal[0], scal[1])
    acc = stiffness_plain([un, vn][: KIND_FIELDS[kind]], Fs, p)
    if band is not None:
        acc[: band.shape[0]] += band
    return stage_finish_plain(kind, acc, un, vn, u0, v0, kvp, kvpp, prev, dense, facets,
                              scal, final)


def stage_finish_plain(kind, acc, un, vn, u0, v0, kvp, kvpp, prev, dense, facets, scal,
                       final):
    """The rest of a stage once its assembled stiffness ``acc`` is known
    (``csrc/stage.cuh::stage_finish``): the packed facet terms, the kind's
    epilogue, and kv or, on the final stage, the step update (u1, v1)."""
    nfa = len(facets)
    corr = -unpack_facet_vector(facets[-1]) * vn
    for j in range(nfa - 1):
        corr = corr + scal[2 + j] * unpack_facet_vector(facets[j])
    if kind in NONLINEAR_KINDS:
        m0, d2 = dense
        kv = (d2 * (vn * vn) - acc + corr) / (m0 - d2 * un)
    else:
        (inv_m,) = dense
        kv = (-acc + corr) * inv_m
    if not final:
        return kv
    kvs = [k for k in (prev, kvpp, kvp) if k is not None] + [kv]
    return step_update(u0, v0, kvs, scal[1 + nfa :])


def check_stage_fields(kind, u0, tensors, Fs, p):
    """Validate the kind, the lattice fields ``tensors`` (u0's shape, dtype
    and device) and the stiffness coefficients of a stage; return the
    coefficients' cell-axis extents."""
    if kind not in KIND_FIELDS:
        raise ValueError(f"unknown stage kind {kind!r}; one of {sorted(KIND_FIELDS)}")
    gdims = tuple(u0.shape)
    if u0.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {u0.dtype}; use float32 or float64")
    if u0.dim() != 3:
        raise ValueError(f"fields must be 3D lattices, got shape {gdims}")
    grid = lattice_grid(gdims, p)
    if len(Fs) != KIND_FIELDS[kind]:
        raise ValueError(f"kind {kind!r} takes {KIND_FIELDS[kind]} coefficients, got {len(Fs)}")
    check_fields(tensors, gdims, u0.dtype, u0.device)
    exts = check_coeffs(Fs, gdims, grid, u0.dtype, u0.device)
    if u0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stage kernel for device {u0.device}")
    return exts


def check_band(band, u0):
    """Raise unless ``band`` is a contiguous tensor of u0's dtype on its
    device, of shape [rows, G1, G2] with 1 <= rows <= G0."""
    G0, G1, G2 = u0.shape
    if band.dim() != 3 or not 1 <= band.shape[0] <= G0:
        raise ValueError(f"band of shape {tuple(band.shape)}; expected [rows <= {G0}, {G1}, {G2}]")
    check_fields([band], (band.shape[0], G1, G2), u0.dtype, u0.device)


def check_stage(kind, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final, band=None):
    """Validate the operands of a whole stage (K2, K5b) and K2's optional
    band operand; return the coefficients' cell-axis extents."""
    if band is not None:
        check_band(band, u0)
    state = [t for t in (u0, v0, kvp, kvpp, prev) if t is not None]
    exts = check_stage_fields(kind, u0, state, Fs, p)
    if kvpp is not None and kvp is None:
        raise ValueError("kvpp without kvp")
    if prev is not None and (kvpp is None or not final):
        raise ValueError("prev is only read by a final stage that also has kvpp")
    if len(dense) != len(KIND_DENSE[kind]) or len(facets) != len(KIND_FACET[kind]):
        raise ValueError(
            f"kind {kind!r} takes dense {KIND_DENSE[kind]} and facets {KIND_FACET[kind]}"
        )
    check_fields(dense, tuple(u0.shape), u0.dtype, u0.device)
    check_facets(facets, u0)
    ns = len(state) - 1
    n_scal = 1 + len(facets) + (2 * ns if final else 0)
    if len(scal) != n_scal:
        raise ValueError(f"scal has {len(scal)} entries, expected {n_scal}")
    return exts


def check_facets(facets, u0):
    """Raise unless every packed facet vector has the parts of u0's lattice,
    in u0's dtype and on its device."""
    G0, G1, G2 = u0.shape
    want = {"xp": (2, G1, G2), "ye": (G0, 2, G2), "ze": (G0, G1, 2)}
    for pf in facets:
        for name, shape in want.items():
            check_fields([pf[name]], shape, u0.dtype, u0.device)


def stage_pointers(u0, v0, kvp, kvpp, prev, Fs, dense, facets, outs, exts):
    """The operand slots of the stage C entries (``csrc/stage.cuh``): device
    pointers (0 = absent) and the 6 coefficient extents. ``outs``: kv_out,
    u_out, v_out, and for K5a/K5b yA."""
    # fixed operand slots: 2 coefficient sets, 2 dense fields, 5 facets
    coeffs = [F[f"F{a}"] for F in Fs for a in range(3)]
    coeffs += [None] * (6 - len(coeffs))
    dense_p = list(dense) + [None] * (2 - len(dense))
    facet_p = [pf[n] for pf in facets for n in ("xp", "ye", "ze")]
    facet_p += [None] * (15 - len(facet_p))
    ptrs = pointer_array([u0, v0, kvp, kvpp, prev] + coeffs + dense_p + facet_p + list(outs))
    ext = [e for ex in exts for e in ex]
    ext += [1] * (6 - len(ext))
    return ptrs, (ctypes.c_int * 6)(*ext)


def stage_apply(kind, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final,
                band=None):
    """One RK stage of ``kind`` on lattice fields [G0, G1, G2].

    ``kvp``/``kvpp``: slopes of the two previous stages (None if absent);
    ``prev``: the slope three stages back, read only by the final RK4 stage;
    ``band``: the band operand of a hybrid lattice, or None. Other arguments
    as ``stage_plain``. CUDA tensors launch the K2 kernel (``csrc/stage.cu``;
    with a band, its band kernels) on the current stream; CPU tensors run
    ``stage_plain``. A band of the wrong shape, dtype or device raises. The
    final stage writes u1/v1 into new buffers (never onto u0/v0, which other
    threads are still reading). Launches count per kind in ``launches``,
    those with a band in ``band_launches``.
    """
    exts = check_stage(kind, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final, band)
    if u0.device.type == "cpu":
        return stage_plain(kind, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final,
                           band)
    from .._build import library

    lib = library()
    if final:
        outs = (None, torch.empty_like(u0), torch.empty_like(v0))
    else:
        outs = (torch.empty_like(u0), None, None)
    ptrs, ext = stage_pointers(u0, v0, kvp, kvpp, prev, Fs, dense, facets, outs, exts)
    gd, K1, stream, dev = launch_args(u0, p)
    nf = KIND_FIELDS[kind]
    kernel = ("K2" if band is None else "K2+band", kind)
    plan = tile_plan(u0.shape, p, nf, u0.dtype, nr=KIND_RAW[nf], kernel=kernel)
    rc = lib.fus_stage(
        KIND_CODES[kind], DTYPE_CODES[u0.dtype], ptrs, ext, gd, p, K1,
        (ctypes.c_double * len(scal))(*scal), len(scal), int(final), plan_ints(plan),
        None if band is None else ctypes.c_void_p(band.data_ptr()),
        0 if band is None else band.shape[0], stream, dev,
    )
    check_launch(lib, rc, "K2 stage" if band is None else "K2 stage with a band")
    (stage_apply.launches if band is None else stage_apply.band_launches)[kind] += 1
    stage_apply.tiles[tile_kernel(plan, p, u0.dtype, kernel)] += 1
    return outs[0] if not final else (outs[1], outs[2])


# kernel launches per kind, without and with a band operand, and by the
# kernel each took (``ops/stiffness.py::tile_kernel``)
stage_apply.launches = collections.Counter()
stage_apply.band_launches = collections.Counter()
stage_apply.tiles = collections.Counter()


class FusedRKStage:
    """Explicit-RK step of one model kind built from one K2 launch per stage."""

    # the function of one stage that ``make_step`` calls by default
    KERNEL = staticmethod(stage_apply)

    def __init__(self, gdims, p: int, kind: str, tables):
        if kind not in KIND_FIELDS:
            raise ValueError(f"unknown stage kind {kind!r}; one of {sorted(KIND_FIELDS)}")
        self.gdims = tuple(gdims)
        self.p = p
        self.kind = kind
        self.a_tab, self.b_tab, self.c_tab = tables
        self.nstage = len(self.b_tab)
        if self.nstage > 4:
            raise NotImplementedError("the fused stage takes at most 4 RK stages")

    def make_step(self, consts_to_Fs, consts_to_extras, stage_fn=None, band_fn=None):
        """Step function (consts, (u, v, t), dt) -> (u, v, t + dt) on lattice
        tensors [G0, G1, G2]; ``t`` and ``dt`` are host floats.

        ``consts_to_Fs(consts)``: the packed stiffness coefficients, one per
        field; ``consts_to_extras(consts)``: (dense, packed facets) in
        ``KIND_DENSE``/``KIND_FACET`` order. ``stage_fn``: the function of
        one stage, with ``stage_apply``'s signature; by default the class's
        kernels (``KERNEL``), or a plain version (``stage_plain``) to run the
        plain path on any device. Scalars (α, β, source coefficients, step
        weights) are formed on the host in float64 and passed to each launch
        as arguments. ``band_fn(consts, u0, v0, kvp, kvpp, alpha, beta)``
        (hybrid lattices; the JAX package's ``make_step(band_fn=...)``)
        returns each stage's band operand, called just before the stage."""
        a_t, b_t, c_t = self.a_tab, self.b_tab, self.c_tab
        n, p, kind = self.nstage, self.p, self.kind
        stage_fn = stage_fn or self.KERNEL

        def step(consts, carry, dtn):
            u0, v0, t = carry
            Fs = consts_to_Fs(consts)
            dense, facets = consts_to_extras(consts)
            kvs = []
            for i in range(n):
                kvp = kvs[i - 1] if i >= 1 else None
                kvpp = kvs[i - 2] if i >= 2 else None
                alpha = a_t[i] * dtn
                beta = (a_t[i] * a_t[i - 1] if i >= 1 else 0.0) * dtn * dtn
                parts = [alpha, beta] + source_coefs(kind, consts, t + c_t[i] * dtn)
                band = {} if band_fn is None else {
                    "band": band_fn(consts, u0, v0, kvp, kvpp, alpha, beta)}
                if i < n - 1:
                    kvs.append(stage_fn(kind, u0, v0, kvp, kvpp, None, Fs, dense,
                                        facets, parts, p, False, **band))
                    continue
                cu = [b_t[j + 1] * a_t[j + 1] * dtn * dtn for j in range(n - 1)]
                db = [b_t[j] * dtn for j in range(n)]
                parts += [float(np.sum(b_t)) * dtn] + cu + db
                prev = kvs[i - 3] if i >= 3 else None
                u1, v1 = stage_fn(kind, u0, v0, kvp, kvpp, prev, Fs, dense,
                                  facets, parts, p, True, **band)
            return u1, v1, t + dtn

        step.carry_shape = self.gdims
        return step
