"""Frozen copy of the bowl-fitted box mesher of the measured package
(``core/bowl.py``), kept beside the plain reference so that the reference
works the mesh out again instead of reading the program's. Numpy only.

The differences from the copied source: the mesh container and the
boundary tagging come from ``fusbench.reference.mesh``, the band check's
volume factors from ``fusbench.reference.sem.q1_det_at``, and the two
tuning variables the source reads from the environment are fixed at their
defaults (spectral tau 1.5, no debug output).
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh, _structured, tag_boundaries

__all__ = ["create_bowl_box", "bowl_cap_area"]


def bowl_cap_area(R: float, a: float) -> float:
    """Area of a spherical cap of curvature radius R and aperture radius a."""
    return 2.0 * np.pi * R * (R - np.sqrt(R * R - a * a))


def _fade(xi: np.ndarray) -> np.ndarray:
    """C1 deformation fade profile: 1 at xi=0, 0 for xi>=1, with ZERO slope
    at both ends (cosine). The zero slope at the cap keeps the first layer
    of cells locally prism-like — a linear fade puts its maximum shear in
    the source-adjacent cells, which at coarse resolution costs ~15% of the
    radiated amplitude (O'Neil gate, tests/test_bowl.py)."""
    x = np.clip(xi, 0.0, 1.0)
    return 0.5 * (1.0 + np.cos(np.pi * x))


def create_bowl_box(
    n,
    lo,
    hi,
    R: float,
    a: float,
    center_yz=None,
    blend: float | None = None,
    lateral_hold: float | None = None,
    tag_source: int = 1,
    tag_other: int | None = 2,
) -> tuple[Mesh, np.ndarray]:
    """Structured box with the x-min face deformed onto a spherical bowl.

    Parameters: ``n``/``lo``/``hi`` as ``create_box``; ``R`` radius of
    curvature, ``a`` aperture radius, ``center_yz`` bowl axis position
    (defaults to the face centre), ``blend`` deformation fade-in depth
    (defaults to three sagittae). Facets on the cap get ``tag_source``;
    every other boundary facet gets ``tag_other`` (None = untagged rigid).

    Returns ``(mesh, focus)`` with ``focus`` the geometric focus
    coordinates [3] (centre of curvature of the cap).
    """
    n = tuple(n)
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    if len(n) != 3:
        raise ValueError("bowl meshes are 3D")
    if not a < R:
        raise ValueError("aperture radius must be < radius of curvature")
    if center_yz is None:
        center_yz = 0.5 * (lo[1:] + hi[1:])
    center_yz = np.asarray(center_yz, float)
    x0 = lo[0]
    xf = float(np.sqrt(R * R - a * a))  # focus distance from the rim plane
    sag = R - xf  # cap depth at the axis
    if blend is None:
        blend = 3.0 * sag
    blend = min(float(blend), 0.9 * (hi[0] - lo[0]))

    mesh = _structured(n, tuple(lo), tuple(hi))

    # rim fitting. The cap facet set is fixed FIRST on the uniform lateral
    # grid (facet-centre radius < a); every vertex on the boundary of that
    # set is then snapped radially onto r = a, so the tagged surface ends
    # on a polygon inscribed in the true rim circle (area error O(h^2))
    # instead of a stair-step (O(h)). The same lateral snap applies to
    # every x-layer — the rim is fitted as a prism through the volume.
    hy = (hi[1] - lo[1]) / n[1]
    hz = (hi[2] - lo[2]) / n[2]
    fy = lo[1] + (np.arange(n[1]) + 0.5) * hy - center_yz[0]
    fz = lo[2] + (np.arange(n[2]) + 0.5) * hz - center_yz[1]
    inside_f = (fy[:, None] ** 2 + fz[None, :] ** 2) < a * a  # [n1, n2]
    # vertex (j,k) adjacency: the up-to-4 surrounding facet cells
    padf = np.zeros((n[1] + 2, n[2] + 2), bool)
    padf[1:-1, 1:-1] = inside_f
    corners = np.stack(
        [padf[:-1, :-1], padf[:-1, 1:], padf[1:, :-1], padf[1:, 1:]]
    )
    boundary_v = corners.any(axis=0) & ~corners.all(axis=0)  # [ny+1, nz+1]

    ny1, nz1 = n[1] + 1, n[2] + 1
    ys = np.linspace(lo[1], hi[1], ny1) - center_yz[0]
    zs = np.linspace(lo[2], hi[2], nz1) - center_yz[1]
    r2d = np.hypot(ys[:, None], zs[None, :])
    mark = boundary_v & (r2d > 1e-12)
    scale2d = np.where(mark, a / np.maximum(r2d, 1e-300), 1.0)

    y2d = ys[:, None] * scale2d  # bowl-centred lateral vertex lattice
    z2d = zs[None, :] * scale2d

    # rim spacing: in diagonal stair regions two grid-adjacent boundary
    # vertices can land on nearly the same rim point, collapsing their
    # shared edge (h_min, and with it the CFL dt, would drop ~4x).
    # Redistribute the snapped vertices ALONG the circle with a global
    # order-preserving minimum-gap pass: sorted angular gaps are floored
    # at dtheta_min and renormalised to 2π, so no two rim vertices
    # crowd, no vertex crosses a neighbour (ordering is preserved by
    # construction — the pairwise-rotation scheme this replaces could
    # sweep a vertex past a third one at fine resolution, twisting the
    # wall-adjacent quads into near-non-convex slivers), and all stay on
    # the rim (inscribed polygon, O(h^2) cap area).
    hmin_lat = min(hy, hz)
    mj, mk = np.nonzero(mark)
    M = len(mj)
    if M >= 3:
        th = np.arctan2(z2d[mj, mk], y2d[mj, mk])
        order = np.argsort(th, kind="stable")
        th_s = th[order]
        dth_min = min(0.6 * hmin_lat / a, 0.95 * 2.0 * np.pi / M)
        gaps = np.diff(np.concatenate([th_s, [th_s[0] + 2.0 * np.pi]]))
        s = np.maximum(gaps, dth_min)
        s *= 2.0 * np.pi / s.sum()
        th_new = th_s[0] + np.concatenate([[0.0], np.cumsum(s[:-1])])
        # anchor: zero mean angular displacement
        th_new -= np.mean(th_new - th_s)
        th2 = np.empty_like(th)
        th2[order] = th_new
        y2d[mj, mk] = a * np.cos(th2)
        z2d[mj, mk] = a * np.sin(th2)

    # inscribed-polygon footprint area — the O(h²) cap-area reference the
    # staircase-corner compensation below restores exactly
    _rj, _rk = np.nonzero(mark)
    _th = np.arctan2(z2d[_rj, _rk], y2d[_rj, _rk])
    _o = np.argsort(_th, kind="stable")
    _yv, _zv = y2d[_rj, _rk][_o], z2d[_rj, _rk][_o]
    _area_inscribed = 0.5 * abs(
        np.sum(_yv * np.roll(_zv, -1) - np.roll(_yv, -1) * _zv)
    )

    # local relaxation: a snap can squeeze a neighbouring edge to ~0.1 h,
    # which would shrink h_min (and the explicit CFL dt) ~4x. A few
    # Laplace-smoothing passes over the UNsnapped vertices within a
    # 3-cell band of the rim spread the squeeze over neighbouring rings.
    # Interior vertex motion does not change the tagged polygon (its rim
    # ring is pinned) nor the facet set (tagged by index).
    band = (np.abs(r2d - a) < 3.0 * max(hy, hz)) & ~mark
    band[0, :] = band[-1, :] = False
    band[:, 0] = band[:, -1] = False
    for _ in range(4):
        yn = 0.25 * (y2d[:-2, 1:-1] + y2d[2:, 1:-1]
                     + y2d[1:-1, :-2] + y2d[1:-1, 2:])
        zn = 0.25 * (z2d[:-2, 1:-1] + z2d[2:, 1:-1]
                     + z2d[1:-1, :-2] + z2d[1:-1, 2:])
        b = band[1:-1, 1:-1]
        y2d[1:-1, 1:-1] = np.where(b, yn, y2d[1:-1, 1:-1])
        z2d[1:-1, 1:-1] = np.where(b, zn, z2d[1:-1, 1:-1])

    # quality-driven 2D repair: a BILINEAR quad's Jacobian det is bilinear
    # in the reference coords, so its minimum is attained at a CORNER —
    # the per-quad corner cross products are an EXACT 2D quality measure.
    # Thin/sheared rim quads (observed at H101, whose aperture passes
    # within ~1 cell of the lateral wall) survive the blanket smoothing
    # above at ~1.5% of the uniform area; the fade shear then drives an
    # interior 3D quadrature point of the extruded cell to ~1e-4 and the
    # measured stable dt collapses ~5x. Relax ONLY the unsnapped,
    # non-boundary vertices of offending quads until every corner det
    # clears the floor (rim ring and walls stay pinned: tagged polygon,
    # cap area and the domain shape are unaffected).
    def _quad_corner_det(y, z):
        """[ny, nz] per-quad minimum corner det (cross products of the
        two edges meeting at each corner, oriented consistently)."""
        p = np.stack([y, z], axis=-1)
        v00, v10 = p[:-1, :-1], p[1:, :-1]
        v01, v11 = p[:-1, 1:], p[1:, 1:]

        def cross(a_, b_):
            return a_[..., 0] * b_[..., 1] - a_[..., 1] * b_[..., 0]

        d = np.stack([
            cross(v10 - v00, v01 - v00),
            cross(v11 - v10, v00 - v10),
            cross(v01 - v11, v10 - v11),
            cross(v00 - v01, v11 - v01),
        ])
        return d.min(axis=0)

    floor2d = 0.05 * hy * hz
    pinned = mark.copy()
    pinned[0, :] = pinned[-1, :] = True
    pinned[:, 0] = pinned[:, -1] = True

    # Staircase corners (round 5): in diagonal rim regions THREE corners
    # of one lattice quad are rim-snapped — three points on a convex arc
    # are nearly collinear, so that quad's corner angle at the middle
    # vertex is ~180° and its compression metric (and with it the cell
    # stiffness spectral radius) blows up by ~(a/h)² regardless of the
    # min-gap spacing (measured 450x uniform at nx=32 H101; these ~60
    # quads alone clamp the production bowl dt, benchmarks/
    # bowl_spectrum.py).  No repositioning ALONG the circle can fix a
    # 3-on-arc quad, so the middle vertex of every such corner is
    # UNPINNED: it stays snapped (starts on the circle) but the repair
    # passes below may pull it off-circle to open the angle.  The tagged
    # cap polygon then cuts these few corners by O(h) — an O(h²)-total
    # cap-area perturbation (O(h)·h per corner × O(1) corners per
    # quadrant), gated by the O'Neil focal-gain test like every other
    # bowl-geometry choice.
    q3 = (
        mark[:-1, :-1].astype(int) + mark[1:, :-1]
        + mark[:-1, 1:] + mark[1:, 1:]
    ) >= 3
    soft = np.zeros_like(mark)
    jj, kk = np.nonzero(q3)
    for j, k in zip(jj, kk):
        # the middle vertex is the marked corner adjacent (in the lattice)
        # to two other marked corners of this quad
        corners = [(j, k), (j + 1, k), (j, k + 1), (j + 1, k + 1)]
        for (cj, ck) in corners:
            if not mark[cj, ck]:
                continue
            nadj = sum(
                1
                for (oj, ok) in corners
                if mark[oj, ok] and abs(oj - cj) + abs(ok - ck) == 1
            )
            if nadj >= 2:
                soft[cj, ck] = True
    soft[0, :] = soft[-1, :] = False
    soft[:, 0] = soft[:, -1] = False
    pinned &= ~soft
    for _ in range(40):
        q = _quad_corner_det(y2d, z2d)
        bad = q < floor2d
        if not bad.any():
            break
        vbad = np.zeros_like(mark)
        vbad[:-1, :-1] |= bad
        vbad[1:, :-1] |= bad
        vbad[:-1, 1:] |= bad
        vbad[1:, 1:] |= bad
        vbad &= ~pinned
        yn = 0.25 * (y2d[:-2, 1:-1] + y2d[2:, 1:-1]
                     + y2d[1:-1, :-2] + y2d[1:-1, 2:])
        zn = 0.25 * (z2d[:-2, 1:-1] + z2d[2:, 1:-1]
                     + z2d[1:-1, :-2] + z2d[1:-1, 2:])
        b = vbad[1:-1, 1:-1]
        y2d[1:-1, 1:-1] = np.where(
            b, 0.5 * y2d[1:-1, 1:-1] + 0.5 * yn, y2d[1:-1, 1:-1]
        )
        z2d[1:-1, 1:-1] = np.where(
            b, 0.5 * z2d[1:-1, 1:-1] + 0.5 * zn, z2d[1:-1, 1:-1]
        )

    # SPECTRAL repair (round 5): the detJ floor above bounds area collapse
    # but not COMPRESSION — a quad at 0.3x area squeezed 3x in one
    # direction keeps detJ healthy while its cell stiffness spectral
    # radius grows ~9x, and exactly such quads (the 1-2 vertex rings just
    # outside the snapped rim, where the snap displacement lands) were
    # measured to clamp the production bowl dt by 1.77x
    # (benchmarks/bowl_spectrum.py: per-cell lambda with global assembled
    # mass localizes at r/a ~ 1.05-1.08, layers 0-2; everywhere else the
    # band is STRETCHED, lambda/uniform median ~0.5).  Per-quad metric:
    # max over corners of trace(J^-1 J^-T)·detJ-normalised — i.e.
    # (|e1|^2+|e2|^2)/det(e1,e2)^2, which bounds the squared max
    # compression sigma_max(J^-1)^2.  Relax unsnapped vertices of quads
    # exceeding FUS_BOWL_SPECTRAL_TAU x the uniform value (rim ring and
    # walls stay pinned, so the tagged polygon, cap area, and the domain
    # shape are unaffected — the pass only redistributes the snap squeeze
    # over neighbouring rings).
    def _quad_corner_compression(y, z):
        """[ny, nz] per-quad max over corners of (|e1|^2+|e2|^2)/det^2."""
        p = np.stack([y, z], axis=-1)
        v00, v10 = p[:-1, :-1], p[1:, :-1]
        v01, v11 = p[:-1, 1:], p[1:, 1:]

        def cross(a_, b_):
            return a_[..., 0] * b_[..., 1] - a_[..., 1] * b_[..., 0]

        def sq(a_):
            return a_[..., 0] ** 2 + a_[..., 1] ** 2

        worst = None
        for c0, c1, c2 in ((v00, v10, v01), (v10, v11, v00),
                           (v11, v01, v10), (v01, v00, v11)):
            e1, e2 = c1 - c0, c2 - c0
            det = np.abs(cross(e1, e2))
            m = (sq(e1) + sq(e2)) / np.maximum(det, 1e-300) ** 2
            worst = m if worst is None else np.maximum(worst, m)
        return worst


    tau = 1.5
    dbg = ""
    comp_u = (hy * hy + hz * hz) / (hy * hz) ** 2
    for _it in range(120):
        m2 = _quad_corner_compression(y2d, z2d)
        bad = m2 > tau * comp_u
        if dbg and (_it < 3 or _it == 119 or not bad.any()):
            jw = np.unravel_index(np.argmax(m2), m2.shape)
            print(f"[bowl spectral] it={_it} bad={int(bad.sum())} "
                  f"max={m2.max()/comp_u:.1f}x at quad {jw} "
                  f"(y={0.5*(y2d[jw]+y2d[jw[0]+1,jw[1]+1])*1e3:.1f}mm "
                  f"z={0.5*(z2d[jw]+z2d[jw[0]+1,jw[1]+1])*1e3:.1f}mm)")
        if not bad.any():
            break
        vbad = np.zeros_like(mark)
        vbad[:-1, :-1] |= bad
        vbad[1:, :-1] |= bad
        vbad[:-1, 1:] |= bad
        vbad[1:, 1:] |= bad
        # include the first ring of neighbours so the squeeze can spread
        vb = vbad.copy()
        vbad[1:, :] |= vb[:-1, :]
        vbad[:-1, :] |= vb[1:, :]
        vbad[:, 1:] |= vb[:, :-1]
        vbad[:, :-1] |= vb[:, 1:]
        vbad &= ~pinned
        yn = 0.25 * (y2d[:-2, 1:-1] + y2d[2:, 1:-1]
                     + y2d[1:-1, :-2] + y2d[1:-1, 2:])
        zn = 0.25 * (z2d[:-2, 1:-1] + z2d[2:, 1:-1]
                     + z2d[1:-1, :-2] + z2d[1:-1, 2:])
        b = vbad[1:-1, 1:-1]
        y2d[1:-1, 1:-1] = np.where(
            b, 0.5 * y2d[1:-1, 1:-1] + 0.5 * yn, y2d[1:-1, 1:-1]
        )
        z2d[1:-1, 1:-1] = np.where(
            b, 0.5 * z2d[1:-1, 1:-1] + 0.5 * zn, z2d[1:-1, 1:-1]
        )
    # the compression pass must not undo the area floor: rerun the detJ
    # guard once (it converges in a few sweeps when triggered at all)
    for _ in range(40):
        q = _quad_corner_det(y2d, z2d)
        bad = q < floor2d
        if not bad.any():
            break
        vbad = np.zeros_like(mark)
        vbad[:-1, :-1] |= bad
        vbad[1:, :-1] |= bad
        vbad[:-1, 1:] |= bad
        vbad[1:, 1:] |= bad
        vbad &= ~pinned
        yn = 0.25 * (y2d[:-2, 1:-1] + y2d[2:, 1:-1]
                     + y2d[1:-1, :-2] + y2d[1:-1, 2:])
        zn = 0.25 * (z2d[:-2, 1:-1] + z2d[2:, 1:-1]
                     + z2d[1:-1, :-2] + z2d[1:-1, 2:])
        b = vbad[1:-1, 1:-1]
        y2d[1:-1, 1:-1] = np.where(
            b, 0.5 * y2d[1:-1, 1:-1] + 0.5 * yn, y2d[1:-1, 1:-1]
        )
        z2d[1:-1, 1:-1] = np.where(
            b, 0.5 * z2d[1:-1, 1:-1] + 0.5 * zn, z2d[1:-1, 1:-1]
        )

    # Area compensation for the unpinned staircase corners: each soft
    # vertex ended a distance delta OUTSIDE the circle (opening its ~180°
    # arc angle), bulging the tagged cap footprint.  With O(1/h) staircase
    # corners on a digitized circle the total bulge is an O(h) area error
    # — one order worse than the inscribed polygon
    # (test_cap_area_converges).  Restore the footprint EXACTLY: shoelace
    # the boundary ring (angular order) before and after the repairs and
    # rescale the whole ring radially by sqrt(A_target/A_now).  Uniform
    # scaling is conformal — the opened corner angles are preserved — and
    # the scale is ~1-O(h²) (every pinned vertex moves ~1e-3·h), so
    # neither the spectral repair nor the cap fit degrades.
    def _ring_area():
        rj, rk = np.nonzero(mark)
        yv, zv = y2d[rj, rk], z2d[rj, rk]
        th_r = np.arctan2(zv, yv)
        o = np.argsort(th_r, kind="stable")
        yv, zv = yv[o], zv[o]
        return 0.5 * abs(
            np.sum(yv * np.roll(zv, -1) - np.roll(yv, -1) * zv)
        )

    area_target = _area_inscribed
    if len(np.nonzero(soft)[0]):
        a_now = _ring_area()
        if a_now > 0:
            sfac = np.sqrt(area_target / a_now)
            rj, rk = np.nonzero(mark)
            y2d[rj, rk] *= sfac
            z2d[rj, rk] *= sfac
            if dbg:
                print(f"[bowl ring] soft={int(soft.sum())} "
                      f"A_inscribed={area_target:.6f} A_now={a_now:.6f} "
                      f"sfac={sfac:.6f} A_after={_ring_area():.6f} "
                      f"disc={np.pi*a*a:.6f}")

    # Lateral snap FADES with depth (same blend as the x-deformation):
    # vertices at x = x0 get the full rim fit (the tagged cap layer), and
    # beyond the blend depth the lattice is exactly uniform again. This
    # confines every deformed cell to the first ``blend_layers`` x-layers,
    # which is what lets the hybrid operator run the lattice fast
    # path on the (uniform) bulk and a per-cell-geometry correction on the
    # blend slab only (ops/operators.py hybrid path).
    # The lateral snap is HELD at full strength for ``lateral_hold`` depth
    # (default: one blend length) and then fades over ``blend``: the wave
    # launches through a rim-fitted prism exactly as if the snap extended
    # through the whole volume (a fade starting AT the cap costs ~13% of
    # the radiated amplitude at 4 elems/wavelength — the rim-adjacent
    # first cells skew and the effective aperture blurs), while the
    # deformation still ends at a fixed depth so the hybrid operator can
    # run the lattice fast path on the uniform bulk.
    if lateral_hold is None:
        lateral_hold = blend
    lateral_hold = min(float(lateral_hold), 0.9 * (hi[0] - lo[0]) - blend)
    v = mesh.vertices.copy()
    iy = np.rint((v[:, 1] - lo[1]) / hy).astype(int)
    iz = np.rint((v[:, 2] - lo[2]) / hz).astype(int)
    fade_l = _fade((v[:, 0] - x0 - lateral_hold) / blend)
    dy = y2d[iy, iz] - ys[iy]
    dz = z2d[iy, iz] - zs[iz]
    v[:, 1] += dy * fade_l
    v[:, 2] += dz * fade_l
    mesh.vertices = v
    mesh.uniform_hint = False  # deformed cells: hybrid/general-geometry path
    hx = (hi[0] - lo[0]) / n[0]
    # cells with ix < blend_layers may be deformed; everything beyond is
    # uniform by construction (both deformations fade to zero by
    # ``lateral_hold + blend``)
    mesh.blend_layers = min(
        int(np.ceil((lateral_hold + blend) / hx)) + 1, n[0]
    )
    mesh.uniform_box = (lo.copy(), hi.copy())

    # tag on the x-undeformed mesh (topological facet sets survive the
    # deformation), by lateral facet INDEX so the tagged set is exactly
    # ``inside_f`` regardless of how snapping moved the midpoints
    def on_cap(x):
        j = np.clip(np.floor((x[1] - lo[1]) / hy).astype(int), 0, n[1] - 1)
        k = np.clip(np.floor((x[2] - lo[2]) / hz).astype(int), 0, n[2] - 1)
        tol = 1e-12 * max(1.0, abs(x0))
        return (np.abs(x[0] - x0) < tol) & inside_f[j, k]

    tags = {tag_source: on_cap}
    tag_boundaries(mesh, tags, default=tag_other)

    # deform: pull the near-face vertices back onto the cap.  RING-column
    # vertices (the footprint boundary, incl. the off-circle staircase
    # corners) continue the SPHERE for r slightly beyond a instead of
    # flattening at s=0 — otherwise each bulged corner carries a flat
    # patch and the tagged surface area degrades from O(h²) to O(h)
    # (test_cap_area_converges).  Non-ring baffle vertices keep s=0.
    v = mesh.vertices.copy()
    # lattice indices by the structured vertex ordering (positions are
    # already laterally deformed here — rint would misround snapped rows)
    _, gy, gz = np.indices((n[0] + 1, ny1, nz1))
    iy_v, iz_v = gy.reshape(-1), gz.reshape(-1)
    on_ring = mark[iy_v, iz_v]
    r = np.hypot(v[:, 1] - center_yz[0], v[:, 2] - center_yz[1])
    s_sphere = xf - np.sqrt(np.maximum(R * R - r * r, 0.0))
    ext = on_ring & (r < min(a + 2.0 * max(hy, hz), 0.95 * R))
    s = np.where((r < a) | ext, s_sphere, 0.0)
    fade = _fade((v[:, 0] - x0) / blend)
    v[:, 0] += s * fade
    mesh.vertices = v

    # validity: intermediate fade planes can create near-degenerate cells
    # (tangentially rim-rotated vertices linearly interpolated toward their
    # lattice positions may sweep across a neighbour column — observed
    # min detJ ~3e-10 at blend = 9 sagittae, which NaNs the solve at the
    # nominal CFL). Check the band's corner Jacobians; if squeezed, relax
    # the interior band planes (cap layer and the uniform region stay
    # pinned, so the tagged surface and the hybrid split are unaffected),
    # and raise rather than return a mesh that will silently blow up.
    _ensure_band_validity(mesh, n, blend_layers=mesh.blend_layers)

    focus = np.array([x0 + xf, center_yz[0], center_yz[1]])
    return mesh, focus


def _ensure_band_validity(mesh, n, blend_layers: int, floor: float = 2e-3):
    """Raise (after attempting TARGETED relaxation) if any blend-band
    cell's detJ at the N=5 GLL lattice falls below ``floor`` x the
    uniform cell volume.

    N=5, not corners: a TRILINEAR cell's det is not trilinear — fade-plane
    shear over an already-thin rim quad collapses an interior quadrature
    point two orders below the corner values (measured 8e-5 of uniform
    with healthy corners at H101 nx=64; the N=3 lattice misses the point
    too), costing a ~6x stable-dt drop through the spectral clamp in
    ``estimate_stable_dt``. N=5 covers the production p<=4 quadrature.

    Relaxation is targeted: only the vertices of offending cells move
    (damped 6-neighbour average), never the cap layer (x-layer 0 — the
    tagged polygon and cap area stay exact) and never domain-boundary
    vertices. Deeper rim-prism vertices may move slightly where quality
    demands; the O'Neil gates (tests/test_bowl.py) pin the physics."""
    from .sem import q1_det_at

    nbl = min(blend_layers + 1, n[0])
    nb = nbl * n[1] * n[2]
    uni_detJ = np.prod(
        (mesh.vertices.max(axis=0) - mesh.vertices.min(axis=0))
        / np.asarray(n)
    )
    def band_quality():
        """(q_min, per-cell q [nb]) over the band at the N=5 lattice."""
        try:
            det = q1_det_at(mesh.vertices[mesh.cells[:nb]], 5)
        except Exception:
            return -1.0, None
        per_cell = det.min(axis=1) / uni_detJ
        return float(per_cell.min()), per_cell

    q, per_cell = band_quality()
    if q >= floor:
        return
    shape = (n[0] + 1, n[1] + 1, n[2] + 1, 3)
    for _ in range(30):
        # vertices of offending cells (band cells are x-slowest ordered:
        # cell (ix, iy, iz) = ((ix*n1)+iy)*n2 + iz)
        bad = np.nonzero(per_cell < floor)[0]
        ix, r = np.divmod(bad, n[1] * n[2])
        iy, iz = np.divmod(r, n[2])
        vmask = np.zeros(shape[:3], bool)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    vmask[ix + dx, iy + dy, iz + dz] = True
        vmask[0] = False  # cap layer pinned (tagged polygon, cap area)
        vmask[-1] = False
        vmask[:, 0, :] = vmask[:, -1, :] = False
        vmask[:, :, 0] = vmask[:, :, -1] = False
        if not vmask.any():
            break
        v = mesh.vertices.reshape(shape).copy()
        nbavg = (
            v[:-2, 1:-1, 1:-1] + v[2:, 1:-1, 1:-1]
            + v[1:-1, :-2, 1:-1] + v[1:-1, 2:, 1:-1]
            + v[1:-1, 1:-1, :-2] + v[1:-1, 1:-1, 2:]
        ) / 6.0
        b = vmask[1:-1, 1:-1, 1:-1, None]
        v[1:-1, 1:-1, 1:-1] = np.where(
            b, 0.5 * v[1:-1, 1:-1, 1:-1] + 0.5 * nbavg, v[1:-1, 1:-1, 1:-1]
        )
        mesh.vertices = v.reshape(-1, 3)
        q, per_cell = band_quality()
        if q >= floor:
            return
    raise ValueError(
        f"bowl mesh blend band has near-degenerate cells (min detJ "
        f"{q:.2e} of uniform after relaxation) — reduce `blend`/"
        "`lateral_hold` or refine the lateral resolution"
    )
