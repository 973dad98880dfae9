"""The launch plan and the schedule of K3, the whole-step wavefront
(``ops/step_wave.py::wave_plan``, ``csrc/wave.cuh``), checked on the CPU.

For p = 1..8 at the HITU lattice, the headline, (20,9,9), (13,11,17) and
(41,1,1) cells, with 1 and 2 stencil fields, fp32 and fp64, at the default
ring and the smallest sound one: the schedule is replayed here from the plan,
with the kernel's ticket order, waits and ring layout restated (``_Schedule``),
and the slopes each item reads derived independently from the planes its
tile walk loads (``csrc/tile.cuh::tile_stencil``). Checked: every wait points
at a smaller ticket (so no grid deadlocks), every slope an item reads was
written by a group it waits for, every node is owned once per stage, no ring
slot is rewritten while a reader of it remains (in a replay where every item
starts as soon as its waits allow), and ``wave_plan`` refuses a ring below
the bound. Other plan sizes are reached through the module constants
``WAVE_SLAB``, ``WAVE_LAG`` and ``RING_SPARE``.
"""

import numpy as np
import pytest
import torch

from fenicsxfus_tpu_torch.ops import step_wave
from fenicsxfus_tpu_torch.ops.step_wave import (
    min_ring,
    ring_bytes,
    ring_planes,
    wave_plan,
    wave_plan_ints,
)
from fenicsxfus_tpu_torch.ops.stiffness import SMEM_MAX

CELLS = {
    "HITU": (80, 47, 47),
    "headline": (104, 104, 104),
    "small": (20, 9, 9),
    "ragged": (13, 11, 17),
    "channel": (41, 1, 1),
}
STAGES = 4
L2_BYTES = 50 * 2**20  # the H100's L2


class _Schedule:
    """csrc/wave.cuh restated: the groups (stage, slab) in ticket order, the
    groups an item of each waits for, and the ring plane of a slope plane."""

    def __init__(self, plan, gdims, p):
        self.p, self.G0 = p, gdims[0]
        self.n0 = (gdims[0] - 1) // p
        self.S, self.lag, self.R = plan["slab"], plan["lag"], plan["ring"]
        self.nslab = plan["grid"][2]
        self.tiles = plan["grid"][0] * plan["grid"][1]
        self.order = []  # groups in ticket order: row b, then stage
        for b in range(self.nslab + self.lag * (STAGES - 1)):
            for s in range(STAGES):
                if 0 <= b - self.lag * s < self.nslab:
                    self.order.append((s, b - self.lag * s))
        # tickets of a group: [first, last]
        self.first = {g: i * self.tiles for i, g in enumerate(self.order)}
        self.last = {g: self.first[g] + self.tiles - 1 for g in self.order}
        self.slab_of = np.full(self.G0, -1)  # the slab whose walk computes a plane
        for Z in range(self.nslab):
            self.slab_of[self.owned_planes(Z)] = Z
        self.read = {g: self.reads(*g) for g in self.order}
        self.readers = {}  # (slope, slab) -> the groups that read it
        for g, rd in self.read.items():
            for x in rd:
                self.readers.setdefault(x, set()).add(g)

    def waits(self, s, Z):
        """wave.cuh::wave_wait: the groups (stage, slab) item (s, Z) waits for."""
        out = {(sp, q) for sp in range(s) for q in (Z - 1, Z, Z + 1)}
        O = Z - self.R
        if s < STAGES - 1 and O >= 0:
            out |= {(r, q) for r in range(s + 1, min(s + 2, STAGES - 1) + 1)
                    for q in (O - 1, O, O + 1)}
            if s == 0:
                out.add((STAGES - 1, O))
        return {(r, q) for r, q in out if 0 <= q < self.nslab}

    def ring_plane(self, g0):
        """The ring plane of plane g0 (csrc/wave.cuh's header)."""
        sp = self.S * self.p
        if g0 == self.G0 - 1:
            return self.R * sp
        Z = g0 // sp
        return (Z % self.R) * sp + g0 - Z * sp

    # --- derived from the tile walk, not from wave.cuh

    def cells(self, Z):
        c_begin = Z * self.S
        return c_begin, min(c_begin + self.S, self.n0)

    def owned_planes(self, Z):
        """The planes the walk of slab Z computes (tile.cuh::tile_stencil)."""
        c_begin, c_end = self.cells(Z)
        return list(range(c_begin * self.p, c_end * self.p + (c_end == self.n0)))

    def loaded_planes(self, Z):
        """The planes the walk of slab Z copies: from the cell before it to the
        plane after its last cell."""
        c_begin, c_end = self.cells(Z)
        return list(range(max(c_begin - 1, 0) * self.p, c_end * self.p + 1))

    def reads(self, s, Z):
        """The (slope, slab) pairs item (s, Z) reads: kv_{s-1} and kv_{s-2}
        on every loaded plane (the stencil), the final stage also kv0 at its
        own nodes."""
        slabs = set(self.slab_of[self.loaded_planes(Z)].tolist())
        out = {(f, q) for f in (s - 1, s - 2) if f >= 0 for q in slabs}
        if s == STAGES - 1:
            out.add((0, Z))
        return out


def _plan(gdims, p, nf, dtype, monkeypatch, spare, slab, lag):
    monkeypatch.setattr(step_wave, "RING_SPARE", spare)
    monkeypatch.setattr(step_wave, "WAVE_SLAB", slab)
    monkeypatch.setattr(step_wave, "WAVE_LAG", lag)
    return wave_plan(gdims, p, nf, dtype, nr=3 if nf == 1 else 4)


# (fields, dtype, RING_SPARE, WAVE_SLAB, WAVE_LAG): the default plan, the
# smallest sound ring, and other slabs and lags
PLANS = [(1, torch.float32, 1, 4, 2), (2, torch.float32, 0, 1, 2), (2, torch.float64, 1, 1, 2),
         (1, torch.float64, 0, 2, 1), (2, torch.float32, 0, 3, 3)]


@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("name", list(CELLS))
def test_schedule_is_sound(name, p, monkeypatch):
    cells = CELLS[name]
    gdims = tuple(n * p + 1 for n in cells)
    for nf, dtype, spare, slab, lag in PLANS:
        plan = _plan(gdims, p, nf, dtype, monkeypatch, spare, slab, lag)
        (t1, t2), S = plan["tile"], plan["slab"]
        gx, gy, nslab = plan["grid"]
        assert plan["smem"] <= SMEM_MAX and plan["threads"] % 32 == 0
        assert S == min(slab, cells[0]) and nslab == -(-cells[0] // S) and plan["lag"] == lag
        assert plan["ring"] == min(min_ring(plan["lag"]) + spare, nslab)
        assert plan["ring_planes"] == plan["ring"] * S * p + 1
        assert list(wave_plan_ints(plan)) == [t1, t2, S, plan["threads"], plan["smem"], gx, gy,
                                              nslab, plan["lag"], plan["ring"], 0]
        w = _Schedule(plan, gdims, p)
        groups = set(w.order)
        assert len(w.order) == len(groups) == STAGES * nslab

        # every node owned once per stage: the tiles partition g1 and g2,
        # the slabs' walks partition g0
        for G, t, nb in ((gdims[1], t1, gy), (gdims[2], t2, gx)):
            owners = np.zeros(G, int)
            for b in range(nb):
                owners[b * t:min(b * t + t, G)] += 1
            assert (owners == 1).all()
        owners = np.zeros(gdims[0], int)
        for Z in range(nslab):
            owners[w.owned_planes(Z)] += 1
        assert (owners == 1).all()

        # the ring layout: a slab's planes fill its slot, the last plane the
        # extra one, and slabs fewer than R apart never share a ring plane
        table = ring_planes(plan, gdims[0], p)  # the kernel's map
        assert table.tolist() == [w.ring_plane(g0) for g0 in range(gdims[0])]
        slots = {Z: {int(table[g0]) for g0 in w.owned_planes(Z)} for Z in range(nslab)}
        assert all(0 <= r < plan["ring_planes"] for s in slots.values() for r in s)
        for Z in range(nslab):
            assert len(slots[Z]) == len(w.owned_planes(Z))
            for Z2 in range(Z + 1, min(Z + w.R, nslab)):
                assert not slots[Z] & slots[Z2]

        for s, Z in w.order:
            waits = w.waits(s, Z)
            # every wait points at a smaller ticket
            assert all(w.last[g] < w.first[(s, Z)] for g in waits), (s, Z)
            # every slope read was written by a group the item waits for
            assert w.read[(s, Z)] <= waits, (s, Z)
            # before a slot is rewritten, every reader of its last slab is done
            if s < STAGES - 1 and Z >= w.R:
                assert w.readers[(s, Z - w.R)] <= waits, (s, Z)

        # a replay with every item starting as soon as its waits allow (one
        # time unit an item): no slot is rewritten while a reader remains
        start, end = {}, {}
        for g in w.order:
            start[g] = max((end[d] for d in w.waits(*g)), default=0)
            end[g] = start[g] + 1
        for f in range(STAGES - 1):
            for Z in range(w.R, nslab):
                assert max(end[g] for g in w.readers[(f, Z - w.R)]) <= start[(f, Z)]


def test_ring_below_the_bound_is_refused(monkeypatch):
    gdims = (321, 189, 189)
    for lag in (1, 2, 3):
        monkeypatch.setattr(step_wave, "WAVE_LAG", lag)
        monkeypatch.setattr(step_wave, "RING_SPARE", 0)
        assert wave_plan(gdims, 4, 2, torch.float32, nr=4)["ring"] == 3 * lag + 1
        monkeypatch.setattr(step_wave, "RING_SPARE", -1)
        with pytest.raises(ValueError, match="rewritten while a reader remains"):
            wave_plan(gdims, 4, 2, torch.float32, nr=4)
    monkeypatch.setattr(step_wave, "WAVE_LAG", 0)
    monkeypatch.setattr(step_wave, "RING_SPARE", 5)
    with pytest.raises(ValueError, match="lag"):
        wave_plan(gdims, 4, 2, torch.float32, nr=4)


def test_main_path_plans(monkeypatch):
    """The fp32 main paths (focused at HITU, linear at the headline) take
    K2's compile-time 8 x 32 tile; at HITU the three rings take 55 MB where
    the full slopes took 138 MB, and with one-cell slabs they fit the L2; a
    negative block count is refused."""
    hitu, head = (321, 189, 189), (417, 417, 417)
    for gd, nf, nr in ((hitu, 2, 4), (head, 1, 3)):
        plan = wave_plan(gd, 4, nf, torch.float32, nr=nr)
        assert plan["tile"] == (8, 32) and plan["threads"] == 256
        assert plan["slab"] == step_wave.WAVE_SLAB == 4
        assert plan["ring"] == min_ring(plan["lag"]) + step_wave.RING_SPARE
        assert ring_bytes(plan, gd, torch.float32) < 0.45 * 3 * 4 * np.prod(gd)
    monkeypatch.setattr(step_wave, "WAVE_SLAB", 1)
    rings = ring_bytes(wave_plan(hitu, 4, 2, torch.float32, nr=4), hitu, torch.float32)
    assert rings < L2_BYTES
    with pytest.raises(ValueError, match="block count"):
        wave_plan(hitu, 4, 2, torch.float32, nr=4, blocks=-1)
