#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fenicsxfus_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device (it exits nonzero without one) and ``nvcc``. Phases,
each ending in ``torch.cuda.synchronize()``; any failure raises:

0. versions of torch, CUDA and nvcc, and the card's name and power limit;
1. build the CUDA kernels from ``fenicsxfus_tpu_torch/csrc`` (first use);
2. K1 (stiffness, the tiled stencil of ``csrc/tile.cuh``) against its
   plain torch version, fp32, on (9,5,7) at p = 2, 3, 4, on the ragged
   (13,11,17) at p = 1, 5, 8 and on the 104³ p=4 headline lattice, constant
   and DG-0 coefficients, with CUDA-event timings and the share of the
   bound at the headline;
3. K2 (fused RK stage, tiled) against its plain version, a non-final and a
   final stage, at (9,5,7) p=4, on unit cells at (9,5,7) and the ragged
   (13,11,17) p=4, and at the headline;
4. the fp32 plane-wave gate through the model's main path (rel-L2 < 1e-3);
5. the headline run — ``bench.py``'s problem (104³ box, p=4, RK4, fp32,
   72.5M DOF, 101 steps) through ``LinearSpectralExplicit.rk`` and its
   ``energy`` diagnostic — with launch counts, throughput, and 3 steps held
   against the plain path;
6. K2 kinds lossy, westervelt and focused against their plain versions, a
   non-final and a final stage, at (9,5,7) p=4 (constant and DG-0
   coefficients), at the channel grids (41,1,1) and (81,1,1) and at the
   11.47M-node HITU lattice (80,47,47) p=4, with CUDA-event timings there;
   then the lossy and Westervelt models through ``rk`` in the 3D channel
   against their 1D gates (damped plane wave < 1e-2, Fubini < 1e-1), fp32,
   each followed by 3 steps held against the plain path;
7. the slice's main path: ``drivers.hitu.run("W", "H101", "WATER")`` at the
   driver defaults (nx=80, p=4, 0.5 MHz, fp32, 11,466,441 DOF, 3835 RK4
   steps) through ``WesterveltSpectralFocused.rk_record``, with K2
   ``focused`` launched 4 times per step, its focal peak held against the
   JAX package's committed run (``benchmarks/hitu/results/w_h101_water.npz``)
   and 3 further steps held against the unfused (K1) step;
8. the O'Neil check of the focused source, ``drivers.hitu.validate_oneil``
   at its defaults (H101, 0.35 MHz, nx=64, 5.7M DOF);
9. K4a/K4b (the two-kernel stiffness: K4a the axis-0 column march of
   ``csrc/column.cuh``, K4b the in-plane plane tile of ``csrc/plane.cuh``,
   shaped by ``ops/stiffness.py::column_plan``/``axes12_plan``) against
   their plain versions, each kernel alone and the pair against K1's plain
   version, fp32, on (9,5,7) at p = 2, 3, 4 and on the ragged (13,11,17) at
   p = 1..8 (constant and DG-0 coefficients, 1 and 2 fields), on (41,1,1)
   and on the 104³ headline lattice with CUDA-event timings (and the
   device's time alone beside them, K1's too), each plan and each timing's
   share of its bound;
10. K5a/K5b (the two-kernel RK stage: K5a the axis-0 column march of
   ``csrc/column.cuh``, K5b the in-plane plane tile of ``csrc/plane.cuh``,
   shaped by ``ops/stage_ab.py::column_plan``/``plane_plan``) against their
   plain versions for all four kinds, a non-final and a final stage, at
   (9,5,7) (constant and DG-0), (41,1,1), (81,1,1), the HITU lattice (timed
   for every kind) and, for ``linear``, the headline lattice (timed), with
   each plan and each timing's share of its bound;
11. the two-kernel pipeline's main path, with ``FUS_STAGE_V3=0`` and
   ``FUS_V3=0`` set for the phase: HITU W-H101-WATER at the driver defaults
   through K5a/K5b ``focused`` (peak held against the JAX package's run and
   against phase 7's), the headline through K5 ``linear`` with ``energy()``
   through K4a/K4b, and the lossy and Westervelt channel gates through K5,
   each followed by 3 steps held against the plain (or unfused) path; then
   the unfused headline (``FUS_FUSED=0``: one stiffness apply per RK stage)
   for 20 RK4 steps from a random state through K4a/K4b, and again through
   K1 (``FUS_V3=1``), the two final states equal bit for bit;
12. the whole-step wavefront, with ``FUS_STEP_WAVE=1`` set for the phase: K3
   (one launch per RK4 step) against its plain version for all four kinds
   at (9,5,7) (constant and DG-0), (41,1,1), (81,1,1), the HITU lattice
   (timed for every kind) and, for ``linear``, the headline (timed), inv_m
   dense and separable for linear and lossy, and against four K2 launches
   of the same step, bit for bit (every kernel rounds alike), as are four
   K5a -> K5b pairs, and K4a -> K4b on the step's fields equals K1; the
   step at the HITU lattice on 1 block against the default grid, bit for
   bit; the plan (tile, slab, lag, ring of the slopes) and the share of
   the bound at the HITU lattice and the headline; then HITU W-H101-WATER
   (one K3 launch per step, peak held against the JAX package's run and
   phase 7's, device memory peak beside phase 7's), the headline (separable inv_m,
   ``energy()`` through K1) and the lossy and Westervelt channel gates, all
   through K3, each followed by 3 steps held against the plain (or unfused)
   path;
13. the bowl-fitted mesh: K2 with its band operand (the hybrid lattice's
   slab correction, added before the facet terms and the epilogue) against
   its plain version for all four kinds, a non-final and a final stage, at
   (9,5,7) p=4 (constant and DG-0, unit cells), on the ragged (13,11,17)
   at p = 1..8 and at the bowl lattice (321,189,189) with its 65-row band,
   K2 with a zero band equal to K2 bit for bit, ``westervelt`` + band timed
   there; then the slice's main path, ``drivers.hitu.run("W", "H101",
   "WATER", bowl=True)`` at its defaults (11,466,441 DOF, 5146 RK4
   steps, K2 ``westervelt`` + band 4 times a step, K1 + K6 for
   ``estimate_stable_dt``), its focal peak held against the JAX package's
   fused bowl run and 3 more steps against the unfused hybrid step (K1 +
   K6); K6 alone at the bowl lattice against its fp64 CPU run, timed; and
   the bowl mesh's O'Neil check, ``validate_bowl_mesh("H101", nx=64)``;
14. the implicit (SDIRK) path, fp64: K1 in fp64 against its plain version,
   1 and 2 fields, constant and DG-0, on (9,5,7) at p = 2, 3, 4, on the
   ragged (13,11,17) at p = 1..8, timed at the headline (1 field) and the
   HITU lattice (2 fields) by CUDA events and on the device alone, with its
   share of the fp64 bound and its ptxas registers and spills; then the
   slice's main path, ``LinearSpectralImplicit`` on the headline problem
   (72.5M DOF, SDIRK4, 10 steps through ``dirk``, K1 the CG matvec), with
   seconds a step, CG iterations, K1 launches, K1's share of a step's
   device time (``torch.profiler``) and the memory peak, and one step from
   a random state through K1 against the plain stiffness (the same CG
   counts, 1e-9); ``LossySpectralImplicit`` at the HITU lattice (two-field
   K1, 5 steps) and ``LinearSpectralImplicit`` on a small bowl mesh, each
   held against the plain path the same way; and the reference gates'
   problems (1D linear and lossy implicit (4,4), linear explicit (4,4),
   the 2D channel (41,6), the implicit 3D channel (41,1,1) through K1) over
   the first eighth of each horizon on the card, held against the same
   run on the CPU (the analytical gates at the full horizon are the CPU
   tests');
15. the general per-cell path (no kernel: gather, per-cell products and a
   deterministic fold in torch, fp32 with TF32 off): first
   ``tools/unstructured_solve.py`` at nx = 54, p = 4 (10,218,313 DOF,
   157,464 cells), 60 Westervelt RK4 steps after a warm-up on the same
   window, on the lattice (K2), the distorted unstructured box and the same
   after ``reorder_locality``, with the rates, the per-DOF gap and the
   memory peak, and the distorted run's u against fp64 on the card (rel-L2
   ≤ 1e-5); then the operators at that size: ``as_unstructured`` of a box
   of unit cells (``K_ref`` and the dense route) against K1, the distorted
   box's default route against ``stiffness_apply_generic`` and the fp64
   apply (1e-5), the fold twice bit for bit, and gather, both cell routes,
   ``K_ref``, both folds and the whole apply timed beside their floors;
   then HITU W-H101-WATER on the bowl mesh with ``FUS_HYBRID=0`` (every
   step on the general path, no kernel launched) over the first eighth of
   the run's time, its peak held against the hybrid path's over the same
   time (1e-4);
16. the rest of the model family (no new kernel: K1 is the only one on
   these paths), each through its entry point at full width and held
   against its plain path: ``LinearSpectralS2`` on the HITU lattice (fp32,
   the default Heaviside window, 3 steps against ``ops.plain()``, 200 timed
   RK4 steps through K1 a stage) and its checkpoint round trip (100 + 100
   steps through ``io/checkpoint.py`` equal to 200 steps bit for bit);
   ``LinearSpectralSponge`` on the HITU box extended to x = 0.15 m
   ((401,189,189) nodes, fp32, 200 steps, the nodal δ apply and K1 timed a
   stage); ``LinearSpectralNewmark`` on the headline box (fp64, 10 steps,
   K1 the CG matvec, one step against the plain stiffness with the same CG
   counts); ``LinearSpectralAdaptive`` and ``WesterveltSpectralAdaptive``
   on the HITU lattice (fp64, one source period, the first 5 attempts
   against the plain path); ``LinearExplicit`` (Gauss quadrature, fp64) on
   ``create_box((54,)*3)``, 5 RK4 steps, its operators timed beside their
   floors; K1 at each of these shapes against its plain version; and the
   CPU tests' gates of these models on the card (Newmark, the adaptive
   models and ``LinearExplicit`` in 1D over the first eighth of each
   horizon, held against the CPU's run);
17. this slice's production runs, each through its driver at full width,
   held against the JAX package's committed run (focal peak within 2% and
   ±1 sensor, ``drivers.hitu.check_artifact``) and K2 held against its plain
   version on the run's own operands (``k2_on_model``): (a) the native
   geometry library (``native/geometry.cpp``) against the ``FUS_NATIVE=0``
   workers on the H101 bowl mesh at nx = 80 (176,720 cells), timed on the
   host; (b) the reference-scale W-H131-WATER problem at 1.1 MHz
   (``hitu.run(..., nx=164, full=True)``: 85,620,897 DOF, p = 4, 7488 RK4
   steps, K2 ``focused`` 4 a step), 3 more steps fused against unfused, and
   the harmonics table of its 31 stations (``drivers/harmonics.py``; its
   gate reported, not asserted); (c) W-H131-WATER, W-H101-LIVER,
   W-H131-LIVER and V-H131-WATER at ``hitu.run``'s defaults, the H131 orderings
   on the port's peaks, and the H131 O'Neil check at 0.45 MHz; (d) PH1
   (``drivers/ph1.py``) at nx = 80: SC1-BM1 (K2 ``linear``, the piston
   oracle's gates), SC1-BM4 (``lossy`` on a flat DG-0 skull, the 1D
   transmission gate), SC2-BM6 (``focused`` on a curved DG-0 skull) and
   SC2-BM7 (p = 5, 22,334,096 DOF), each sensor read at its nearest node
   as in the committed runs; (e) ``tools/fp32_drift.py``, linear and
   Westervelt, fp32 beside fp64 to 8000 steps, with the gates of
   ``tests/test_fp32_drift.py``: two side jobs, each in its own process,
   that run with [18a] and are reported after it (``SIDE_JOBS``).

18. this slice's scripts on the card: (a) every ported example and
   experiment and MENDOUSSE (``--quick``) through its ``main`` at the
   script's width and dtype over the fraction of its horizon in
   ``SCRIPTS`` (a depth cut where the whole horizon does not fit), its
   fields finite, its ``.npz`` read back, in 3D its stage kernel 4 times a
   step and 3 more steps against ``stage_plain``, in 1D/2D no kernel, and
   the script's own gate where it ran whole (the scattering ring, the
   bowl's O'Neil gain); then the same
   script in fp64 on the card and on the CPU over a shorter horizon, held
   together (1e-10, 1e-7 through a CG; the bowl is held by its gate
   instead); each 2D script also at its CPU test's size over its whole
   horizon, fp64, card against CPU; the two reference-mesh readers are left
   out (no reference meshes there); (b) ``tools/operator_speed.py`` at its defaults
   (p = 2..6 at about 38.3M DOF, constant and DG-0, K1 and then K4a -> K4b
   under ``FUS_V3=0``, the mass divide), each apply held against the plain
   one before it is timed; (c) ``tools/stage_attrib.py`` (K2 ``linear`` at
   417³ with 0, 1, 2 slope operands, each against ``stage_plain``); (d)
   ``tools/solver_speed.py`` for the linear, lossy and Westervelt models at
   417³, 101 steps, then 3 more steps against ``stage_plain``; (e) ``tools/hybrid_speed.py`` (lattice, hybrid, band at
   the H101 bowl mesh, nx = 80).

19. this slice's benchmark scripts on the card, each through its ``main``
   at the script's default width and held against its plain path: (a)
   ``tools/setup_speed.py`` (the headline's host setup, 72.5M DOF, phase by
   phase) twice in this process and once in a fresh one, with each phase's
   spread; (b) ``tools/phase_breakdown.py`` (417³: the RK4 step, the stage,
   K1 alone, the pointwise pass and the unfused step for the linear, lossy
   and Westervelt models), fused against unfused after 3 steps, K2 on each
   model's operands and K1 against their plain versions, and K2 in fp64
   against ``stage_plain`` on the linear model's reached state (1e-12); (c)
   ``tools/wave_attrib.py`` (417³, ``FUS_STEP_WAVE=1``: K3 chained, the
   model's step through its loop and a plain loop, four K2), K3 against its
   plain version on the model's operands and against four K2; (d)
   ``tools/unstructured_speed.py`` (the shuffled, reordered distorted box at
   nx = 28, 1.44M DOF, with the segment-sum oracle and the CSR fold), its
   parts held together before they are timed, K1 of its lattice row against
   its plain version; (e) ``tools/unstructured_trace.py`` (nx = 24, the
   general path, a ``torch.profiler`` window), no kernel; (f)
   ``tools/bowl_blend_sweep.py``: the 4 × 3 grid at nx = 16 and two points at
   nx = 64 (a depth cut: every point builds a bowl mesh on the host), K1 at
   the nx = 64 lattice against its plain version; (g)
   ``tools/bowl_spectrum.py`` (H101 nx = 64, the band's per-cell power
   iteration in fp64), no kernel; (h) ``drivers/ph1_sc1_bm1.py`` (241³,
   14.0M DOF, 3840 RK4 steps of ``LinearSpectralS2`` at cfl 0.5, K1 4 times
   a step), K1 and 3 steps against the plain path; (i)
   ``drivers/bowl_convergence.py`` (H101 bowl mesh at 200 kHz, nx = 20, 28,
   36, fp64; three side jobs that run with [18a]), each O'Neil error within
   1e-6 of the JAX package's fp64 run, then fp64 K2 with its band and fp64
   K1 at nx = 36 against their plain versions. Kernels held against their plain versions inside a phase do
   not count as its launches.

20. the slab decomposition (``fenicsxfus_tpu_torch/parallel/``): (a) at
   world size 1 over NCCL (the card holds one NCCL rank), run where its
   models are built: at the end of [11], ``ShardedExplicitSolver`` on the
   headline box (72,511,713 DOF, fp32) for 20 RK4 steps from [11]'s random
   state against [11]'s ``FUS_FUSED=0`` run through K1 (1e-6, and whether
   bit for bit), K1 4 times a step, its rate and device memory peak; in
   [14b], ``ShardedImplicitSolver`` for 2 SDIRK4 steps in fp64 from the
   implicit headline's reached state against ``model.dirk`` (CG counts
   within 2, u within 1e-9); (b) two gloo ranks on the one card, their halo
   planes through host buffers (the side job ``slab:2``, with [18a]):
   the linear and Westervelt models on 24 × 12 × 12 cells at p = 4 from a
   pulse on the ranks' interface plane, 40 RK4 steps recorded at sensors
   on both sides of and on that plane, the linear model on 13 cells along
   x (uneven), each fp32 and fp64, and the linear implicit model for 2
   steps in fp64, against world size 1 (fp64 1e-11; in fp32 the one-rank
   run within FP32_FROM_FP64 of the fp64 run, the two-rank run within 1.5
   times that distance of it and within that distance of the one-rank run,
   sensor traces within 1e-6; CG counts within 2; K1 4 times a step on
   each rank), and K1 on each rank's own operands of each case (its local
   lattice and packed coefficients) against its plain version, timed; (c)
   ``drivers.ph1.focal_comparison`` on [17d]'s SC1-BM1 profile with the
   JAX suite's gates, and
   ``drivers.ph1.validate(1, 1, 40, 56)`` (a side job), its stamp read back
   from ``--out``.

21. the grid and unstructured decompositions (``parallel/grid.py``,
   ``parallel/unstructured.py``): (a) at world size 1 over NCCL, run where
   their models are built: at the end of [11], after [20a],
   ``ShardedExplicitSolver2D(model, (1, 1))`` on the headline box for 20 RK4
   steps from [11]'s state, bit for bit [20a]'s slab run, K1 4 times a step
   and no other kernel, its rate beside [20a]'s and its memory peak; in [15],
   ``ShardedUnstructuredExplicitSolver(model, 1)`` on the distorted box
   (10.2M DOF, Westervelt, fp32) over [15]'s 60 steps against [15]'s run
   (rel-L2 1e-5; the max rel and whether bit for bit printed), no kernel,
   its rate beside [15]'s and its memory peak; (b) the side jobs ``grid:4``
   (a (2, 2) grid of gloo ranks on the card against world size 1 over NCCL:
   linear and Westervelt on 13 × 11 × 12 cells at p = 4, uneven on both
   partitioned axes, from a line pulse on the column the four blocks share,
   40 RK4 steps recorded on and off that column, fp32 and fp64; the linear
   implicit model, fp64; the sponge, fp64; then ``dryrun_multichip(4,
   "gloo", "cuda")``) and ``unstructured:2`` (two gloo ranks on the
   distorted, scrambled 16 × 12 × 12 box: linear and Westervelt, fp32 and
   fp64, recorded; the implicit model, fp64), held to [20b]'s gates (the
   unstructured fp32 direct gap within 1.5 times the one-rank run's
   distance from fp64, the grid's within 1.0 times, as [20b]'s), and K1 on
   each grid rank's own operands of each case against its plain version
   (fp64 1e-14, fp32 5e-7), timed, with that rank's launches.

22. the compiled tiles of K1 and K2 (``csrc/tiles.cuh``: the degree and the
   tile fixed at compile time, one tile per degree and type from
   ``ops/stiffness.py::degree_tile``): (a) each against its plain version
   and against the general kernel (p and tile at run time) bit for bit, on
   [14a]'s (9,5,7) and ragged (13,11,17) and on a lattice of two whole
   tiles and a cut one; (b) each at its run's shape where a run of the port
   launches it at full size (PH1 SC2-BM7's lattice at p = 5, the HITU
   lattice at p = 6 for fp32 K2 of every kind and its band,
   ``operator_speed``'s at p = 2, 3, 5, 6, the headline and the HITU
   lattice for fp64 K1, ``bowl_convergence``'s nx = 36 for the fp64 band),
   held and timed beside the general kernel on the same operands, its
   plain version and its bound, and every other compiled tile on 161³
   nodes, held and timed beside its plain version and its bound; (c) the models through their entry points
   at each compiled degree and type (``rk``: K2 of every compiled kind and,
   on the bowl-fitted mesh at nx = 20, K2 with its band; the linear and
   lossy models' unfused step: K1 with one and two fields), 2 steps each,
   with each kernel's launches, and each held against its plain path; (d)
   each compiled kernel's ptxas registers and spills (a spill fails).

Each phase prints its wall time. Every kernel wrapper counts its launches;
the counts are set to 0 just before a main path runs and read just after.
The line before the last is one JSON object with the per-kernel numbers
(launches on the main path, error and times against the plain version, and
the byte or operation floor of the timed call); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the bounds of every timed call (H100 peaks; fenicsxfus_tpu_torch/tools/bounds.py)
from fenicsxfus_tpu_torch.tools.bounds import (  # noqa: F401
    FP32_FLOP_PER_S, FP64_FLOP_PER_S, HBM_BYTES_PER_S, STAGE_NODE_FLOPS, floor_ms, general_bounds,
    nbytes, share_text, stage_floor, stencil_flops,
)

ROOT = Path(__file__).resolve().parent
TOL = 1e-5  # fp32, sums of ~30 terms taken in another order than the plain version
HEADLINE_NX = 104
STEPS = 101
# two-kernel pipeline switches (read as the JAX package reads them)
TWO_KERNEL_ENV = {"FUS_STAGE_V3": "0", "FUS_V3": "0"}
# the whole-step wavefront's switch
WAVE_ENV = {"FUS_STEP_WAVE": "1"}


def say(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, runs: int = 10) -> float:
    """Median device time of ``fn()`` over ``runs`` calls, by CUDA events
    (one warm-up call first)."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cuda_device_ms(fn, runs: int = 10) -> float:
    """As ``cuda_median_ms``, but with the stream held busy (about 2 ms of
    ``torch.cuda._sleep``) while the host enqueues the events and ``fn``'s
    launches: the device's time alone, without the wrapper's host time
    before its launch. ``fn`` must not synchronize."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b| / max |b|, max |a - b|)."""
    d = float((a.double() - b.double()).abs().max())
    scale = max(float(b.double().abs().max()), 1e-300)
    return d / scale, d


def split_plan_line(gdims, kind: str) -> str:
    """The fp32 plans of K5a (column march) and K5b (plane tile) of
    ``kind`` on a p = 4 lattice."""
    import torch

    from fenicsxfus_tpu_torch.ops.stage import KIND_FIELDS, KIND_RAW
    from fenicsxfus_tpu_torch.ops.stiffness import column_plan, plane_plan

    nf = KIND_FIELDS[kind]
    return (f"K5a column plan {column_plan(gdims, 4)}, K5b plane plan "
            f"{plane_plan(gdims, 4, nf, torch.float32, nr=KIND_RAW[nf])}")


def k4_plan_line(gdims, p: int) -> str:
    """The fp32 plans of K4a (column march) and K4b (plane tile, one and two
    fields) on a lattice of degree p."""
    import torch

    from fenicsxfus_tpu_torch.ops.stiffness import axes12_plan, column_plan

    return (f"K4a column plan {column_plan(gdims, p)}, K4b plane plan "
            f"{axes12_plan(gdims, p, 1, torch.float32)}, of two fields "
            f"{axes12_plan(gdims, p, 2, torch.float32)}")


def plan_line(gdims, p: int, nf: int, nr=None, dtype=None, kernel=None) -> str:
    """The tile plan (fp32 unless ``dtype`` is given) of the tiled K1
    (nr = nf) or K2 kernels on a lattice, for the launch ``kernel`` (as
    ``ops/stiffness.py::compiled_key``; None: the general plan)."""
    import torch

    from fenicsxfus_tpu_torch.ops.stiffness import tile_plan

    return str(tile_plan(gdims, p, nf, dtype or torch.float32, nr=nr, kernel=kernel))


# ------------------------------------------------------------ launch counts


def counts() -> dict:
    """The launch count of every kernel wrapper: K1, K4a, K4b (ints) and K2,
    K5a, K5b, K3 (per kind)."""
    from fenicsxfus_tpu_torch.ops import stage, stage_ab, step_wave, stiffness

    return {"K1": stiffness.stiffness_apply.launches,
            "K4a": stiffness.stiffness_axis0_apply.launches,
            "K4b": stiffness.stiffness_axes12_apply.launches,
            "K2": dict(stage.stage_apply.launches),
            "K2+band": dict(stage.stage_apply.band_launches),
            "K5a": dict(stage_ab.stage_a_apply.launches),
            "K5b": dict(stage_ab.stage_b_apply.launches),
            "K3": dict(step_wave.step_wave_apply.launches)}


def reset_counts() -> None:
    from fenicsxfus_tpu_torch.ops import stage, stage_ab, step_wave, stiffness

    for fn in (stiffness.stiffness_apply, stiffness.stiffness_axis0_apply,
               stiffness.stiffness_axes12_apply):
        fn.launches = 0
    for fn in (stage.stage_apply, stage_ab.stage_a_apply, stage_ab.stage_b_apply,
               step_wave.step_wave_apply):
        fn.launches.clear()
    stage.stage_apply.band_launches.clear()
    stiffness.stiffness_apply.tiles.clear()
    stage.stage_apply.tiles.clear()


STAGE_KERNELS = ("K2", "K2+band", "K5a", "K5b", "K3")


class Pipeline:
    """The kernels one configuration of the port runs: its stage kernels
    (``per_step`` launches each per RK4 step), its stiffness kernels, and
    the stage class (``models/base.py::fused_step``) that runs them."""

    def __init__(self, name, stage, stiffness, stage_cls, per_step=4):
        self.name, self.stage, self.stiffness = name, stage, stiffness
        self.stage_cls, self.per_step = stage_cls, per_step

    def plain(self):
        """The plain version of this pipeline's stage function."""
        from fenicsxfus_tpu_torch.ops import stage, stage_ab, step_wave

        if "K3" in self.stage:  # (the band pipeline's plain stage is stage_plain too)
            return step_wave.step_wave_plain
        return stage_ab.stage_ab_plain if "K5a" in self.stage else stage.stage_plain

    def check_model(self, model) -> None:
        """Raise unless ``model`` built the fused step on this pipeline."""
        if model.step_kind != "fused" or model.stage_cls.__name__ != self.stage_cls:
            raise AssertionError(f"{self.name}: the model took the {model.step_kind} step on "
                                 f"{model.stage_cls}, expected {self.stage_cls}")

    def check(self, c: dict, kind: str, steps: int, stiffness_launches=None):
        """Raise unless the counts ``c`` show ``per_step`` launches per RK4
        step for ``steps`` steps of each of this pipeline's stage kernels for
        ``kind`` and none of the other pipelines'; with
        ``stiffness_launches``, as many of each of its stiffness kernels, and
        none of the others. On K3, also raise if a launch gave up a wait."""
        from fenicsxfus_tpu_torch.ops.step_wave import step_wave_check

        for k in STAGE_KERNELS:
            want = {kind: self.per_step * steps} if k in self.stage and steps else {}
            if c[k] != want:
                raise AssertionError(f"{self.name}: {k} launched {c[k]}, expected {want}: {c}")
        if stiffness_launches is not None:
            for k in ("K1", "K4a", "K4b"):
                want = stiffness_launches if k in self.stiffness else 0
                if c[k] != want:
                    raise AssertionError(f"{self.name}: {k} launched {c[k]}, expected {want}")
        if "K3" in self.stage:
            step_wave_check()


ONE_KERNEL = Pipeline("one-kernel (K2, K1)", ("K2",), ("K1",), "FusedRKStage")
# selected by TWO_KERNEL_ENV
TWO_KERNEL = Pipeline("two-kernel (K5a/K5b, K4a/K4b)", ("K5a", "K5b"), ("K4a", "K4b"),
                      "FusedRKStageAB")
# selected by WAVE_ENV: one K3 launch per RK4 step
WAVE = Pipeline("wavefront (K3, K1)", ("K3",), ("K1",), "FusedRKStepWave", per_step=1)
# a hybrid (bowl-fitted) lattice: K2 with its band operand (the slab
# correction K6 formed before each stage), K1 + K6 for the stiffness
BAND = Pipeline("one-kernel with the band (K2 + band, K1 + K6)", ("K2+band",), ("K1",),
                "FusedRKStage")


@contextlib.contextmanager
def environment(env: dict):
    """Set ``env`` in ``os.environ`` for the block, and restore it after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ------------------------------------------------------------------ phases


def phase_versions() -> str:
    import torch

    from fenicsxfus_tpu_torch import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    card = gpu_line()
    say(f"[0] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    say(f"[0] gpu: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("[0] allow_tf32: matmul False, cudnn False")
    return card


def phase_build() -> dict:
    """Build the kernels; return each kernel's ptxas lines (registers,
    stack and spills) by its mangled name."""
    from fenicsxfus_tpu_torch import _build

    path, seconds, log = _build.build()
    _build.library()
    say(f"[1] built {path.name} in {seconds:.1f} s")
    entry, ptxas = "", {}
    for line in log.splitlines():  # ptxas -v: each kernel's registers, stack and spills
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            text = line.replace('ptxas info    :', '').strip()
            ptxas.setdefault(entry, []).append(text)
            say(f"[1]   {entry}: {text}")
    return ptxas


def _lattice(grid, p, dtype):
    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness

    return LatticeStiffness(grid, p, [0.12 / g for g in grid], dtype)


def phase_k1(device, card, grids, headline) -> dict:
    """K1 against its plain version; timings at ``headline`` (grid, p)."""
    import torch

    from fenicsxfus_tpu_torch.ops.stiffness import (
        pack_const, pack_field, stiffness_apply, stiffness_plain,
    )

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for grid, p in grids:
        lat = _lattice(grid, p, torch.float32)
        coeffs = {
            "const": pack_const(lat, 1.0 / 1000.0, device),
            "dg0": pack_field(lat, rng.uniform(0.5, 2.0, int(np.prod(grid))) / 1000.0, device),
        }
        xs = [torch.randn(lat.gdims, generator=gen, device=device) for _ in range(2)]
        cases = [(name, [xs[0]], [F]) for name, F in coeffs.items()]
        if (grid, p) != headline:
            cases.append(("2 fields", xs, [coeffs["const"], coeffs["dg0"]]))
        for name, x_in, F_in in cases:
            y = stiffness_apply(x_in, F_in, p)
            y_ref = stiffness_plain(x_in, F_in, p)
            torch.cuda.synchronize()
            rel, err = rel_err(y, y_ref)
            say(f"[2] K1 grid={grid} p={p} {name}: max|dy|/max|y| = {rel:.3e}")
            if not rel <= TOL:
                raise AssertionError(f"K1 disagrees with its plain version: {rel:.3e} > {TOL}")
            if (grid, p) == headline and name == "const":
                out = {"max_abs_err": err, "rel_err": rel}
        if (grid, p) == headline:
            say(f"[2] K1 headline tile plan {plan_line(lat.gdims, p, 1)}")
            for name, F in coeffs.items():
                ms = cuda_median_ms(lambda: stiffness_apply([xs[0]], [F], p))
                pms = cuda_median_ms(lambda: stiffness_plain([xs[0]], [F], p))
                bound = floor_ms(nbytes(xs[0], F), nbytes(xs[0]),
                                 stencil_flops(lat.gdims, p, 1, (0, 1, 2)))
                say(f"[2] K1 headline {name}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
                    f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}), bound/ms "
                    f"{bound['bound_ms'] / ms:.3f} (median of 10, CUDA events; {card})")
                if name == "const":
                    out.update(ms=ms, plain_ms=pms, **bound)
        del xs
        torch.cuda.synchronize()
    return out


def _stage_inputs(kind, lat, device, gen, rng, final, scale, dg0=False):
    """Random stage operands of ``kind`` on lattice ``lat``: state, slopes,
    dense extras (inverse mass, or m0 and a small d2), packed facets, and
    stiffness coefficients of size ``scale`` (constant or DG-0)."""
    import torch

    from fenicsxfus_tpu_torch.ops.stage import KIND_DENSE, KIND_FACET, KIND_FIELDS, pack_facet_vector
    from fenicsxfus_tpu_torch.ops.stiffness import pack_const, pack_field

    gd = lat.gdims

    def field():
        return torch.randn(gd, generator=gen, device=device)

    def facets():
        f = np.zeros(gd, np.float32)
        for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
            f[sl] = rng.uniform(0.5, 1.5, f[sl].shape)
        return {k: torch.as_tensor(v, device=device) for k, v in pack_facet_vector(f, gd).items()}

    def coeff(c):
        if dg0:
            return pack_field(lat, rng.uniform(0.5, 2.0, int(np.prod(lat.grid))) * c, device)
        return pack_const(lat, c, device)

    nfa = len(KIND_FACET[kind])
    return dict(
        kind=kind, u0=field(), v0=field(), kvp=field(), kvpp=field(),
        prev=field() if final else None,
        Fs=[coeff(scale * (1.0 - 0.5 * f)) for f in range(KIND_FIELDS[kind])],
        dense=[torch.rand(gd, generator=gen, device=device) * (0.05 if n == "d2" else 1.0)
               + (0.0 if n == "d2" else 0.5) for n in KIND_DENSE[kind]],
        facets=[facets() for _ in range(nfa)],
        scal=[0.3, 0.05] + [1.7, -0.6, 0.9, 0.4][: nfa - 1]
        + ([1.0, 0.02, 0.03, 0.01, 0.15, 0.3, 0.3, 0.15] if final else []),
        p=lat.p, final=final,
    )


def phase_k2(device, card, grids, headline) -> dict:
    """K2 against its plain version, non-final and final stage."""
    import torch

    from fenicsxfus_tpu_torch.ops.stage import stage_apply, stage_plain

    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness

    rng = np.random.default_rng(1)
    gen = torch.Generator(device=device).manual_seed(1)
    out = {}
    # unit cells and an O(1) coefficient: the stiffness term as large as
    # the facet and mass terms, so a stencil fault cannot hide behind them
    unit = [((9, 5, 7), 4, True), ((13, 11, 17), 4, True)]
    for grid, p, unit_cells in [(g, q, False) for g, q in grids] + unit:
        if unit_cells:
            lat, scale = LatticeStiffness(grid, p, (1.0, 1.0, 1.0), torch.float32), 1.0
        else:
            lat, scale = _lattice(grid, p, torch.float32), 1.0 / 1000.0
        for final in (False, True):
            args = _stage_inputs("linear", lat, device, gen, rng, final, scale=scale)
            got = stage_apply(**args)
            ref = stage_plain(**args)
            torch.cuda.synchronize()
            pairs = list(zip(got, ref)) if final else [(got, ref)]
            worst = max(rel_err(a, b) for a, b in pairs)
            kind = "final" if final else "non-final"
            cells = ", unit cells" if unit_cells else ""
            say(f"[3] K2 grid={grid} p={p}{cells} {kind}: max|d|/max|ref| = {worst[0]:.3e}")
            if not worst[0] <= TOL:
                raise AssertionError(f"K2 disagrees with its plain version: {worst[0]:.3e} > {TOL}")
            if (grid, p) == headline and not unit_cells:
                ms = cuda_median_ms(lambda: stage_apply(**args))
                pms = cuda_median_ms(lambda: stage_plain(**args))
                bound = stage_floor(args, "K2")
                say(f"[3] K2 headline {kind}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                    f"{share_text(bound, ms)} (median of 10, CUDA events; {card}); tile plan "
                    f"{plan_line(lat.gdims, p, 1, 3)}")
                if not final:
                    out = {"max_abs_err": worst[1], "rel_err": worst[0], "ms": ms, "plain_ms": pms,
                           **bound}
            del args, got, ref
            torch.cuda.synchronize()
    return out


def phase_planewave(device) -> None:
    """fp32 plane wave in the 3D channel through the main path (fused K2)."""
    import torch

    import fenicsxfus_tpu_torch as ft
    from fenicsxfus_tpu_torch.analysis.analytical import planewave
    from fenicsxfus_tpu_torch.analysis.error import relative_l2_error
    from fenicsxfus_tpu_torch.models.common import step_sizes
    from fenicsxfus_tpu_torch.ops.stage import stage_apply

    f0, c0, rho0, p = 10.0, 1.0, 4.0, 4
    p0 = rho0 * c0
    mesh = ft.create_box((41, 1, 1), (0, 0, 0), (1.0, 0.1, 0.1))
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
    dt = 0.9 * (1 / 41) / (c0 * p**2)
    tend = 1.0 / c0 + 16.0 / f0
    model = ft.LinearSpectralExplicit(mesh, None, p, c0, rho0, f0, p0, c0, 4, dt,
                                      dtype=torch.float32, device=device)
    model.init()
    stage_apply.launches.clear()
    t0 = time.perf_counter()
    u, _, tf = model.rk(0.0, tend)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    nsteps = len(step_sizes(0.0, tend, dt))
    err = relative_l2_error(model.ops, u, lambda x: planewave(x[0], tf, c0, f0, p0))
    say(f"[4] planewave fp32: {model.step_kind} step, {nsteps} steps in {seconds:.2f} s, "
        f"rel-L2 = {err:.3e} (gate 1e-3)")
    if model.step_kind != "fused" or dict(stage_apply.launches) != {"linear": 4 * nsteps}:
        raise AssertionError("the plane-wave run did not go through K2 once per stage")
    if not err < 1e-3:
        raise AssertionError(f"planewave rel-L2 {err:.3e} >= 1e-3")


def phase_headline(device, card, nx, pipe: Pipeline = ONE_KERNEL, tag: str = "[5]") -> dict:
    """bench.py's problem through the port's entry points, on ``pipe``'s
    kernels (the caller sets its switches)."""
    import torch

    import fenicsxfus_tpu_torch as ft
    from fenicsxfus_tpu_torch.models.common import run_steps, step_sizes

    degree, c0, rho0, f0, p0, L = 4, 1500.0, 1000.0, 0.5e6, 60000.0, 0.12
    t0 = time.perf_counter()
    mesh = ft.create_box((nx, nx, nx), (0, 0, 0), (L, L, L))
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > L - 1e-9})
    dt = 0.9 * (L / nx) / (c0 * degree**2)
    model = ft.LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt,
                                      dtype=torch.float32, device=device)
    model.init()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    ndofs = model.number_of_dofs()
    nsteps = len(step_sizes(0.0, STEPS * dt, dt))
    say(f"{tag} headline nx={nx} on the {pipe.name} pipeline: {ndofs} DOF, {model.step_kind} "
        f"step, setup {setup:.1f} s")

    # --- the main path: counts from 0 just before, read just after
    reset_counts()
    t0 = time.perf_counter()
    u, v, t = model.rk(0.0, STEPS * dt)
    torch.cuda.synchronize()
    solve = time.perf_counter() - t0
    energy = model.energy()
    torch.cuda.synchronize()
    launches = counts()

    checksum = float(u.double().abs().sum())
    rate = ndofs * nsteps / solve / 1e9
    say(f"{tag} {nsteps} RK4 steps: solve {solve:.3f} s, {rate:.4f} GDOF-RK4-updates/s, "
        f"setup {setup:.1f} s ({card})")
    say(f"{tag} checksum sum|u| = {checksum:.6e}, energy = {energy:.6e}, launches {launches}")
    pipe.check_model(model)
    # the stage kernels per_step times per RK4 step, and energy() through
    # the stiffness kernels once
    pipe.check(launches, "linear", nsteps, stiffness_launches=1)
    if not (np.isfinite(checksum) and checksum > 0 and np.isfinite(energy) and energy > 0):
        raise AssertionError("headline state is not finite and nonzero")

    # --- 3 more steps from the reached state: kernels vs the plain path
    gd = model.ops.gdims
    dts = [dt] * 3
    uk, vk, _ = run_steps(model.fused_step(), model.consts, u.view(gd), v.view(gd), t, dts)
    up, vp, _ = run_steps(model.fused_step(stage_fn=pipe.plain()), model.consts,
                          u.view(gd), v.view(gd), t, dts)
    torch.cuda.synchronize()
    worst = max(rel_err(uk, up)[0], rel_err(vk, vp)[0])
    say(f"{tag} 3 steps, kernel path vs plain path: max rel diff {worst:.3e} (gate 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError(f"headline kernel path disagrees with the plain path: {worst:.3e}")
    return {"launches": launches, "rate": rate, "solve_s": solve, "setup_s": setup,
            "separable": "inv_m__sep0" in model.consts}


NEW_KINDS = ("lossy", "westervelt", "focused")
HITU_GRID = (80, 47, 47)  # drivers.hitu.build_model("W", "H101", "WATER", nx=80)


def phase_kinds(device, card) -> dict:
    """K2 kinds lossy, westervelt, focused against their plain versions. The
    lattice has unit cells, so the stiffness term is of the size of the
    facet and mass terms and a stencil fault cannot hide behind them."""
    import torch

    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
    from fenicsxfus_tpu_torch.ops.stage import stage_apply, stage_plain

    rng = np.random.default_rng(6)
    gen = torch.Generator(device=device).manual_seed(6)
    out = {}
    # (9,5,7) with both coefficient forms, the two channel grids of
    # phase_channel (one cell across y and z: every node on two facet
    # planes), and the HITU lattice with timings
    cases = [((9, 5, 7), False), ((9, 5, 7), True), ((41, 1, 1), False), ((81, 1, 1), True),
             (HITU_GRID, False)]
    for kind in NEW_KINDS:
        for grid, dg0 in cases:
            lat = LatticeStiffness(grid, 4, (1.0, 1.0, 1.0), torch.float32)
            for final in (False, True):
                args = _stage_inputs(kind, lat, device, gen, rng, final, scale=1.0, dg0=dg0)
                got = stage_apply(**args)
                ref = stage_plain(**args)
                torch.cuda.synchronize()
                pairs = list(zip(got, ref)) if final else [(got, ref)]
                worst = max(rel_err(a, b) for a, b in pairs)
                stage = "final" if final else "non-final"
                coeff = "DG-0" if dg0 else "const"
                say(f"[6] K2 {kind} grid={grid} p=4 {coeff} {stage}: "
                    f"max|d|/max|ref| = {worst[0]:.3e}")
                if not worst[0] <= TOL:
                    raise AssertionError(
                        f"K2 {kind} disagrees with its plain version: {worst[0]:.3e} > {TOL}")
                if grid == HITU_GRID:
                    ms = cuda_median_ms(lambda: stage_apply(**args))
                    pms = cuda_median_ms(lambda: stage_plain(**args))
                    bound = stage_floor(args, "K2")
                    say(f"[6] K2 {kind} HITU lattice {stage}: kernel {ms:.3f} ms, plain "
                        f"{pms:.3f} ms, {share_text(bound, ms)} (median of 10, CUDA events; "
                        f"{card}); tile plan {plan_line(lat.gdims, 4, 2, 4)}")
                    if not final:
                        out[kind] = {"max_abs_err": worst[1], "rel_err": worst[0],
                                     "ms": ms, "plain_ms": pms, **bound}
                del args, got, ref
                torch.cuda.synchronize()
    return out


def phase_channel(device, pipe: Pipeline = ONE_KERNEL, tag: str = "[6]") -> dict:
    """The lossy and Westervelt models through ``rk`` in the 3D channel
    (source at x=0, ABC at x=L: the 1D problem) against the reference's 1D
    gates, fp32, on ``pipe``'s stage kernels, then 3 steps from the reached
    state held against the plain path; returns the stage launches of each
    run."""
    import torch

    import fenicsxfus_tpu_torch as ft
    from fenicsxfus_tpu_torch.analysis.analytical import damped_planewave, fubini
    from fenicsxfus_tpu_torch.analysis.error import relative_l2_error
    from fenicsxfus_tpu_torch.models.common import run_steps, step_sizes

    f0, c0, u0, L = 10.0, 1.0, 1.0, 1.0
    launches = {}
    for kind, degree, epw, gate in (("lossy", 4, 4, 1e-2), ("westervelt", 4, 8, 1e-1)):
        nx = int(epw * L * f0 / c0 + 1)
        mesh = ft.create_box((nx, 1, 1), (0, 0, 0), (L, 0.1, 0.1))
        ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
        h = L / nx
        if kind == "lossy":
            rho0, alphadB = 4.0, 5.0
            p0 = rho0 * c0 * u0
            alpha_np = alphadB / 20 * np.log(10)
            delta0 = ft.compute_diffusivity_of_sound(2 * np.pi * f0, c0, alphadB)
            dt = 0.5 * h / (c0 * degree**2)
            tend = L / c0 + 16.0 / f0
            model = ft.LossySpectralExplicit(mesh, None, degree, c0, rho0, delta0, f0, p0, c0,
                                             4, dt, dtype=torch.float32, device=device)
            exact = lambda x, t: damped_planewave(x[0], t, c0, f0, p0, alpha_np)  # noqa: E731
        else:
            rho0, beta0 = 1.0, 0.01
            p0 = rho0 * c0 * u0
            dt = 0.9 * h / (c0 * degree**2)
            tend = L / c0 + 8.0 / f0
            model = ft.WesterveltSpectralExplicit(mesh, None, degree, c0, rho0, 0.0, beta0, f0,
                                                  p0, c0, 4, dt, dtype=torch.float32,
                                                  device=device)
            exact = lambda x, t: fubini(x[0], t, c0, f0, p0, rho0, beta0)  # noqa: E731
        reset_counts()
        t0 = time.perf_counter()
        u, v, tf = model.rk(0.0, tend)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        c = counts()
        launches[kind] = {k: c[k].get(kind, 0) for k in pipe.stage}
        nsteps = len(step_sizes(0.0, tend, dt))
        err = relative_l2_error(model.ops, u, lambda x: exact(x, tf))
        say(f"{tag} {kind} channel fp32: {model.step_kind} step, {nsteps} steps in {seconds:.2f} s, "
            f"rel-L2 = {err:.3e} (gate {gate:g}), launches {launches[kind]}")
        pipe.check_model(model)
        pipe.check(c, kind, nsteps)
        if not err < gate:
            raise AssertionError(f"{kind} channel rel-L2 {err:.3e} >= {gate:g}")
        # 3 more steps at this shape: the kernel path against the plain path
        gd, dts = model.ops.gdims, [dt] * 3
        uk, vk, _ = run_steps(model.fused_step(), model.consts, u.view(gd), v.view(gd), tf, dts)
        up, vp, _ = run_steps(model.fused_step(stage_fn=pipe.plain()), model.consts,
                              u.view(gd), v.view(gd), tf, dts)
        torch.cuda.synchronize()
        worst = max(rel_err(uk, up)[0], rel_err(vk, vp)[0])
        say(f"{tag} {kind} channel, 3 steps, kernel path vs plain path: max rel diff "
            f"{worst:.3e} (gate 1e-4)")
        if not worst <= 1e-4:
            raise AssertionError(f"{kind} channel kernel path disagrees with the plain path: "
                                 f"{worst:.3e}")
    return launches


def phase_hitu(device, card, pipe: Pipeline = ONE_KERNEL, tag: str = "[7]",
               k2_peak: float | None = None) -> dict:
    """HITU W-H101-WATER at the driver defaults on ``pipe``'s kernels; with
    ``k2_peak`` (phase 7's focal peak), its peak is also held against it."""
    import torch

    from fenicsxfus_tpu_torch.drivers import hitu

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    # --- the main path: counts from 0 just before, read just after
    reset_counts()
    res = hitu.run("W", "H101", "WATER", device=device)
    torch.cuda.synchronize()
    launches = counts()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    model = res.model
    ndofs = model.number_of_dofs()
    rate = ndofs * res.nsteps / res.solve_s / 1e9
    say(f"{tag} HITU W-H101-WATER on the {pipe.name} pipeline: {ndofs} DOF, {res.nsteps} RK4 "
        f"steps, {model.step_kind} step, launches {launches}")
    say(f"{tag} setup {res.setup_s:.2f} s, solve {res.solve_s:.3f} s, {rate:.4f} "
        f"GDOF-RK4-updates/s, device memory peak {peak_gib:.3f} GiB ({card})")
    pipe.check_model(model)
    pipe.check(launches, "focused", res.nsteps, stiffness_launches=0)
    amp = res.amplitude
    if amp.shape != (161,) or not np.all(np.isfinite(amp)):
        raise AssertionError("HITU axial amplitude is not 161 finite values")

    held(tag, res, HITU_RESULTS / "w_h101_water.npz")  # the JAX package's run
    i_pk = int(np.argmax(amp))
    if k2_peak is not None:
        rel_k2 = (amp[i_pk] - k2_peak) / k2_peak
        say(f"{tag} focal peak against phase [7]'s one-kernel run {k2_peak:.6e} Pa: relative "
            f"difference {rel_k2:.3e} (gate 1e-3)")
        if not abs(rel_k2) < 1e-3:
            raise AssertionError(f"HITU focal peak differs from the one-kernel run: {rel_k2:.3e}")

    # --- 3 more steps from the reached state: the fused step vs the unfused
    # step (its stiffness kernels once per stage)
    fused_against_unfused(model, tag, "focused", pipe)
    return {"launches": launches, "rate": rate, "solve_s": res.solve_s, "setup_s": res.setup_s,
            "peak_gib": peak_gib, "peak_pa": float(amp[i_pk])}


def phase_oneil(device) -> None:
    """The O'Neil check of the focused source at ``validate_oneil``'s
    defaults, gated as the JAX package's committed run."""
    import json

    import torch

    from fenicsxfus_tpu_torch.drivers import hitu

    t0 = time.perf_counter()
    gain, pos, prof = hitu.validate_oneil("H101", device=device)
    torch.cuda.synchronize()
    ref = json.loads(str(np.load(ROOT / "benchmarks" / "hitu" / "results"
                                 / "oneil_h101_0.35mhz.npz")["meta"]))
    say(f"[8] O'Neil H101 0.35 MHz nx=64 ({time.perf_counter() - t0:.1f} s): gain error "
        f"{gain*100:.3f}%, position error {pos*1e3:.3f} mm, focal L2 {prof*100:.3f}%; "
        f"JAX package's run: {ref['gain_err']*100:.3f}%, {ref['pos_err_mm']:.3f} mm, "
        f"{ref['profile_err']*100:.3f}% (gates 8%, 2.25 mm, 10%)")
    if not (gain < 0.08 and pos <= 2.25e-3 + 1e-12 and prof < 0.10):
        raise AssertionError("O'Neil gate failed")


def phase_k4(device, card) -> dict:
    """K4a and K4b against their plain versions, each alone and the pair
    against K1's plain version; timings at the headline."""
    import torch

    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
    from fenicsxfus_tpu_torch.ops.stiffness import (
        pack_const, pack_field, stiffness_apply, stiffness_axes12_apply, stiffness_axes12_plain,
        stiffness_axis0_apply, stiffness_axis0_plain, stiffness_plain,
    )

    t_phase = time.perf_counter()
    rng = np.random.default_rng(9)
    gen = torch.Generator(device=device).manual_seed(9)
    headline = ((HEADLINE_NX,) * 3, 4)
    # unit cells and coefficients at the small grids (no mass term to hide
    # behind, but the stiffness alone is all there is here): every degree on
    # the ragged lattice, which no tile divides; the headline lattice and
    # coefficient of phase [2]
    grids = ([((9, 5, 7), p) for p in (2, 3, 4)] + [((13, 11, 17), p) for p in range(1, 9)]
             + [((41, 1, 1), 4), headline])
    out = {}
    for grid, p in grids:
        if (grid, p) == headline:
            lat, c = _lattice(grid, p, torch.float32), 1.0 / 1000.0
        else:
            lat, c = LatticeStiffness(grid, p, (1.0, 1.0, 1.0), torch.float32), 1.0
        say(f"[9] K4 grid={grid} p={p}: {k4_plan_line(lat.gdims, p)}")
        coeffs = {"const": pack_const(lat, c, device),
                  "dg0": pack_field(lat, rng.uniform(0.5, 2.0, int(np.prod(grid))) * c, device)}
        xs = [torch.randn(lat.gdims, generator=gen, device=device) for _ in range(2)]
        cases = [(name, [xs[0]], [F]) for name, F in coeffs.items()]
        if (grid, p) != headline:
            cases.append(("2 fields", xs, [coeffs["const"], coeffs["dg0"]]))
        for name, x_in, F_in in cases:
            yA = stiffness_axis0_apply(x_in, F_in, p)
            yA_ref = stiffness_axis0_plain(x_in, F_in, p)
            y = stiffness_axes12_apply(x_in, F_in, yA.clone(), p)
            y_ref = stiffness_axes12_plain(x_in, F_in, yA.clone(), p)
            whole = stiffness_plain(x_in, F_in, p)
            torch.cuda.synchronize()
            errs = {"K4a": rel_err(yA, yA_ref), "K4b": rel_err(y, y_ref),
                    "K4a+K4b vs K1 plain": rel_err(y, whole)}
            say(f"[9] K4 grid={grid} p={p} {name}: " + ", ".join(
                f"{k} {v[0]:.3e}" for k, v in errs.items()))
            bad = {k: v[0] for k, v in errs.items() if not v[0] <= TOL}
            if bad:
                raise AssertionError(f"K4 disagrees with its plain version: {bad} > {TOL}")
            if (grid, p) == headline and name == "const":
                out = {"K4a": {"max_abs_err": errs["K4a"][1]}, "K4b": {"max_abs_err": errs["K4b"][1]}}
        if (grid, p) == headline:
            for name, F in coeffs.items():
                x = [xs[0]]
                yA = stiffness_axis0_apply(x, [F], p)
                kernels = {"K4a": lambda: stiffness_axis0_apply(x, [F], p),
                           # in place on one scratch yA, as the two-kernel path runs it
                           "K4b": lambda: stiffness_axes12_apply(x, [F], yA, p),
                           "K1": lambda: stiffness_apply(x, [F], p)}
                times = {
                    "K4a": (cuda_median_ms(kernels["K4a"]),
                            cuda_median_ms(lambda: stiffness_axis0_plain(x, [F], p))),
                    "K4b": (cuda_median_ms(kernels["K4b"]),
                            cuda_median_ms(lambda: stiffness_axes12_plain(x, [F], yA, p))),
                }
                device = {k: cuda_device_ms(fn) for k, fn in kernels.items()}
                xb, gd = nbytes(xs[0]), lat.gdims
                bounds = {"K4a": floor_ms(xb + nbytes(F["F0"]), xb, stencil_flops(gd, p, 1, (0,))),
                          "K4b": floor_ms(2 * xb + nbytes(F["F1"], F["F2"]), xb,
                                          stencil_flops(gd, p, 1, (1, 2)))}
                for k, (ms, pms) in times.items():
                    say(f"[9] {k} headline {name}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                        f"{share_text(bounds[k], ms)} (median of 10, CUDA events; {card}); "
                        f"the device alone {device[k]:.3f} ms, bound/ms "
                        f"{bounds[k]['bound_ms'] / device[k]:.3f}")
                say(f"[9] headline {name}, the device alone: K4a + K4b "
                    f"{device['K4a'] + device['K4b']:.3f} ms against K1 {device['K1']:.3f} ms")
                if name == "const":
                    for k, (ms, pms) in times.items():
                        out[k].update(ms=ms, plain_ms=pms, **bounds[k])
                del yA
        del xs
        torch.cuda.synchronize()
    say(f"[9] done in {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_k5(device, card) -> dict:
    """K5a and K5b against their plain versions for all four kinds (K5b on
    K5a's output, and the pair against K2's plain version), a non-final and
    a final stage; timings at the HITU lattice (every kind) and at the
    headline (``linear``)."""
    import torch

    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
    from fenicsxfus_tpu_torch.ops.stage import KIND_FIELDS, stage_plain
    from fenicsxfus_tpu_torch.ops.stage_ab import (
        stage_a_apply, stage_a_plain, stage_b_apply, stage_b_plain,
    )

    t_phase = time.perf_counter()
    rng = np.random.default_rng(10)
    gen = torch.Generator(device=device).manual_seed(10)
    headline = (HEADLINE_NX,) * 3
    # (9,5,7) with both coefficient forms, the channel grids (one cell across
    # y and z), the HITU lattice, and for linear the headline lattice; unit
    # cells except at the headline (phase [3]'s lattice and coefficient)
    cases = [((9, 5, 7), False), ((9, 5, 7), True), ((41, 1, 1), False), ((81, 1, 1), True),
             (HITU_GRID, False)]
    out = {}
    for kind in sorted(KIND_FIELDS):
        for grid, dg0 in cases + ([(headline, False)] if kind == "linear" else []):
            if grid == headline:
                lat, scale = _lattice(grid, 4, torch.float32), 1.0 / 1000.0
            else:
                lat, scale = LatticeStiffness(grid, 4, (1.0, 1.0, 1.0), torch.float32), 1.0
            for final in (False, True):
                args = _stage_inputs(kind, lat, device, gen, rng, final, scale=scale, dg0=dg0)
                a_args = {k: args[k] for k in ("kind", "u0", "v0", "kvp", "kvpp", "Fs", "scal", "p")}
                yA = stage_a_apply(**a_args)
                yA_ref = stage_a_plain(**a_args)
                got = stage_b_apply(yA=yA, **args)
                ref = stage_b_plain(yA=yA, **args)
                whole = stage_plain(**args)
                torch.cuda.synchronize()
                pairs = list(zip(got, ref, whole)) if final else [(got, ref, whole)]
                errs = {"K5a": rel_err(yA, yA_ref),
                        "K5b": max(rel_err(a, b) for a, b, _ in pairs),
                        "K5a+K5b vs K2 plain": max(rel_err(a, c) for a, _, c in pairs)}
                stage = "final" if final else "non-final"
                coeff = "DG-0" if dg0 else "const"
                say(f"[10] K5 {kind} grid={grid} p=4 {coeff} {stage}: " + ", ".join(
                    f"{k} {v[0]:.3e}" for k, v in errs.items()))
                bad = {k: v[0] for k, v in errs.items() if not v[0] <= TOL}
                if bad:
                    raise AssertionError(f"K5 {kind} disagrees with its plain version: {bad}")
                timed = grid == HITU_GRID or grid == headline
                if timed:
                    times = {
                        "K5a": (cuda_median_ms(lambda: stage_a_apply(**a_args)),
                                cuda_median_ms(lambda: stage_a_plain(**a_args))),
                        "K5b": (cuda_median_ms(lambda: stage_b_apply(yA=yA, **args)),
                                cuda_median_ms(lambda: stage_b_plain(yA=yA, **args))),
                    }
                    where = "headline" if grid == headline else "HITU lattice"
                    for k, (ms, pms) in times.items():
                        say(f"[10] {k} {kind} {where} {stage}: kernel {ms:.3f} ms, plain "
                            f"{pms:.3f} ms, {share_text(stage_floor(args, k), ms)} (median of "
                            f"10, CUDA events; {card})")
                    if not final:
                        say(f"[10] {kind} {where}: {split_plan_line(lat.gdims, kind)}")
                    # the entry of the kernels line: the shape of the kind's
                    # main path (the headline for linear), a non-final stage
                    if not final and (grid == headline or kind != "linear"):
                        out[kind] = {k: {"max_abs_err": errs[k][1], "ms": ms, "plain_ms": pms,
                                         **stage_floor(args, k)}
                                     for k, (ms, pms) in times.items()}
                del args, a_args, yA, yA_ref, got, ref, whole
                torch.cuda.synchronize()
    say(f"[10] done in {time.perf_counter() - t_phase:.1f} s")
    return out


UNFUSED_STEPS = 20


def phase_unfused_headline(device, card, nx) -> dict:
    """The headline's unfused step (``FUS_FUSED=0``: the reference RK step
    over ``rhs_pure``, one stiffness apply per RK stage) for UNFUSED_STEPS
    RK4 steps from a random state through ``LinearSpectralExplicit.rk``:
    first through K4a -> K4b (``FUS_V3=0``), then from the same state
    through K1 (``FUS_V3=1``). Launch counts, rates, and the two final
    states bit for bit (K4a -> K4b rounds as K1)."""
    import torch

    import fenicsxfus_tpu_torch as ft
    from fenicsxfus_tpu_torch.models.common import step_sizes

    degree, c0, rho0, f0, p0, L = 4, 1500.0, 1000.0, 0.5e6, 60000.0, 0.12
    with environment({"FUS_FUSED": "0"}):
        mesh = ft.create_box((nx, nx, nx), (0, 0, 0), (L, L, L))
        ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > L - 1e-9})
        dt = 0.9 * (L / nx) / (c0 * degree**2)
        model = ft.LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt,
                                          dtype=torch.float32, device=device)
        ndofs = model.number_of_dofs()
        nsteps = len(step_sizes(0.0, UNFUSED_STEPS * dt, dt))
        gen = torch.Generator(device=device).manual_seed(11)
        u0, v0 = (torch.randn(ndofs, generator=gen, device=device) for _ in range(2))
        runs = {}
        for v3, want in (("0", ("K4a", "K4b")), ("1", ("K1",))):
            with environment({"FUS_V3": v3}):
                model.u_n, model.v_n = u0.clone(), v0.clone()
                torch.cuda.synchronize()
                # --- the main path: counts from 0 just before, read just after
                reset_counts()
                t0 = time.perf_counter()
                u, _, _ = model.rk(0.0, UNFUSED_STEPS * dt)
                torch.cuda.synchronize()
                solve = time.perf_counter() - t0
                launches = counts()
            rate = ndofs * nsteps / solve / 1e9
            say(f"[11] unfused headline FUS_V3={v3}: {model.step_kind} step, {nsteps} RK4 steps "
                f"in {solve:.3f} s, {rate:.4f} GDOF-RK4-updates/s ({card}), launches {launches}")
            if model.step_kind != "unfused":
                raise AssertionError(f"FUS_FUSED=0 took the {model.step_kind} step")
            for k in ("K1", "K4a", "K4b"):  # one apply per RK stage, 4 per step
                expect = 4 * nsteps if k in want else 0
                if launches[k] != expect:
                    raise AssertionError(f"unfused headline FUS_V3={v3}: {k} launched "
                                         f"{launches[k]}, expected {expect}")
            if any(launches[k] for k in STAGE_KERNELS):
                raise AssertionError(f"unfused headline launched a stage kernel: {launches}")
            runs[v3] = {"u": u, "launches": launches, "rate": rate, "solve_s": solve}
    same = torch.equal(runs["0"]["u"], runs["1"]["u"])
    finite = bool(torch.isfinite(runs["0"]["u"]).all())
    say(f"[11] unfused headline: K4a -> K4b {runs['0']['rate']:.4f} against K1 "
        f"{runs['1']['rate']:.4f} GDOF-RK4-updates/s; K4 launches "
        f"{runs['0']['launches']['K4a'] + runs['0']['launches']['K4b']} "
        f"({(runs['0']['launches']['K4a'] + runs['0']['launches']['K4b']) // nsteps} a step); "
        f"final u finite {finite}, bit for bit with K1: {same}")
    if not (same and finite):
        raise AssertionError("the unfused headline through K4a -> K4b differs from K1's")
    out = {k: {n: r[n] for n in ("launches", "rate", "solve_s")} for k, r in runs.items()}
    out["sharded"] = phase_sharded_headline(device, card, model, u0, v0, runs["1"], nsteps)
    out["grid"] = phase_grid_headline(device, card, model, u0, v0, out["sharded"], nsteps)
    return out


def phase_two_kernel(device, card, k2_peak: float) -> dict:
    """The two-kernel pipeline's main path with its switches set for the
    phase: HITU, the headline and the channel gates; then the unfused
    headline through K4a/K4b against K1."""
    t_phase = time.perf_counter()
    with environment(TWO_KERNEL_ENV):
        say(f"[11] switches {TWO_KERNEL_ENV}")
        hitu_run = phase_hitu(device, card, TWO_KERNEL, "[11]", k2_peak=k2_peak)
        say(f"[11] HITU done at {time.perf_counter() - t_phase:.1f} s")
        headline = phase_headline(device, card, HEADLINE_NX, TWO_KERNEL, "[11]")
        say(f"[11] headline done at {time.perf_counter() - t_phase:.1f} s")
        channel = phase_channel(device, TWO_KERNEL, "[11]")
    say(f"[11] channels done at {time.perf_counter() - t_phase:.1f} s")
    unfused = phase_unfused_headline(device, card, HEADLINE_NX)
    say(f"[11] done in {time.perf_counter() - t_phase:.1f} s")
    return {"hitu": hitu_run, "headline": headline, "channel": channel, "unfused": unfused}


WAVE_DT = 0.02  # dt of the K3 step tables: keeps m0 − d2·un away from 0
WAVE_SRC = (1.7, -0.6, 0.9, 0.4)


def _wave_inputs(kind, lat, device, gen, rng, scale, dg0=False, sep=False):
    """Random K3 operands of ``kind`` on lattice ``lat`` (those of
    ``_stage_inputs``, inv_m separable with ``sep``) and an RK4 step table
    at dt = WAVE_DT with distinct source coefficients per stage."""
    import torch

    from fenicsxfus_tpu_torch.models.common import explicit_tables
    from fenicsxfus_tpu_torch.ops.stage import KIND_FACET
    from fenicsxfus_tpu_torch.ops.step_wave import step_table

    st = _stage_inputs(kind, lat, device, gen, rng, False, scale, dg0)
    dense = st["dense"]
    if sep:
        G0, G1, G2 = lat.gdims
        dense = [torch.rand(shape, generator=gen, device=device) + 0.5
                 for shape in ((G0,), (1, G1, G2))]
    nsrc = len(KIND_FACET[kind]) - 1
    srcs = [[x * (1.0 + 0.1 * i) for x in WAVE_SRC[:nsrc]] for i in range(4)]
    return dict(kind=kind, u0=st["u0"], v0=st["v0"],
                scal4=step_table(kind, explicit_tables(4), WAVE_DT, srcs), Fs=st["Fs"],
                dense=dense, facets=st["facets"], p=lat.p)


def wave_floor(args: dict) -> dict:
    """``floor_ms`` of one K3 launch on the operands ``args`` of
    ``_wave_inputs``: u0, v0, the coefficients, the dense (or separable)
    extras and the facets read once, u1 and v1 written once; four stages of
    stencil and node arithmetic."""
    from fenicsxfus_tpu_torch.ops.stage import KIND_FIELDS

    u0 = args["u0"]
    gd, nodes = tuple(u0.shape), float(u0.numel())
    read = nbytes(u0, args["v0"], args["Fs"], args["dense"], args["facets"])
    flops = 4 * (stencil_flops(gd, args["p"], KIND_FIELDS[args["kind"]], (0, 1, 2))
                 + STAGE_NODE_FLOPS * nodes)
    return floor_ms(read, 2 * nbytes(u0), flops)


def wave_plan_line(gdims, kind: str) -> str:
    """The fp32 K3 plan of ``kind`` on a lattice: tile, slab, lag, ring, the
    item grid and the rings' bytes."""
    import torch

    from fenicsxfus_tpu_torch.ops.stage import KIND_FIELDS, KIND_RAW
    from fenicsxfus_tpu_torch.ops.step_wave import ring_bytes, wave_plan

    nf = KIND_FIELDS[kind]
    plan = wave_plan(gdims, 4, nf, torch.float32, nr=KIND_RAW[nf])
    return (f"K3 plan: tile {plan['tile']}, slab {plan['slab']} cell(s), lag {plan['lag']}, "
            f"ring {plan['ring']} slabs, items {plan['grid']} x 4 stages, threads "
            f"{plan['threads']}, smem {plan['smem']} B, rings "
            f"{ring_bytes(plan, gdims, torch.float32) / 1e6:.2f} MB")


def phase_k3(device, card) -> dict:
    """K3 against its plain version for all four kinds (inv_m dense and
    separable for linear and lossy), beside four K2 launches of the same
    step; timings at the HITU lattice (every kind) and at the headline
    (``linear``); the grid-size check at the HITU lattice."""
    import torch

    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
    from fenicsxfus_tpu_torch.ops.stage import KIND_FIELDS, stage_apply
    from fenicsxfus_tpu_torch.ops.stage_ab import stage_ab_apply
    from fenicsxfus_tpu_torch.ops.step_wave import (
        SEP_KINDS, step_wave_apply, step_wave_check, step_wave_plain,
    )
    from fenicsxfus_tpu_torch.ops.stiffness import (
        stiffness_apply, stiffness_axes12_apply, stiffness_axis0_apply,
    )

    t_phase = time.perf_counter()
    rng = np.random.default_rng(12)
    gen = torch.Generator(device=device).manual_seed(12)
    headline = (HEADLINE_NX,) * 3
    cases = [((9, 5, 7), False), ((9, 5, 7), True), ((41, 1, 1), False), ((81, 1, 1), True),
             (HITU_GRID, False)]
    out = {}
    for kind in sorted(KIND_FIELDS):
        for grid, dg0 in cases + ([(headline, False)] if kind == "linear" else []):
            if grid == headline:
                lat, scale = _lattice(grid, 4, torch.float32), 1.0 / 1000.0
            else:
                lat, scale = LatticeStiffness(grid, 4, (1.0, 1.0, 1.0), torch.float32), 1.0
            # the headline runs linear on a separable inv_m only
            forms = (True,) if grid == headline else (
                (False, True) if kind in SEP_KINDS else (False,))
            for sep in forms:
                args = _wave_inputs(kind, lat, device, gen, rng, scale, dg0, sep)
                got = step_wave_apply(**args)
                ref = step_wave_plain(**args)
                k2 = step_wave_plain(**args, stage_fn=stage_apply)
                k5 = step_wave_plain(**args, stage_fn=stage_ab_apply)
                # K4a -> K4b against K1 on the step's fields and coefficients
                fields = [args["u0"], args["v0"]][: len(args["Fs"])]
                same4 = all(torch.equal(stiffness_axes12_apply(
                    x, F, stiffness_axis0_apply(x, F, 4), 4), stiffness_apply(x, F, 4))
                    for x, F in ((fields[:1], args["Fs"][:1]), (fields, args["Fs"])))
                step_wave_check()
                torch.cuda.synchronize()
                worst = max(rel_err(a, b) for a, b in zip(got, ref))
                vs_k2 = max(rel_err(a, b) for a, b in zip(got, k2))
                same = all(torch.equal(a, b) for a, b in zip(got, k2))
                same5 = all(torch.equal(a, b) for a, b in zip(k5, k2))
                form = ("DG-0" if dg0 else "const") + (", inv_m separable" if sep else "")
                say(f"[12] K3 {kind} grid={grid} p=4 {form}: max|d|/max|ref| = {worst[0]:.3e}; "
                    f"against four K2 launches {vs_k2[0]:.3e} (bit for bit: {same}); four "
                    f"K5a -> K5b pairs against them bit for bit: {same5}; K4a -> K4b against "
                    f"K1 bit for bit: {same4}")
                if not worst[0] <= TOL:
                    raise AssertionError(
                        f"K3 {kind} disagrees with its plain version: {worst[0]:.3e} > {TOL}")
                if not same:  # every kernel rounds the per-node arithmetic alike
                    raise AssertionError(f"K3 {kind} differs from four K2 launches")
                if not same5:
                    raise AssertionError(f"K5a -> K5b {kind} differs from K2")
                if not same4:
                    raise AssertionError(f"K4a -> K4b on the {kind} fields differs from K1")
                if grid in (HITU_GRID, headline):
                    ms = cuda_median_ms(lambda: step_wave_apply(**args))
                    pms = cuda_median_ms(lambda: step_wave_plain(**args))
                    k2ms = cuda_median_ms(lambda: step_wave_plain(**args, stage_fn=stage_apply))
                    step_wave_check()
                    where = "headline" if grid == headline else "HITU lattice"
                    bound = wave_floor(args)
                    say(f"[12] K3 {kind} {where} {form}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                        f"four K2 launches {k2ms:.3f} ms, {share_text(bound, ms)} (median of "
                        f"10, CUDA events; {card}); {wave_plan_line(lat.gdims, kind)}")
                    # the entry of the kernels line: the shape and inv_m form
                    # of the kind's main path (the headline for linear)
                    main_form = sep == (kind in SEP_KINDS)
                    if main_form and (grid == headline or kind != "linear"):
                        out[kind] = {"max_abs_err": worst[1], "ms": ms, "plain_ms": pms,
                                     "k2_ms": k2ms, **bound}
                del args, got, ref, k2, k5, fields
                torch.cuda.synchronize()

    # the grid-size check: 1 block against the default grid, bit for bit
    lat = LatticeStiffness(HITU_GRID, 4, (1.0, 1.0, 1.0), torch.float32)
    args = _wave_inputs("focused", lat, device, gen, rng, 1.0)
    t0 = time.perf_counter()
    one = step_wave_apply(**args, grid=1)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    full = step_wave_apply(**args)
    step_wave_check()
    same = all(torch.equal(a, b) for a, b in zip(one, full))
    say(f"[12] K3 focused HITU lattice on 1 block ({t_one:.2f} s) against the default grid: "
        f"bit for bit {same}")
    if not same:
        raise AssertionError("K3 on 1 block differs from K3 on the default grid")
    del args, one, full
    torch.cuda.synchronize()
    say(f"[12] kernels done in {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_wave(device, card, k2_peak: float) -> dict:
    """The wavefront's main path with its switch set for the phase: HITU,
    the headline (on a separable inv_m) and the channel gates, through K3."""
    t_phase = time.perf_counter()
    with environment(WAVE_ENV):
        say(f"[12] switches {WAVE_ENV}")
        hitu_run = phase_hitu(device, card, WAVE, "[12]", k2_peak=k2_peak)
        say(f"[12] HITU done at {time.perf_counter() - t_phase:.1f} s")
        headline = phase_headline(device, card, HEADLINE_NX, WAVE, "[12]")
        say(f"[12] headline took inv_m separable: {headline['separable']}")
        if not headline["separable"]:
            raise AssertionError("the headline on K3 did not take inv_m separable")
        say(f"[12] headline done at {time.perf_counter() - t_phase:.1f} s")
        channel = phase_channel(device, WAVE, "[12]")
    say(f"[12] done in {time.perf_counter() - t_phase:.1f} s")
    return {"hitu": hitu_run, "headline": headline, "channel": channel}


# ------------------------------------------------- [13] the bowl-fitted mesh

BOWL_BAND_LAYERS = 16  # blend layers of drivers.hitu's default bowl mesh (nx = 80)
BOWL_BAND_ROWS = BOWL_BAND_LAYERS * 4 + 1  # its slab_x at p = 4
BOWL_REF = "w_h101_water_bowlmesh_fused.npz"  # the JAX package's fused bowl run (dt 9.43e-9)
BOWL_REF_DT = "w_h101_water_bowlmesh.npz"  # its bowl run at drivers.hitu's dt, 1.887e-8
ONEIL_BOWL_REF = "oneil_bowlmesh_h101_nx64.npz"


def phase_band(device, card) -> dict:
    """K2 with its band operand against ``stage_plain`` with the same band,
    all four kinds, a non-final and a final stage, at (9,5,7) p=4 (constant
    and DG-0 coefficients, and unit cells), on the ragged (13,11,17) at p =
    1..8 (unit cells), and at the bowl lattice (321,189,189) with its
    65-row band (unit cells); K2 with an all-zero band equals K2 without
    one bit for bit; ``westervelt`` + band timed at the bowl lattice."""
    import torch

    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
    from fenicsxfus_tpu_torch.ops.stage import KIND_FIELDS, stage_apply, stage_plain

    rng = np.random.default_rng(13)
    gen = torch.Generator(device=device).manual_seed(13)
    t_phase = time.perf_counter()
    out = {}
    # (grid, p, unit cells, DG-0 coefficients)
    cases = [((9, 5, 7), 4, False, False), ((9, 5, 7), 4, False, True), ((9, 5, 7), 4, True, False)]
    cases += [((13, 11, 17), p, True, False) for p in range(1, 9)]
    cases += [(HITU_GRID, 4, True, False)]
    for kind in sorted(KIND_FIELDS):
        for grid, p, unit, dg0 in cases:
            if unit:
                lat, scale = LatticeStiffness(grid, p, (1.0, 1.0, 1.0), torch.float32), 1.0
            else:
                lat, scale = _lattice(grid, p, torch.float32), 1.0 / 1000.0
            G0, G1, G2 = lat.gdims
            rows = BOWL_BAND_ROWS if grid == HITU_GRID else G0 // 2 + 1
            for final in (False, True):
                args = _stage_inputs(kind, lat, device, gen, rng, final, scale=scale, dg0=dg0)
                args["band"] = torch.randn((rows, G1, G2), generator=gen, device=device) * scale
                got = stage_apply(**args)
                ref = stage_plain(**args)
                torch.cuda.synchronize()
                pairs = list(zip(got, ref)) if final else [(got, ref)]
                worst = max(rel_err(a, b) for a, b in pairs)
                stage = "final" if final else "non-final"
                what = ("unit cells" if unit else "DG-0" if dg0 else "const")
                say(f"[13] K2 {kind} + band grid={grid} p={p} {what} {stage}, band rows {rows}: "
                    f"max|d|/max|ref| = {worst[0]:.3e}")
                if not worst[0] <= TOL:
                    raise AssertionError(
                        f"K2 {kind} + band disagrees with its plain version: {worst[0]:.3e}")
                if (grid, p) in (((9, 5, 7), 4), (HITU_GRID, 4)) and not dg0:
                    # an all-zero band: the band kernel equals the band-less one
                    band = args.pop("band")
                    plain_k2 = stage_apply(**args)
                    zero_k2 = stage_apply(**args, band=torch.zeros_like(band))
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in
                               (zip(plain_k2, zero_k2) if final else [(plain_k2, zero_k2)]))
                    say(f"[13] K2 {kind} grid={grid} {what} {stage}: a zero band equals no "
                        f"band bit for bit: {same}")
                    if not same:
                        raise AssertionError(f"K2 {kind} with a zero band differs from K2")
                    args["band"] = band
                if grid == HITU_GRID and kind == "westervelt":
                    ms = cuda_median_ms(lambda: stage_apply(**args))
                    dms = cuda_device_ms(lambda: stage_apply(**args))
                    pms = cuda_median_ms(lambda: stage_plain(**args))
                    bound = stage_floor(args, "K2")
                    say(f"[13] K2 westervelt + band bowl lattice {stage}: kernel {ms:.3f} ms "
                        f"(device alone {dms:.3f} ms, bound/device {bound['bound_ms'] / dms:.3f}), "
                        f"plain {pms:.3f} ms, {share_text(bound, ms)} (median of 10, CUDA "
                        f"events; {card})")
                    if not final:
                        out = {"max_abs_err": worst[1], "rel_err": worst[0], "ms": ms,
                               "device_ms": dms, "plain_ms": pms, **bound}
                del args, got, ref
                torch.cuda.synchronize()
    say(f"[13] K2 + band checks done in {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_bowl(device, card) -> dict:
    """HITU W-H101-WATER on the bowl-fitted mesh at its defaults
    (``drivers.hitu.run(..., bowl=True)``): K2 ``westervelt`` with its band
    four times a step, K1 + K6 for ``estimate_stable_dt``'s 41 applies, the
    focal peak held against the JAX package's fused bowl run (2%, ±1
    sensor), then 3 more steps held against the unfused hybrid step."""
    import torch

    from fenicsxfus_tpu_torch.drivers import hitu
    from fenicsxfus_tpu_torch.models.common import run_steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    # --- the main path: counts from 0 just before, read just after
    reset_counts()
    res = hitu.run("W", "H101", "WATER", bowl=True, device=device)
    torch.cuda.synchronize()
    launches = counts()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    model = res.model
    ndofs = model.number_of_dofs()
    rate = ndofs * res.nsteps / res.solve_s / 1e9
    hyb = model.ops.hybrid
    say(f"[13] HITU W-H101-WATER bowl mesh: {ndofs} DOF, lattice {model.ops.gdims}, slab "
        f"{hyb['bx']} layers = {hyb['nb']} of {model.ops.num_cells} cells, {hyb['slab_x']} rows; "
        f"dt {model.dt:.6e} s, {res.nsteps} RK4 steps, {model.step_kind} step on "
        f"{model.stage_cls.__name__}, launches {launches}")
    say(f"[13] setup {res.setup_s:.2f} s (host s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in res.setup_split.items())
        + f"), solve {res.solve_s:.3f} s, {rate:.4f} GDOF-RK4-updates/s, device memory peak "
        f"{peak_gib:.3f} GiB ({card})")
    BAND.check_model(model)
    BAND.check(launches, "westervelt", res.nsteps, stiffness_launches=41)
    amp, x = res.amplitude, res.x
    if amp.shape != (161,) or not np.all(np.isfinite(amp)):
        raise AssertionError("bowl axial amplitude is not 161 finite values")
    ref = np.load(ROOT / "benchmarks" / "hitu" / "results" / BOWL_REF)
    ref_amp, ref_x = ref["amplitude"], ref["x"]
    i_pk, i_ref = int(np.argmax(amp)), int(np.argmax(ref_amp))
    rel_peak = (amp[i_pk] - ref_amp[i_ref]) / ref_amp[i_ref]
    say(f"[13] focal peak {amp[i_pk]:.6e} Pa at x = {x[i_pk]*1e3:.2f} mm (sensor {i_pk}); "
        f"JAX package's run {ref_amp[i_ref]:.6e} Pa at {ref_x[i_ref]*1e3:.2f} mm (sensor {i_ref}); "
        f"relative difference {rel_peak:.6e}, axial profile max rel diff "
        f"{np.max(np.abs(amp - ref_amp)) / ref_amp[i_ref]:.3e}")
    if not (abs(rel_peak) < 0.02 and abs(i_pk - i_ref) <= 1):
        raise AssertionError("bowl focal peak misses the JAX package's run (2%, ±1 sensor)")
    same_dt = np.load(ROOT / "benchmarks" / "hitu" / "results" / BOWL_REF_DT)["amplitude"]
    say(f"[13] against the JAX package's bowl run at the same dt ({BOWL_REF_DT}): peak "
        f"{same_dt.max():.6e} Pa, relative difference {(amp[i_pk] - same_dt.max()) / same_dt.max():.3e}, "
        f"axial profile max rel diff {np.max(np.abs(amp - same_dt)) / same_dt.max():.3e}")

    # --- 3 more steps from the reached state: the fused step vs the unfused
    # hybrid step (K1 + K6 once per stage)
    gd = model.ops.gdims
    u, v, t, dts = model.u_n, model.v_n, model.t, [model.dt] * 3
    uk, vk, _ = run_steps(model.fused_step(), model.consts, u.view(gd), v.view(gd), t, dts)
    reset_counts()
    uu, vu, _ = run_steps(model.unfused_step(), model.consts, u, v, t, dts)
    torch.cuda.synchronize()
    unfused = counts()
    worst = max(rel_err(uk.reshape(-1), uu)[0], rel_err(vk.reshape(-1), vu)[0])
    say(f"[13] 3 steps, fused path vs unfused path: max rel diff {worst:.3e} (gate 1e-4); "
        f"unfused launches {unfused}")
    if not worst <= 1e-4:
        raise AssertionError(f"bowl fused path disagrees with the unfused path: {worst:.3e}")
    BAND.check(unfused, "westervelt", 0, stiffness_launches=4 * len(dts))
    return {"launches": launches, "rate": rate, "solve_s": res.solve_s, "setup_s": res.setup_s,
            "peak_gib": peak_gib, "model": model, "amplitude": amp, "nsteps": res.nsteps,
            "dt": model.dt}


def phase_k6(model, card) -> None:
    """K6, the slab correction, alone at the bowl lattice on the bowl run's
    operators: two fields (Westervelt's un and vn) against the same
    function on the CPU in fp64, timed with its bound."""
    import torch

    ops = model.ops
    hy = ops.hybrid
    c_u, c_v = model.consts["coeff_u"], model.consts["coeff_v"]
    gen = torch.Generator(device=ops.device).manual_seed(6)
    rows = [torch.randn((hy["slab_x"],) + tuple(ops.gdims[1:]), generator=gen,
                        device=ops.device) for _ in range(2)]
    coeffs = [c_u["hyb_b"], c_v["hyb_b"] * (c_u["hyb_b"].abs().max() / c_v["hyb_b"].abs().max())]
    G = c_u["hyb_G"]

    def k6():
        return ops.band_correction_rows(rows, coeffs, G)

    got = k6()
    from fenicsxfus_tpu_torch.ops.band import band_correction_rows

    ref = band_correction_rows([r.cpu().double() for r in rows], [c.cpu().double() for c in coeffs],
                               G.cpu().double(), ops.D.cpu().double(), hy["blocks"], ops.degree)
    rel, err = rel_err(got.cpu(), ref)
    ms = cuda_median_ms(k6)
    dms = cuda_device_ms(k6)
    N = ops.N
    # bytes: G once, the two fields' slab rows and the coefficients read,
    # the correction written; operations: per cell 6 contractions of N^4
    # multiply-adds and the 15 products and 12 sums of the G transform
    read = nbytes(G, rows, coeffs)
    flops = hy["nb"] * (6 * 2 * N**4 + 27 * N**3 + 2 * 2 * N**3)
    bound = floor_ms(read, nbytes(rows[0]), flops)
    say(f"[13] K6 (slab correction, {hy['nb']} cells, {hy['slab_x']} rows, two fields) at the "
        f"bowl lattice: against fp64 on the CPU max|d|/max|ref| = {rel:.3e} (gate 1e-5); "
        f"{ms:.3f} ms a call (device alone {dms:.3f} ms), {share_text(bound, dms)} "
        f"(median of 10, CUDA events; {card})")
    if not rel <= 1e-5:
        raise AssertionError(f"K6 disagrees with its fp64 CPU run: {rel:.3e}")


def phase_oneil_bowl(device) -> None:
    """The O'Neil check on the bowl-fitted mesh, ``validate_bowl_mesh`` at
    nx = 64 (H101, 0.35 MHz), gated as ``tests/test_hitu.py``'s bowl gates
    and its peak held against the JAX package's chip run."""
    import json
    import tempfile

    import torch

    from fenicsxfus_tpu_torch.drivers import hitu

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:  # the run's axial amplitude, read back
        out = os.path.join(tmp, "oneil_bowl_h101_nx64.npz")
        gain, pos, prof = hitu.validate_bowl_mesh("H101", nx=64, out=out, device=device)
        torch.cuda.synchronize()
        got = np.load(out)["amplitude"]
    ref = np.load(ROOT / "benchmarks" / "hitu" / "results" / ONEIL_BOWL_REF)
    meta = json.loads(str(ref["meta"]))
    rel_peak = (got.max() - ref["amplitude"].max()) / ref["amplitude"].max()
    half_lam = hitu.MEDIA["WATER"]["c0"] / 0.35e6 / 2
    say(f"[13] O'Neil bowl mesh H101 0.35 MHz nx=64 ({time.perf_counter() - t0:.1f} s): gain "
        f"error {gain*100:.3f}%, position error {pos*1e3:.3f} mm, focal L2 {prof*100:.3f}% "
        f"(gates 3%, {half_lam*1e3:.3f} mm, 5%); JAX package's run: {meta['gain_err']*100:.3f}%, "
        f"{meta['pos_err_mm']:.3f} mm, {meta['profile_err']*100:.3f}%; peak "
        f"{got.max():.6e} Pa against {ref['amplitude'].max():.6e} Pa, relative difference "
        f"{rel_peak:.3e} (gate 2%)")
    if not (gain < 0.03 and prof < 0.05 and pos < half_lam and abs(rel_peak) < 0.02):
        raise AssertionError("O'Neil bowl-mesh gate failed")


def phase_bowl_all(device, card) -> dict:
    """[13]: the band kernel, the bowl run, K6 alone and the bowl O'Neil
    check."""
    t_phase = time.perf_counter()
    band = phase_band(device, card)
    bowl = phase_bowl(device, card)
    say(f"[13] bowl run done at {time.perf_counter() - t_phase:.1f} s")
    phase_k6(bowl.pop("model"), card)
    phase_oneil_bowl(device)
    say(f"[13] done in {time.perf_counter() - t_phase:.1f} s")
    return {"band": band, "bowl": bowl}


# ------------------------------------------------ [14] the implicit path

TOL64 = 1e-12  # fp64, sums of ~30 terms taken in another order than the plain version
IMPLICIT_STEPS = 10
def ptxas_text(ptxas: dict, key: str) -> str:
    """The ptxas lines of the kernel whose mangled name holds ``key``."""
    found = [" ".join(v) for k, v in ptxas.items() if key in k]
    return "; ".join(found) if found else "not in this run's build log (library reused)"


def phase_k1_fp64(device, card, ptxas) -> dict:
    """[14a] K1 in fp64 against its plain version: 1 and 2 fields, constant
    and DG-0 coefficients, on (9,5,7) at p = 2, 3, 4, on the ragged
    (13,11,17) at p = 1..8, at the headline lattice (1 field, timed: the
    linear implicit CG's matvec) and at the HITU lattice (2 fields, timed:
    the lossy implicit CG's matvec)."""
    import torch

    from fenicsxfus_tpu_torch.ops.stiffness import (
        pack_const, pack_field, stiffness_apply, stiffness_plain,
    )

    rng = np.random.default_rng(14)
    gen = torch.Generator(device=device).manual_seed(14)
    grids = ([((9, 5, 7), p) for p in (2, 3, 4)] + [((13, 11, 17), p) for p in range(1, 9)]
             + [((HEADLINE_NX,) * 3, 4), (HITU_GRID, 4)])
    timed = {((HEADLINE_NX,) * 3, 4): 1, (HITU_GRID, 4): 2}  # fields timed at each
    out = {}
    for grid, p in grids:
        lat = _lattice(grid, p, torch.float64)
        coeffs = {
            "const": pack_const(lat, 1.0, device),
            "dg0": pack_field(lat, rng.uniform(0.5, 2.0, int(np.prod(grid))), device),
        }
        xs = [torch.randn(lat.gdims, generator=gen, device=device, dtype=torch.float64)
              for _ in range(2)]
        cases = {"const": ([xs[0]], [coeffs["const"]]), "dg0": ([xs[0]], [coeffs["dg0"]]),
                 "2 fields": (xs, [coeffs["const"], coeffs["dg0"]])}
        for name, (x_in, F_in) in cases.items():
            y = stiffness_apply(x_in, F_in, p)
            y_ref = stiffness_plain(x_in, F_in, p)
            torch.cuda.synchronize()
            rel, err = rel_err(y, y_ref)
            say(f"[14] K1 fp64 grid={grid} p={p} {name}: max|dy|/max|y| = {rel:.3e}")
            if not rel <= TOL64:
                raise AssertionError(f"fp64 K1 disagrees with its plain version: {rel:.3e}")
            del y, y_ref
        nf = timed.get((grid, p))
        if nf:
            x_in, F_in = cases["const" if nf == 1 else "2 fields"]
            ms = cuda_median_ms(lambda: stiffness_apply(x_in, F_in, p))
            dms = cuda_device_ms(lambda: stiffness_apply(x_in, F_in, p))
            pms = cuda_median_ms(lambda: stiffness_plain(x_in, F_in, p))
            bound = floor_ms(nbytes(x_in, F_in), nbytes(xs[0]),
                             stencil_flops(lat.gdims, p, nf, (0, 1, 2)), FP64_FLOP_PER_S)
            y, kernel = _took(lambda: stiffness_apply(x_in, F_in, p))
            err = rel_err(y, stiffness_plain(x_in, F_in, p))[1]
            del y
            say(f"[14] K1 fp64 {nf} field(s) grid={grid} p={p}: kernel {ms:.3f} ms (device "
                f"alone {dms:.3f} ms), plain {pms:.3f} ms, {share_text(bound, dms)} of the "
                f"device's time (median of 10, CUDA events; {card}); tile plan "
                f"{plan_line(lat.gdims, p, nf, dtype=torch.float64, kernel=('K1', nf))}, "
                f"{kernel}; ptxas "
                f"{ptxas_text(ptxas, tile_mangled(kernel))}")
            out[nf] = {"max_abs_err": err, "ms": ms, "device_ms": dms, "plain_ms": pms,
                       "kernel": kernel, **bound}
        del xs, coeffs
        torch.cuda.synchronize()
    return out


def _counting(fn):
    """``fn`` with a count of its calls in ``.calls``."""
    def wrapped(*args):
        wrapped.calls += 1
        return fn(*args)

    wrapped.calls = 0
    return wrapped


def implicit_against_plain(model, tag: str, steps: int = 1) -> dict:
    """``steps`` SDIRK steps from a seeded random (u, v) through K1 and
    through the plain stiffness, both on the card: the same CG iteration
    counts (the worst per step, and the stiffness applies in all), the
    fields within 1e-9 relative in max-norm."""
    import torch

    from fenicsxfus_tpu_torch.models.common import run_steps
    from fenicsxfus_tpu_torch.ops.stiffness import stiffness_plain

    gen = torch.Generator(device=model.device).manual_seed(141)
    n = model.ops.ndofs
    u0 = 1e-3 * torch.randn(n, generator=gen, device=model.device, dtype=model.dtype)
    v0 = torch.randn(n, generator=gen, device=model.device, dtype=model.dtype)
    plain = model.ops.plain()
    plain.stiffness_fn = _counting(stiffness_plain)
    dts = [model.dt] * steps
    sk, sp = [], []
    reset_counts()
    uk, vk, _ = run_steps(model.dirk_step(stats=sk), model.consts, u0, v0, 0.0, dts)
    torch.cuda.synchronize()
    k1 = counts()["K1"]
    up, vp, _ = run_steps(model.dirk_step(ops=plain, stats=sp), model.consts, u0, v0, 0.0, dts)
    torch.cuda.synchronize()
    worst = max(rel_err(uk, up)[0], rel_err(vk, vp)[0])
    its_k, its_p = [s[0] for s in sk], [s[0] for s in sp]
    say(f"{tag} {steps} step(s) from a random state, K1 against the plain stiffness: max rel "
        f"diff {worst:.3e} (gate 1e-9); worst CG iterations {its_k} against {its_p}, "
        f"stiffness applies {k1} against {plain.stiffness_fn.calls}")
    if not (worst <= 1e-9 and its_k == its_p and k1 == plain.stiffness_fn.calls > 0):
        raise AssertionError(f"{tag} the K1 path disagrees with the plain path")
    return {"max_rel": worst}


def device_split(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device's busy time and the K1 kernels' time (ms), summed over kernels;
    device times None where the profiler shows none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = k1 = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:  # the kernels, not the ops that launch them
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        busy += us / 1e3
        if "stiffness_tile_kernel" in evt.key:
            k1 += us / 1e3
    if busy == 0.0:
        return {"wall_ms": wall, "busy_ms": None, "k1_ms": None}
    return {"wall_ms": wall, "busy_ms": busy, "k1_ms": k1}


def phase_implicit_headline(device, card) -> dict:
    """[14b] the slice's main path: ``LinearSpectralImplicit`` on bench.py's
    problem (phase [5]'s box, medium, tags and dt), SDIRK4, fp64, through
    ``dirk`` for IMPLICIT_STEPS steps; then one step from a random state
    through K1 and through the plain stiffness."""
    import torch

    import fenicsxfus_tpu_torch as ft
    from fenicsxfus_tpu_torch.models.common import run_steps

    nx, degree, c0, rho0, f0, p0, L = HEADLINE_NX, 4, 1500.0, 1000.0, 0.5e6, 60000.0, 0.12
    t0 = time.perf_counter()
    mesh = ft.create_box((nx, nx, nx), (0, 0, 0), (L, L, L))
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > L - 1e-9})
    dt = 0.9 * (L / nx) / (c0 * degree**2)
    model = ft.LinearSpectralImplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt,
                                      dtype=torch.float64, device=device)
    model.init()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    ndofs = model.number_of_dofs()
    say(f"[14] implicit headline nx={nx}: {ndofs} DOF, SDIRK{model.rk_order}, fp64, dt "
        f"{dt:.6e} s, cg_rtol {model.cg_rtol:g}, setup {setup:.1f} s")
    torch.cuda.reset_peak_memory_stats(device)

    # --- the main path: counts from 0 just before, read just after
    reset_counts()
    t0 = time.perf_counter()
    u, v, t = model.dirk(0.0, IMPLICIT_STEPS * dt)
    torch.cuda.synchronize()
    solve = time.perf_counter() - t0
    launches = counts()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30

    stages = len(model.b_tab)
    k1 = launches["K1"]
    # per stage: one rhs_stage apply, the initial residual A(x0), one per iteration
    mean_it = (k1 - 2 * stages * IMPLICIT_STEPS) / (stages * IMPLICIT_STEPS)
    checksum = float(u.double().abs().sum())
    say(f"[14] {IMPLICIT_STEPS} SDIRK4 steps: solve {solve:.3f} s, {solve / IMPLICIT_STEPS:.4f} "
        f"s a step, {ndofs * IMPLICIT_STEPS / solve:.6e} DOF-steps/s; CG iterations a stage: "
        f"worst {model.cg_stats['max_iterations']}, mean {mean_it:.2f} (worst final |r|^2 "
        f"{model.cg_stats['max_residual2']:.3e}); K1 launches {k1} ({k1 / IMPLICIT_STEPS:.1f} a "
        f"step); device memory peak {peak_gib:.3f} GiB; checksum sum|u| = {checksum:.6e} "
        f"({card})")
    if not (np.isfinite(checksum) and checksum > 0):
        raise AssertionError("implicit headline state is not finite and nonzero")
    if any(launches[k] for k in ("K4a", "K4b") + STAGE_KERNELS):
        raise AssertionError(f"the implicit headline launched another kernel: {launches}")
    if not (k1 >= 3 * stages * IMPLICIT_STEPS and model.cg_stats["max_iterations"] < 2000):
        raise AssertionError("the implicit headline's CG did not run through K1")

    # one more step under the profiler: K1's share of the step's device time
    split = device_split(lambda: run_steps(model.dirk_step(), model.consts, u, v, t, [dt]))
    if split["busy_ms"] is None:
        say(f"[14] one more step: {split['wall_ms']:.1f} ms by the host clock; the profiler "
            f"shows no device time (K1's share not measured)")
    else:
        say(f"[14] one more step: {split['wall_ms']:.1f} ms by the host clock, device busy "
            f"{split['busy_ms']:.1f} ms (idle share "
            f"{1 - split['busy_ms'] / split['wall_ms']:.3f}), K1 {split['k1_ms']:.1f} ms = "
            f"{split['k1_ms'] / split['busy_ms']:.3f} of the device time (torch.profiler)")
    del u, v
    sharded = phase_sharded_implicit(device, card, model)
    against = implicit_against_plain(model, "[14] headline")
    return {"launches": launches, "solve_s": solve, "setup_s": setup, "peak_gib": peak_gib,
            "mean_it": mean_it, "split": split, "sharded": sharded, **against}


def phase_implicit_lossy(device, card) -> dict:
    """[14c] ``LossySpectralImplicit`` at the HITU lattice (box, tags,
    medium and dt of ``drivers.hitu.build_model("W", "H101", "WATER")``),
    SDIRK4, fp64, 5 steps through ``dirk`` (two-field K1 in every CG
    iteration), then one step against the plain stiffness."""
    import torch

    import fenicsxfus_tpu_torch as ft
    from fenicsxfus_tpu_torch.drivers import hitu

    f0, degree, nx = 0.5e6, 4, HITU_GRID[0]
    c0, rho0, p0, delta0, _ = hitu._medium("W", "H101", "WATER", f0, False)
    g = hitu.TRANSDUCERS["H101"]
    L, W, a = g["L"], g["W"], g["a"]
    h = L / nx
    mesh = ft.create_box(HITU_GRID, (0.0, -W / 2, -W / 2), (L, W / 2, W / 2))
    ft.tag_boundaries(mesh, {1: lambda x: (x[0] < 1e-9) & (np.hypot(x[1], x[2]) <= a)},
                      default=2)
    dt, _ = hitu._cfl_dt(0.4, h, c0, degree, f0)
    t0 = time.perf_counter()
    model = ft.LossySpectralImplicit(mesh, None, degree, c0, rho0, delta0, f0, p0, c0, 4, dt,
                                     dtype=torch.float64, device=device)
    model.init()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    steps = 5
    reset_counts()
    t0 = time.perf_counter()
    u, _, _ = model.dirk(0.0, steps * dt)
    torch.cuda.synchronize()
    solve = time.perf_counter() - t0
    launches = counts()
    k1 = launches["K1"]
    mean_it = (k1 - 2 * 4 * steps) / (4 * steps)
    say(f"[14] lossy implicit, HITU lattice: {model.number_of_dofs()} DOF, delta0 "
        f"{delta0:.4e}, dt {dt:.6e} s, setup {setup:.1f} s; {steps} SDIRK4 steps in "
        f"{solve:.3f} s ({solve / steps:.4f} s a step); CG iterations a stage: worst "
        f"{model.cg_stats['max_iterations']}, mean {mean_it:.2f}; two-field K1 launches {k1} "
        f"({card})")
    if not (torch.isfinite(u).all() and k1 >= 3 * 4 * steps):
        raise AssertionError("the lossy implicit run is not finite or missed K1")
    del u
    against = implicit_against_plain(model, "[14] lossy HITU lattice")
    return {"launches": launches, "solve_s": solve, "steps": steps, "mean_it": mean_it,
            **against}


def phase_implicit_bowl(device) -> None:
    """[14d] ``LinearSpectralImplicit`` on a small bowl-fitted mesh (the
    hybrid ``stiffness_diag``; K1 + K6 in every CG iteration), 3 steps
    through K1 and through the plain stiffness from one random state."""
    import torch

    import fenicsxfus_tpu_torch as ft

    mesh, _ = ft.create_bowl_box((16, 7, 7), (0, 0, 0), (1.0, 0.9, 0.9), 0.9, 0.25,
                                 blend=0.08, lateral_hold=0.08)
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)
    dt = 0.3 * mesh.h_min() / 16
    model = ft.LinearSpectralImplicit(mesh, None, 4, 1.0, 1.0, 1 / 0.3, 1.0, 1.0, 4, dt,
                                      dtype=torch.float64, device=device)
    hyb = model.ops.hybrid
    say(f"[14] bowl mesh: {model.number_of_dofs()} DOF, slab {hyb['nb']} cells, "
        f"{hyb['slab_x']} rows")
    implicit_against_plain(model, "[14] bowl", steps=3)


# The launch-bound 1D/2D reference gates ([14e], [16f]) run the first
# GATE_DEPTH of their horizon on the card and on the CPU, held together; the
# analytical gates at the full horizon are the CPU tests'
# (tests/test_torch_implicit.py, tests/test_torch_experimental_gates.py). A
# depth cut: at the full horizon they took about 220 s of the script's time
# limit, at a quarter 96 s; an eighth leaves room for [19].
GATE_DEPTH = 0.125


def card_against_cpu(tag, name, make, march, tend, gate, device) -> dict:
    """Build ``make(dev)`` on the card and on the CPU, march each with
    ``march(model, t)`` (which returns u) from zero to GATE_DEPTH·``tend``,
    and hold the card's u against the CPU's: max|d|/max|u| <= ``gate``.
    Returns the difference and the card run's K1 launches and model."""
    import torch

    t = GATE_DEPTH * tend
    runs = []
    for dev in (device, "cpu"):
        model = make(dev)
        model.init()
        reset_counts()
        t0 = time.perf_counter()
        u = march(model, t)
        torch.cuda.synchronize()
        runs.append((u, time.perf_counter() - t0, counts()["K1"], model))
    (uk, sk, k1, model), (uc, sc, _, _) = runs
    rel = rel_err(uk.cpu(), uc)[0]
    say(f"{tag} {name}, fp64, the first {GATE_DEPTH:g} of its horizon (t = {t:.4g}): card "
        f"{sk:.2f} s, CPU {sc:.2f} s, max|d|/max|u| = {rel:.3e} (gate {gate:g}), K1 launches "
        f"{k1}")
    if not (uk.device == model.device and rel <= gate and float(uc.abs().max()) > 0):
        raise AssertionError(f"{tag} {name}: the card's run differs from the CPU's: {rel:.3e}")
    return {"rel": rel, "k1": k1, "model": model}


def phase_implicit_gates(device) -> dict:
    """[14e] the reference gates' problems (1D and 2D: plain torch ops on
    the device; the 3D channel through K1), fp64, the first GATE_DEPTH of
    each horizon on the card against the CPU (1e-10 explicit, 1e-7 through
    the CG's stopping test)."""
    import torch

    import fenicsxfus_tpu_torch as ft

    f0, c0, L, degree, rho0 = 10.0, 1.0, 1.0, 4, 4.0
    p0 = rho0 * c0
    nx = int(4 * L * f0 / c0 + 1)  # 4 elements per wavelength
    h = L / nx
    alphadB = 5.0
    delta0 = ft.compute_diffusivity_of_sound(2 * np.pi * f0, c0, alphadB)
    f64 = torch.float64

    def ends(mesh):
        ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
        return mesh

    cases = {
        "1D linear implicit (4,4)": (
            lambda dev: ft.LinearSpectralImplicit(ends(ft.create_interval(nx, 0.0, L)), None,
                                                  degree, c0, rho0, f0, p0, c0, 4,
                                                  0.9 * h / (c0 * degree**2), device=dev), 1e-7),
        "1D lossy implicit (4,4)": (
            lambda dev: ft.LossySpectralImplicit(ends(ft.create_interval(nx, 0.0, L)), None,
                                                 degree, c0, rho0, delta0, f0, p0, c0, 4,
                                                 0.5 * h / (c0 * degree**2), device=dev), 1e-7),
        "1D linear explicit (4,4)": (
            lambda dev: ft.LinearSpectralExplicit(ends(ft.create_interval(nx, 0.0, L)), None,
                                                  degree, c0, rho0, f0, p0, c0, 4,
                                                  0.9 * h / (c0 * degree**2), dtype=f64,
                                                  device=dev), 1e-10),
        "2D channel explicit (41,6)": (
            lambda dev: ft.LinearSpectralExplicit(
                ends(ft.create_rectangle((41, 6), (0, 0), (L, 0.15))), None, degree, c0,
                rho0, f0, p0, c0, 4, 0.9 * (L / 41) / (c0 * degree**2), dtype=f64,
                device=dev), 1e-10),
        "3D channel implicit (41,1,1) through K1": (
            lambda dev: ft.LinearSpectralImplicit(
                ends(ft.create_box((41, 1, 1), (0, 0, 0), (L, 0.1, 0.1))), None, degree, c0,
                rho0, f0, p0, c0, 4, 0.9 * (L / 41) / (c0 * degree**2), device=dev), 1e-7),
    }

    def march(model, t):
        return model.dirk(0.0, t)[0] if hasattr(model, "dirk") else model.rk(0.0, t)[0]

    out = {}
    for name, (make, gate) in cases.items():
        res = card_against_cpu("[14]", name, make, march, L / c0 + 16.0 / f0, gate, device)
        if (res["model"].ops.d == 3) != (res["k1"] > 0):
            raise AssertionError(f"{name}: K1 launched {res['k1']} times on a "
                                 f"{res['model'].ops.d}D lattice")
        out[name] = res["rel"]
    return out


def phase_implicit(device, card, ptxas) -> dict:
    """[14]: fp64 K1, the implicit headline, the lossy implicit run at the
    HITU lattice, the bowl check and the reference gates."""
    t_phase = time.perf_counter()
    k1 = phase_k1_fp64(device, card, ptxas)
    say(f"[14] fp64 K1 checks done at {time.perf_counter() - t_phase:.1f} s")
    headline = phase_implicit_headline(device, card)
    say(f"[14] implicit headline done at {time.perf_counter() - t_phase:.1f} s")
    lossy = phase_implicit_lossy(device, card)
    say(f"[14] lossy implicit done at {time.perf_counter() - t_phase:.1f} s")
    phase_implicit_bowl(device)
    phase_implicit_gates(device)
    say(f"[14] done in {time.perf_counter() - t_phase:.1f} s")
    return {"k1": k1, "headline": headline, "lossy": lossy}


# ----------------------------------------- [15] the general per-cell path
GENERAL_NX = 54  # create_box((54,)*3) at p=4: 217^3 = 10,218,313 DOF, 157,464 cells
GENERAL_STEPS = 60


def assert_no_tf32() -> None:
    """The general path's fp32 products run through torch.matmul: they
    must be full fp32 (the precision rule of the port)."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is not False")
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("torch.get_float32_matmul_precision() is not 'highest'")


def phase_general_solve(device, card) -> dict:
    """[15](b): ``tools/unstructured_solve.py`` at nx = 54, p = 4, 60 RK4
    steps (warm-up on the identical window), fp32: the lattice, the
    distorted unstructured box and the same after ``reorder_locality``;
    the device memory peak; the distorted run's final u against the same
    run in fp64 on the card (rel-L2 ≤ 1e-5)."""
    import torch

    from fenicsxfus_tpu_torch.tools import unstructured_solve as us

    assert_no_tf32()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    res, gap = us.main(GENERAL_NX, 4, GENERAL_STEPS, torch.float32, device,
                       say=lambda line: say("[15] " + line.strip()))
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    kinds = [r["step_kind"] for r in res]
    if kinds != ["fused", "unfused", "unfused"] or any(
            r["model"].ops.lattice is not None for r in res[1:]):
        raise AssertionError(f"[15] unexpected steps {kinds}")
    for r in res:
        u = r["u"]
        finite = bool(torch.isfinite(u).all()) and float(u.abs().max()) > 0
        if u.shape != (r["ndofs"],) or not finite:
            raise AssertionError(f"[15] {r['label']}: u is not {r['ndofs']} finite nonzero values")
    t0 = time.perf_counter()
    m64 = us.build_model(res[1]["model"].mesh, 4, torch.float64, device)
    u64, _, _ = m64.rk(0.0, GENERAL_STEPS * m64.dt)
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    u32 = res[1]["u"].double()
    rel_l2 = float(torch.linalg.vector_norm(u32 - u64) / torch.linalg.vector_norm(u64))
    say(f"[15] lattice {res[0]['gdof_steps_per_s']:.4f}, unstructured "
        f"{res[1]['gdof_steps_per_s']:.4f}, unstructured+reorder {res[2]['gdof_steps_per_s']:.4f} "
        f"GDOF-RK4-steps/s; per-DOF gap lattice / unstructured+reorder {gap:.3f} (lattice / "
        f"unstructured {res[0]['gdof_steps_per_s'] / res[1]['gdof_steps_per_s']:.3f}); device "
        f"memory peak {peak_gib:.3f} GiB ({card})")
    say(f"[15] distorted box fp32 against fp64 on the card after {GENERAL_STEPS} steps: rel-L2 "
        f"{rel_l2:.3e} (gate 1e-5); fp64 build and run {t64:.1f} s")
    if not rel_l2 <= 1e-5:
        raise AssertionError(f"[15] the fp32 general run drifts from fp64: {rel_l2:.3e}")
    split = phase_split_general(device, card, res[1])
    return {"res": res, "gap": gap, "peak_gib": peak_gib, "ops64": m64.ops, "split": split}


def phase_general_ops(device, card, ops32, ops64) -> dict:
    """[15](a) at 10.2M DOF: ``as_unstructured`` of a box of unit cells
    (the general path: ``K_ref``, and the dense route) against K1 on the
    same field; the distorted box's default route against
    ``stiffness_apply_generic`` in fp32 and against the same apply in fp64
    on the card; the fold twice, bit for bit; each part timed by CUDA events
    beside its floor."""
    import torch

    import fenicsxfus_tpu_torch as ft
    from fenicsxfus_tpu_torch.ops.operators import stiffness_cells, stiffness_cells_dense

    assert_no_tf32()
    t0 = time.perf_counter()
    box = ft.create_box((GENERAL_NX,) * 3, (0, 0, 0), (float(GENERAL_NX),) * 3)
    lat = ft.SEMOperators(box, 4, device=device)
    gen = ft.SEMOperators(ft.as_unstructured(box), 4, device=device)
    if lat.lattice is None or gen.lattice is not None or gen.K_ref is None:
        raise AssertionError("[15] the unstructured box did not take the general path")
    to_lat = np.empty(gen.ndofs, np.int64)
    to_lat[gen.space.dofmap.reshape(-1)] = lat.space.dofmap.reshape(-1)
    to_lat = torch.as_tensor(to_lat, device=device)
    say(f"[15] box of unit cells {box.grid_shape}, p=4: {gen.ndofs} DOF, {gen.num_cells} cells; "
        f"lattice and general operators built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(15)
    gen_t = torch.Generator(device=device).manual_seed(15)
    coeff = rng.uniform(0.5, 2.0, box.num_cells)
    x = torch.randn(lat.ndofs, generator=gen_t, device=device)
    y_lat = lat.stiffness_apply([x], [lat.stiff_coeff(coeff)])[to_lat]
    c_gen = gen.stiff_coeff(coeff)
    xg = x[to_lat]
    y_kref = gen.stiffness_apply([xg], [c_gen])
    z = gen.gather_combine([xg], [c_gen])
    y_dense = gen.scatter(stiffness_cells_dense(gen.B_tab, gen.G, z, 3))
    for name, y in (("K_ref", y_kref), ("dense", y_dense)):
        rel, _ = rel_err(y, y_lat)
        say(f"[15] unstructured box, general path ({name} route) against the lattice path (K1): "
            f"max|d|/max|ref| = {rel:.3e} (gate 1e-5)")
        if not rel <= 1e-5:
            raise AssertionError(f"[15] the general path ({name}) disagrees with K1: {rel:.3e}")
    del lat, y_lat, y_kref, y_dense, z

    # the distorted box: default route, oracle, fp64
    ops = ops32
    nc, ndofs = ops.num_cells, ops.ndofs
    coeff = rng.uniform(0.5, 2.0, nc)
    c32 = ops.stiff_coeff(coeff)
    x = torch.randn(ndofs, generator=gen_t, device=device)
    y = ops.stiffness_apply([x], [c32])
    y_gen = ops.stiffness_apply_generic([x], [coeff])
    y64 = ops64.stiffness_apply([x.double()], [coeff])
    with environment({"FUS_DENSE_TAB": "0"}):
        y_sum = ops.stiffness_apply([x], [c32])
    for name, a, b in (("default (dense) route against stiffness_apply_generic, fp32", y, y_gen),
                       ("default (dense) route against the fp64 apply", y, y64),
                       ("FUS_DENSE_TAB=0 route against the fp64 apply", y_sum, y64)):
        rel, _ = rel_err(a, b)
        say(f"[15] distorted box {ndofs} DOF: {name}: max|d|/max|ref| = {rel:.3e} (gate 1e-5)")
        if not rel <= 1e-5:
            raise AssertionError(f"[15] distorted box: {name}: {rel:.3e}")
    ycells = torch.randn((nc,) + (ops.N,) * 3, generator=gen_t, device=device)
    a, b = ops.scatter(ycells), ops.scatter(ycells)
    same = bool(torch.equal(a, b))
    rel, _ = rel_err(a, ops.scatter_segsum(ycells))
    valences = [int(t.numel() // d.numel()) for d, t in ops.fold_plan]
    say(f"[15] the fold twice on the same cell values: equal bits {same}; against the sorted "
        f"segment sum max|d|/max|ref| = {rel:.3e}; valences {valences}")
    if not same or not rel <= 1e-5:
        raise AssertionError("[15] the fold is not deterministic or disagrees with the segment sum")

    # timings at 10.2M DOF, each beside its floor
    z = ops.gather_combine([x], [c32])
    parts = {
        "gather": lambda: ops.gather(x),
        "dense": lambda: stiffness_cells_dense(ops.B_tab, ops.G, z, 3),
        "sum-factorised": lambda: stiffness_cells(ops.D, ops.G, z, 3),
        "K_ref": lambda: torch.matmul(z.reshape(nc, -1), gen.K_ref.T),
        "scatter": lambda: ops.scatter(ycells),
        "scatter_segsum": lambda: ops.scatter_segsum(ycells),
        "apply": lambda: ops.stiffness_apply([x], [c32]),
    }
    bounds = general_bounds(ops)
    times = {}
    for name, fn in parts.items():
        ms = cuda_median_ms(fn)
        times[name] = {"ms": ms, **bounds[name]}
        say(f"[15] {name} at {ndofs} DOF, {nc} cells: {ms:.3f} ms, {share_text(bounds[name], ms)} "
            f"(median of 10, CUDA events; {card})")
    return times


# [15](c) runs the first eighth of the bowl run's time on the general path
# and on the hybrid path (the whole run and the bowl O'Neil check on the
# general path took 130-140 s of the script's time limit, a quarter 44 s;
# an eighth leaves room for [19])
BOWL_GENERAL_DEPTH = 0.125


def phase_general_bowl(device, card, hybrid: dict) -> dict:
    """[15](c): HITU W-H101-WATER on the bowl mesh with ``FUS_HYBRID=0``
    (the general per-cell path, no kernel) over the first
    BOWL_GENERAL_DEPTH of ``hitu.run``'s final time, its axial amplitude held
    against the hybrid path's (K2 + band) over the same time: the peak
    within 1e-4 at the same sensor, in as many steps."""
    import torch

    from fenicsxfus_tpu_torch.drivers import hitu

    assert_no_tf32()
    tf = BOWL_GENERAL_DEPTH * (hitu.TRANSDUCERS["H101"]["L"] / hitu.MEDIA["WATER"]["c0"]
                               + 8.0 / 0.5e6)
    twin = hitu.run("W", "H101", "WATER", bowl=True, final_time=tf, device=device)
    ref = twin.amplitude
    with environment({"FUS_HYBRID": "0"}):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        res = hitu.run("W", "H101", "WATER", bowl=True, final_time=tf, device=device)
        torch.cuda.synchronize()
        launches = counts()
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
        model = res.model
        if model.ops.lattice is not None or model.step_kind != "unfused":
            raise AssertionError("[15] FUS_HYBRID=0 did not take the general path")
        if any(launches[k] for k in ("K1", "K4a", "K4b")) or any(
                launches[k] for k in STAGE_KERNELS):
            raise AssertionError(f"[15] a kernel ran on the general path: {launches}")
        amp = res.amplitude
        if amp.shape != ref.shape or not np.all(np.isfinite(amp)):
            raise AssertionError("[15] bowl axial amplitude is not 161 finite values")
        i_pk, i_ref = int(np.argmax(amp)), int(np.argmax(ref))
        rel_peak = (amp[i_pk] - ref[i_ref]) / ref[i_ref]
        ndofs = model.number_of_dofs()
        say(f"[15] HITU W-H101-WATER bowl mesh, FUS_HYBRID=0, the first {BOWL_GENERAL_DEPTH:g} "
            f"of the run ({tf:.4e} s): {ndofs} DOF, {model.ops.num_cells} cells, dt "
            f"{model.dt:.6e} s ([13]: {hybrid['dt']:.6e}), {res.nsteps} RK4 steps (hybrid "
            f"path: {twin.nsteps}), {model.step_kind} step, no kernel launched")
        say(f"[15] setup {res.setup_s:.2f} s (host s: "
            + ", ".join(f"{k} {v:.2f}" for k, v in res.setup_split.items())
            + f"), solve {res.solve_s:.3f} s ({ndofs * res.nsteps / res.solve_s / 1e9:.4f} "
            f"GDOF-RK4-updates/s; the hybrid path {twin.solve_s:.3f} s), device memory peak "
            f"{peak_gib:.3f} GiB ({card})")
        say(f"[15] peak {amp[i_pk]:.6e} Pa (sensor {i_pk}) against the hybrid path's "
            f"{ref[i_ref]:.6e} Pa (sensor {i_ref}): relative difference {rel_peak:.3e} (gate "
            f"1e-4); axial profile max rel diff {np.max(np.abs(amp - ref)) / ref[i_ref]:.3e}")
        if not (abs(rel_peak) <= 1e-4 and i_pk == i_ref and res.nsteps == twin.nsteps):
            raise AssertionError("[15] the general bowl run misses the hybrid run's peak")
        out = {"solve_s": res.solve_s, "setup_s": res.setup_s, "peak_gib": peak_gib,
               "rel_peak": float(rel_peak)}
        del model, res
    return out


def phase_general(device, card, hybrid: dict) -> dict:
    """[15]: the general per-cell path: (b) the solve, (a) the operators on
    (b)'s meshes at 10.2M DOF, (c) the bowl mesh under FUS_HYBRID=0."""
    t_phase = time.perf_counter()
    solve = phase_general_solve(device, card)
    say(f"[15] solves done at {time.perf_counter() - t_phase:.1f} s")
    ops = phase_general_ops(device, card, solve["res"][1]["model"].ops, solve.pop("ops64"))
    solve.pop("res")
    say(f"[15] operators done at {time.perf_counter() - t_phase:.1f} s")
    bowl = phase_general_bowl(device, card, hybrid)
    say(f"[15] done in {time.perf_counter() - t_phase:.1f} s")
    return {"solve": solve, "ops": ops, "bowl": bowl}


# ------------------------------------------- [16] the rest of the model family
S2_STEPS = 200
SPONGE_GRID = (100, 47, 47)  # the HITU box extended to x = 0.15 m: (401, 189, 189) nodes
SPONGE_L = 0.15
NEWMARK_STEPS = 10
# one source period (two before): a depth cut that keeps the script
# inside its time limit as [17] grows it
ADAPTIVE_PERIODS = 1
GAUSS_NX = 54  # create_box((54,)*3) over the unit box, p = 4: 10,218,313 DOF
GAUSS_STEPS = 5


def hitu_box(grid, L, aperture: bool):
    """The HITU W-H101 box [0, L] x [-W/2, W/2]^2 on ``grid`` cells: source
    (tag 1) on the flat aperture r <= a of x = 0 (``aperture``) or on the
    whole face, the ABC (tag 2) on every other facet."""
    import fenicsxfus_tpu_torch as ft
    from fenicsxfus_tpu_torch.drivers import hitu

    g = hitu.TRANSDUCERS["H101"]
    W, a = g["W"], g["a"]
    mesh = ft.create_box(grid, (0.0, -W / 2, -W / 2), (L, W / 2, W / 2))
    src = ((lambda x: (x[0] < 1e-9) & (np.hypot(x[1], x[2]) <= a)) if aperture
           else (lambda x: x[0] < 1e-9))
    ft.tag_boundaries(mesh, {1: src}, default=2)
    return mesh


def water(f0: float):
    """(c0, rho0, p0, delta0, beta0) of W-H101-WATER at ``f0``, and the
    driver's dt at the HITU cell size."""
    from fenicsxfus_tpu_torch.drivers import hitu

    c0, rho0, p0, delta0, beta0 = hitu._medium("W", "H101", "WATER", f0, False)
    dt, _ = hitu._cfl_dt(0.4, hitu.TRANSDUCERS["H101"]["L"] / HITU_GRID[0], c0, 4, f0)
    return c0, rho0, p0, delta0, beta0, dt


def k1_on_model(model, keys, card, tag) -> dict:
    """K1 with ``model``'s own packed coefficients ``keys`` (``k1_on_operands``)."""
    return k1_on_operands([model.consts[k] for k in keys], model.ops.gdims, model.ops.degree,
                          card, tag)


def k1_on_operands(Fs, gdims, p, card, tag) -> dict:
    """K1 with the packed coefficients ``Fs`` (one or two fields) on seeded
    random fields at the lattice ``gdims``, against its plain version:
    error, CUDA-event times and the bound (fp32 or fp64 rate by the
    operands' dtype)."""
    import torch

    from fenicsxfus_tpu_torch.ops.stiffness import stiffness_apply, stiffness_plain

    device, dtype = Fs[0]["F0"].device, Fs[0]["F0"].dtype
    gen = torch.Generator(device=device).manual_seed(16)
    xs = [torch.randn(gdims, generator=gen, device=device, dtype=dtype) for _ in Fs]
    y, kernel = _took(lambda: stiffness_apply(xs, Fs, p))
    rel, err = rel_err(y, stiffness_plain(xs, Fs, p))
    del y
    ms = cuda_median_ms(lambda: stiffness_apply(xs, Fs, p))
    pms = cuda_median_ms(lambda: stiffness_plain(xs, Fs, p))
    rate = FP64_FLOP_PER_S if dtype == torch.float64 else FP32_FLOP_PER_S
    bound = floor_ms(nbytes(xs, Fs), nbytes(xs[0]),
                     stencil_flops(gdims, p, len(Fs), (0, 1, 2)), rate)
    say(f"{tag} K1 {str(dtype).split('.')[-1]} {len(Fs)} field(s) at {tuple(gdims)}: "
        f"max|dy|/max|y| = {rel:.3e}; kernel {ms:.3f} ms, plain {pms:.3f} ms, "
        f"{share_text(bound, ms)} (median of 10, CUDA events; {card})")
    if not rel <= (TOL64 if dtype == torch.float64 else TOL):
        raise AssertionError(f"{tag} K1 disagrees with its plain version: {rel:.3e}")
    return {"max_abs_err": err, "rel": rel, "ms": ms, "plain_ms": pms, "kernel": kernel, **bound}


def explicit_against_plain(model, tag: str, steps: int = 3, gate: float = TOL) -> float:
    """``steps`` unfused RK steps from a seeded random (u, v) through the
    model's kernels and through ``ops.plain()``: max rel diff <= ``gate``."""
    import torch

    from fenicsxfus_tpu_torch.models.common import run_steps

    gen = torch.Generator(device=model.device).manual_seed(161)
    n = model.ops.ndofs
    u0 = 1e-3 * torch.randn(n, generator=gen, device=model.device, dtype=model.dtype)
    v0 = torch.randn(n, generator=gen, device=model.device, dtype=model.dtype)
    dts = [model.dt] * steps
    uk, vk, _ = run_steps(model.unfused_step(), model.consts, u0, v0, 0.0, dts)
    up, vp, _ = run_steps(model.unfused_step(ops=model.ops.plain()), model.consts, u0, v0,
                          0.0, dts)
    torch.cuda.synchronize()
    worst = max(rel_err(uk, up)[0], rel_err(vk, vp)[0])
    say(f"{tag} {steps} steps from a random state, K1 against the plain stiffness: max rel "
        f"diff {worst:.3e} (gate {gate:g})")
    if not worst <= gate:
        raise AssertionError(f"{tag} the K1 path disagrees with the plain path: {worst:.3e}")
    return worst


def timed_rk(model, steps: int, tag: str, card) -> dict:
    """``model.rk`` over ``steps`` steps from zero, counts from 0 just
    before and read just after: K1 once a stage and no other kernel."""
    import torch

    model.init()
    reset_counts()
    t0 = time.perf_counter()
    u, v, t = model.rk(0.0, steps * model.dt)
    torch.cuda.synchronize()
    solve = time.perf_counter() - t0
    launches = counts()
    ndofs = model.number_of_dofs()
    rate = ndofs * steps / solve / 1e9
    say(f"{tag} {steps} RK4 steps ({model.step_kind} step): solve {solve:.3f} s, "
        f"{rate:.4f} GDOF-RK4-updates/s, K1 launches {launches['K1']}, max|u| "
        f"{float(u.abs().max()):.6e} ({card})")
    if model.step_kind != "unfused" or launches["K1"] != 4 * steps:
        raise AssertionError(f"{tag} expected K1 4 times a step: {launches}")
    if any(launches[k] for k in ("K4a", "K4b") + STAGE_KERNELS):
        raise AssertionError(f"{tag} another kernel ran: {launches}")
    if not (torch.isfinite(u).all() and float(u.abs().max()) > 0):
        raise AssertionError(f"{tag} the state is not finite and nonzero")
    return {"u": u, "v": v, "t": t, "solve_s": solve, "rate": rate, "launches": launches}


def phase_s2(device, card) -> dict:
    """[16a] ``LinearSpectralS2`` on the HITU W-H101-WATER lattice (80, 47,
    47) cells, p = 4, fp32, the default Heaviside window on x1 in [-0.011,
    0.011] over the whole x = 0 face; 3 steps against the plain path, then
    S2_STEPS timed RK4 steps; [16g] the checkpoint round trip: S2_STEPS / 2
    steps, save, reset, load, S2_STEPS / 2 steps, equal bit for bit to the
    timed run."""
    import tempfile

    import torch

    import fenicsxfus_tpu_torch as ft
    from fenicsxfus_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    f0 = 0.5e6
    c0, rho0, p0, _, _, dt = water(f0)
    t0 = time.perf_counter()
    model = ft.LinearSpectralS2(hitu_box(HITU_GRID, 0.12, False), None, 4, c0, rho0, f0, p0,
                                c0, dtype=torch.float32, device=device)
    model.dt = dt
    model._build()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    say(f"[16] S2, HITU lattice: {model.number_of_dofs()} DOF, lattice {model.ops.gdims}, dt "
        f"{dt:.6e} s, source nodes {int((model.consts['src_vec'] != 0).sum())}, setup "
        f"{setup:.1f} s")
    explicit_against_plain(model, "[16] S2")
    run = timed_rk(model, S2_STEPS, "[16] S2", card)
    k1 = k1_on_model(model, ("coeff_u",), card, "[16] S2")

    # [16g] checkpoint round trip of the same run
    half = S2_STEPS // 2
    model.init()
    model.rk(0.0, half * dt)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "s2.npz")
        t_save = time.perf_counter()
        save_checkpoint(path, model)
        model.init()
        t = load_checkpoint(path, model)
        t_save = time.perf_counter() - t_save
    u, v, _ = model.rk(t, S2_STEPS * dt)
    torch.cuda.synchronize()
    same = torch.equal(u, run["u"]) and torch.equal(v, run["v"])
    say(f"[16] checkpoint: {half} + {half} steps through save/load (t = {t:.6e} s, save and "
        f"load {t_save:.2f} s) against {S2_STEPS} steps: equal bits {same}")
    if not same:
        raise AssertionError("[16] the checkpointed S2 run differs from the uninterrupted one")
    return {"solve_s": run["solve_s"], "rate": run["rate"], "launches": run["launches"],
            "k1": k1, "setup_s": setup}


def phase_sponge(device, card) -> dict:
    """[16b] ``LinearSpectralSponge`` on the HITU box extended to x = 0.15 m,
    SPONGE_GRID cells, p = 4, fp32, sponge from x = 0.12 m with δ0 =
    4·2c0/ω0 (the JAX gate's); 3 steps against the plain path, then
    S2_STEPS timed steps; the nodal δ apply's and K1's ms a stage."""
    import torch

    import fenicsxfus_tpu_torch as ft

    f0 = 0.5e6
    c0, rho0, p0, _, _, dt = water(f0)
    delta0 = 4.0 * 2 * c0 / (2 * np.pi * f0)
    t0 = time.perf_counter()
    model = ft.LinearSpectralSponge(hitu_box(SPONGE_GRID, SPONGE_L, True), None, 4, c0, rho0,
                                    delta0, f0, p0, c0, sponge_start=0.12,
                                    dtype=torch.float32, device=device)
    model.dt = dt
    model._build()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    ops = model.ops
    say(f"[16] sponge: {model.number_of_dofs()} DOF, lattice {ops.gdims}, delta0 "
        f"{delta0:.4e}, delta max {float(np.max(model.delta_nodal)):.4e}, setup {setup:.1f} s")
    explicit_against_plain(model, "[16] sponge")
    run = timed_rk(model, S2_STEPS, "[16] sponge", card)
    u, v = run["u"], run["v"]
    c = model.consts
    nodal_ms = cuda_median_ms(lambda: ops.stiffness_apply_nodal([v], [c["delta_scales"]]))
    k1_ms = cuda_median_ms(lambda: ops.stiffness_apply([u], [c["coeff_u"]]))
    stage_ms = cuda_median_ms(lambda: type(model).rhs_pure(ops, c, 1e-6, u, v))
    scales = nbytes(list(c["delta_scales"]))
    bound = floor_ms(nbytes(v) + scales, nbytes(v), 0)
    say(f"[16] sponge, a stage's slope {stage_ms:.3f} ms: the nodal delta apply "
        f"{nodal_ms:.3f} ms ({nodal_ms / stage_ms:.3f} of it; byte floor "
        f"{bound['bound_ms']:.3f} ms, {scales / 2**20:.0f} MiB of scales), K1 {k1_ms:.3f} ms "
        f"(median of 10, CUDA events; {card})")
    return {"solve_s": run["solve_s"], "rate": run["rate"], "launches": run["launches"],
            "nodal_ms": nodal_ms, "k1_ms": k1_ms, "stage_ms": stage_ms, "setup_s": setup}


def phase_newmark(device, card) -> dict:
    """[16c] ``LinearSpectralNewmark`` on bench.py's headline box (104^3
    cells, p = 4, 72,511,713 DOF), fp64, at bench.py's dt: NEWMARK_STEPS
    steps through ``newmark`` (K1 the CG matvec); then one step from a
    seeded random state through K1 and through ``ops.plain()``: the same
    CG iterations, the fields within 1e-9."""
    import torch

    import fenicsxfus_tpu_torch as ft
    from fenicsxfus_tpu_torch.ops.stiffness import stiffness_plain

    nx, degree, c0, rho0, f0, p0, L = HEADLINE_NX, 4, 1500.0, 1000.0, 0.5e6, 60000.0, 0.12
    t0 = time.perf_counter()
    mesh = ft.create_box((nx, nx, nx), (0, 0, 0), (L, L, L))
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > L - 1e-9})
    dt = 0.9 * (L / nx) / (c0 * degree**2)
    model = ft.LinearSpectralNewmark(mesh, None, degree, c0, rho0, f0, p0, c0, dt,
                                     device=device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    ndofs = model.number_of_dofs()
    say(f"[16] Newmark headline nx={nx}: {ndofs} DOF, fp64, dt {dt:.6e} s, cg_rtol "
        f"{model.cg_rtol:g}, setup {setup:.1f} s")
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    u, _, _, _ = model.newmark(0.0, NEWMARK_STEPS * dt)
    torch.cuda.synchronize()
    solve = time.perf_counter() - t0
    launches = counts()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    its = model.cg_stats["iterations"]
    k1 = launches["K1"]
    say(f"[16] {NEWMARK_STEPS} Newmark steps: {solve:.3f} s, {solve / NEWMARK_STEPS:.4f} s a "
        f"step; CG iterations a step: worst {max(its)}, mean {np.mean(its):.2f} ({its}); fp64 "
        f"K1 launches {k1}; device memory peak {peak_gib:.3f} GiB; max|u| "
        f"{float(u.abs().max()):.6e} ({card})")
    # per step: the predictor's apply, CG's initial residual, one per iteration
    if k1 != sum(its) + 2 * NEWMARK_STEPS or not torch.isfinite(u).all():
        raise AssertionError(f"[16] Newmark: K1 launched {k1} for CG iterations {its}")
    if any(launches[k] for k in ("K4a", "K4b") + STAGE_KERNELS):
        raise AssertionError(f"[16] Newmark launched another kernel: {launches}")
    del u
    k1_entry = k1_on_model(model, ("coeff_u",), card, "[16] Newmark")

    gen = torch.Generator(device=device).manual_seed(163)
    u0 = 1e-3 * torch.randn(ndofs, generator=gen, device=device, dtype=torch.float64)
    v0 = torch.randn(ndofs, generator=gen, device=device, dtype=torch.float64)
    w0 = torch.zeros_like(v0)
    plain = model.ops.plain()
    plain.stiffness_fn = _counting(stiffness_plain)
    sk, sp = [], []
    reset_counts()
    a = model.newmark_step(stats=sk)(model.consts, (u0, v0, w0, 0.0), dt)
    torch.cuda.synchronize()
    k1_step = counts()["K1"]
    b = model.newmark_step(ops=plain, stats=sp)(model.consts, (u0, v0, w0, 0.0), dt)
    torch.cuda.synchronize()
    worst = max(rel_err(x, y)[0] for x, y in zip(a[:3], b[:3]))
    say(f"[16] Newmark, one step from a random state, K1 against the plain stiffness: max rel "
        f"diff {worst:.3e} (gate 1e-9); CG iterations {sk[0][0]} against {sp[0][0]}, "
        f"stiffness applies {k1_step} against {plain.stiffness_fn.calls}")
    if not (worst <= 1e-9 and sk[0][0] == sp[0][0] and k1_step == plain.stiffness_fn.calls):
        raise AssertionError("[16] Newmark: the K1 step disagrees with the plain step")
    return {"launches": launches, "solve_s": solve, "setup_s": setup, "peak_gib": peak_gib,
            "its": its, "k1": k1_entry, "max_rel": worst}


def phase_adaptive(device, card) -> dict:
    """[16d] ``LinearSpectralAdaptive`` and ``WesterveltSpectralAdaptive`` on
    the HITU lattice (flat aperture), fp64, atol = rtol = 1e-9, over
    ADAPTIVE_PERIODS source periods: the first 5 attempts through K1 and
    through ``ops.plain()`` (the same accept/reject sequence, t and the
    fields within 1e-9), then the whole march, timed: attempts, accepted steps,
    K1 launches (7 an attempt)."""
    import torch

    import fenicsxfus_tpu_torch as ft

    f0 = 0.5e6
    c0, rho0, p0, delta0, beta0, _ = water(f0)
    tf = ADAPTIVE_PERIODS / f0
    out = {}
    for name in ("linear", "westervelt"):
        t0 = time.perf_counter()
        mesh = hitu_box(HITU_GRID, 0.12, True)
        if name == "linear":
            model = ft.LinearSpectralAdaptive(mesh, None, 4, c0, rho0, f0, p0, c0,
                                              device=device)
            keys = ("coeff_u",)
        else:
            model = ft.WesterveltSpectralAdaptive(mesh, None, 4, c0, rho0, delta0, beta0, f0,
                                                  p0, c0, device=device)
            keys = ("coeff_u", "coeff_v")
        model.init()
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        tag = f"[16] adaptive {name}"
        lk, lp = [], []
        uk, vk, tk, _ = model.adaptive(0.0, tf, max_steps=5, log=lk)
        up, vp, tp, _ = model.adaptive(0.0, tf, ops=model.ops.plain(), max_steps=5, log=lp)
        torch.cuda.synchronize()
        worst = max(rel_err(uk, up)[0], rel_err(vk, vp)[0])
        say(f"{tag}: {model.number_of_dofs()} DOF, fp64, setup {setup:.1f} s; 5 attempts, K1 "
            f"against the plain stiffness: accepted {[a for a, _ in lk]} against "
            f"{[a for a, _ in lp]}, t {tk:.6e} against {tp:.6e}, max rel diff {worst:.3e} "
            f"(gate 1e-9)")
        # t and dt follow each attempt's error norm, which the two paths round
        # apart in its last bits
        if not ([a for a, _ in lk] == [a for a, _ in lp] and abs(tk - tp) <= 1e-9 * tk
                and worst <= 1e-9):
            raise AssertionError(f"{tag}: the K1 attempts disagree with the plain attempts")
        del uk, vk, up, vp
        reset_counts()
        t0 = time.perf_counter()
        u, v, t, attempts = model.rk(0.0, tf)
        torch.cuda.synchronize()
        solve = time.perf_counter() - t0
        launches = counts()
        say(f"{tag}: {attempts} attempts, {model.naccepted} accepted, t = {t:.6e} s (tf "
            f"{tf:.6e}), {solve:.3f} s ({solve / attempts * 1e3:.2f} ms an attempt), fp64 K1 "
            f"launches {launches['K1']}, max|u| {float(u.abs().max()):.6e} ({card})")
        if not (launches["K1"] == 7 * attempts and t == tf and torch.isfinite(u).all()
                and float(u.abs().max()) > 0):
            raise AssertionError(f"{tag}: the march missed K1 or tf: {launches}")
        del u, v
        k1 = k1_on_model(model, keys, card, tag)
        out[name] = {"launches": launches, "solve_s": solve, "attempts": attempts,
                     "accepted": model.naccepted, "k1": k1, "setup_s": setup}
        del model
        torch.cuda.empty_cache()
    return out


def phase_gauss(device, card) -> dict:
    """[16e] ``LinearExplicit`` (Gauss quadrature, consistent mass, CG at
    every slope) on ``create_box((GAUSS_NX,)*3)`` over the unit box (the
    size of ``tools/unstructured_solve.py`` at nx = 54: 10,218,313 DOF),
    p = 4, fp64, the tool's medium, GAUSS_STEPS RK4 steps: CG iterations a
    slope, s a step; ``mass_apply`` and ``stiffness_apply`` timed beside
    their byte floors; the mass of a constant is the volume and its
    stiffness zero."""
    import torch

    import fenicsxfus_tpu_torch as ft

    nx, p, c0, rho0, f0 = GAUSS_NX, 4, 1.5, 1.0, 10.0
    t0 = time.perf_counter()
    mesh = ft.create_box((nx,) * 3, (0, 0, 0), (1.0, 1.0, 1.0))
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
    dt = 0.4 * (1.0 / nx) / (c0 * p**2)
    model = ft.LinearExplicit(mesh, None, p, c0, rho0, f0, 1.0, c0, 4, dt, device=device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    q, ops = model.qops, model.ops
    ndofs, nc = ops.ndofs, ops.num_cells
    say(f"[16] LinearExplicit: {ndofs} DOF, {nc} cells, nq = {q.nq}, fp64, dt {dt:.6e} s, "
        f"setup {setup:.1f} s")
    model.init()
    model.cg_log.clear()
    reset_counts()
    t0 = time.perf_counter()
    u, v, _ = model.rk(0.0, GAUSS_STEPS * dt)
    torch.cuda.synchronize()
    solve = time.perf_counter() - t0
    launches = counts()
    its = list(model.cg_log)
    say(f"[16] LinearExplicit {GAUSS_STEPS} RK4 steps: {solve:.3f} s, "
        f"{solve / GAUSS_STEPS:.3f} s a step; CG iterations a slope {its}; max|u| "
        f"{float(u.abs().max()):.6e} ({card})")
    if not (len(its) == 4 * GAUSS_STEPS and max(its) < model.cg_maxiter
            and torch.isfinite(u).all() and float(u.abs().max()) > 0):
        raise AssertionError("[16] LinearExplicit: a CG did not converge or the state is bad")
    if any(launches[k] for k in ("K1", "K4a", "K4b") + STAGE_KERNELS):
        raise AssertionError(f"[16] LinearExplicit launched a kernel: {launches}")
    ones = torch.ones(ndofs, dtype=torch.float64, device=device)
    vol = float(q.mass_apply(ones, model.mass_coeff).sum()) * rho0 * c0 * c0
    stiff0 = float(q.stiffness_apply([ones], [model.stiff_coeff]).abs().max())
    say(f"[16] LinearExplicit checks: volume by the consistent mass {vol:.15f} (1), stiffness "
        f"of a constant {stiff0:.3e}")
    if not (abs(vol - 1.0) < 1e-12 and stiff0 < 1e-9):
        raise AssertionError("[16] the Gauss operators fail the constant checks")
    del u, v, ones
    gen = torch.Generator(device=device).manual_seed(165)
    x = torch.randn(ndofs, generator=gen, device=device, dtype=torch.float64)
    mass_ms = cuda_median_ms(lambda: q.mass_apply(x, model.mass_coeff))
    stiff_ms = cuda_median_ms(lambda: q.stiffness_apply([x], [model.stiff_coeff]))
    N, nq = p + 1, q.nq
    # index maps read once: the gather's int32 dofmap, the fold's int32
    # table and int64 DOF list
    idx = 2 * 4 * nc * N**3 + 8 * ndofs
    # one evaluation at the Gauss lattice (three contractions) and its
    # transpose, 2 operations a multiply-add
    contract = 2 * 2 * nc * (nq * N**3 + nq**2 * N**2 + nq**3 * N)
    mass_floor = floor_ms(8 * ndofs + 8 * nc + nbytes(q.wdetJ) + idx, 8 * ndofs,
                          contract + nc * nq**3, FP64_FLOP_PER_S)
    stiff_floor = floor_ms(8 * ndofs + 8 * nc + nbytes(q.G) + idx, 8 * ndofs,
                           3 * contract + 2 * 9 * nc * nq**3, FP64_FLOP_PER_S)
    say(f"[16] LinearExplicit at {ndofs} DOF, fp64: mass_apply {mass_ms:.3f} ms, "
        f"{share_text(mass_floor, mass_ms)}; stiffness_apply {stiff_ms:.3f} ms, "
        f"{share_text(stiff_floor, stiff_ms)} (median of 10, CUDA events; {card})")
    return {"solve_s": solve, "its": its, "mass_ms": mass_ms, "stiff_ms": stiff_ms,
            "setup_s": setup}


def phase_family_gates(device) -> dict:
    """[16f] the CPU tests' gates of these models, on the card in fp64
    (1D and 2D: torch ops on the device): the problems of Newmark 1D,
    adaptive linear and Westervelt and Gauss LinearExplicit over the first
    GATE_DEPTH of each horizon, the card against the CPU (1e-7 through a
    CG, 1e-6 through the step-size control); the S2 window (near > 10
    far), the sponge's damping (deep < 0.5 inside), the sponge on an
    unstructured mesh equal to the lattice (1e-10)."""
    import torch

    import fenicsxfus_tpu_torch as ft
    from fenicsxfus_tpu_torch.core.mesh import Mesh
    from fenicsxfus_tpu_torch.models.experimental import heaviside_window

    f0, c0, L = 10.0, 1.0, 1.0
    f64 = dict(dtype=torch.float64, device=device)

    def interval(epw):
        nx = int(epw * (L * f0 / c0) + 1)
        mesh = ft.create_interval(nx, 0.0, L)
        ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
        return mesh, L / nx

    h4 = interval(4)[1]
    depth_cases = {  # name: (model on a device, march to t -> u, horizon, gate)
        "Newmark 1D (4,4)": (
            lambda dev: ft.LinearSpectralNewmark(interval(4)[0], None, 4, c0, 4.0, f0, 4.0, c0,
                                                 0.25 * h4 / (c0 * 16), device=dev),
            lambda m, t: m.newmark(0.0, t)[0], L / c0 + 16 / f0, 1e-7),
        "adaptive linear 1D": (
            lambda dev: ft.LinearSpectralAdaptive(interval(4)[0], None, 4, c0, 4.0, f0, 4.0, c0,
                                                  device=dev),
            lambda m, t: m.rk(0.0, t)[0], L / c0 + 16 / f0, 1e-6),
        "adaptive Westervelt 1D": (
            lambda dev: ft.WesterveltSpectralAdaptive(interval(8)[0], None, 4, c0, 1.0, 0.0,
                                                      0.01, f0, 1.0, c0, device=dev,
                                                      atol=1e-8, rtol=1e-8),
            lambda m, t: m.rk(0.0, t)[0], L / c0 + 8 / f0, 1e-6),
        "Gauss LinearExplicit 1D (4,4)": (
            lambda dev: ft.LinearExplicit(interval(4)[0], None, 4, c0, 4.0, f0, 4.0, c0, 4,
                                          0.9 * h4 / (c0 * 16), device=dev),
            lambda m, t: m.rk(0.0, t)[0], L / c0 + 16 / f0, 1e-7),
    }

    def s2_window():
        mesh = ft.create_rectangle((20, 10), (0, -0.5), (1.0, 0.5))
        ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
        m = ft.LinearSpectralS2(mesh, None, 3, c0, 1.0, f0, 1.0, c0,
                                source_profile=heaviside_window(-0.1, 0.1, axis=1), **f64)
        u, _, _ = m.init().rk4(0.0, 0.2, 0.5 * 0.05 / (c0 * 9))
        x, un = m.ops.space.dof_coords, u.abs().cpu().numpy()
        near = un[(np.abs(x[:, 1]) < 0.08) & (x[:, 0] < 0.15)].max()
        far = un[(np.abs(x[:, 1]) > 0.35) & (x[:, 0] < 0.15)].max()
        return max(far, 1e-12) / near, 0.1  # near > 10 far

    def sponge_damping():
        mesh = ft.create_interval(40, 0.0, 0.2)
        ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 0.2 - 1e-12})
        fs, cs = 0.5e6, 1500.0
        m = ft.LinearSpectralSponge(mesh, None, 4, cs, 1.0, 2 * cs / (2 * np.pi * fs) * 4.0, fs,
                                    1.0, cs, sponge_start=0.12, **f64)
        u, _, _ = m.init().rk4(0.0, 0.25 / fs * 200, 0.25 * (0.2 / 40) / (cs * 16))
        x, un = m.ops.space.dof_coords[:, 0], u.abs().cpu().numpy()
        return un[x > 0.19].max() / un[x < 0.10].max(), 0.5  # deep < 0.5 inside

    def sponge_unstructured():
        fs, cs, Lx = 0.5e6, 1500.0, 0.2
        mesh_s = ft.create_rectangle((20, 5), (0, 0), (Lx, 0.05))
        perm = np.random.default_rng(3).permutation(mesh_s.num_vertices)
        v2 = np.empty_like(mesh_s.vertices)
        v2[perm] = mesh_s.vertices
        dt = 0.25 * (Lx / 20) / (cs * 16)
        sols = []
        for mesh in (mesh_s, Mesh(dim=2, vertices=v2, cells=perm[mesh_s.cells])):
            ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > Lx - 1e-12})
            m = ft.LinearSpectralSponge(mesh, None, 4, cs, 1.0, 2 * cs / (2 * np.pi * fs) * 4.0,
                                        fs, 1.0, cs, sponge_start=0.12, **f64)
            u, _, _ = m.init().rk4(0.0, 60 * dt, dt)
            x = m.ops.space.dof_coords
            sols.append(u.cpu().numpy()[np.lexsort((x[:, 1], x[:, 0]))])
        return np.abs(sols[1] - sols[0]).max() / np.abs(sols[0]).max(), 1e-10

    out = {name: card_against_cpu("[16]", name, make, march, tend, gate, device)["rel"]
           for name, (make, march, tend, gate) in depth_cases.items()}
    for name, gate_fn in (("S2 window 2D, far/near", s2_window),
                          ("sponge 1D, deep/inside", sponge_damping),
                          ("sponge unstructured against lattice", sponge_unstructured)):
        t0 = time.perf_counter()
        value, gate = gate_fn()
        torch.cuda.synchronize()
        say(f"[16] gate {name} on the card: {value:.3e} (gate < {gate:g}), "
            f"{time.perf_counter() - t0:.2f} s")
        if not value < gate:
            raise AssertionError(f"[16] gate {name}: {value:.3e} >= {gate:g}")
        out[name] = value
    return out


def phase_family(device, card) -> dict:
    """[16]: the rest of the model family on the card: (a) S2 with (g) its
    checkpoint round trip, (b) the sponge, (c) Newmark, (d) the adaptive
    models, (e) LinearExplicit, (f) the gates."""
    import torch

    t_phase = time.perf_counter()
    out = {}
    for key, fn in (("s2", phase_s2), ("sponge", phase_sponge), ("newmark", phase_newmark),
                    ("adaptive", phase_adaptive), ("gauss", phase_gauss)):
        out[key] = fn(device, card)
        torch.cuda.empty_cache()
        say(f"[16] {key} done at {time.perf_counter() - t_phase:.1f} s")
    out["gates"] = phase_family_gates(device)
    say(f"[16] done in {time.perf_counter() - t_phase:.1f} s")
    return out



# ---------------- [17] native geometry, the reference-scale HITU runs, PH1, fp32 drift

HITU_RESULTS = ROOT / "benchmarks" / "hitu" / "results"
PH1_RESULTS = ROOT / "benchmarks" / "ph1" / "results"
# W-H131-WATER at 1.1 MHz (W-H131-WATER/main.cpp): nx = 164 at p = 4,
# (657, 361, 361) nodes, 7488 RK4 steps
FULL_NX, FULL_DOF, FULL_STEPS = 164, 85_620_897, 7488
# the HITU variants besides W-H101-WATER ([7]), at ``hitu.run``'s defaults
VARIANTS = (("W", "H131", "WATER"), ("W", "H101", "LIVER"), ("W", "H131", "LIVER"),
            ("V", "H131", "WATER"))
# one PH1 case a K2 route: linear with the facet source, lossy on a flat
# DG-0 skull, focused on a curved DG-0 skull, and p = 5 (the general tile)
PH1_CASES = {(1, 1): "linear", (1, 4): "lossy", (2, 6): "focused", (2, 7): "focused"}


def k2_on_model(model, card, tag) -> dict:
    """K2 against its plain version on ``model``'s own operands: one RK4
    step from its state through ``model.fused_step(stage_fn=probe)``, where
    ``probe`` runs ``stage_apply`` and ``stage_plain`` on each stage's
    operands (the model's lattice, packed coefficients, dense and facet
    vectors, the stage fields and, on a hybrid lattice, the band), holds
    them together (TOL; TOL64 in fp64) and times the
    first non-final stage and the final one beside their bounds. Returns
    those two stages' numbers by "non-final" and "final"."""
    import torch

    from fenicsxfus_tpu_torch.models.common import run_steps
    from fenicsxfus_tpu_torch.ops.stage import stage_apply, stage_plain

    out = {}

    def probe(kind, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final, band=None):
        args = dict(kind=kind, u0=u0, v0=v0, kvp=kvp, kvpp=kvpp, prev=prev, Fs=Fs, dense=dense,
                    facets=facets, scal=scal, p=p, final=final)
        if band is not None:
            args["band"] = band
        launch = ("K2" if band is None else "K2+band", kind)
        (got, kernel), ref = _took(lambda: stage_apply(**args)), stage_plain(**args)
        torch.cuda.synchronize()
        worst = max(rel_err(a, b) for a, b in (zip(got, ref) if final else [(got, ref)]))
        stage = "final" if final else "non-final"
        coeff = "DG-0" if any(F["F0"].shape[0] > 1 for F in Fs) else "const"
        gate = TOL64 if u0.dtype == torch.float64 else TOL
        if not worst[0] <= gate:
            raise AssertionError(f"{tag} K2 {kind} {stage} disagrees with its plain version: "
                                 f"{worst[0]:.3e} > {gate}")
        if stage not in out:
            del ref
            ms = cuda_median_ms(lambda: stage_apply(**args))
            pms = cuda_median_ms(lambda: stage_plain(**args))
            bound = stage_floor(args, "K2")
            say(f"{tag} K2 {kind} p={p} at {tuple(u0.shape)}, the model's {coeff} operands, "
                f"{stage}: max|d|/max|ref| = {worst[0]:.3e}; kernel {ms:.3f} ms, plain "
                f"{pms:.3f} ms, {share_text(bound, ms)} (median of 10, CUDA events; {card}); "
                f"tile plan {plan_line(tuple(u0.shape), p, len(Fs), len(Fs) + 2, u0.dtype, launch)}"
                f", {kernel}")
            out[stage] = {"max_abs_err": worst[1], "rel_err": worst[0], "ms": ms,
                          "plain_ms": pms, "coeff": coeff, "gdims": tuple(u0.shape),
                          "kernel": kernel, **bound}
        return got

    gd = model.ops.gdims
    run_steps(model.fused_step(stage_fn=probe), model.consts, model.u_n.view(gd),
              model.v_n.view(gd), model.t, [model.dt])
    torch.cuda.synchronize()
    return out


def k2_fp64_on_model(model, tag) -> dict:
    """K2 in fp64 against ``stage_plain`` on ``model``'s reached state: the
    operands of the first non-final stage of one RK4 step from it (fields,
    packed coefficients, dense and facet vectors) cast to float64, both
    held together to TOL64. Where they agree, K2's fp32 gap to its plain
    version on the same operands is the rounding of fp32, not a fault."""
    import torch

    from fenicsxfus_tpu_torch.models.common import run_steps
    from fenicsxfus_tpu_torch.ops.stage import stage_apply, stage_plain

    def f64(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.double()
        if isinstance(x, dict):
            return {k: f64(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(f64(v) for v in x)
        return x

    out = {}

    def probe(kind, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final, band=None):
        args = dict(kind=kind, u0=u0, v0=v0, kvp=kvp, kvpp=kvpp, prev=prev, Fs=Fs, dense=dense,
                    facets=facets, scal=scal, p=p, final=final)
        if band is not None:
            args["band"] = band
        if not final and not out:
            a64 = f64(args)
            got32, ref32 = stage_apply(**args), stage_plain(**args)
            got, ref = stage_apply(**a64), stage_plain(**a64)
            torch.cuda.synchronize()
            rel, err = rel_err(got, ref)
            rel32 = rel_err(got32, ref32)[0]
            say(f"{tag} K2 {kind} fp64 on the reached state's first non-final stage operands: "
                f"max|d|/max|ref| = {rel:.3e} (gate {TOL64:g}); the same stage in fp32 "
                f"{rel32:.3e}")
            if not rel <= TOL64:
                raise AssertionError(f"{tag} fp64 K2 disagrees with stage_plain: {rel:.3e}")
            out.update(rel=rel, max_abs_err=err, rel32=rel32)
            del a64, got, ref, got32, ref32
        return stage_apply(**args)

    gd = model.ops.gdims
    run_steps(model.fused_step(stage_fn=probe), model.consts, model.u_n.view(gd),
              model.v_n.view(gd), model.t, [model.dt])
    torch.cuda.synchronize()
    return out


def fused_against_unfused(model, tag: str, kind: str, pipe: Pipeline = ONE_KERNEL) -> float:
    """3 steps from the model's state through the fused step and through
    the unfused step (its stiffness through ``pipe``'s stiffness kernels
    once a stage): max rel diff <= 1e-4."""
    import torch

    from fenicsxfus_tpu_torch.models.common import run_steps

    gd = model.ops.gdims
    u, v, t, dts = model.u_n, model.v_n, model.t, [model.dt] * 3
    uk, vk, _ = run_steps(model.fused_step(), model.consts, u.view(gd), v.view(gd), t, dts)
    reset_counts()
    uu, vu, _ = run_steps(model.unfused_step(), model.consts, u.reshape(-1), v.reshape(-1), t,
                          dts)
    torch.cuda.synchronize()
    unfused = counts()
    worst = max(rel_err(uk.reshape(-1), uu)[0], rel_err(vk.reshape(-1), vu)[0])
    say(f"{tag} 3 steps, fused path vs unfused path: max rel diff {worst:.3e} (gate 1e-4); "
        f"unfused launches {unfused}")
    if not worst <= 1e-4:
        raise AssertionError(f"{tag} fused path disagrees with the unfused path: {worst:.3e}")
    pipe.check(unfused, kind, 0, stiffness_launches=4 * len(dts))
    return worst


def driven(tag: str, card, device, kind: str, fn):
    """Run ``fn()`` (a driver's run) as a main path: memory peak and counts
    from 0 just before, read just after; K2 ``kind`` 4 times a step and no
    other kernel. Prints setup s, solve s, the rate, the memory peak and
    the launches; returns (the run, a summary)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    res = fn()
    torch.cuda.synchronize()
    launches = counts()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    ndofs = res.model.number_of_dofs()
    rate = ndofs * res.nsteps / res.solve_s / 1e9
    say(f"{tag} {ndofs} DOF, p={res.model.degree}, {res.nsteps} RK4 steps, setup "
        f"{res.setup_s:.2f} s, solve {res.solve_s:.3f} s, {rate:.4f} GDOF-RK4-updates/s, device "
        f"memory peak {peak_gib:.3f} GiB, K2 launches {launches['K2']} ({card})")
    ONE_KERNEL.check_model(res.model)
    ONE_KERNEL.check(launches, kind, res.nsteps, stiffness_launches=0)
    if not np.all(np.isfinite(res.amplitude)):
        raise AssertionError(f"{tag} the axial amplitude is not finite")
    return res, {"ndofs": ndofs, "degree": res.model.degree, "nsteps": res.nsteps,
                 "setup_s": res.setup_s,
                 "solve_s": res.solve_s, "rate": rate, "peak_gib": peak_gib,
                 "launches": launches["K2"].get(kind, 0), "peak_pa": float(np.max(res.amplitude)),
                 "x_pk": float(res.x[int(np.argmax(res.amplitude))])}


def held(tag: str, res, npz: Path) -> dict:
    """``hitu.check_artifact`` of a run against a committed run; raises on
    a miss (2%, ±1 sensor)."""
    from fenicsxfus_tpu_torch.drivers.hitu import check_artifact

    print(tag, end="")
    chk = check_artifact(res, npz)
    if not chk["ok"]:
        raise AssertionError(f"{tag} focal peak misses {npz.name} (2%, ±1 sensor): {chk}")
    return chk


def phase_native(card) -> dict:
    """[17a] the native geometry library against the numpy workers
    (``FUS_NATIVE=0``) on the H101 bowl mesh at nx = 80, p = 4."""
    from fenicsxfus_tpu_torch import native
    from fenicsxfus_tpu_torch.core.geometry import quadrature_factors
    from fenicsxfus_tpu_torch.core.gll import gll_points_weights_01
    from fenicsxfus_tpu_torch.drivers import hitu

    t0 = time.perf_counter()
    path = native.build()
    native.library()
    t_build = time.perf_counter() - t0
    mesh, _ = hitu.bowl_mesh("H101", 80)
    x1, w1 = gll_points_weights_01(5)
    t0 = time.perf_counter()
    nat = quadrature_factors(mesh, x1, w1)
    t_native = time.perf_counter() - t0
    with environment({"FUS_NATIVE": "0"}):
        t0 = time.perf_counter()
        ref = quadrature_factors(mesh, x1, w1)
        t_workers = time.perf_counter() - t0
    rel = max(float(np.max(np.abs(a - b)) / np.max(np.abs(b))) for a, b in zip(nat, ref))
    say(f"[17a] native geometry ({path.name}, built or found in {t_build:.2f} s): "
        f"quadrature_factors of the H101 bowl mesh, {mesh.num_cells} cells x {nat[0].shape[1]} "
        f"points: native {t_native:.3f} s, FUS_NATIVE=0 workers {t_workers:.3f} s (host "
        f"clock, {os.cpu_count()} cores); max|d|/max|ref| = {rel:.3e} (gate 1e-12)")
    if mesh.num_cells != 176_720 or not rel <= 1e-12:
        raise AssertionError(f"[17a] native factors disagree with the workers: {rel:.3e}")
    return {"native_s": t_native, "workers_s": t_workers, "rel": rel}


def phase_full(device, card) -> dict:
    """[17b] W-H131-WATER at 1.1 MHz, the reference-scale problem, through
    ``drivers.hitu.run(..., nx=164, full=True)``; held against the JAX
    package's run, 3 steps fused against unfused, its harmonics, and K2 at
    this lattice against its plain version."""
    import tempfile

    from fenicsxfus_tpu_torch.drivers import harmonics, hitu

    with tempfile.TemporaryDirectory() as tmp:  # the run's waveforms, read back
        out = os.path.join(tmp, "w_h131_water_full11MHz.npz")
        res, run = driven("[17b] HITU W-H131-WATER 1.1 MHz:", card, device, "focused",
                          lambda: hitu.run("W", "H131", "WATER", nx=FULL_NX, full=True, out=out,
                                           device=device))
        say("[17b] harmonics of the 31 stations (drivers/harmonics.py; the gate is reported, "
            "not asserted: the committed gate is a p = 5 run)")
        gate = harmonics.analyze(out)["gate"]
    say(f"[17b] harmonics gate at p = 4: {gate}")
    if (run["ndofs"], run["nsteps"]) != (FULL_DOF, FULL_STEPS):
        raise AssertionError(f"[17b] not the reference-scale problem: {run}")
    run["check"] = held("[17b]", res, HITU_RESULTS / "w_h131_water_full11MHz.npz")
    run["unfused"] = fused_against_unfused(res.model, "[17b]", "focused")
    run["k2"] = k2_on_model(res.model, card, "[17b]")
    del res
    return run


def phase_variants(device, card) -> dict:
    """[17c] the four other HITU variants at ``hitu.run``'s defaults, each held
    against its committed run; the orderings of
    ``tests/test_hitu.py::test_h131_production_artifacts`` on the port's
    own peaks; the H131 O'Neil check at 0.45 MHz."""
    from fenicsxfus_tpu_torch.drivers import hitu

    out = {}
    for kind, tx, medium in VARIANTS:
        name = f"{kind}-{tx}-{medium}"
        res, run = driven(f"[17c] HITU {name}:", card, device, "focused",
                          lambda: hitu.run(kind, tx, medium, device=device))
        run["check"] = held(f"[17c] {name}", res,
                            HITU_RESULTS / f"{kind.lower()}_{tx.lower()}_{medium.lower()}.npz")
        out[name] = run
        del res
    peaks = {k: (v["peak_pa"], v["x_pk"]) for k, v in out.items()}
    for name in ("W-H131-WATER", "W-H131-LIVER", "V-H131-WATER"):
        pk, xpk = peaks[name]
        if not (0.015 < xpk < 0.045 and 1e6 < pk < 3e7):
            raise AssertionError(f"[17c] {name}: peak {pk:.4e} Pa at {xpk} m")
    if not (peaks["W-H131-WATER"][0] > peaks["V-H131-WATER"][0]
            and peaks["W-H131-WATER"][0] > peaks["W-H131-LIVER"][0]):
        raise AssertionError(f"[17c] the H131 orderings fail: {peaks}")
    say("[17c] H131 orderings hold: W-water > V-water and W-water > W-liver, each peak in "
        "15-45 mm and 1-30 MPa")
    t0 = time.perf_counter()
    gain, pos, prof = hitu.validate_oneil("H131", f0=0.45e6, nx=64, device=device)
    ref = json.loads(str(np.load(HITU_RESULTS / "oneil_h131_0.45mhz.npz")["meta"]))
    say(f"[17c] O'Neil H131 0.45 MHz nx=64 ({time.perf_counter() - t0:.1f} s): gain error "
        f"{gain*100:.3f}%, position error {pos*1e3:.3f} mm, focal L2 {prof*100:.3f}%; JAX "
        f"package's run: {ref['gain_err']*100:.3f}%, {ref['pos_err_mm']:.3f} mm, "
        f"{ref['profile_err']*100:.3f}% (gates 8%, 2.25 mm, 10%)")
    if not (gain < 0.08 and pos <= 2.25e-3 + 1e-12 and prof < 0.10):
        raise AssertionError("[17c] H131 O'Neil gate failed")
    return out


def phase_ph1(device, card) -> dict:
    """[17d] PH1 at nx = 80: SC1-BM1 (the piston oracle's gates of
    ``tests/test_ph1.py``), SC1-BM4 (the 1D transmission gate), SC2-BM6,
    SC2-BM7 (p = 5); each peak held against its committed run, and K2 at
    each case's lattice and coefficients against its plain version. The
    committed runs read each sensor at its nearest node (they predate the
    JAX package's interpolation of off-node sensors), so these runs do too
    (``ph1.run(..., snap=True)``)."""
    from fenicsxfus_tpu_torch.analysis.analytical import piston_axial_amplitude
    from fenicsxfus_tpu_torch.drivers import ph1

    out, profiles = {}, {}
    for (sc, bm), kind in PH1_CASES.items():
        tag = f"[17d] PH1 SC{sc}-BM{bm}:"
        # each sensor at its nearest node: the committed runs' sampling
        res, run = driven(tag, card, device, kind,
                          lambda: ph1.run(sc, bm, device=device, snap=True))
        run["check"] = held(tag, res, PH1_RESULTS / f"sc{sc}_bm{bm}.npz")
        x, amp = res.x, res.amplitude
        profiles[(sc, bm)] = run["profile"] = (x, amp)
        if (sc, bm) == (1, 1):
            c0 = 1500.0
            lam, k = c0 / ph1.F0, 2 * np.pi * ph1.F0 / c0
            i_pk = int(np.argmax(amp))
            z_last = ph1.SC1_RADIUS**2 / lam
            gain = abs(amp[i_pk] - 2 * ph1.P0) / (2 * ph1.P0)
            far = x > 0.08
            ref = piston_axial_amplitude(x, ph1.SC1_RADIUS, k, ph1.P0)
            l2 = np.linalg.norm(amp[far] - ref[far]) / np.linalg.norm(ref[far])
            say(f"{tag} piston oracle: last axial maximum at {x[i_pk]*1e3:.2f} mm (a^2/lambda "
                f"{z_last*1e3:.2f} mm, gate 3 mm), peak {amp[i_pk]:.4e} Pa against 2 p0 "
                f"({gain*100:.2f}%, gate 10%), far field (x > 80 mm) rel-L2 {l2:.4f} (gate 0.15)")
            if not (abs(x[i_pk] - z_last) < 3e-3 and gain < 0.1 and l2 < 0.15):
                raise AssertionError(f"{tag} the piston oracle's gates fail")
        if (sc, bm) == (1, 4):
            xw, ampw = profiles[(1, 1)]
            print(tag, end="")
            tc = ph1.transmission_check(sc, bm, x, amp, xw, ampw)
            ref = json.loads((PH1_RESULTS / "validation_sc1_bm4.json").read_text())
            say(f"{tag} JAX package's run: measured {ref['transmission_1d']['measured']:.4f}, "
                f"rel {ref['transmission_1d']['rel']:.4f} (gate 0.35)")
            if not tc["pass"]:
                raise AssertionError(f"{tag} the 1D transmission gate fails: {tc}")
            run["transmission"] = tc
        run["k2"] = k2_on_model(res.model, card, tag)
        out[(sc, bm)] = run
        del res
    return out


# Launch-bound card runs that hold no timing: [17e]'s two fp32-drift runs
# and [19i]'s three convergence runs run as side jobs, each in its own
# process, while [18a] runs (the scripts are launch-bound too, and no
# timed tool runs until the side jobs have ended).
VALIDATE_NX = (40, 56)  # [20c]: the nx pair of the PH1 stamp (a side job, under 60 s)
SIDE_JOBS = ("drift:linear", "drift:westervelt", "convergence:20", "convergence:28",
             "convergence:36", "slab:2", f"validate:{VALIDATE_NX[0]}-{VALIDATE_NX[1]}",
             "grid:4", "unstructured:2")


def side_worker(job: str, path: str) -> None:
    """One side job in its own process (``python -c "import chip_smoke;
    chip_smoke.side_worker(job, path)"``): ``fp32_drift.drift`` of a kind
    to 8000 steps, ``bowl_convergence.main`` at one nx, [20b]'s slab runs
    (``slab_job``), [20c]'s PH1 stamp (``validate_job``) or [21b]'s grid
    runs and dry run (``grid_job``) or unstructured runs
    (``unstructured_job``), on the card,
    with the launch counts from 0 just before it and read just after; the
    result, seconds and counts saved as JSON to ``path`` (written under
    another name, then renamed into place)."""
    import torch

    what, arg = job.split(":")
    torch.set_num_threads(1)  # five side jobs share the host with [18a]
    reset_counts()
    t0 = time.perf_counter()
    if what == "drift":
        from fenicsxfus_tpu_torch.tools import fp32_drift

        out = {"rows": fp32_drift.drift(8000, arg, "cuda")[0]}
    elif what == "slab":
        out = {"rows": slab_job(int(arg), path + ".k1.pt"), "operands": path + ".k1.pt"}
    elif what == "validate":
        out = validate_job(*(int(n) for n in arg.split("-")))
    elif what == "grid":
        out = grid_job(int(arg), path + ".k1.pt")
    elif what == "unstructured":
        out = {"rows": unstructured_job(int(arg))}
    else:
        from fenicsxfus_tpu_torch.drivers import bowl_convergence

        out = {"res": bowl_convergence.main(nx=arg, device="cuda")}
    torch.cuda.synchronize()
    out.update(seconds=time.perf_counter() - t0, launches=counts())
    Path(path + ".part").write_text(json.dumps(out))
    os.replace(path + ".part", path)


class SideJobs:
    """``SIDE_JOBS``, one process each (``side_worker``), started on entry
    and ended (killed if still running) on exit; ``wait()`` waits for all of
    them and raises if one failed; ``result(job)`` is its saved result."""

    def __init__(self, jobs=SIDE_JOBS):
        self.jobs, self.results = jobs, {}

    def __enter__(self):
        import tempfile

        self.tmp = tempfile.TemporaryDirectory()
        self.procs = {}
        for job in self.jobs:
            name = job.replace(":", "_")
            log = open(os.path.join(self.tmp.name, name + ".log"), "w")
            path = os.path.join(self.tmp.name, name + ".json")
            proc = subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.side_worker({job!r}, "
                 f"{path!r})"], cwd=ROOT, stdout=subprocess.DEVNULL, stderr=log,
                env={**os.environ, "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
                     "MKL_NUM_THREADS": "1"})
            self.procs[job] = (proc, log, path)
        return self

    def wait(self, timeout: float = 900.0) -> None:
        t0 = time.perf_counter()
        for job, (proc, log, path) in self.procs.items():
            rc = proc.wait(timeout=max(timeout - (time.perf_counter() - t0), 1.0))
            log.flush()
            if rc != 0 or not os.path.exists(path):
                with open(log.name) as f:
                    raise RuntimeError(f"side job {job} failed (exit {rc}):\n{f.read()[-3000:]}")
            self.results[job] = json.loads(Path(path).read_text())

    def result(self, job: str) -> dict:
        return self.results[job]

    def __exit__(self, *exc):
        for proc, log, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()
        self.tmp.cleanup()
        return False


def phase_drift(side: SideJobs, device) -> dict:
    """[17e] ``tools/fp32_drift.py`` on the card, linear and Westervelt, to
    8000 steps (the side jobs ``drift:linear`` and ``drift:westervelt``),
    with ``tests/test_fp32_drift.py``'s gates, beside the JAX package's
    committed tables; no kernel (a 2D lattice)."""
    import torch

    from fenicsxfus_tpu_torch.tools import fp32_drift

    out = {}
    for kind, table in (("linear", "fp32_drift.txt"), ("westervelt", "fp32_drift_westervelt.txt")):
        res = side.result(f"drift:{kind}")
        rows, seconds = [tuple(r) for r in res["rows"]], res["seconds"]
        ref = np.loadtxt(ROOT / "benchmarks" / table)
        say(f"[17e] fp32 drift, {kind} ({seconds:.1f} s in a side process, "
            f"{torch.cuda.get_device_name(device)}): steps, drift_l2, drift_max, err fp64, err "
            "fp32 | the JAX package's table")
        for r, j in zip(rows, ref):
            say(f"[17e]   {r[0]:5d}  {r[1]:.4e}  {r[2]:.4e}  {r[3]:.4e}  {r[4]:.4e} | "
                f"{int(j[0]):5d}  {j[1]:.4e}  {j[2]:.4e}  {j[3]:.4e}  {j[4]:.4e}")
        fails = fp32_drift.gates(rows, kind)
        if fails:
            raise AssertionError(f"[17e] {kind} drift gates fail: {fails}")
        c = res["launches"]
        if c["K1"] or any(c[k] for k in ("K4a", "K4b") + STAGE_KERNELS):
            raise AssertionError(f"[17e] {kind}: a kernel ran on the 2D lattice: {c}")
        out[kind] = {"drift_l2": {r[0]: r[1] for r in rows}, "seconds": seconds}
    say("[17e] drift gates hold: drift_l2 < 1e-4 from 7488 steps on (both), err32 < 2 err64 "
        "(linear)")
    return out


def phase_production(device, card) -> dict:
    """[17]: (a) native geometry, (b) the 1.1 MHz run, (c) the other HITU
    variants, (d) PH1; (e), fp32 drift, runs as side jobs during [18a]."""
    t_phase = time.perf_counter()
    out = {"native": phase_native(card)}
    say(f"[17a] done at {time.perf_counter() - t_phase:.1f} s")
    out["full"] = phase_full(device, card)
    say(f"[17b] done at {time.perf_counter() - t_phase:.1f} s")
    out["variants"] = phase_variants(device, card)
    say(f"[17c] done at {time.perf_counter() - t_phase:.1f} s")
    out["ph1"] = phase_ph1(device, card)
    say(f"[17d] done at {time.perf_counter() - t_phase:.1f} s")
    say(f"[17] done in {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------- [18] the examples, experiments, MENDOUSSE and the speed tools

# Each ported script (module under fenicsxfus_tpu_torch, keyword arguments):
# the card's run through ``main`` at the script's width and dtype over the
# fraction RUN of its horizon (a depth cut where the whole horizon does not
# fit the script's time limit: the 1D/2D scripts are launch-bound, 1-16 ms
# a step on the card, with the host's speed), then the card's and the CPU's
# runs in fp64 over the fraction HELD, held together (the CPU's in a worker
# process while the card runs); HELD None where the script's own gate at
# its whole horizon holds it instead (the bowl's O'Neil gain: three setups
# of its 2.46M-DOF mesh cost 40 s). (module, kwargs, RUN, HELD)
SCRIPTS = (
    ("examples.linear_planewave1d", {}, 0.005, 0.004),
    ("examples.linear_planewave1d", {"hetero": True}, 0.003, 0.002),
    ("examples.linear_planewave1d_imp", {}, 0.05, 0.05),
    ("examples.linear_planewave1d_newmark", {}, 0.1, 0.1),
    ("examples.westervelt_planewave1d", {}, 0.01, 0.01),
    ("examples.linear_planewave2d", {}, 0.05, 0.001),
    ("examples.linear_planar2d", {}, 0.05, 0.001),
    ("examples.lossy_planewave2d", {}, 0.03, 0.0005),
    ("examples.westervelt_planewave2d", {}, 0.008, 0.0002),
    ("examples.westervelt_planar2d", {}, 0.005, 0.0001),
    ("examples.lossy_planar2d_heterogeneous", {}, 0.012, 0.0003),
    ("examples.westervelt_planar2d_heterogeneous", {}, 0.012, 0.0003),
    ("examples.linear_planewave2d_windowed", {}, 0.05, 0.001),
    ("examples.linear_planewave2d_sponge", {}, 0.012, 0.0003),
    ("examples.linear_scattering2d", {}, 1.0, 0.005),
    ("examples.linear_planewave2d_imp", {}, 0.03, 0.0025),
    ("examples.linear_planar2d_imp", {}, 0.03, 0.0025),
    ("examples.lossy_planewave2d_imp", {}, 0.03, 0.0025),
    ("examples.lossy_planar2d_imp", {}, 0.03, 0.0025),
    ("examples.linear_planewave3d", {}, 1.0, 0.005),
    ("examples.linear_bowl3d", {}, 1.0, None),
    ("experiments.exp1_windowing", {}, 0.1, 0.1),
    ("experiments.exp2_p_convergence", {}, 0.02, 0.02),
    ("experiments.exp3_source_conformity", {}, 1.0, 0.1),
    ("experiments.exp4_rk_order", {}, 0.02, 0.02),
    ("experiments.exp5_delta_stiffness", {}, 0.02, 0.02),
    ("drivers.mendousse", {"quick": True}, 0.02, 0.02),
)
# HELD reaches a few steps into a 2D script's horizon, before the wave leaves
# the source face. So each 2D script is also held at its CPU test's size
# (tests/test_torch_examples.py: epw 1, p 1 or 2), card against CPU in fp64
# over the whole horizon, where the wave crosses the domain and the ABC, the
# Westervelt term, the media and the sponge act. (module, kwargs)
SMALL = tuple((f"examples.{name}", {"epw": 1, "degree": degree}) for name, degree in (
    ("linear_planewave2d", 2), ("linear_planar2d", 2), ("lossy_planewave2d", 2),
    ("westervelt_planewave2d", 2), ("westervelt_planar2d", 1),
    ("lossy_planar2d_heterogeneous", 1), ("westervelt_planar2d_heterogeneous", 1),
    ("linear_planewave2d_windowed", 2), ("linear_planewave2d_sponge", 1),
    ("linear_planewave2d_imp", 2), ("linear_planar2d_imp", 2), ("lossy_planewave2d_imp", 2),
    ("lossy_planar2d_imp", 2)))
CPU_THREADS = 4  # the CPU worker's torch threads (the card's process keeps the rest)
# need a mesh file of the reference's (``--mesh``), which the card's machine
# does not hold: held on the CPU only (tests/test_torch_examples.py)
CPU_ONLY = ("examples.linear_from_reference_mesh",
            "examples.linear_planewave2d_sponge_unstructured")
SCATTER_GATE = 0.05  # the ring's steady amplitudes against the exact series
ONEIL_GATE = 0.08  # the bowl's focal gain against O'Neil's (drivers.hitu.validate_oneil's)


def script_key(name: str, kwargs: dict) -> str:
    """The script and its arguments as its command line gives them."""
    return name + "".join(f" --{k}" if v is True else f" --{k} {v}" for k, v in kwargs.items())


def script_fields(res: dict) -> dict:
    """The fields a script's ``main`` returned, by name: the final u (of
    each run, for the experiments), the sensor traces and exp4's reference."""
    import torch

    out = {}
    for key in ("u", "u_ref", "ys"):
        val = res.get(key)
        if isinstance(val, dict):
            out.update({f"{key}[{k}]": v for k, v in val.items()})
        elif val is not None:
            out[key] = torch.as_tensor(val)
    for i, (delta, frac, u) in enumerate(res.get("runs", ())):
        out[f"run {i} (delta {delta:g}, dt/dt0 {frac:g})"] = u
    return out


def script_gate(name: str, res: dict, depth: float) -> str:
    """The script's own gate, where it has one and ran its whole horizon
    (the scattering ring and the bowl's O'Neil gain; the other scripts are
    held against the CPU); raises on a miss, returns its line."""
    if depth != 1.0:
        return ""
    if name == "examples.linear_scattering2d":
        ok, line = res["err"] < SCATTER_GATE, f"ring error {res['err']:.4f} (gate {SCATTER_GATE})"
    elif name == "examples.linear_bowl3d":
        ok = res["gain_err"] < ONEIL_GATE
        line = (f"O'Neil focal gain error {res['gain_err'] * 100:.3f}% (gate "
                f"{ONEIL_GATE * 100:g}%), peak at {res['x_peak'] * 1e3:.1f} mm")
    else:
        return ""
    if not ok:
        raise AssertionError(f"[18a] {name}: the script's gate fails: {line}")
    return line


def fused_against_plain(model, tag: str, steps: int = 3) -> float:
    """``steps`` fused RK steps from the model's state through its stage
    kernels and through ``stage_plain`` (the band formed alike): max rel
    diff <= TOL (fp32) or TOL64."""
    import torch

    from fenicsxfus_tpu_torch.models.common import run_steps
    from fenicsxfus_tpu_torch.ops.stage import stage_plain

    gd = model.ops.gdims
    u, v, dts = model.u_n.view(gd), model.v_n.view(gd), [model.dt] * steps
    uk, vk, _ = run_steps(model.fused_step(), model.consts, u, v, model.t, dts)
    up, vp, _ = run_steps(model.fused_step(stage_fn=stage_plain), model.consts, u, v, model.t,
                          dts)
    torch.cuda.synchronize()
    worst = max(rel_err(uk, up)[0], rel_err(vk, vp)[0])
    gate = TOL64 if model.dtype == torch.float64 else TOL
    say(f"{tag} {steps} more steps, the stage kernel against stage_plain: max rel diff "
        f"{worst:.3e} (gate {gate:g})")
    if not worst <= gate:
        raise AssertionError(f"{tag} the kernel path disagrees with the plain path: {worst:.3e}")
    return worst


def check_script_launches(tag, model, launches) -> None:
    """Raise unless a 3D model ran its stage kernel (K2, with or without a
    band) a whole number of RK4 steps and no kernel but it and K1, and a
    1D/2D one (or a script without a model) no kernel."""
    ran = {k: v for k, v in launches.items() if v}
    if model is not None and model.ops.d == 3:
        n = sum(sum(launches[k].values()) for k in ("K2", "K2+band"))
        if not (n and n % 4 == 0 and set(ran) <= {"K2", "K2+band", "K1"}):
            raise AssertionError(f"{tag} expected the stage kernel 4 times a step: {launches}")
    elif ran:
        raise AssertionError(f"{tag} a kernel ran on a 1D/2D lattice: {ran}")


def run_script(name, kwargs, depth, device, tmp, dtype=None):
    """``main`` of the ported script ``name`` on ``device`` over ``depth`` of
    its horizon, its files under ``tmp``: (its dict, host seconds)."""
    import importlib
    import inspect

    import torch

    main = importlib.import_module(f"fenicsxfus_tpu_torch.{name}").main
    kw = dict(kwargs, depth=depth, device=device)
    params = inspect.signature(main).parameters
    if "out" in params:
        kw["out"] = os.path.join(tmp, name.split(".")[-1])
    if dtype is not None and "dtype" in params:
        kw["dtype"] = dtype
    t0 = time.perf_counter()
    res = main(**kw)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def cpu_worker() -> None:
    """The CPU process of ``phase_scripts`` (``python -c "import chip_smoke;
    chip_smoke.cpu_worker()"``): reads (jobs, directory) pickled on stdin,
    runs each job's script in fp64 on the CPU over its depth, and saves its
    fields and host seconds to ``held<i>.pt`` in the directory (written
    under another name, then renamed into place)."""
    import pickle

    import torch

    jobs, tmp = pickle.load(sys.stdin.buffer)
    torch.set_num_threads(CPU_THREADS)
    for i, (name, kwargs, depth) in enumerate(jobs):
        res, secs = run_script(name, kwargs, depth, "cpu", os.path.join(tmp, "cpu"),
                               torch.float64)
        path = os.path.join(tmp, f"held{i}.pt")
        torch.save((script_fields(res), secs), path + ".part")
        os.replace(path + ".part", path)


class CpuRuns:
    """The CPU's fp64 runs of ``jobs`` ((name, kwargs, depth) each) in one
    worker process (``cpu_worker``), started on entry and ended (killed if
    still running) on exit; ``get(i)`` waits for job i's (fields, seconds)."""

    def __init__(self, jobs, tmp):
        self.jobs, self.tmp = jobs, tmp

    def __enter__(self):
        import pickle

        os.mkdir(os.path.join(self.tmp, "cpu"))
        self.log = open(os.path.join(self.tmp, "cpu_worker.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.cpu_worker()"], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, stderr=self.log)
        self.proc.stdin.write(pickle.dumps((self.jobs, self.tmp)))
        self.proc.stdin.close()
        return self

    def get(self, i: int, timeout: float = 600.0):
        import torch

        path = os.path.join(self.tmp, f"held{i}.pt")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if self.proc.poll() is not None or time.perf_counter() - t0 > timeout:
                self.log.flush()
                with open(self.log.name) as f:
                    tail = f.read()[-3000:]
                raise RuntimeError(f"[18a] the CPU worker gave no result for {self.jobs[i][0]} "
                                   f"(exit {self.proc.poll()}):\n{tail}")
            time.sleep(0.05)
        return torch.load(path)

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            if exc[0] is None:
                self.proc.wait(timeout=60)
            else:
                self.proc.kill()
        self.proc.wait()
        self.log.close()
        return False


def phase_script(name, kwargs, run_depth, held_depth, device, card, tmp, cpu) -> dict:
    """[18a] one ported script: its run on the card (counts from 0 just
    before, read just after: in 3D its stage kernel 4 times a step and no
    other, in 1D and 2D no kernel, as the JAX package has none there), its
    fields finite and its ``.npz`` written and read back, its own gate; a 3D
    model 3 more steps against the plain path; then the card against the CPU
    in fp64 over ``held_depth`` (1e-10, or 1e-7 through a CG's stopping
    test): ``cpu()`` waits for the CPU worker's run (None when the
    script's gate holds it instead). A script that runs fp64 whatever the device
    (no ``dtype`` argument) and whose two depths are equal is held on its
    first run."""
    import torch

    import importlib
    import inspect

    tag = f"[18a] {script_key(name, kwargs)}:"
    reset_counts()
    res, secs = run_script(name, kwargs, run_depth, device, tmp)
    launches = counts()
    model = res.get("model")
    fields = script_fields(res)
    for key, f in fields.items():  # (exp5's unstable runs may overflow, as they should)
        f = torch.as_tensor(f)
        if not (bool(torch.isfinite(f).all()) or key.startswith("run ")):
            raise AssertionError(f"{tag} {key} is not finite")
    if model is not None and model.device.type != torch.device(device).type:
        raise AssertionError(f"{tag} ran on {model.device}")
    steps = script_steps(model)
    ran = {k: v for k, v in launches.items() if v}
    say(f"{tag} {run_depth:g} of its horizon on the card in {secs:.2f} s{steps}, "
        f"{'' if model is None else str(model.dtype).split('.')[-1]}, launches {ran} ({card})")
    check_script_launches(tag, model, launches)
    for path in res.get("paths", []):
        if path.endswith(".npz") and not np.all(np.isfinite(np.load(path)["u"])):
            raise AssertionError(f"{tag} {path} does not hold a finite u")
    gate_line = script_gate(name, res, run_depth)
    if gate_line:
        say(f"{tag} gate: {gate_line}")
    out = {"seconds": secs, "depth": run_depth, "launches": ran, "gate": gate_line}
    if model is not None and model.ops.d == 3:
        out["plain"] = fused_against_plain(model, tag)
    cg = hasattr(model, "cg_stats")
    if held_depth is None:
        if not gate_line:
            raise AssertionError(f"{tag} neither held against the CPU nor by its gate")
        return out
    # the card against the CPU, both fp64, over held_depth
    main = importlib.import_module(f"fenicsxfus_tpu_torch.{name}").main
    if held_depth == run_depth and "dtype" not in inspect.signature(main).parameters:
        fk, sk, held_steps = fields, secs, steps
    else:
        rk, sk = run_script(name, kwargs, held_depth, device, tmp, torch.float64)
        fk, held_steps = script_fields(rk), script_steps(rk.get("model"))
        del rk
    del res, model, fields
    torch.cuda.empty_cache()
    out.update(against_cpu(tag, f"{held_depth:g} of its horizon{held_steps}", fk, sk, cg, cpu))
    return out


def script_steps(model) -> str:
    return "" if model is None else f", {int(round(model.t / model.dt))} steps"


def against_cpu(tag, span, fk, sk, cg, cpu) -> dict:
    """The card's fp64 fields ``fk`` (``sk`` s) against the CPU worker's run
    of the same problem (``cpu()`` waits for it): max rel diff <= 1e-10, or
    1e-7 through a CG's stopping test."""
    import torch

    fc, sc = cpu()
    gate = 1e-7 if cg else 1e-10
    worst = 0.0
    for key, uc in fc.items():
        if bool(torch.isfinite(uc).all()):
            worst = max(worst, rel_err(torch.as_tensor(fk[key]).cpu(), uc)[0])
    say(f"{tag} fp64, {span}: card {sk:.2f} s, CPU {sc:.2f} s, max|d|/max|u| over "
        f"{len(fc)} field(s) = {worst:.3e} (gate {gate:g})")
    if set(fk) != set(fc) or not worst <= gate:
        raise AssertionError(f"{tag} the card's run differs from the CPU's: {worst:.3e}")
    return {"held": worst, "held_s": (sk, sc)}


def phase_small(name, kwargs, device, tmp, cpu) -> dict:
    """[18a] a 2D script at its CPU test's size (``SMALL``) over its whole
    horizon in fp64 on the card (no kernel, as in 2D at any size), held
    against the CPU worker's run."""
    import torch

    tag = f"[18a] {script_key(name, kwargs)}:"
    reset_counts()
    res, secs = run_script(name, kwargs, 1.0, device, tmp, torch.float64)
    model = res["model"]
    check_script_launches(tag, model, counts())
    if model.device.type != torch.device(device).type or model.dtype != torch.float64:
        raise AssertionError(f"{tag} ran on {model.device} in {model.dtype}")
    span = f"its whole horizon{script_steps(model)}"
    return against_cpu(tag, span, script_fields(res), secs, hasattr(model, "cg_stats"), cpu)


def phase_scripts(device, card) -> dict:
    """[18a] every ported example and experiment and MENDOUSSE, then the 2D
    examples at their CPU tests' size (``SMALL``); the CPU's runs in one
    worker process (``CpuRuns``: all queued at the start, ended before this
    returns or raises)."""
    import tempfile

    out = {}
    held = [i for i, (_, _, _, depth) in enumerate(SCRIPTS) if depth is not None]
    jobs = [(SCRIPTS[i][0], SCRIPTS[i][1], SCRIPTS[i][3]) for i in held]
    jobs += [(name, kwargs, 1.0) for name, kwargs in SMALL]
    with tempfile.TemporaryDirectory() as tmp, CpuRuns(jobs, tmp) as cpu:
        for i, (name, kwargs, run_depth, held_depth) in enumerate(SCRIPTS):
            job = (lambda j=held.index(i): cpu.get(j)) if i in held else None
            out[script_key(name, kwargs)] = phase_script(name, kwargs, run_depth, held_depth,
                                                         device, card, tmp, job)
        for j, (name, kwargs) in enumerate(SMALL, start=len(held)):
            out[script_key(name, kwargs)] = phase_small(name, kwargs, device, tmp,
                                                        lambda j=j: cpu.get(j))
    say(f"[18a] left out on the card: {', '.join(CPU_ONLY)} (they need a mesh file of the "
        "reference's, given by --mesh, which this machine does not hold; held on the CPU by "
        "tests/test_torch_examples.py)")
    return out


def phase_operator_speed(device, card) -> dict:
    """[18b] ``tools/operator_speed.py`` at its defaults (about 38.3M DOF,
    p = 2..6), K1 and then K4a -> K4b (``FUS_V3=0``), constant and DG-0
    coefficients, each apply held against the plain one (TOL) before it is
    timed; the K1 kernel's own entry for each degree (constant coefficient:
    error, CUDA-event times of the kernel and the plain apply, bound)."""
    import torch

    from fenicsxfus_tpu_torch.ops.stiffness import stiffness_apply, stiffness_plain
    from fenicsxfus_tpu_torch.tools import operator_speed

    out = {"rows": [], "k1": {}}
    for degree in (2, 3, 4, 5, 6):
        s = operator_speed.setup(degree, device=device)
        for env, kernels in (({"FUS_V3": "1"}, ("K1",)), ({"FUS_V3": "0"}, ("K4a", "K4b"))):
            with environment(env):
                reset_counts()
                rows = operator_speed.rows(s)
                launches = counts()
            if kernels == ("K1",):
                k1_launches = launches["K1"]
            for r in rows:
                say(f"[18b] {operator_speed.row_text(r)} ({card})")
                if r["rel"] is not None and not r["rel"] <= TOL:
                    raise AssertionError(f"[18b] {r['op']} p={degree} disagrees with the plain "
                                         f"apply: {r['rel']:.3e}")
            if not all(launches[k] for k in kernels):
                raise AssertionError(f"[18b] p={degree}: {kernels} did not launch: {launches}")
            out["rows"] += rows
        x, F, p = s["x"], s["coeffs"]["const"], degree
        with uncounted():
            (y, kernel), ref = (_took(lambda: stiffness_apply([x], [F], p)),
                                stiffness_plain([x], [F], p))
        err = rel_err(y, ref)[1]
        del y, ref
        k1 = next(r for r in out["rows"] if r["degree"] == degree and r["pipeline"] == "K1")
        out["k1"][degree] = {"max_abs_err": err, "ms": k1["ms"], "kernel": kernel,
                             "plain_ms": cuda_median_ms(lambda: stiffness_plain([x], [F], p)),
                             "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
                             "gdims": s["ops"].gdims, "launches": k1_launches}
        del s, x, F
        torch.cuda.empty_cache()
    return out


def phase_stage_attrib(device, card) -> dict:
    """[18c] ``tools/stage_attrib.py`` at its default (the headline lattice,
    417³): K2 ``linear`` with 0, 1 and 2 slope operands, each held against
    ``stage_plain`` (TOL) before it is timed."""
    from fenicsxfus_tpu_torch.tools import stage_attrib

    reset_counts()
    res = stage_attrib.main(device=device)
    launches = counts()["K2"].get("linear", 0)
    for r in res["rows"]:
        if not r["rel"] <= TOL:
            raise AssertionError(f"[18c] {r['name']} disagrees with stage_plain: {r['rel']:.3e}")
    if not launches:
        raise AssertionError("[18c] K2 did not launch")
    say(f"[18c] K2 launches {launches}, each held against stage_plain ({card})")
    return res


def phase_solver_speed(device, card) -> dict:
    """[18d] ``tools/solver_speed.py`` at its defaults (nx = 104, 72.5M DOF,
    101 RK4 steps) for the linear, lossy and Westervelt models: K2 of the
    model's kind 4 times a step (the probe step, the warm-up step and the
    101) and no other kernel; then, from the reached state, 3 more steps
    through K2 against ``stage_plain`` (TOL)."""
    import torch

    from fenicsxfus_tpu_torch.tools import solver_speed

    out = {}
    for model in ("linear", "lossy", "westervelt"):
        reset_counts()
        res = solver_speed.main(model=model, device=device)
        launches = counts()
        ONE_KERNEL.check(launches, model, res["steps"] + 2, stiffness_launches=0)
        say(f"[18d] {model}: K2 launches {launches['K2']} ({card})")
        out[model] = {k: v for k, v in res.items() if k not in ("u", "eqn")}
        out[model]["plain"] = fused_against_plain(res["eqn"], f"[18d] {model} at 417³:")
        del res
        torch.cuda.empty_cache()
    return out


def phase_hybrid_speed(device, card) -> dict:
    """[18e] ``tools/hybrid_speed.py`` at its defaults (H101 bowl mesh,
    nx = 80): lattice (K1), hybrid (K1 + K6) and band (K6), the hybrid apply
    equal to the lattice's plus the band's (TOL)."""
    from fenicsxfus_tpu_torch.tools import hybrid_speed

    reset_counts()
    res = hybrid_speed.main(device=device)
    if not (res["rel"] <= TOL and counts()["K1"]):
        raise AssertionError(f"[18e] hybrid apply != lattice + band: {res['rel']:.3e}")
    say(f"[18e] done ({card})")
    return res


def phase_slice(device, card, side: SideJobs) -> dict:
    """[18]: (a) the examples, experiments and MENDOUSSE, while the side jobs
    run; then, once they have ended, [17e]'s report; (b) operator_speed, (c)
    stage_attrib, (d) solver_speed, (e) hybrid_speed."""
    import torch

    t_phase = time.perf_counter()
    out = {}
    for key, fn in (("scripts", phase_scripts), ("operator", phase_operator_speed),
                    ("stage", phase_stage_attrib), ("solver", phase_solver_speed),
                    ("hybrid", phase_hybrid_speed)):
        out[key] = fn(device, card)
        torch.cuda.empty_cache()
        say(f"[18] {key} done at {time.perf_counter() - t_phase:.1f} s")
        if key == "scripts":
            side.wait()
            say(f"[18] the side jobs ended at {time.perf_counter() - t_phase:.1f} s")
            out["drift"] = phase_drift(side, device)
    say(f"[18] done in {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------------------------------- [19] the benchmark scripts


@contextlib.contextmanager
def uncounted():
    """Launches made in the block (a kernel held against its plain version)
    do not count: after it every launch count is what it was before it."""
    from fenicsxfus_tpu_torch.ops import stage, stage_ab, step_wave, stiffness

    saved = counts()
    tiles = {fn: dict(fn.tiles) for fn in (stiffness.stiffness_apply, stage.stage_apply)}
    try:
        yield
    finally:
        for fn, saved_tiles in tiles.items():
            fn.tiles.clear()
            fn.tiles.update(saved_tiles)
        stiffness.stiffness_apply.launches = saved["K1"]
        stiffness.stiffness_axis0_apply.launches = saved["K4a"]
        stiffness.stiffness_axes12_apply.launches = saved["K4b"]
        for counter, key in ((stage.stage_apply.launches, "K2"),
                             (stage.stage_apply.band_launches, "K2+band"),
                             (stage_ab.stage_a_apply.launches, "K5a"),
                             (stage_ab.stage_b_apply.launches, "K5b"),
                             (step_wave.step_wave_apply.launches, "K3")):
            counter.clear()
            counter.update(saved[key])


def k1_lattice(grid, dtype, card, tag) -> dict:
    """K1 (p = 4, one field, constant coefficient) on ``grid`` cells of a
    seeded random field against its plain version (TOL, TOL64 in fp64):
    error, CUDA-event times and the bound."""
    import torch

    from fenicsxfus_tpu_torch.ops.stiffness import pack_const, stiffness_apply, stiffness_plain

    lat = _lattice(grid, 4, dtype)
    dev = torch.device("cuda", 0)
    x = torch.randn(lat.gdims, generator=torch.Generator(device=dev).manual_seed(19),
                    device=dev, dtype=dtype)
    F = pack_const(lat, 1.0, dev)
    y, kernel = _took(lambda: stiffness_apply([x], [F], 4))
    rel, err = rel_err(y, stiffness_plain([x], [F], 4))
    del y
    ms = cuda_median_ms(lambda: stiffness_apply([x], [F], 4))
    pms = cuda_median_ms(lambda: stiffness_plain([x], [F], 4))
    rate = FP64_FLOP_PER_S if dtype == torch.float64 else FP32_FLOP_PER_S
    bound = floor_ms(nbytes(x, F), nbytes(x), stencil_flops(lat.gdims, 4, 1, (0, 1, 2)), rate)
    say(f"{tag} K1 {str(dtype).split('.')[-1]} at {lat.gdims}: max|dy|/max|y| = {rel:.3e}; "
        f"kernel {ms:.3f} ms, plain {pms:.3f} ms, {share_text(bound, ms)} (median of 10, CUDA "
        f"events; {card})")
    if not rel <= (TOL64 if dtype == torch.float64 else TOL):
        raise AssertionError(f"{tag} K1 disagrees with its plain version: {rel:.3e}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, "gdims": lat.gdims, "kernel": kernel,
            **bound}


def no_stage_kernel(tag, launches) -> None:
    """Raise if the counts ``launches`` show a kernel other than K1."""
    if any(launches[k] for k in ("K4a", "K4b") + STAGE_KERNELS):
        raise AssertionError(f"{tag} a kernel other than K1 ran: {launches}")


def phase_setup_speed(device, card) -> dict:
    """[19a] ``tools/setup_speed.py`` at its defaults (104³ cells, p = 4,
    72,511,713 DOF): twice in this process, then once as a file in a fresh
    process (its imports include torch); each phase's spread over the
    three."""
    import tempfile

    import torch

    from fenicsxfus_tpu_torch.tools import setup_speed

    runs = []
    for _ in range(2):
        runs.append(dict(setup_speed.main(device=device)["rows"]))
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "setup.json"
        proc = subprocess.run([sys.executable, str(ROOT / "fenicsxfus_tpu_torch" / "tools" /
                                                   "setup_speed.py"), "--out", str(out)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"[19a] setup_speed.py in a fresh process failed:\n"
                                 f"{proc.stderr[-2000:]}")
        runs.append(dict(json.loads(out.read_text())["rows"]))
    for name in setup_speed.PHASES + ("total",):
        ts = [sum(r.values()) if name == "total" else r[name] for r in runs]
        say(f"[19a] setup {name}: {' / '.join(f'{t:.3f}' for t in ts)} s (in process, in "
            f"process, fresh process); max/min {max(ts) / max(min(ts), 1e-9):.2f}")
    return {"runs": runs}


def phase_phase_breakdown(device, card) -> dict:
    """[19b] ``tools/phase_breakdown.py`` at 417³ (its default), linear,
    lossy and Westervelt, each model built once, the fused step's slope
    over 10 and 20 steps (the script's default 20 and 40: a depth cut): the
    rows beside their bounds, the fused step held against the unfused one
    (1e-4) after 3 steps from the reached state; on each model, K2 against
    its plain version on the model's own operands (``k2_on_model``), and
    for the linear one K1 with its coefficient (``k1_on_model``) and K2 in
    fp64 on the reached state (``k2_fp64_on_model``), uncounted."""
    from fenicsxfus_tpu_torch.tools import phase_breakdown

    held = {}

    def hold(kind, model):
        held[kind] = {"launches": counts()}
        with uncounted():
            held[kind]["k2"] = k2_on_model(model, card, f"[19b] {kind} at 417³:")
            if kind == "linear":
                held[kind]["k1"] = k1_on_model(model, type(model).STIFF_KEYS, card,
                                               "[19b] linear at 417³:")
                held[kind]["k2_fp64"] = k2_fp64_on_model(model, "[19b] linear at 417³:")
        reset_counts()

    reset_counts()
    res = phase_breakdown.main(device=device, steps=10, hold=hold)
    for kind, r in res.items():
        c = held[kind]["launches"]
        k2 = c["K2"].get(kind, 0)
        say(f"[19b] {kind}: " + ", ".join(
            f"{name} {'not measured' if v['ms'] is None else format(v['ms'], '.3f')} ms (share "
            f"{'-' if v['share'] is None else format(v['share'], '.3f')})"
            for name, v in r["rows"].items())
            + f"; fused vs unfused {r['held']:.3e}; launches K2 {k2}, K1 {c['K1']} ({card})")
        if not r["held"] <= 1e-4:
            raise AssertionError(f"[19b] {kind}: fused and unfused steps disagree: {r['held']:.3e}")
        if not (k2 and k2 % 4 == 0 and c["K1"]) or set(c["K2"]) != {kind}:
            raise AssertionError(f"[19b] {kind}: unexpected launches {c}")
        r["launches"] = c
    return {"rows": res, "held": held}


def phase_wave_attrib(device, card) -> dict:
    """[19c] ``tools/wave_attrib.py`` at its defaults (417³, linear, under
    ``FUS_STEP_WAVE=1``): K3 chained, the model's step through its loop and
    through a plain loop, and four K2; K3 against its plain version on the
    model's own operands and first step table (uncounted), timed beside its
    bound; K3 against four K2 after 10 steps."""
    import torch

    from fenicsxfus_tpu_torch.ops.step_wave import (
        step_wave_apply, step_wave_check, step_wave_plain,
    )
    from fenicsxfus_tpu_torch.tools import wave_attrib

    k3 = {}

    def hold(model, args):
        with uncounted():
            got, ref = step_wave_apply(**args), step_wave_plain(**args)
            step_wave_check()
            rel, err = max(rel_err(a, b) for a, b in zip(got, ref))
            del got, ref
            ms = cuda_median_ms(lambda: step_wave_apply(**args))
            pms = cuda_median_ms(lambda: step_wave_plain(**args))
            step_wave_check()
            bound = wave_floor(args)
            say(f"[19c] K3 linear at {tuple(args['u0'].shape)}, the model's operands: max|d|/"
                f"max|ref| = {rel:.3e}; kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                f"{share_text(bound, ms)} (median of 10, CUDA events; {card})")
            if not rel <= TOL:
                raise AssertionError(f"[19c] K3 disagrees with its plain version: {rel:.3e}")
            k3.update(max_abs_err=err, ms=ms, plain_ms=pms, **bound)

    reset_counts()
    res = wave_attrib.main(device=device, hold=hold)
    torch.cuda.synchronize()
    launches = counts()
    say(f"[19c] K3 against four K2 after {res['chain']} steps: {res['k3_vs_k2']:.3e}; launches "
        f"K3 {launches['K3']}, K2 {launches['K2']} ({card})")
    if not (res["k3_vs_k2"] <= TOL and launches["K3"].get("linear") and launches["K2"]):
        raise AssertionError(f"[19c] K3 and four K2: {res['k3_vs_k2']:.3e}, {launches}")
    return {**res, "k3": k3, "launches": launches}


def phase_unstructured_speed(device, card) -> dict:
    """[19d] ``tools/unstructured_speed.py`` at nx = 28, p = 4 (1,442,897
    DOF) with ``shuffle``, ``reorder`` and ``with_segsum``: the cell routes,
    the fold, the segment sum, the CSR fold and the apply against the
    oracle held together (1e-5) before the parts are timed; K1 (the lattice
    row) the only kernel, then held against its plain version at 113³."""
    import torch

    from fenicsxfus_tpu_torch.tools import unstructured_speed

    assert_no_tf32()
    reset_counts()
    res = unstructured_speed.main(nx=28, with_segsum=True, shuffle=True, reorder=True,
                                  device=device)
    launches = counts()
    no_stage_kernel("[19d]", launches)
    worst = max(res["held"].values())
    say(f"[19d] {res['ndofs']} DOF, {res['num_cells']} cells: parts held together, worst "
        f"{worst:.3e} (gate 1e-5); apply / K1 per DOF {res['ratio']:.3f}; K1 launches "
        f"{launches['K1']} ({card})")
    if not (worst <= 1e-5 and launches["K1"]):
        raise AssertionError(f"[19d] held {res['held']}, launches {launches}")
    with uncounted():
        k1 = k1_lattice((28, 28, 28), torch.float32, card, "[19d] lattice row:")
    return {**res, "k1": {**k1, "launches": launches["K1"]}}


def phase_unstructured_trace(device, card) -> dict:
    """[19e] ``tools/unstructured_trace.py`` at its defaults (nx = 24,
    912,673 DOF, 6 steps a window): the general path, no kernel; the
    profiled window's device operations."""
    import torch

    from fenicsxfus_tpu_torch.tools import unstructured_trace

    reset_counts()
    res = unstructured_trace.main(device=device)
    launches = counts()
    no_stage_kernel("[19e]", launches)
    u = res.pop("u")
    say(f"[19e] {res['ndofs']} DOF, {res['step_kind']} step: {res['ms_step']:.3f} ms a step, "
        f"{res['rate']:.4f} GDOF-RK4-steps/s; device busy {res['busy_ms']:.3f} of "
        f"{res['profiled_wall_ms']:.3f} ms profiled; K1 launches {launches['K1']} ({card})")
    if launches["K1"] or res["step_kind"] != "unfused" or not res["ops"]:
        raise AssertionError(f"[19e] expected the general path without kernels: {launches}")
    if not (bool(torch.isfinite(u).all()) and float(u.abs().max()) > 0):
        raise AssertionError("[19e] the state is not finite and nonzero")
    return res


# the blend sweep's whole grid at a coarser mesh, and two of its points at
# the script's default nx = 64 (each point builds a bowl mesh and its
# hybrid operators on the host)
SWEEP_COARSE_NX, SWEEP_NX = 16, 64
SWEEP_POINTS = {"blends": "2,5", "holds": "0.25"}


def phase_blend_sweep(device, card) -> dict:
    """[19f] ``tools/bowl_blend_sweep.py``: the 4 × 3 grid at nx = 16, then
    blend 2 and 5 sags at hold 0.25 at nx = 64 ((64, 37, 37) cells,
    5,705,657 DOF); K1 (+ K6) in ``estimate_stable_dt``, then K1 held
    against its plain version at the nx = 64 lattice."""
    import torch

    from fenicsxfus_tpu_torch.tools import bowl_blend_sweep

    out = {}
    for nx, kw in ((SWEEP_COARSE_NX, {}), (SWEEP_NX, SWEEP_POINTS)):
        reset_counts()
        res = bowl_blend_sweep.main(nx=nx, device=device, **kw)
        launches = counts()
        no_stage_kernel("[19f]", launches)
        built = [r for r in res["rows"] if "failed" not in r]
        say(f"[19f] nx = {nx}: {len(built)} of {len(res['rows'])} points built, best "
            f"{res['best'] and (res['best']['mb'], res['best']['mh'])}; K1 launches "
            f"{launches['K1']} ({card})")
        if not built or launches["K1"] != 41 * len(built):
            raise AssertionError(f"[19f] nx = {nx}: {launches}")
        if not all(np.isfinite(r["ratio"]) and r["ratio"] > 0 for r in built):
            raise AssertionError("[19f] a dt ratio is not finite and positive")
        out[nx] = {**res, "launches": launches["K1"]}
    with uncounted():
        k1 = k1_lattice((SWEEP_NX, 37, 37), torch.float32, card, "[19f] the nx = 64 bowl lattice:")
    out["k1"] = {**k1, "launches": out[SWEEP_NX]["launches"]}
    return out


def phase_bowl_spectrum(device, card) -> dict:
    """[19g] ``tools/bowl_spectrum.py`` at its defaults (H101, nx = 64):
    the band cells' power iteration in fp64 on the card, no kernel."""
    from fenicsxfus_tpu_torch.tools import bowl_spectrum

    reset_counts()
    res = bowl_spectrum.main(device=device)
    launches = counts()
    no_stage_kernel("[19g]", launches)
    s = res["summary"]
    say(f"[19g] {res['band_cells']} band cells: λ/λ_uniform max {s['max']:.4f}, p99 "
        f"{s['p99']:.4f}, median {s['median']:.4f}, implied clamp {s['clamp']:.4f}; host and "
        "device s " + ", ".join(f"{k} {v:.2f}" for k, v in res["seconds"].items()) + f" ({card})")
    if launches["K1"] or not all(np.isfinite(v) and v > 0 for v in s.values()):
        raise AssertionError(f"[19g] {s}, {launches}")
    return {k: v for k, v in res.items() if k != "rel"}


def phase_sc1_bm1(device, card) -> dict:
    """[19h] ``drivers/ph1_sc1_bm1.py`` at its defaults (nx = 60, 241³ =
    13,997,521 DOF, two crossings at cfl 0.5: 3840 RK4 steps, fp32; the JAX
    script's cfl 0.9 diverges): K1 4 times a step and no other
    kernel; then K1 with the model's coefficient and 3 steps from a random
    state held against the plain path (uncounted)."""
    from fenicsxfus_tpu_torch.drivers import ph1_sc1_bm1

    reset_counts()
    res = ph1_sc1_bm1.main(device=device)
    launches = counts()
    no_stage_kernel("[19h]", launches)
    eqn = res.pop("eqn")
    say(f"[19h] {res['ndofs']} DOF, {res['nsteps']} RK4 steps: setup {res['setup_s']:.2f} s, "
        f"solve {res['solve_s']:.3f} s, {res['rate']:.4f} GDOF-RK4-updates/s; K1 launches "
        f"{launches['K1']}; axial |p| max {np.max(np.abs(res['values'])):.6e} Pa ({card})")
    if launches["K1"] != 4 * res["nsteps"]:
        raise AssertionError(f"[19h] expected K1 4 times a step: {launches}")
    with uncounted():
        k1 = k1_on_model(eqn, ("coeff_u",), card, "[19h] at 241³:")
        explicit_against_plain(eqn, "[19h]")
    return {**res, "k1": {**k1, "launches": launches["K1"], "gdims": eqn.ops.gdims}}


CONVERGENCE_GATE = 1e-6  # the card's fp64 runs against the JAX package's, absolute


def phase_bowl_convergence(device, card, side: SideJobs) -> dict:
    """[19i] ``drivers/bowl_convergence.py`` at its defaults (H101 bowl mesh,
    200 kHz, fp64), one side job a nx (20, 28, 36) run during [18a]: each
    O'Neil error within 1e-6 of the JAX package's fp64 CPU run
    (``drivers/bowl_convergence_jax.json``); K2 ``westervelt`` with its band
    4 times a step, K1 (+ K6) 41 times a run for ``estimate_stable_dt``;
    then, on the nx = 36 model from a seeded random state, K2 with its band
    against its plain version and K1 fp64 at its lattice (uncounted)."""
    import torch

    from fenicsxfus_tpu_torch.drivers import hitu

    rows, launches = [], {"K1": 0, "K2+band": 0, "other": 0}
    for job in (j for j in side.jobs if j.startswith("convergence:")):
        res, c = side.result(job)["res"], side.result(job)["launches"]
        if res["dtype"] != "torch.float64":
            raise AssertionError(f"[19i] {job} took {res['dtype']}, not float64")
        band = c["K2+band"]
        say(f"[19i] {job}: {side.result(job)['seconds']:.1f} s in a side process, launches {c} "
            f"({card})")
        if (set(band) != {"westervelt"} or band["westervelt"] % 4 or c["K1"] != 41
                or any(c[k] for k in ("K2", "K4a", "K4b", "K5a", "K5b", "K3"))):
            raise AssertionError(f"[19i] {job}: unexpected launches {c}")
        launches["K1"] += c["K1"]
        launches["K2+band"] += band["westervelt"]
        rows += res["rows"]
    for r in rows:
        say(f"[19i] nx = {r['nx']}: gain {r['gain_err']:.12e}, position {r['pos_err']:.12e} m, "
            f"focal L2 {r['profile_err']:.12e}; against the JAX package's run max |d| "
            f"{r['held']:.3e} (gate {CONVERGENCE_GATE:g})")
        if r["held"] is None or not r["held"] <= CONVERGENCE_GATE:
            raise AssertionError(f"[19i] nx = {r['nx']} misses the JAX package's run")
    with uncounted():
        model, *_ = hitu.build_bowl_model("W", "H101", "WATER", rows[-1]["nx"], f0=200e3,
                                          dtype=torch.float64, linear=True, device=device)
        gen = torch.Generator(device=device).manual_seed(191)
        n = model.number_of_dofs()
        model.u_n = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
        model.v_n = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
        tag = f"[19i] nx = {rows[-1]['nx']}"
        k2 = k2_on_model(model, card, f"{tag}, fp64:")["non-final"]
        k1 = k1_lattice(model.mesh.grid_shape, torch.float64, card, f"{tag} lattice:")
    return {"rows": rows, "launches": launches, "k2": {**k2, "launches": launches["K2+band"]},
            "k1": {**k1, "launches": launches["K1"]}}


def phase_bench(device, card, side: SideJobs) -> dict:
    """[19]: (a) setup_speed, (b) phase_breakdown, (c) wave_attrib, (d)
    unstructured_speed, (e) unstructured_trace, (f) bowl_blend_sweep, (g)
    bowl_spectrum, (h) ph1_sc1_bm1, (i) bowl_convergence (run as side jobs
    during [18a])."""
    import torch

    t_phase = time.perf_counter()
    out = {}
    for key, fn in (("setup", phase_setup_speed), ("phase", phase_phase_breakdown),
                    ("wave", phase_wave_attrib), ("unstructured", phase_unstructured_speed),
                    ("trace", phase_unstructured_trace), ("sweep", phase_blend_sweep),
                    ("spectrum", phase_bowl_spectrum), ("sc1_bm1", phase_sc1_bm1),
                    ("convergence", lambda d, c: phase_bowl_convergence(d, c, side))):
        out[key] = fn(device, card)
        torch.cuda.empty_cache()
        say(f"[19] {key} done at {time.perf_counter() - t_phase:.1f} s")
    say(f"[19] done in {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------------------------ [20] the slab decomposition

SHARDED_TOL = 1e-6  # [20a]: fp32, world size 1 against the model's own unfused run
SHARDED_IMPLICIT_STEPS = 2
SLAB_STEPS = 40
SLAB_H = 1.0 / 12  # [20b]: cells of about unit scale, O(1) coefficients (queue 3, item 5)
FP32_SPLIT = 1.5  # [20b]: two fp32 ranks at most this many times as far from fp64 as one
# [20b]: how far the one-rank fp32 run may lie from the fp64 run (max|d|/max|ref|)
FP32_FROM_FP64 = {"u": 2e-5, "v": 5e-4, "ys": 1e-5}
SENSOR_TOL = 1e-6  # [20b]: fp32 sensor traces, two ranks against one


def phase_sharded_headline(device, card, model, u0, v0, ref, nsteps) -> dict:
    """[20a] (run at the end of [11], on its model and random state)
    ``ShardedExplicitSolver`` at world size 1 over NCCL on the headline box
    (104³, p = 4, 72,511,713 DOF, fp32): UNFUSED_STEPS RK4 steps from [11]'s
    state against [11]'s unfused run through K1 (``FUS_FUSED=0``; rel
    SHARDED_TOL, and whether bit for bit), K1 4 times a step, the rate and
    the device memory peak."""
    import torch

    from fenicsxfus_tpu_torch.parallel import ShardedExplicitSolver, process_group

    with process_group("nccl"):
        t0 = time.perf_counter()
        solver = ShardedExplicitSolver(model, device=device)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        model.u_n, model.v_n = u0.clone(), v0.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        # --- the main path: counts from 0 just before, read just after
        reset_counts()
        t0 = time.perf_counter()
        u, _, _ = solver.rk(0.0, UNFUSED_STEPS * model.dt)
        torch.cuda.synchronize()
        solve = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated(device) / 2**30
    rate = model.number_of_dofs() * nsteps / solve / 1e9
    rel = rel_err(u, ref["u"])[0]
    same = torch.equal(u, ref["u"])
    say(f"[20a] ShardedExplicitSolver, world size 1 over NCCL, headline {model.ops.gdims}: "
        f"setup {setup:.3f} s, {nsteps} RK4 steps in {solve:.3f} s, {rate:.4f} "
        f"GDOF-RK4-updates/s against [11]'s unfused K1 step {ref['rate']:.4f}; K1 launches "
        f"{launches['K1']} ({launches['K1'] / nsteps:.0f} a step); device memory peak "
        f"{peak:.3f} GiB; against [11]'s FUS_FUSED=0 run max|du|/max|u| = {rel:.3e} (gate "
        f"{SHARDED_TOL:g}), bit for bit: {same} ({card})")
    if launches["K1"] != 4 * nsteps or any(launches[k] for k in ("K4a", "K4b") + STAGE_KERNELS):
        raise AssertionError(f"[20a] expected K1 4 times a step and no other kernel: {launches}")
    if not (rel <= SHARDED_TOL and bool(torch.isfinite(u).all())):
        raise AssertionError(f"[20a] the sharded headline differs from the unfused run: {rel:.3e}")
    return {"launches": launches, "rate": rate, "solve_s": solve, "setup_s": setup,
            "peak_gib": peak, "rel": rel, "bit_equal": same, "u": u}


def phase_sharded_implicit(device, card, model) -> dict:
    """[20a] (run in [14b], on its model at the state its SDIRK4 steps
    reached) ``ShardedImplicitSolver`` at world size 1 over NCCL, fp64:
    SHARDED_IMPLICIT_STEPS steps against ``model.dirk`` over the same steps
    (the worst CG count within 2, u within 1e-9)."""
    import torch

    from fenicsxfus_tpu_torch.parallel import ShardedImplicitSolver, process_group

    u0, v0, t0 = model.u_n.clone(), model.v_n.clone(), model.t
    tf = t0 + SHARDED_IMPLICIT_STEPS * model.dt
    u1 = model.dirk(t0, tf)[0].clone()
    cg1 = model.cg_stats["max_iterations"]
    model.u_n, model.v_n = u0, v0
    with process_group("nccl"):
        solver = ShardedImplicitSolver(model, device=device)
        torch.cuda.synchronize()
        # --- the main path: counts from 0 just before, read just after
        reset_counts()
        t_start = time.perf_counter()
        u2 = solver.dirk(t0, tf)[0]
        torch.cuda.synchronize()
        solve = time.perf_counter() - t_start
        launches = counts()
    cg2 = model.cg_stats["max_iterations"]
    rel = rel_err(u2, u1)[0]
    say(f"[20a] ShardedImplicitSolver, world size 1 over NCCL, implicit headline, fp64: "
        f"{SHARDED_IMPLICIT_STEPS} SDIRK4 steps in {solve:.3f} s; worst CG iterations {cg2} "
        f"against model.dirk's {cg1} (gate: within 2); max|du|/max|u| = {rel:.3e} (gate 1e-9); "
        f"K1 launches {launches['K1']} ({card})")
    if abs(cg1 - cg2) > 2 or not rel <= 1e-9:
        raise AssertionError(f"[20a] the sharded implicit run differs: cg {cg2} vs {cg1}, {rel:.3e}")
    if launches["K1"] < 3 * 4 * SHARDED_IMPLICIT_STEPS or any(
            launches[k] for k in ("K4a", "K4b") + STAGE_KERNELS):
        raise AssertionError(f"[20a] the sharded CG did not run through K1 alone: {launches}")
    return {"launches": launches, "solve_s": solve, "cg": [cg1, cg2], "rel": rel}


def slab_cases() -> list:
    """[20b]'s cases (``fenicsxfus_tpu_torch/parallel/runs.py``), each in
    fp32 and in fp64: ``LinearSpectralExplicit`` and
    ``WesterveltSpectralExplicit`` on 24 × 12 × 12 cells (h = 1/12, p = 4,
    232,897 DOF) from a plane Gaussian pulse of u on the plane rank 0's slab
    ends at (x = 1), SLAB_STEPS RK4 steps, recording at sensors on both
    sides of and on that plane, on and off the nodes; the linear model on
    13 × 12 × 12 cells (7 + 6 and a padding cell); and, fp64 only,
    ``LinearSpectralImplicit``, SHARDED_IMPLICIT_STEPS SDIRK4 steps."""
    h = SLAB_H
    dt = 0.5 * h / 16
    c0 = 1.0 + 0.1 * np.random.default_rng(20).random(24 * 12 * 12)
    out = []
    for grid in ((24, 12, 12), (13, 12, 12)):
        L = grid[0] * h
        x_if = -(-grid[0] // 2) * h
        box = ("box", grid, (0.0, 0.0, 0.0), (L, 1.0, 1.0))
        pts = np.array([[x_if - 0.1, x_if, x_if + 0.1, x_if - 0.03, x_if + 0.04],
                        [0.5, 0.5, 0.5, 0.43, 0.61], [0.5, 0.5, 0.5, 0.57, 0.38]])
        c = c0[: int(np.prod(grid))]
        models = [("linear", "LinearSpectralExplicit", (4, c, 1.0, 2.0, 1.0, 1.0, 4, dt))]
        if grid[0] == 24:
            models.append(("westervelt", "WesterveltSpectralExplicit",
                           (4, c, 1.0, 1e-3, 3.5, 2.0, 1.0, 1.0, 4, dt)))
        for dtype in ("float32", "float64"):
            for kind, cls, args in models:
                out.append(dict(name=f"{kind} {grid[0]} {dtype}", mesh=box, tag_L=L, model=cls,
                                args=args, dtype=dtype, run="rk_record", t_end=SLAB_STEPS * dt,
                                points=pts, u0=([x_if], 0.2, 0.05), k1_operands=True))
        if grid[0] == 24:
            out.append(dict(name="implicit 24 float64", mesh=box, tag_L=L,
                            model="LinearSpectralImplicit",
                            args=(4, c, 1.0, 2.0, 1.0, 1.0, 4, 4 * dt), dtype="float64",
                            run="dirk", t_end=SHARDED_IMPLICIT_STEPS * 4 * dt,
                            u0=([x_if], 0.2, 0.05), k1_operands=True))
    return out


def slab_job(world: int, operands: str) -> list:
    """[20b] in a side process: ``slab_cases`` at world size 1 over NCCL and
    at ``world`` gloo ranks on the one card (their halo planes through host
    buffers), each a ``parallel.launch.spawn``; per case the two-rank run's
    distance from the one-rank run, each rank's K1 launches, the CG counts,
    and for an fp32 case both runs' distance from the fp64 one-rank run;
    then the sharded example at its defaults on the card (one NCCL rank).
    The operands each gloo rank's K1 got, per case, are saved to
    ``operands`` (``torch.save``) for ``phase_sharded`` to hold and time."""
    import torch

    from fenicsxfus_tpu_torch.examples import sharded_planewave3d
    from fenicsxfus_tpu_torch.parallel import runs, spawn

    cases = slab_cases()
    one = spawn(runs.run_cases, 1, "nccl", "cuda", args=(cases,))[0]
    many = spawn(runs.run_cases, world, "gloo", "cuda", args=(cases,))
    torch.save({spec["name"]: [ranks[i].pop("k1_operands") for ranks in many]
                for i, spec in enumerate(cases)}, operands)
    rows = rank_rows(cases, one, many)
    ex = sharded_planewave3d.main()
    rows.append({"name": "examples.sharded_planewave3d", "ndev": ex["ndev"],
                 "ndofs": ex["ndofs"], "max_u": ex["max_u"],
                 "finite": bool(np.all(np.isfinite(ex["u"])))})
    return rows


def rank_rows(cases, one, many) -> list:
    """Per case, the many-rank run (``many``: each rank's results) against
    world size 1 (``one``): the distance of each field, whether the ranks
    hold the same bits, each rank's K1 launches, the marches' seconds, the
    CG counts, and for an fp32 case both runs' distance from the fp64
    one-rank run of the same name."""

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))

    by_name = {r["name"]: r for r in one}
    rows = []
    for i, (spec, a) in enumerate(zip(cases, one)):
        b = [ranks[i] for ranks in many]
        keys = [k for k in ("u", "v", "ys") if k in a]
        row = {"name": spec["name"], "dtype": spec["dtype"], "run": spec["run"],
               "rel": {k: rel(b[0][k], a[k]) for k in keys},
               "ranks_equal": all(np.array_equal(r[k], b[0][k]) for r in b for k in keys),
               "k1": [r["k1"] for r in b], "k1_one": a["k1"],
               "seconds": [a["seconds"], b[0]["seconds"]],
               "local_ndofs": [r["local_ndofs"] for r in b]}
        if "cg" in a:
            row["cg"] = [a["cg"], b[0]["cg"]]
        if spec["dtype"] == "float32":
            ref = by_name[spec["name"].replace("float32", "float64")]
            row["vs_fp64"] = {k: [rel(a[k], ref[k]), rel(b[0][k], ref[k])] for k in keys}
        rows.append(row)
    return rows


def check_rank_rows(tag: str, rows, nranks: int, card: str, steps: int, k1: bool = True,
                    direct: float = 1.0) -> None:
    """[20b]'s and [21b]'s gates on ``rank_rows``: fp64 within 1e-11 of
    world size 1; in fp32 the one-rank run within FP32_FROM_FP64 of the fp64
    run, the many-rank run within FP32_SPLIT times that distance of it and
    within ``direct`` times that distance of the one-rank run ([20b] and
    [21b]'s grid 1.0, [21b]'s unstructured split FP32_SPLIT), sensor traces within SENSOR_TOL; the CG counts
    within 2; the ranks' bits equal; K1 the same count on every rank, 4 a
    step of a recorded run (``k1``), or never launched (the general path:
    not ``k1``)."""
    for row in rows:
        gate = 1e-11 if row["dtype"] == "float64" else None
        rel = ", ".join(f"{k} {v:.3e}" for k, v in row["rel"].items())
        extra = ""
        if "vs_fp64" in row:
            extra = (f"; from the fp64 run, one rank against {nranks} (gates {FP32_FROM_FP64}, "
                     f"{nranks} ranks at most {FP32_SPLIT}x one, the direct gap at most "
                     f"{direct}x one): " + ", ".join(
                         f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in row["vs_fp64"].items()))
        fp32_gate = f"fp32: the one-rank run's distance from fp64, ys {SENSOR_TOL:g}"
        say(f"{tag} {row['name']} ({row['run']}): {nranks} gloo ranks against world size 1 "
            f"(NCCL) max|d|/max|ref| {rel} (gate {gate or fp32_gate}){extra}; K1 "
            f"launches per rank {row['k1']} (world size 1: {row['k1_one']})"
            + (f"; worst CG iterations {row['cg']}" if "cg" in row else "")
            + f"; DOFs per rank {row['local_ndofs']}; ranks equal {row['ranks_equal']}; "
            f"{row['seconds'][1]:.2f} s ({card})")
        ok = row["ranks_equal"] and len(set(row["k1"])) == 1
        if k1:
            ok &= row["k1"][0] > 0
            if row["run"] == "rk_record":
                ok &= row["k1"][0] == row["k1_one"] == 4 * steps
        else:
            ok &= row["k1"][0] == row["k1_one"] == 0
        if gate is not None:
            ok &= all(v <= gate for v in row["rel"].values())
        else:
            ok &= all(a <= FP32_FROM_FP64[k] and b <= FP32_SPLIT * a
                      and row["rel"][k] <= direct * a for k, (a, b) in row["vs_fp64"].items())
            ok &= row["rel"].get("ys", 0.0) <= SENSOR_TOL
        if "cg" in row:
            ok &= abs(row["cg"][0] - row["cg"][1]) <= 2
        if not ok:
            raise AssertionError(f"{tag} {row['name']}: {row}")


def validate_job(nx: int, nx_fine: int) -> dict:
    """[20c] in a side process: ``drivers.ph1.validate(1, 1, nx, nx_fine)``
    on the card with its stamp written to a temporary ``--out``; the stamp
    read back from that file."""
    import tempfile

    from fenicsxfus_tpu_torch.drivers import ph1

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "validation_sc1_bm1.json")
        t0 = time.perf_counter()
        ph1.validate(1, 1, nx, nx_fine, out=out, device="cuda")
        seconds = time.perf_counter() - t0
        return {"stamp": json.loads(Path(out).read_text()), "seconds": seconds,
                "nx": [nx, nx_fine]}


def _numbers(tree):
    """Every number in a JSON tree."""
    if isinstance(tree, dict):
        return [n for v in tree.values() for n in _numbers(v)]
    if isinstance(tree, list):
        return [n for v in tree for n in _numbers(v)]
    return [tree] if isinstance(tree, (int, float)) and not isinstance(tree, bool) else []


def phase_sharded(device, card, side: SideJobs, explicit, implicit, sc1_bm1) -> dict:
    """[20] the slab decomposition: (a) world size 1 over NCCL, run in [11]
    and [14b] (``phase_sharded_headline``, ``phase_sharded_implicit``); (b)
    two gloo ranks on the card (the side job ``slab:2``): fp64 within 1e-11
    of world size 1; in fp32 the one-rank run within FP32_FROM_FP64 of the
    fp64 run, the two-rank run within FP32_SPLIT times that distance of it
    and within that distance of the one-rank run, sensor traces within
    SENSOR_TOL; the CG counts within 2, K1 4 times a step on each rank;
    K1 on each rank's own operands of each case against its plain version
    (``k1_on_operands``);
    (c) ``ph1.focal_comparison`` on [17d]'s SC1-BM1 profile (the JAX
    suite's gates) and the PH1 stamp of the side job ``validate``, read
    back from its file."""
    import torch

    from fenicsxfus_tpu_torch.drivers import ph1

    t_phase = time.perf_counter()
    res = side.result("slab:2")
    operands = torch.load(res["operands"])
    *rows, ex = res["rows"]
    say(f"[20b] the side job slab:2 took {res['seconds']:.1f} s (one NCCL rank, then two gloo "
        f"ranks on the card, then the sharded example)")
    say(f"[20b] examples.sharded_planewave3d at its defaults on the card: {ex['ndev']} rank(s), "
        f"{ex['ndofs']} DOF, max|u| = {ex['max_u']:.1f}, finite {ex['finite']}")
    if not (ex["finite"] and ex["max_u"] > 0):
        raise AssertionError(f"[20b] the sharded example: {ex}")
    check_rank_rows("[20b]", rows, 2, card, SLAB_STEPS)
    k1 = []
    with uncounted():
        for row in rows:
            for rank, ops in enumerate(operands[row["name"]]):
                Fs = [{k: f.to(device) for k, f in F.items()} for F in ops["F"]]
                m = k1_on_operands(Fs, ops["gdims"], ops["degree"], card,
                                   f"[20b] {row['name']}, rank {rank}'s own operands:")
                k1.append({**m, "case": row["name"], "rank": rank, "gdims": ops["gdims"],
                           "fields": len(Fs), "launches": row["k1"][rank]})
    x, amp = sc1_bm1["profile"]
    print("[20c]", end="")
    fc = ph1.focal_comparison(1, 1, x, amp)
    gates = (0.05, 2.0, 0.15)  # tests/test_ph1_validation.py:165-180
    got = (fc["dp_rel"], fc["dx_mm"], fc["dext_rel"])
    say(f"[20c] focal_comparison on [17d]'s SC1-BM1 profile: dP {got[0]:.4f}, dx {got[1]:.3f} mm, "
        f"d-6dB {got[2]:.4f} (gates {gates})")
    if not all(v < g for v, g in zip(got, gates)):
        raise AssertionError(f"[20c] SC1-BM1 misses the focal gates: {fc}")
    val = side.result(f"validate:{VALIDATE_NX[0]}-{VALIDATE_NX[1]}")
    stamp = val["stamp"]
    nums = _numbers(stamp)
    finite = bool(nums) and all(np.isfinite(v) for v in nums)
    say(f"[20c] validate(1, 1, {val['nx'][0]}, {val['nx'][1]}) in a side process: "
        f"{val['seconds']:.1f} s; stamp read back from --out: platform {stamp['platform']!r}, "
        f"convergence L2 {stamp['convergence']['profile_l2']:.4f}, tf stationarity "
        f"{stamp['tf_stationarity']['profile_l2']:.4f}, focal dP {stamp['focal']['dp_rel']:.4f}; "
        f"{len(nums)} numbers, all finite: {finite}")
    if not (finite and stamp["sc"] == 1 and stamp["bm"] == 1 and "focal" in stamp
            and stamp["platform"].startswith("cuda")):
        raise AssertionError(f"[20c] the stamp is not whole and finite: {stamp}")
    say(f"[20] done in {time.perf_counter() - t_phase:.1f} s")
    return {"explicit": explicit, "implicit": implicit, "ranks": {"rows": rows, "example": ex},
            "k1": k1, "focal": fc, "stamp": stamp}


# ------------------------------------ [21] the grid and unstructured decompositions
GRID_STEPS = SLAB_STEPS  # [21b]: RK4 steps of each recorded case
# [21b]: K1 on a grid rank's own operands against its plain version,
# max|dy|/max|y|: fp64 1e-14; fp32 5e-7, about 4 ulp of max|y| (the two
# summation orders differ by 1-2 ulp: 1.06e-7 to 2.12e-7 read on the grid
# ranks, fp32 K1's 2e-7 target of the slab ranks in [20b] not met by 5 of 8)
GRID_K1_TOL = {"float32": 5e-7, "float64": 1e-14}
GRID_K1_TARGET = {"float32": 2e-7, "float64": 1e-14}  # read out beside the gate


def phase_grid_headline(device, card, model, u0, v0, slab: dict, nsteps) -> dict:
    """[21a] (run at the end of [11], after [20a], on its model and random
    state) ``ShardedExplicitSolver2D(model, (1, 1))`` at world size 1 over
    NCCL on the headline box (72,511,713 DOF, fp32): UNFUSED_STEPS RK4 steps
    from [11]'s state, bit for bit [20a]'s slab run, K1 4 times a step and
    no other kernel; the rate beside [20a]'s and the device memory peak."""
    import torch

    from fenicsxfus_tpu_torch.parallel import ShardedExplicitSolver2D, process_group

    ref = slab.pop("u")
    with process_group("nccl"):
        t0 = time.perf_counter()
        solver = ShardedExplicitSolver2D(model, (1, 1), device=device)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        model.u_n, model.v_n = u0.clone(), v0.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        # --- the main path: counts from 0 just before, read just after
        reset_counts()
        t0 = time.perf_counter()
        u, _, _ = solver.rk(0.0, UNFUSED_STEPS * model.dt)
        torch.cuda.synchronize()
        solve = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated(device) / 2**30
    rate = model.number_of_dofs() * nsteps / solve / 1e9
    same = torch.equal(u, ref)
    rel = rel_err(u, ref)[0]
    say(f"[21a] ShardedExplicitSolver2D (1, 1), world size 1 over NCCL, headline "
        f"{model.ops.gdims}: setup {setup:.3f} s, {nsteps} RK4 steps in {solve:.3f} s, "
        f"{rate:.4f} GDOF-RK4-updates/s against [20a]'s {slab['rate']:.4f}; K1 launches "
        f"{launches['K1']} ({launches['K1'] / nsteps:.0f} a step); device memory peak "
        f"{peak:.3f} GiB; against [20a]'s slab run max|du|/max|u| = {rel:.3e}, bit for bit: "
        f"{same} ({card})")
    if launches["K1"] != 4 * nsteps or any(launches[k] for k in ("K4a", "K4b") + STAGE_KERNELS):
        raise AssertionError(f"[21a] expected K1 4 times a step and no other kernel: {launches}")
    if not (same and bool(torch.isfinite(u).all())):
        raise AssertionError(f"[21a] the (1, 1) grid is not [20a]'s slab run bit for bit: {rel:.3e}")
    return {"launches": launches, "rate": rate, "solve_s": solve, "setup_s": setup,
            "peak_gib": peak, "bit_equal": same}


def phase_split_general(device, card, run: dict) -> dict:
    """[21a] (run in [15], on its distorted-box model)
    ``ShardedUnstructuredExplicitSolver(model, 1)`` at world size 1 over
    NCCL (10,218,313 DOF, Westervelt, fp32): GENERAL_STEPS RK4 steps from
    zero after a warm-up on the same window, as [15] ran them, against
    [15]'s single-device run (rel-L2 within 1e-5, [15]'s gate on fp32
    against fp64; the max rel and whether bit for bit printed); no kernel
    launched (the general path); the rate beside [15]'s and the memory
    peak."""
    import torch

    from fenicsxfus_tpu_torch.parallel import ShardedUnstructuredExplicitSolver, process_group

    model, ref = run["model"], run["u"]
    tf = GENERAL_STEPS * model.dt
    with process_group("nccl"):
        t0 = time.perf_counter()
        solver = ShardedUnstructuredExplicitSolver(model, 1, device=device)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        model.init()
        solver.rk(0.0, tf)  # warm-up on the identical window
        model.init()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        # --- the main path: counts from 0 just before, read just after
        reset_counts()
        t0 = time.perf_counter()
        u, _, _ = solver.rk(0.0, tf)
        torch.cuda.synchronize()
        solve = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated(device) / 2**30
    rate = model.number_of_dofs() * GENERAL_STEPS / solve / 1e9
    rel_l2 = float(torch.linalg.vector_norm((u - ref).double())
                   / torch.linalg.vector_norm(ref.double()))
    rel = rel_err(u, ref)[0]
    same = torch.equal(u, ref)
    say(f"[21a] ShardedUnstructuredExplicitSolver, world size 1 over NCCL, [15]'s distorted box "
        f"({model.number_of_dofs()} DOF, fp32): setup {setup:.3f} s, {GENERAL_STEPS} RK4 steps "
        f"in {solve:.3f} s, {rate:.4f} GDOF-RK4-steps/s against [15]'s "
        f"{run['gdof_steps_per_s']:.4f}; against [15]'s run rel-L2 {rel_l2:.3e} (gate 1e-5), max "
        f"rel {rel:.3e}, bit for bit: {same}; device memory peak {peak:.3f} GiB; launches "
        f"{launches} ({card})")
    if launches["K1"] or any(launches[k] for k in ("K4a", "K4b") + STAGE_KERNELS):
        raise AssertionError(f"[21a] the unstructured split launched a kernel: {launches}")
    if not (rel_l2 <= 1e-5 and bool(torch.isfinite(u).all())):
        raise AssertionError(f"[21a] the unstructured split differs from [15]'s run: {rel_l2:.3e}")
    return {"rate": rate, "solve_s": solve, "setup_s": setup, "peak_gib": peak,
            "rel_l2": rel_l2, "rel": rel, "bit_equal": same}


def grid_cases(dshape) -> list:
    """[21b]'s grid cases (``parallel/runs.py``) on a ``dshape`` grid of
    ranks: ``LinearSpectralExplicit`` and ``WesterveltSpectralExplicit`` on
    13 × 11 × 12 cells (h = 1/12, O(1) coefficients, p = 4, 116,865 DOF;
    7 + 6 and 6 + 5 cells on a (2, 2) grid) from a Gaussian line pulse of u
    on the column the four blocks share, GRID_STEPS RK4 steps recorded at
    sensors on that column (on and off the nodes) and off it, each fp32 and
    fp64; ``LinearSpectralImplicit``, SHARDED_IMPLICIT_STEPS SDIRK4 steps,
    fp64; ``LinearSpectralSponge`` (its nodal δ), GRID_STEPS steps, fp64."""
    h = SLAB_H
    dt = 0.5 * h / 16
    grid = (13, 11, 12)
    x_if, y_if = 7 * h, 6 * h
    box = ("box", grid, (0.0, 0.0, 0.0), (grid[0] * h, grid[1] * h, 1.0))
    pts = np.array([[x_if, x_if, x_if - 0.03, x_if + 0.04, x_if - 0.1],
                    [y_if, y_if, y_if + 0.02, y_if - 0.05, y_if + 0.1],
                    [0.5, 0.37, 0.43, 0.61, 0.5]])
    c = 1.0 + 0.1 * np.random.default_rng(21).random(int(np.prod(grid)))
    common = dict(mesh=box, tag_L=grid[0] * h, decomp="grid", dshape=dshape,
                  u0=([x_if, y_if], 0.2, 0.05), k1_operands=True)
    out = []
    for dtype in ("float32", "float64"):
        for kind, cls, args in (
                ("linear", "LinearSpectralExplicit", (4, c, 1.0, 2.0, 1.0, 1.0, 4, dt)),
                ("westervelt", "WesterveltSpectralExplicit",
                 (4, c, 1.0, 1e-3, 3.5, 2.0, 1.0, 1.0, 4, dt))):
            out.append(dict(common, name=f"grid {kind} {dtype}", model=cls, args=args,
                            dtype=dtype, run="rk_record", t_end=GRID_STEPS * dt, points=pts))
    out.append(dict(common, name="grid implicit float64", model="LinearSpectralImplicit",
                    args=(4, c, 1.0, 2.0, 1.0, 1.0, 4, 4 * dt), dtype="float64", run="dirk",
                    t_end=SHARDED_IMPLICIT_STEPS * 4 * dt))
    out.append(dict(common, name="grid sponge float64", model="LinearSpectralSponge",
                    args=(4, 1.0, 1.0, 1e-2, 2.0, 1.0, 1.0), kwargs={"sponge_start": 0.6},
                    dt=dt, dtype="float64", run="rk", t_end=GRID_STEPS * dt))
    return out


def grid_job(world: int, operands: str) -> dict:
    """[21b] in a side process: ``grid_cases`` on a (1, 1) grid at world
    size 1 over NCCL and on a (2, 2) grid of ``world`` gloo ranks on the one
    card (their planes through host buffers), each a ``spawn``
    (``rank_rows``); the operands each gloo rank's K1 got, per case, saved to
    ``operands`` for ``phase_split`` to hold and time; then
    ``dryrun_multichip(world, "gloo", "cuda")``."""
    import torch

    from fenicsxfus_tpu_torch.parallel import dryrun, runs, spawn

    side = int(round(world ** 0.5))
    cases = grid_cases((side, world // side))
    one = spawn(runs.run_cases, 1, "nccl", "cuda", args=(grid_cases((1, 1)),))[0]
    many = spawn(runs.run_cases, world, "gloo", "cuda", args=(cases,))
    torch.save({spec["name"]: [ranks[i].pop("k1_operands") for ranks in many]
                for i, spec in enumerate(cases)}, operands)
    for r in one:
        r.pop("k1_operands", None)
    rows = rank_rows(cases, one, many)
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(world, "gloo", "cuda")
    return {"rows": rows, "operands": operands, "dshape": cases[0]["dshape"],
            "dryrun": {"seconds": time.perf_counter() - t0, "parts": dry[0],
                       "finite": all(r["finite"] for rank in dry for r in rank.values())}}


def unstructured_cases() -> list:
    """[21b]'s unstructured cases: the box of 16 × 12 × 12 cells (h = 1/12,
    p = 4, 156,065 DOF) with its interior vertices jittered by 0.15 h and
    its vertex ids permuted (seeded; no ``grid_shape``: the entity-blocked
    numbering), split by ``partition_tables`` (``auto``), from a Gaussian
    pulse of u on x = 8 h, ``LinearSpectralExplicit`` and
    ``WesterveltSpectralExplicit`` recorded at sensors on and beside that
    plane over GRID_STEPS RK4 steps, fp32 and fp64; ``LinearSpectralImplicit``
    SHARDED_IMPLICIT_STEPS SDIRK4 steps, fp64."""
    h = SLAB_H
    dt = 0.5 * h / 16
    grid = (16, 12, 12)
    x_if = 8 * h
    mesh = ("jittered", grid, (0.0, 0.0, 0.0), (grid[0] * h, 1.0, 1.0), 17, 0.15 * h, True)
    pts = np.array([[x_if - 0.1, x_if, x_if + 0.1, x_if - 0.03, x_if + 0.04],
                    [0.5, 0.5, 0.5, 0.43, 0.61], [0.5, 0.5, 0.5, 0.57, 0.38]])
    c = 1.0 + 0.1 * np.random.default_rng(22).random(int(np.prod(grid)))
    common = dict(mesh=mesh, tag_L=grid[0] * h, decomp="unstructured", u0=([x_if], 0.2, 0.05))
    out = []
    for dtype in ("float32", "float64"):
        for kind, cls, args in (
                ("linear", "LinearSpectralExplicit", (4, c, 1.0, 2.0, 1.0, 1.0, 4, dt)),
                ("westervelt", "WesterveltSpectralExplicit",
                 (4, c, 1.0, 1e-3, 3.5, 2.0, 1.0, 1.0, 4, dt))):
            out.append(dict(common, name=f"unstructured {kind} {dtype}", model=cls, args=args,
                            dtype=dtype, run="rk_record", t_end=GRID_STEPS * dt, points=pts))
    out.append(dict(common, name="unstructured implicit float64", model="LinearSpectralImplicit",
                    args=(4, c, 1.0, 2.0, 1.0, 1.0, 4, 4 * dt), dtype="float64", run="dirk",
                    t_end=SHARDED_IMPLICIT_STEPS * 4 * dt))
    return out


def unstructured_job(world: int) -> list:
    """[21b] in a side process: ``unstructured_cases`` at world size 1 over
    NCCL and on ``world`` gloo ranks on the one card (the shared rows'
    ``all_reduce`` through host buffers), each a ``spawn``; ``rank_rows``."""
    from fenicsxfus_tpu_torch.parallel import runs, spawn

    cases = unstructured_cases()
    one = spawn(runs.run_cases, 1, "nccl", "cuda", args=(cases,))[0]
    many = spawn(runs.run_cases, world, "gloo", "cuda", args=(cases,))
    return rank_rows(cases, one, many)


def phase_split(device, card, side: SideJobs) -> dict:
    """[21b]: the side jobs ``grid:4`` (a (2, 2) grid of gloo ranks on the
    card against world size 1 over NCCL, then the dry run) and
    ``unstructured:2`` (two gloo ranks), each row held by
    ``check_rank_rows`` ([20b]'s gates, the fp32 direct gap within
    FP32_SPLIT of the one-rank run's distance from fp64 on the
    unstructured split, 1.0 on the grid; no kernel on the unstructured
    path); K1 on each grid rank's own operands of each case against its
    plain version (within GRID_K1_TOL) and timed, with that rank's
    launches."""
    import torch

    t_phase = time.perf_counter()
    res = side.result("grid:4")
    dry = res["dryrun"]
    say(f"[21b] the side job grid:4 took {res['seconds']:.1f} s (one NCCL rank, a "
        f"{tuple(res['dshape'])} grid of gloo ranks on the card, then the dry run)")
    check_rank_rows("[21b]", res["rows"], 4, card, GRID_STEPS)
    say(f"[21b] dryrun_multichip(4, 'gloo', 'cuda'): {dry['seconds']:.1f} s, parts "
        f"{sorted(dry['parts'])}, every field finite on every rank: {dry['finite']}")
    if not (dry["finite"] and "grid 2x2" in dry["parts"] and "unstructured_record" in dry["parts"]):
        raise AssertionError(f"[21b] the dry run: {dry}")
    un = side.result("unstructured:2")
    say(f"[21b] the side job unstructured:2 took {un['seconds']:.1f} s (one NCCL rank, then two "
        "gloo ranks on the card)")
    check_rank_rows("[21b]", un["rows"], 2, card, GRID_STEPS, k1=False, direct=FP32_SPLIT)
    operands = torch.load(res["operands"])
    k1 = []
    with uncounted():
        for row in res["rows"]:
            for rank, ops in enumerate(operands[row["name"]]):
                Fs = [{k: f.to(device) for k, f in F.items()} for F in ops["F"]]
                m = k1_on_operands(Fs, ops["gdims"], ops["degree"], card,
                                   f"[21b] {row['name']}, grid rank {rank}'s own operands:")
                if not m["rel"] <= GRID_K1_TOL[row["dtype"]]:
                    raise AssertionError(f"[21b] K1 on {row['name']} rank {rank}: {m['rel']:.3e} "
                                         f"(gate {GRID_K1_TOL[row['dtype']]:g})")
                k1.append({**m, "case": row["name"], "rank": rank, "gdims": ops["gdims"],
                           "fields": len(Fs), "launches": row["k1"][rank], "dtype": row["dtype"]})
    for dtype, tol in GRID_K1_TOL.items():
        rels = [m["rel"] for m in k1 if m["dtype"] == dtype]
        say(f"[21b] K1 on the grid ranks' own operands, {dtype}: max|dy|/max|y| "
            f"{min(rels):.3e}-{max(rels):.3e} over {len(rels)} holds (gate {tol:g}); within "
            f"{GRID_K1_TARGET[dtype]:g}: {sum(r <= GRID_K1_TARGET[dtype] for r in rels)} of "
            f"{len(rels)}")
    say(f"[21] done in {time.perf_counter() - t_phase:.1f} s")
    return {"grid": res["rows"], "unstructured": un["rows"], "dryrun": dry, "k1": k1}


# ------------------------------------------- [22] the compiled tiles of K1 and K2

# the box of [22c]'s model drives, by (dtype, degree): 16 cells along x and
# two whole tiles and a cut one along y and z for the widest compiled tile
# at that degree, so every compiled tile runs under the default plan (at
# least MIN_BLOCKS blocks) on a cut last tile; cubic cells of 1 mm
TILE_CELL_MM = 1e-3
TILE_RUN_STEPS = 2
# the run shapes of the compiled tiles that a run of the port launches at
# full size (cells; K2+band with the bowl's band, BOWL_BAND_LAYERS cells
# deep): timed there beside the general kernel; every other compiled tile is
# timed on MID_NODES_SIDE³ nodes
RUN_CELLS = {
    ("K2", "float32", 5, "focused"): ((80, 47, 47), "PH1 SC2-BM7 [17d]"),
    ("K2", "float32", 6, "focused"): ((80, 47, 47), "HITU W-H101-WATER at p = 6, flat"),
    ("K2+band", "float32", 6, "westervelt"): ((80, 47, 47), "HITU W-H101-WATER at p = 6, bowl"),
    **{("K2", "float32", 6, kind): ((80, 47, 47), "the HITU lattice at p = 6")
       for kind in ("linear", "lossy", "westervelt")},
    ("K1", "float64", 4, 1): ((HEADLINE_NX,) * 3, "the implicit headline's CG [14]"),
    ("K1", "float64", 4, 2): ((80, 47, 47), "the HITU lattice's lossy CG and adaptive slopes [14]"),
    ("K2+band", "float64", 4, "westervelt"): ((36, 21, 21), "bowl_convergence nx = 36 [19i]"),
    **{("K1", "float32", p, 1): ((n,) * 3, "operator_speed [18b]")
       for p, n in ((2, 169), (3, 112), (5, 67), (6, 56))},
}
MID_NODES_SIDE = 161


KIND_INDEX = {"linear": 0, "lossy": 1, "westervelt": 2, "focused": 3}  # csrc/stage.cuh Kind


def _tile_name(name: str):
    """(family, float64?, p, fields or kind, (t1, t2) or None, how) of a
    kernel name of ``ops/stiffness.py::tile_kernel``."""
    parts = name.split()
    fam, f64, p, what, how = (parts[0], parts[1] == "float64", int(parts[2][2:]), parts[3],
                              parts[-1])
    tile = tuple(int(t) for t in parts[4].split("x")) if how != "general" else None
    return fam, f64, p, int(what[:-1]) if fam == "K1" else what, tile, how


def tile_source(name: str) -> str:
    """The csrc file that holds the kernel ``name`` (``tile_kernel``'s)."""
    fam, f64, p, _, _, how = _tile_name(name)
    if how != "compiled":
        return "stiffness.cu" if fam == "K1" else ("stage_f64.cu" if f64 else "stage.cu")
    if fam == "K1":
        return "stiffness_tiles_f64.cu" if f64 else "stiffness_tiles_f32.cu"
    if not f64 and p == 5:
        return "stage_tiles_f32.cu"
    return f"stage_tiles_{'f64' if f64 else 'f32'}_p{p}.cu"


def tile_mangled(name: str) -> str:
    """A part of the mangled name of the kernel ``name`` (``tile_kernel``'s),
    to find its ptxas lines."""
    fam, f64, p, what, tile, how = _tile_name(name)
    t = "d" if f64 else "f"
    arg = f"Li{what}E" if fam == "K1" else f"Li{KIND_INDEX[what]}E"
    kernel = {"K1": "stiffness", "K2": "stage", "K2+band": "stage_band"}[fam]
    if how == "compiled":
        return (f"{kernel}_fixed_kernelI{t}{arg}NS_9FixedTileILi{p}ELi{tile[0]}ELi{tile[1]}E")
    return f"{kernel}_{'kernel' if fam == 'K2+band' else 'tile_kernel'}I{t}{arg}Lb" \
        f"{1 if how == 'main' else 0}E"


def tile_counts() -> dict:
    """The launches of K1 and K2 by the kernel each took
    (``ops/stiffness.py::tile_kernel``)."""
    from fenicsxfus_tpu_torch.ops import stage, stiffness

    return dict(stiffness.stiffness_apply.tiles) | dict(stage.stage_apply.tiles)


def _tile_key_args(key):
    """(nf, nr, dtype) of a compiled tile's key."""
    import torch

    from fenicsxfus_tpu_torch.ops.stiffness import KIND_FIELDS, KIND_RAW

    fam, dtn, p, what = key
    nf = what if fam == "K1" else KIND_FIELDS[what]
    return nf, (nf if fam == "K1" else KIND_RAW[nf]), getattr(torch, dtn)


def _tile_operands(key, lat, device, gen, rng, scale, dg0):
    """Seeded operands of a compiled tile's kernel on ``lat``: (call, plain,
    bound) with call() and plain() its wrapper and its plain version."""
    import torch

    from fenicsxfus_tpu_torch.ops import stage, stiffness

    fam, _, p, what = key
    nf, _, dt = _tile_key_args(key)
    if fam == "K1":
        xs = [torch.randn(lat.gdims, generator=gen, device=device, dtype=dt) for _ in range(nf)]
        Fs = [stiffness.pack_const(lat, scale * (1.0 - 0.5 * f), device) for f in range(nf)]
        if dg0:  # the last field's coefficient DG-0
            Fs[-1] = stiffness.pack_field(
                lat, rng.uniform(0.5, 2.0, int(np.prod(lat.grid))) * scale, device)
        rate = FP64_FLOP_PER_S if dt == torch.float64 else FP32_FLOP_PER_S
        bound = floor_ms(nbytes(xs, Fs), nbytes(xs[0]),
                         stencil_flops(lat.gdims, p, nf, (0, 1, 2)), rate)
        return (lambda: stiffness.stiffness_apply(xs, Fs, p),
                lambda: stiffness.stiffness_plain(xs, Fs, p), bound)
    args = _stage_inputs(what, lat, device, gen, rng, False, scale, dg0=dg0)
    args = {k: (v.to(dt) if isinstance(v, torch.Tensor) else v) for k, v in args.items()}
    args["Fs"] = [{k: v.to(dt) for k, v in F.items()} for F in args["Fs"]]
    args["dense"] = [d.to(dt) for d in args["dense"]]
    args["facets"] = [{k: v.to(dt) for k, v in f.items()} for f in args["facets"]]
    if fam == "K2+band":
        rows = min(BOWL_BAND_LAYERS * p + 1, lat.gdims[0])
        args["band"] = torch.randn((rows, *lat.gdims[1:]), generator=gen, device=device,
                                   dtype=dt)
    return (lambda: stage.stage_apply(**args), lambda: stage.stage_plain(**args),
            stage_floor(args, "K2"))


@contextlib.contextmanager
def general_plan():
    """K1 and K2 on the general kernel (p and the tile read at run time)
    and the general plan (``tile_plan`` without its kernel): the design
    before the compiled tiles, on the same operands. Where the general plan
    is a compiled tile's (the C dispatch keys on the plan), it gets one
    warp more, so that the general kernel takes it."""
    from fenicsxfus_tpu_torch.ops import stage, stiffness

    plan = stiffness.tile_plan

    def general(gdims, p, nf, dtype, nr=None, kernel=None):
        out = plan(gdims, p, nf, dtype, nr=nr)
        if kernel is not None and stiffness.tile_kernel(out, p, dtype, kernel).endswith(
                "compiled"):
            out = dict(out, threads=out["threads"] + 32)
        return out

    stiffness.tile_plan = stage.tile_plan = general
    try:
        yield
    finally:
        stiffness.tile_plan = stage.tile_plan = plan


def _took(fn):
    """fn()'s result and the kernel its launch took."""
    import torch

    before = tile_counts()
    out = fn()
    torch.cuda.synchronize()
    took = [k for k, v in tile_counts().items() if v != before.get(k, 0)]
    return out, took[0] if len(took) == 1 else took


def hold_tile(key, lat, device, gen, rng, scale, dg0, tag, card=None, general=True) -> dict:
    """A compiled tile's kernel on ``lat`` against its plain version (TOL,
    TOL64) and against the general kernel bit for bit; with ``card``, timed
    (CUDA events, the device alone) beside its plain version, its bound and
    (``general``) the general kernel. Returns the kernel taken and the
    numbers."""
    import torch

    call, plain, bound = _tile_operands(key, lat, device, gen, rng, scale, dg0)
    with uncounted():
        got, took = _took(call)
        with general_plan():
            ref_general = call()
        ref = plain()
        torch.cuda.synchronize()
        rel, err = rel_err(got, ref)
        same = torch.equal(got, ref_general)
        gate = TOL64 if key[1] == "float64" else TOL
        del got, ref, ref_general
        out = {"kernel": took, "rel": rel, "max_abs_err": err, "gdims": lat.gdims, **bound}
        text = ""
        if card is not None:
            ms, dms = cuda_median_ms(call), cuda_device_ms(call)
            pms = cuda_median_ms(plain, runs=3)
            out.update(ms=ms, device_ms=dms, plain_ms=pms)
            text = f"; {ms:.3f} ms (alone {dms:.3f})"
            if general:
                with general_plan():
                    gms, gdms = cuda_median_ms(call), cuda_device_ms(call)
                out.update(general_ms=gms, general_device_ms=gdms)
                text += f", the general kernel {gms:.3f} (alone {gdms:.3f})"
            text += (f", plain {pms:.3f}, {share_text(bound, dms)} of the device's time (median "
                     f"of 10, CUDA events; {card})")
    say(f"{tag} {key} at {lat.gdims}: {took}; max|d|/max|ref| = {rel:.3e}, bit for bit the "
        f"general kernel: {same}{text}")
    if not rel <= gate:
        raise AssertionError(f"{tag} {key} disagrees with its plain version: {rel:.3e}")
    if not same:
        raise AssertionError(f"{tag} {key} differs from the general kernel")
    return out


def _tile_box(dtype, p):
    """[22c]'s box at (dtype, p): cells (16, 2 c1 + 1, 2 c2 + 1) for the
    widest compiled tile (c1 x c2 cells) at that degree and type."""
    from fenicsxfus_tpu_torch.ops.stiffness import COMPILED_TILES, ITEMSIZE, degree_tile

    dtn = str(dtype).split(".")[-1]
    tiles = [degree_tile(p, *_tile_key_args(k)[:2], ITEMSIZE[dtype])
             for k in COMPILED_TILES if k[1] == dtn and k[2] == p]
    return (16, 2 * max(t[0] for t in tiles) // p + 1, 2 * max(t[1] for t in tiles) // p + 1)


def drive_tiles(device, dtype, p, kinds, k1_fields, card) -> dict:
    """[22c] the main paths of the compiled tiles at (dtype, p): each model
    of ``kinds`` through ``rk`` (its fused step: K2 four times a step) and
    the linear (one field) and lossy (two fields) models' unfused step
    (``unfused_step``: K1 once a stage) for ``k1_fields``, on ``_tile_box``;
    counts from 0 just before each and read just after; then each fused
    step against ``stage_plain`` and each unfused one against the plain
    stiffness. Returns the launches by kernel."""
    import torch

    import fenicsxfus_tpu_torch as ft
    from fenicsxfus_tpu_torch.models.common import run_steps

    cells = _tile_box(dtype, p)
    h = TILE_CELL_MM
    mesh = ft.create_box(cells, (0.0, 0.0, 0.0), tuple(n * h for n in cells))
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12}, default=2)
    c0, rho0, f0, p0 = 1500.0, 1000.0, 0.5e6, 6e4
    dt = 0.3 * h / (c0 * p * p)
    kw = dict(dtype=dtype, device=device)
    make = {
        "linear": lambda: ft.LinearSpectralExplicit(mesh, None, p, c0, rho0, f0, p0, c0, 4, dt,
                                                    **kw),
        "lossy": lambda: ft.LossySpectralExplicit(mesh, None, p, c0, rho0, 4e-3, f0, p0, c0, 4,
                                                  dt, **kw),
        "westervelt": lambda: ft.WesterveltSpectralExplicit(mesh, None, p, c0, rho0, 4e-3, 3.5,
                                                            f0, p0, c0, 4, dt, **kw),
        "focused": lambda: ft.WesterveltSpectralFocused(
            mesh, None, p, c0, rho0, 4e-3, 3.5, f0, p0, c0, 4, dt,
            aperture_radius=cells[1] * h / 3, focal_distance=cells[0] * h,
            center=np.array([0.0, cells[1] * h / 2, cells[2] * h / 2]), **kw),
    }
    launches, tag = {}, f"[22c] {str(dtype).split('.')[-1]} p={p}"
    field_kind = {1: "linear", 2: "lossy"}
    for kind in dict.fromkeys(list(kinds) + [field_kind[nf] for nf in k1_fields]):
        model = make[kind]()
        model.init()
        if kind in kinds:  # the fused step through rk
            reset_counts()
            u, _, _ = model.rk(0.0, TILE_RUN_STEPS * model.dt)
            torch.cuda.synchronize()
            c = tile_counts()
            if counts()["K2"] != {kind: 4 * TILE_RUN_STEPS} or not torch.isfinite(u).all():
                raise AssertionError(f"{tag} {kind}: K2 {counts()['K2']}, finite "
                                     f"{bool(torch.isfinite(u).all())}")
            say(f"{tag} {kind} through rk, {TILE_RUN_STEPS} steps on {model.ops.gdims}: {c}")
            launches.update(c)
            with uncounted():
                fused_against_plain(model, f"{tag} {kind}", steps=1)
        nf = {"linear": 1, "lossy": 2}.get(kind)
        if nf in k1_fields:  # the unfused step: K1 once a stage
            reset_counts()
            u, _, _ = run_steps(model.unfused_step(), model.consts, model.u_n, model.v_n,
                                model.t, [model.dt] * TILE_RUN_STEPS)
            torch.cuda.synchronize()
            c = tile_counts()
            if counts()["K1"] != 4 * TILE_RUN_STEPS or not torch.isfinite(u).all():
                raise AssertionError(f"{tag} {kind} unfused: K1 {counts()['K1']}")
            say(f"{tag} {kind} unfused step, {TILE_RUN_STEPS} steps: {c}")
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
            with uncounted():
                explicit_against_plain(model, f"{tag} {kind} unfused", steps=1,
                                       gate=TOL64 if dtype == torch.float64 else 1e-5)
        del model
    return launches


def drive_band(device, dtype, p, card) -> dict:
    """[22c] the bowl-fitted H101 model (``hitu.build_bowl_model``, nx = 20)
    at (dtype, p) through ``rk``: K2 + band ``westervelt`` four times a step;
    then the fused step against ``stage_plain``."""
    import torch

    from fenicsxfus_tpu_torch.drivers import hitu

    tag = f"[22c] {str(dtype).split('.')[-1]} p={p} bowl"
    model, _, _, _ = hitu.build_bowl_model("W", "H101", "WATER", 20, degree=p, dtype=dtype,
                                           device=device)
    model.init()
    reset_counts()
    u, _, _ = model.rk(0.0, TILE_RUN_STEPS * model.dt)
    torch.cuda.synchronize()
    c = tile_counts()
    if counts()["K2+band"] != {"westervelt": 4 * TILE_RUN_STEPS} or not torch.isfinite(u).all():
        raise AssertionError(f"{tag}: K2+band {counts()['K2+band']}")
    say(f"{tag} through rk, {TILE_RUN_STEPS} steps on {model.ops.gdims}: {c}")
    with uncounted():
        fused_against_plain(model, tag, steps=1)
    return c


def phase_tiles(device, card, ptxas) -> dict:
    """[22] the compiled tiles of csrc/tiles.cuh: (a) each against its
    plain version and the general kernel bit for bit at [14a]'s shapes and
    on a lattice of two whole tiles and a cut one along g1 and g2; (b) each
    at its run's shape (``RUN_CELLS``: held and timed beside the general
    kernel, the design before them, and its bound) or on MID_NODES_SIDE³
    nodes (held and timed beside its bound); (c) the models through their entry points
    at each compiled degree and type, with each kernel's launches; (d) the
    ptxas registers and spills of each (no spill allowed)."""
    import torch

    from fenicsxfus_tpu_torch.ops import stiffness
    from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness

    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(22)
    rng = np.random.default_rng(22)
    keys = sorted(stiffness.COMPILED_TILES)
    held, timed = {}, {}
    # (a) [14a]'s shapes and the cut-tile lattice, unit cells, O(1) coefficients
    saved = stiffness.MIN_BLOCKS
    for key in keys:
        nf, nr, dt = _tile_key_args(key)
        p = key[2]
        t1, t2 = stiffness.degree_tile(p, nf, nr, stiffness.ITEMSIZE[dt])
        cut = (9, 2 * t1 // p + 1, 2 * t2 // p + 1)
        for grid in ((9, 5, 7), (13, 11, 17), cut):
            stiffness.MIN_BLOCKS = 1 if grid == cut else saved
            try:
                lat = LatticeStiffness(grid, p, (1.0, 1.0, 1.0), dt)
                out = hold_tile(key, lat, device, gen, rng, 1.0, True, "[22a]")
            finally:
                stiffness.MIN_BLOCKS = saved
            if grid == cut and not str(out["kernel"]).endswith("compiled"):
                raise AssertionError(f"[22a] {key} took {out['kernel']} on {grid}")
            held[key] = out
    say(f"[22a] done at {time.perf_counter() - t_phase:.1f} s")
    # (b) the run shapes, or MID_NODES_SIDE³ nodes
    for key in keys:
        fam, dtn, p, what = key
        nf, nr, dt = _tile_key_args(key)
        n = round((MID_NODES_SIDE - 1) / p)
        cells, where = RUN_CELLS.get(key, ((n,) * 3, "no full-size run"))
        lat = _lattice(cells, p, dt)
        scale = 1.0 if fam == "K1" else 1e-3
        out = hold_tile(key, lat, device, gen, rng, scale, fam != "K1" or nf == 2,
                        f"[22b] {where}", card, general=key in RUN_CELLS)
        if not str(out["kernel"]).endswith("compiled"):
            raise AssertionError(f"[22b] {key} took {out['kernel']} at {lat.gdims}")
        timed[key] = out
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    say(f"[22b] done at {time.perf_counter() - t_phase:.1f} s")
    # (c) the models through their entry points
    launches = {}
    f32, f64 = torch.float32, torch.float64
    for dt, p in ((f32, 2), (f32, 3), (f32, 5), (f32, 6), (f64, 2), (f64, 3), (f64, 4),
                  (f64, 5), (f64, 6)):
        dtn = str(dt).split(".")[-1]
        kinds = [k[3] for k in keys if k[0] == "K2" and k[1] == dtn and k[2] == p]
        fields = [k[3] for k in keys if k[0] == "K1" and k[1] == dtn and k[2] == p]
        launches.update(drive_tiles(device, dt, p, kinds, fields, card))
        if ("K2+band", dtn, p, "westervelt") in stiffness.COMPILED_TILES:
            launches.update(drive_band(device, dt, p, card))
    say(f"[22c] done at {time.perf_counter() - t_phase:.1f} s")
    # (d) ptxas: every compiled kernel built and named, no spills
    fixed = {k: v for k, v in ptxas.items() if "fixed_kernel" in k}
    for k, v in sorted(fixed.items()):
        say(f"[22d] {k}: {'; '.join(v)}")
    spills = [k for k, v in fixed.items() for t in v
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", t)]
    if ptxas and len(fixed) != len(keys):
        raise AssertionError(f"[22d] {len(fixed)} compiled kernels in the build log, "
                             f"{len(keys)} in the table")
    if spills:
        raise AssertionError(f"[22d] compiled kernels spill: {spills}")
    out = {}
    for key in keys:
        fam, dtn, p, what = key
        t = timed[key]
        name = t["kernel"]
        if launches.get(name, 0) < 1:
            raise AssertionError(f"[22c] {name} was not launched on its main path: {launches}")
        out[key] = dict(t, launches=launches[name], ptxas=ptxas_text(ptxas, tile_mangled(name)))
    say(f"[22] done in {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; needs one GPU")
    if not (ROOT / "fenicsxfus_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = phase_versions()
    ptxas = phase_build()
    headline = ((HEADLINE_NX,) * 3, 4)
    small = [((9, 5, 7), p) for p in (2, 3, 4)] + [((13, 11, 17), p) for p in (1, 5, 8)]
    k1 = phase_k1(device, card, small + [headline], headline)
    k2 = phase_k2(device, card, [((9, 5, 7), 4), headline], headline)
    phase_planewave(device)
    run = phase_headline(device, card, HEADLINE_NX)
    kinds = phase_kinds(device, card)
    channel = phase_channel(device)
    hitu_run = phase_hitu(device, card)
    phase_oneil(device)
    k4 = phase_k4(device, card)
    k5 = phase_k5(device, card)
    two = phase_two_kernel(device, card, hitu_run["peak_pa"])
    k3 = phase_k3(device, card)
    wave = phase_wave(device, card, hitu_run["peak_pa"])
    say(f"[12] HITU solve: K3 {wave['hitu']['solve_s']:.3f} s against K2 "
        f"{hitu_run['solve_s']:.3f} s; headline: K3 {wave['headline']['rate']:.4f} against K2 "
        f"{run['rate']:.4f} GDOF-RK4-updates/s ({card})")
    say(f"[12] HITU device memory peak: K3 {wave['hitu']['peak_gib']:.3f} GiB against K2 "
        f"{hitu_run['peak_gib']:.3f} GiB ([7]); {wave_plan_line((321, 189, 189), 'focused')}")
    bowl = phase_bowl_all(device, card)
    say(f"[13] bowl solve {bowl['bowl']['solve_s']:.3f} s ({bowl['bowl']['rate']:.4f} "
        f"GDOF-RK4-updates/s) against the flat aperture's {hitu_run['solve_s']:.3f} s "
        f"({hitu_run['rate']:.4f}, [7]); device memory peak {bowl['bowl']['peak_gib']:.3f} "
        f"against {hitu_run['peak_gib']:.3f} GiB ({card})")
    implicit = phase_implicit(device, card, ptxas)
    phase_general(device, card, bowl["bowl"])
    family = phase_family(device, card)
    prod = phase_production(device, card)
    with SideJobs() as side:
        slice18 = phase_slice(device, card, side)
        bench = phase_bench(device, card, side)
        sharded = phase_sharded(device, card, side, two["unfused"]["sharded"],
                                implicit["headline"]["sharded"], prod["ph1"][(1, 1)])
        split = phase_split(device, card, side)
    tiles = phase_tiles(device, card, ptxas)

    # launches on each kernel's main path: K1/K2 from phases [5]-[7], K4/K5
    # from phase [11], K3 from phase [12] (HITU for focused, the headline
    # for linear and for K1 through energy(), the unfused headline for K4,
    # the channels for lossy and westervelt)
    def stage_launches(headline_run, channel_runs, hitu, k):
        return {"linear": headline_run["launches"][k]["linear"],
                **{kind: channel_runs[kind][k] for kind in ("lossy", "westervelt")},
                "focused": hitu["launches"][k]["focused"]}

    k2_launches = stage_launches(run, channel, hitu_run, "K2")
    k5_launches = {k: stage_launches(two["headline"], two["channel"], two["hitu"], k)
                   for k in ("K5a", "K5b")}
    csrc = "fenicsxfus_tpu_torch/csrc/"

    def entry(name, source, replaces, launches, m):
        # no single PyTorch call computes any of these functions: library_ms is null; where
        # the record names the kernel its launch took (ops/stiffness.py::tile_kernel), the
        # source is that kernel's file
        if isinstance(m.get("kernel"), str):
            name, source = f"{name} [{m['kernel']}]", tile_source(m["kernel"])
        return {"name": name, "route": "cuda", "source": csrc + source, "replaces": replaces,
                "launches": launches, "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": None}

    kinds["linear"] = k2
    kernels = [entry("stiffness_apply (K1)", "stiffness.cu", "fenicsxfus_tpu/ops/pallas_v3.py:276",
                     run["launches"]["K1"], k1)]
    kernels += [entry(f"stage_apply {kind} (K2)", "stage.cu",
                      "fenicsxfus_tpu/ops/pallas_stage_v3.py:442", k2_launches[kind], kinds[kind])
                for kind in ("linear",) + NEW_KINDS]
    # K4's main path: the unfused headline through K4a -> K4b ([11])
    k4_launches = two["unfused"]["0"]["launches"]
    kernels += [entry("stiffness_axis0 (K4a)", "stiffness_ab.cu",
                      "fenicsxfus_tpu/ops/pallas_lattice.py:522", k4_launches["K4a"], k4["K4a"]),
                entry("stiffness_axes12 (K4b)", "stiffness_ab.cu",
                      "fenicsxfus_tpu/ops/pallas_lattice.py:572", k4_launches["K4b"], k4["K4b"])]
    for k, fn, line in (("K5a", "stage_a", 276), ("K5b", "stage_b", 444)):
        kernels += [entry(f"{fn} {kind} ({k})", "stage_ab.cu",
                          f"fenicsxfus_tpu/ops/pallas_stage.py:{line}", k5_launches[k][kind],
                          k5[kind][k])
                    for kind in ("linear",) + NEW_KINDS]
    k3_launches = stage_launches(wave["headline"], wave["channel"], wave["hitu"], "K3")
    kernels += [entry(f"step_wave_apply {kind} (K3)", "step_wave.cu",
                      "fenicsxfus_tpu/ops/pallas_step_wave.py:624", k3_launches[kind], k3[kind])
                for kind in ("linear",) + NEW_KINDS]
    # K2 with its band operand: launches on the bowl run ([13])
    kernels.append(entry("stage_apply westervelt +band (K2)", "stage.cu",
                         "fenicsxfus_tpu/ops/pallas_stage_v3.py:442",
                         bowl["bowl"]["launches"]["K2+band"]["westervelt"], bowl["band"]))
    # fp64 K1 on the implicit path ([14]): one field in the linear model's CG
    # at the headline, two fields in the lossy model's at the HITU lattice
    kernels += [entry("stiffness_apply fp64 (K1), linear implicit CG", "stiffness.cu",
                      "fenicsxfus_tpu/ops/pallas_v3.py:276",
                      implicit["headline"]["launches"]["K1"], implicit["k1"][1]),
                entry("stiffness_apply fp64 two fields (K1), lossy implicit CG", "stiffness.cu",
                      "fenicsxfus_tpu/ops/pallas_v3.py:276",
                      implicit["lossy"]["launches"]["K1"], implicit["k1"][2])]
    # fp32 K1 in the unfused step of S2 and the sponge ([16a], [16b]; timed
    # at the HITU lattice), fp64 K1 in the Newmark CG ([16c], the headline)
    # and in the adaptive attempts ([16d], the HITU lattice)
    fam = family
    kernels += [entry("stiffness_apply (K1), S2/sponge unfused step", "stiffness.cu",
                      "fenicsxfus_tpu/ops/pallas_v3.py:276",
                      fam["s2"]["launches"]["K1"] + fam["sponge"]["launches"]["K1"],
                      fam["s2"]["k1"]),
                entry("stiffness_apply fp64 (K1), Newmark CG", "stiffness.cu",
                      "fenicsxfus_tpu/ops/pallas_v3.py:276", fam["newmark"]["launches"]["K1"],
                      fam["newmark"]["k1"]),
                entry("stiffness_apply fp64 (K1), linear adaptive attempts", "stiffness.cu",
                      "fenicsxfus_tpu/ops/pallas_v3.py:276",
                      fam["adaptive"]["linear"]["launches"]["K1"],
                      fam["adaptive"]["linear"]["k1"]),
                entry("stiffness_apply fp64 two fields (K1), Westervelt adaptive attempts",
                      "stiffness.cu", "fenicsxfus_tpu/ops/pallas_v3.py:276",
                      fam["adaptive"]["westervelt"]["launches"]["K1"],
                      fam["adaptive"]["westervelt"]["k1"])]
    # K2 on [17]'s paths: focused at the 1.1 MHz lattice, and each PH1
    # case's kind at its lattice and coefficients (timed on the model's own
    # operands, the first non-final stage)
    k2 = prod["full"]["k2"]["non-final"]
    kernels.append(entry(f"stage_apply focused {k2['coeff']} (K2), W-H131-WATER 1.1 MHz "
                         f"{k2['gdims']}", "stage.cu", "fenicsxfus_tpu/ops/pallas_stage_v3.py:442",
                         prod["full"]["launches"], k2))
    for (sc, bm), kind in PH1_CASES.items():
        run = prod["ph1"][(sc, bm)]
        k2 = run["k2"]["non-final"]
        kernels.append(entry(f"stage_apply {kind} {k2['coeff']} p={run['degree']} (K2), PH1 "
                             f"SC{sc}-BM{bm} {k2['gdims']}", "stage.cu",
                             "fenicsxfus_tpu/ops/pallas_stage_v3.py:442", run["launches"], k2))
    # K1 at each degree of operator_speed ([18b]): about 38.3M DOF, constant
    # coefficient, launches in that phase's K1 rows
    for degree, m in slice18["operator"]["k1"].items():
        kernels.append(entry(f"stiffness_apply (K1) p={degree} const, operator_speed {m['gdims']}",
                             "stiffness.cu", "fenicsxfus_tpu/ops/pallas_v3.py:276",
                             m["launches"], m))
    # [19]: K2 of each kind and K1 at 417³ (phase_breakdown), K3 at 417³
    # (wave_attrib), K1 at the unstructured box's lattice, at the nx = 64
    # bowl lattice and on the S2 lattice 241³, and fp64 K2 with its band
    # and fp64 K1 on the nx = 36 bowl mesh; launches in each script's run
    pb = bench["phase"]
    for kind in ("linear", "lossy", "westervelt"):
        k2 = pb["held"][kind]["k2"]["non-final"]
        kernels.append(entry(f"stage_apply {kind} {k2['coeff']} (K2), phase_breakdown "
                             f"{k2['gdims']}", "stage.cu",
                             "fenicsxfus_tpu/ops/pallas_stage_v3.py:442",
                             pb["rows"][kind]["launches"]["K2"][kind], k2))
    kernels.append(entry("stiffness_apply (K1), phase_breakdown linear (417, 417, 417)",
                         "stiffness.cu", "fenicsxfus_tpu/ops/pallas_v3.py:276",
                         pb["rows"]["linear"]["launches"]["K1"], pb["held"]["linear"]["k1"]))
    wa = bench["wave"]
    kernels.append(entry(f"step_wave_apply linear (K3), wave_attrib {wa['gdims']}",
                         "step_wave.cu", "fenicsxfus_tpu/ops/pallas_step_wave.py:624",
                         wa["launches"]["K3"]["linear"], wa["k3"]))
    for key, name in (("unstructured", "unstructured_speed lattice row"),
                      ("sweep", "bowl_blend_sweep estimate_stable_dt"),
                      ("sc1_bm1", "ph1_sc1_bm1 S2 unfused step"),
                      ("convergence", "bowl_convergence estimate_stable_dt, fp64")):
        m = bench[key]["k1"]
        kernels.append(entry(f"stiffness_apply (K1), {name} {m['gdims']}", "stiffness.cu",
                             "fenicsxfus_tpu/ops/pallas_v3.py:276", m["launches"], m))
    k2 = bench["convergence"]["k2"]
    kernels.append(entry(f"stage_apply westervelt +band fp64 (K2), bowl_convergence "
                         f"{k2['gdims']}", "stage.cu", "fenicsxfus_tpu/ops/pallas_stage_v3.py:442",
                         k2["launches"], k2))
    # K1 on [20]'s sharded paths: world size 1 over NCCL at the headline (its
    # timing [2]'s at that lattice; fp64 [14]'s), and two gloo ranks on the
    # card (each case and rank held and timed on that rank's own operands)
    kernels += [entry("stiffness_apply (K1), sharded explicit, world size 1 (NCCL)",
                      "stiffness.cu", "fenicsxfus_tpu/ops/pallas_v3.py:276",
                      sharded["explicit"]["launches"]["K1"], k1),
                entry("stiffness_apply fp64 (K1), sharded implicit CG, world size 1 (NCCL)",
                      "stiffness.cu", "fenicsxfus_tpu/ops/pallas_v3.py:276",
                      sharded["implicit"]["launches"]["K1"], implicit["k1"][1])]
    kernels += [entry(f"stiffness_apply (K1), 2 gloo ranks on one card, {m['case']}, rank "
                      f"{m['rank']} {m['gdims']} {m['fields']} field(s)", "stiffness.cu",
                      "fenicsxfus_tpu/ops/pallas_v3.py:276", m["launches"], m)
                for m in sharded["k1"]]
    # K1 on [21]'s grid: world size 1 over NCCL at the headline (its timing
    # [2]'s at that lattice), and a (2, 2) grid of gloo ranks on the card
    # (each case and rank held and timed on that rank's own operands)
    kernels.append(entry("stiffness_apply (K1), grid (1, 1), world size 1 (NCCL)", "stiffness.cu",
                         "fenicsxfus_tpu/ops/pallas_v3.py:276",
                         two["unfused"]["grid"]["launches"]["K1"], k1))
    kernels += [entry(f"stiffness_apply (K1), (2, 2) grid of gloo ranks on one card, {m['case']}, "
                      f"rank {m['rank']} {m['gdims']} {m['fields']} field(s)", "stiffness.cu",
                      "fenicsxfus_tpu/ops/pallas_v3.py:276", m["launches"], m)
                for m in split["k1"]]
    # [22]: each compiled tile of csrc/tiles.cuh, timed at its run's shape, its
    # launches on [22c]'s main paths (the models at its degree and type)
    for key, m in tiles.items():
        k1 = key[0] == "K1"
        kernels.append(entry(f"{'stiffness_apply' if k1 else 'stage_apply'} at "
                             f"{m['gdims']} ({'K1' if k1 else 'K2'})", "",
                             "fenicsxfus_tpu/ops/pallas_v3.py:276" if k1
                             else "fenicsxfus_tpu/ops/pallas_stage_v3.py:442", m["launches"], m))
    say(f"chip_smoke.py: every phase passed in {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
