"""Shared time-integration machinery for the wave models.

Port of ``fenicsxfus_tpu/models/common.py``. Butcher tables match the
reference (``python/src/fenicsxfus/_linear.py:40-65`` explicit, ``:543-585``
DIRK). The time loop is a
plain Python loop over per-step dt values (PyTorch runs eagerly; the JAX
package's ``lax.scan`` and its launch segmentation have no counterpart here).
Step start times are precomputed on the host in float64, so the source phase
never accumulates rounding of the field dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def explicit_tables(order: int):
    """Explicit RK tables: forward Euler, Ralston 2/3, classical RK4.

    These schemes use only the previous stage slope, encoded as a vector
    ``a`` (stage shift multiplies k_{i-1}) exactly like the reference.
    """
    if order == 1:
        return (0.0,), (1.0,), (0.0,)
    if order == 2:
        return (0.0, 2 / 3), (1 / 4, 3 / 4), (0.0, 2 / 3)
    if order == 3:
        return (0.0, 1 / 2, 3 / 4), (2 / 9, 1 / 3, 4 / 9), (0.0, 1 / 2, 3 / 4)
    if order == 4:
        return (
            (0.0, 0.5, 0.5, 1.0),
            (1 / 6, 1 / 3, 1 / 3, 1 / 6),
            (0.0, 0.5, 0.5, 1.0),
        )
    raise ValueError(f"unsupported explicit RK order {order}")


def dirk_tables(order: int):
    """SDIRK tables: backward Euler, Crouzeix 2/3-stage, 4-stage.

    ``A`` is a nested tuple (index ``A[i][j]``), all entries Python floats.
    """
    if order == 1:
        return ((1.0,),), (1.0,), (1.0,)
    if order == 2:
        return (
            ((1 / 4, 0.0), (1 / 2, 1 / 4)),
            (1 / 2, 1 / 2),
            (1 / 4, 3 / 4),
        )
    if order == 3:
        q = float(2 * np.cos(np.pi / 18) / np.sqrt(3))
        return (
            (
                ((1 + q) / 2, 0.0, 0.0),
                (-q / 2, (1 + q) / 2, 0.0),
                (1 + q, -(1 + 2 * q), (1 + q) / 2),
            ),
            (1 / (6 * q**2), 1 - 1 / (3 * q**2), 1 / (6 * q**2)),
            ((1 + q) / 2, 1 / 2, (1 - q) / 2),
        )
    if order == 4:
        return (
            (
                (1 / 2, 0.0, 0.0, 0.0),
                (1 / 6, 1 / 2, 0.0, 0.0),
                (-1 / 2, 1 / 2, 1 / 2, 0.0),
                (3 / 2, -3 / 2, 1 / 2, 1 / 2),
            ),
            (3 / 2, -3 / 2, 1 / 2, 1 / 2),
            (1 / 2, 2 / 3, 1 / 2, 1.0),
        )
    raise ValueError(f"unsupported DIRK order {order}")


def step_sizes(t0: float, tf: float, dt: float) -> np.ndarray:
    """Per-step dt values reproducing the reference loop
    ``while t < tf: dt = min(dt, tf - t)`` (``_linear.py:475-476``)."""
    span = tf - t0
    n_full = int(np.floor(span / dt + 1e-12))
    rem = span - n_full * dt
    dts = [dt] * n_full
    if rem > 1e-12 * max(abs(span), 1.0):
        dts.append(rem)
    return np.array(dts if dts else [0.0])


def source_window(t: float, freq: float, alpha: float = 4.0) -> tuple[float, float]:
    """Cosine ramp window over ``alpha`` source periods and its derivative
    (reference ``_lossy.py:169-180``), on the host in float64."""
    T = 1.0 / freq
    if t < T * alpha:
        ramp = 0.5 * (1.0 - math.cos(freq * math.pi * t / alpha))
        dramp = 0.5 * math.pi * freq / alpha * math.sin(freq * math.pi * t / alpha)
        return ramp, dramp
    return 1.0, 0.0


def make_rk_step(rhs, order: int):
    """Reference explicit-RK step (a-vector tables):
    ``step(consts, (u, v, t), dt) -> (u, v, t + dt)``.

    ``rhs(consts, t, u, v) -> (ku, kv)`` is the model's slope function with
    its device data passed as the ``consts`` dict."""
    a, b, c = explicit_tables(order)

    def step(consts, carry, dtn):
        u0, v0, t = carry
        ku = torch.zeros_like(u0)
        kv = torch.zeros_like(v0)
        u_acc, v_acc = u0, v0
        for i in range(len(b)):
            un = u0 + (a[i] * dtn) * ku
            vn = v0 + (a[i] * dtn) * kv
            tn = t + c[i] * dtn
            ku, kv = rhs(consts, tn, un, vn)
            u_acc = u_acc + (b[i] * dtn) * ku
            v_acc = v_acc + (b[i] * dtn) * kv
        return u_acc, v_acc, t + dtn

    return step


def run_steps(step, consts, u, v, t0: float, dts, record=None):
    """Apply ``step`` once per entry of ``dts``. Each step starts at its
    float64 host time t0 + Σ previous dts (never a time carried in the field
    dtype). ``record(i, u)``, if given, sees the state after step i."""
    dts64 = np.asarray(dts, np.float64)
    ts64 = float(t0) + np.concatenate([[0.0], np.cumsum(dts64)[:-1]])
    t = float(t0)
    for i, (dtn, tn) in enumerate(zip(dts64.tolist(), ts64.tolist())):
        u, v, t = step(consts, (u, v, tn), dtn)
        if record is not None:
            record(i, u)
    return u, v, t


def make_scan_from_step(step):
    """Wrap a step into ``solve(consts, u, v, t0, tf, dt) -> (u, v, t)``.

    If the step declares ``carry_shape`` (the fused stage does), u/v are
    viewed in that lattice shape for the loop and returned in their own."""
    carry_shape = getattr(step, "carry_shape", None)

    def solve(consts, u, v, t0: float, tf: float, dt: float):
        shape = u.shape
        if carry_shape is not None:
            u, v = u.view(carry_shape), v.view(carry_shape)
        u, v, t = run_steps(step, consts, u, v, t0, step_sizes(t0, tf, dt))
        return u.reshape(shape), v.reshape(shape), t

    return solve


def make_recording_scan(step, extract):
    """Like ``make_scan_from_step`` but records point sensors after every
    step: ``solve(consts, u, v, t0, tf, dt) -> (u, v, t, ys)`` with ``ys`` a
    device tensor [n_steps, n_sensors] of ``extract(u)``, filled in place
    step by step (no host sync inside the loop)."""
    carry_shape = getattr(step, "carry_shape", None)

    def solve(consts, u, v, t0: float, tf: float, dt: float):
        shape = u.shape
        if carry_shape is not None:
            u, v = u.view(carry_shape), v.view(carry_shape)
        dts = step_sizes(t0, tf, dt)
        ys = None

        def record(i, u_step):
            nonlocal ys
            y = extract(u_step)
            if ys is None:
                ys = y.new_empty((len(dts),) + tuple(y.shape))
            ys[i] = y

        u, v, t = run_steps(step, consts, u, v, t0, dts, record=record)
        return u.reshape(shape), v.reshape(shape), t, ys

    return solve
