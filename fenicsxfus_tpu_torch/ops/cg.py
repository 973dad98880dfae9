"""Matrix-free preconditioned conjugate gradients (Jacobi preconditioner).

Port of ``fenicsxfus_tpu/ops/cg.py`` (the reference's PETSc KSP CG + PC
Jacobi of the implicit DIRK solvers, ``python/src/fenicsxfus/_linear.py:
644-647``). The vector updates and reductions are plain torch ops on the
fields' device; the matvec is the caller's ``A`` (on the card, K1).

The loop stops at the iteration the JAX package's ``lax.while_loop`` stops
at: its condition ``torch.dot(r, r) > tol2 and it < maxiter`` is read on the host
once per iteration (one device sync). α and β stay 0-d tensors on the
device, so the updates themselves need no host read; each update of x, r
and p is one ``addcmul`` pass.

``dot`` replaces the inner product, as in the JAX package: the sharded
solver (``parallel/slab.py``) passes the interface-weighted local dot summed
over the ranks. Every rank then reads the same ‖r‖² and takes the same
number of iterations.
"""

from __future__ import annotations

import torch


def cg_solve(A, b, x0, diag_inv, rtol=1e-8, maxiter=1000, dot=None):
    """Solve A x = b with PCG; ``A`` is a linear callable, ``diag_inv`` the
    inverse diagonal (Jacobi), ``dot`` an optional inner product returning a
    0-d tensor (default ``torch.dot``).

    Returns ``(x, (iterations, final ‖r‖²))``: the iteration count as a
    Python int and ‖r‖² as a 0-d tensor, the convergence information the
    reference gets from PETSc KSP (``_linear.py:644-647``)."""
    if dot is None:
        dot = torch.dot
    r = b - A(x0)
    z = diag_inv * r
    p = z
    rz = dot(r, z)
    # the tolerance in the fields' dtype, read once: comparing it with each
    # ‖r‖² read back (exact in a Python float) is the device's comparison
    tol2 = float(rtol * rtol * dot(b, b))

    x, it = x0, 0
    rr = dot(r, r)
    while it < maxiter and rr.item() > tol2:
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = torch.addcmul(x, alpha, p)  # x + α p, one pass
        r = torch.addcmul(r, alpha, Ap, value=-1.0)
        z = diag_inv * r
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = torch.addcmul(z, beta, p)
        rz = rz_new
        it += 1
        rr = dot(r, r)
    return x, (it, rr)
