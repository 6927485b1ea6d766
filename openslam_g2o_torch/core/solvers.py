"""Linear solvers for the normal equations: counterpart of
openslam_g2o_tpu/core/solvers.py:63-139, 157-164 and 213-297.

The closed-form small-block Cholesky factors feed the split-form
block-Jacobi scaling of the LM-PCG trial, and `pcg_solve` is the CG loop
of that trial. Operands of `pcg_solve` are dicts of per-group parts, as
the JAX pytrees are.
"""
from __future__ import annotations

import torch

__all__ = ["batched_chol_lower", "batched_chol_inv_lower", "pcg_solve"]


def batched_chol_inv_lower(A):
    """L^-1 for a batch of small SPD matrices A = L L^T ([..., D, D]).

    D <= 3 uses the closed-form scalar Cholesky and forward solve of
    solvers.py:63-104: a non-SPD block takes the square root of a negative
    number and yields NaN, which fails the PCG solve and triggers the LM
    lambda retry. Larger D uses torch.linalg (which raises instead)."""
    D = A.shape[-1]
    if D == 1:
        return 1.0 / torch.sqrt(A)
    if D == 2:
        l11 = torch.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l22 = torch.sqrt(A[..., 1, 1] - l21 * l21)
        m11 = 1.0 / l11
        m22 = 1.0 / l22
        m21 = -(l21 * m11) * m22
        z = torch.zeros_like(l11)
        return _rows((m11, z), (m21, m22))
    if D == 3:
        l11 = torch.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l31 = A[..., 2, 0] / l11
        l22 = torch.sqrt(A[..., 1, 1] - l21 * l21)
        l32 = (A[..., 2, 1] - l31 * l21) / l22
        l33 = torch.sqrt(A[..., 2, 2] - l31 * l31 - l32 * l32)
        m11 = 1.0 / l11
        m22 = 1.0 / l22
        m33 = 1.0 / l33
        m21 = -(l21 * m11) * m22
        m31 = -(l31 * m11 + l32 * m21) * m33
        m32 = -(l32 * m22) * m33
        z = torch.zeros_like(l11)
        return _rows((m11, z, z), (m21, m22, z), (m31, m32, m33))
    L = torch.linalg.cholesky(A)
    eye = torch.eye(D, dtype=A.dtype, device=A.device).expand(A.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def batched_chol_lower(A):
    """L for a batch of small SPD matrices A = L L^T (closed form for
    D <= 3, solvers.py:111-139; torch.linalg.cholesky beyond)."""
    D = A.shape[-1]
    if D == 1:
        return torch.sqrt(A)
    if D == 2:
        l11 = torch.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l22 = torch.sqrt(A[..., 1, 1] - l21 * l21)
        z = torch.zeros_like(l11)
        return _rows((l11, z), (l21, l22))
    if D == 3:
        l11 = torch.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l31 = A[..., 2, 0] / l11
        l22 = torch.sqrt(A[..., 1, 1] - l21 * l21)
        l32 = (A[..., 2, 1] - l31 * l21) / l22
        l33 = torch.sqrt(A[..., 2, 2] - l31 * l31 - l32 * l32)
        z = torch.zeros_like(l11)
        return _rows((l11, z, z), (l21, l22, z), (l31, l32, l33))
    return torch.linalg.cholesky(A)


def _rows(*rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _tree_dot(a: dict, b: dict):
    """Sum over groups of the flattened dot product (jnp.vdot per leaf)."""
    return sum(torch.dot(a[k].reshape(-1), b[k].reshape(-1)) for k in a)


def _tree_axpy(alpha, x: dict, y: dict):
    return {k: alpha * x[k] + y[k] for k in x}


def pcg_solve(matvec, b: dict, precond=None, max_iter: int = 100,
              tol: float = 1e-6, x0: dict = None, unroll: int = 1,
              norm: str = "true"):
    """Preconditioned conjugate gradient with a fixed iteration budget
    (solvers.py:213-297, LinearSolverPCG linear_solver_pcg.h:47-110).

    The semantics follow the JAX loop exactly, because the LM gain ratio
    sees every difference:
    * the stop test i < max_iter and pd and r2 > tol^2 b2 is checked once
      per `unroll` iterations (the LM-PCG trial uses unroll=2, so CG may run
      one iteration past the tolerance);
    * a non-positive curvature p^T H p gates alpha to 0 and stays gated
      (pd is sticky);
    * ok = finite(x) and (pd or converged); x is zeroed when not ok.

    Each stop test is one host read (`.item()`): one device sync per
    `unroll` CG iterations. Returns (x, ok) with ok a 0-dim bool tensor.
    """
    if precond is None:
        precond = lambda r: r
    use_precond_norm = norm == "precond"
    x = {k: torch.zeros_like(v) for k, v in b.items()} if x0 is None else x0
    hx = matvec(x)
    r = {k: b[k] - hx[k] for k in b}
    z = precond(r)
    p = z
    rz = _tree_dot(r, z)
    if use_precond_norm:
        r2 = rz
        b2 = torch.clamp_min(_tree_dot(b, precond(b)), 1e-30)
    else:
        r2 = _tree_dot(r, r)
        b2 = torch.clamp_min(_tree_dot(b, b), 1e-30)
    thresh = tol * tol * b2
    pd = torch.ones((), dtype=torch.bool, device=rz.device)
    i = 0
    while i < max_iter and bool((pd & (r2 > thresh)).item()):
        for _ in range(unroll):
            hp = matvec(p)
            denom = _tree_dot(p, hp)
            pd = pd & (denom > 0)
            safe = torch.where(denom == 0, torch.ones_like(denom), denom)
            alpha = torch.where(pd, rz / safe, torch.zeros_like(rz))
            x = _tree_axpy(alpha, p, x)
            r = _tree_axpy(-alpha, hp, r)
            z = precond(r)
            rz_new = _tree_dot(r, z)
            r2 = rz_new if use_precond_norm else _tree_dot(r, r)
            beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
            p = _tree_axpy(beta, p, z)
            rz = rz_new
            i += 1
    finite = torch.stack([torch.isfinite(v).all() for v in x.values()]).all()
    ok = finite & (pd | (r2 <= thresh))
    x = {k: torch.where(ok, v, torch.zeros_like(v)) for k, v in x.items()}
    return x, ok
