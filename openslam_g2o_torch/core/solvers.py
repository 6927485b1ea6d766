"""Linear solvers for the normal equations: counterpart of
openslam_g2o_tpu/core/solvers.py:25-297.

`solve_dense_cholesky` is the dense route's solve (one large factorization,
left to torch.linalg as the JAX package leaves it to XLA). The closed-form
small-block Cholesky factors (kernels/damp_chol.py) feed the split-form
block-Jacobi scaling of the LM-PCG trial, `pcg_solve` is the CG loop of that
trial and `make_chebyshev_precond` its optional polynomial preconditioner.
Operands of `pcg_solve` are dicts of per-group parts, as the JAX pytrees are;
a flat operator's loop runs on one vector holding every group's part.
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.kernels import cg_step as cg
from openslam_g2o_torch.kernels import chebyshev as cheb
from openslam_g2o_torch.kernels import jacobi_scale
from openslam_g2o_torch.kernels.damp_chol import (
    batched_chol_inv_lower, batched_chol_lower)

__all__ = ["solve_dense_cholesky", "batched_small_inv", "batched_chol_lower",
           "batched_chol_inv_lower", "make_chebyshev_precond", "BlockJacobi",
           "pcg_solve"]


def solve_dense_cholesky(H, b):
    """Solve H x = b by dense Cholesky. Returns (x, ok), ok a 0-dim bool
    tensor; nothing is read by the host.

    On failure ok is False and x is zeros, which the LM trial loop treats
    as the reference treats a failed factorization: chi2 = inf, retry with
    a larger lambda (optimization_algorithm_levenberg.cpp:119-120).
    jnp.linalg.cholesky marks a non-SPD matrix with NaN
    (openslam_g2o_tpu/core/solvers.py:142-154); LAPACK and cuSOLVER report
    it in `info` and leave the factor undefined, so `info != 0` is folded
    into ok beside the finiteness test."""
    L, info = torch.linalg.cholesky_ex(H, check_errors=False)
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
    ok = (info == 0) & torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x)), ok


def batched_small_inv(A):
    """Inverse of a batch of small SPD matrices [..., D, D]: the closed-form
    adjugate for D in {1, 2, 3}, torch.linalg.inv beyond
    (openslam_g2o_tpu/core/solvers.py:25-60)."""
    D = A.shape[-1]
    if D == 1:
        return 1.0 / A
    rows = lambda *r: torch.stack([torch.stack(x, dim=-1) for x in r], dim=-2)
    if D == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        inv_det = 1.0 / (a * d - b * c)
        return rows((d, -b), (-c, a)) * inv_det[..., None, None]
    if D == 3:
        a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
        d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
        g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
        A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
        A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
        A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
        inv_det = 1.0 / (a * A11 + b * A21 + c * A31)
        return rows((A11, A12, A13), (A21, A22, A23),
                    (A31, A32, A33)) * inv_det[..., None, None]
    return torch.linalg.inv(A)


def make_chebyshev_precond(matvec, lo, hi, degree: int):
    """Chebyshev polynomial preconditioner z = p(S) r, p the degree-1
    Chebyshev approximation of S^-1 on [lo, hi] (solvers.py:167-210; Saad,
    Iterative Methods for Sparse Linear Systems, Alg. 12.1).

    It spends degree-1 extra matvecs per outer CG iteration to cut the
    number of outer iterations, each of which carries the fixed cost of
    its launches and of the stop test. For an SPD S with spectrum in
    (0, hi] the polynomial is positive on the spectrum for any lo > 0, so
    the preconditioner stays SPD when lo overestimates lambda_min; pair it
    with a Gershgorin hi, which never underestimates.

    lo and hi may be 0-dim device tensors: the recurrence coefficients are
    computed on the device once (kernels/chebyshev.py), at the first
    application, and no host read is made. Returns apply(r: dict) -> dict;
    over a flat operator (one with `flatten`, core/sparse.py) r is the
    one-part dict {FLAT: vector} that `pcg_solve` hands it.
    """
    coef = []
    if hasattr(matvec, "flatten"):
        matvec = _FlatParts(matvec)

    def coefficients(like):
        if not coef:
            as_t = lambda v: torch.as_tensor(v, dtype=like.dtype,
                                             device=like.device)
            coef.append(cheb.chebyshev_coeffs(as_t(lo), as_t(hi), degree))
        return coef[0]

    def apply(r: dict) -> dict:
        c = coefficients(next(iter(r.values())))
        d, z = {}, {}
        for k, rk in r.items():
            d[k], z[k] = cheb.chebyshev_init(c, rk)
        for pair in range(degree - 1):
            sz = _contiguous(matvec(z))
            for k, rk in r.items():
                cheb.chebyshev_update(c, pair, rk, sz[k], d[k], z[k])
        return z

    return apply


FLAT = "flat"


class _FlatParts:
    """A flat operator (one with `flatten` and `split`, whose calls take
    one flat vector: core/sparse.py EllOperator, PairOperator) as a map
    of the one-part dict {FLAT: vector}, the form `pcg_solve` runs it in."""

    def __init__(self, op):
        self.op = op

    def __call__(self, x: dict) -> dict:
        return {FLAT: self.op(x[FLAT])}

    def matvec_dot(self, p: dict):
        hp, partials = self.op.matvec_dot(p[FLAT])
        return {FLAT: hp}, partials


class BlockJacobi:
    """The block-Jacobi preconditioner of the Schur routes' CG: z = M r per
    vertex group, M the group's factor table [D*D, N] (`tables`, keyed as
    the CG vectors; K11's inverse blocks). `pcg_solve` calls `apply_dot`,
    which also returns the partial sums of r . z, one K4
    `lane_block_mv_dot` launch per group where `lane_block_mv` and
    `dot_partials` were two."""

    def __init__(self, tables: dict):
        self.tables = tables

    def apply_dot(self, r: dict):
        """(z, partials of r . z over the groups in r's order)."""
        z, parts = {}, []
        for k, v in r.items():
            z[k], part = jacobi_scale.lane_block_mv_dot(self.tables[k], v)
            parts.append(part)
        return z, _cat(parts)


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _contiguous(parts: dict) -> dict:
    return {k: v.contiguous() for k, v in parts.items()}


def _matvec_dot(matvec, p: dict):
    """(H p, partial sums of p . H p): the operator's fused form where it
    has one, else the matvec and a dot kernel per group."""
    fused = getattr(matvec, "matvec_dot", None)
    if fused is not None:
        return fused(p)
    hp = _contiguous(matvec(p))
    return hp, _cat([cg.dot_partials(p[k], hp[k]) for k in p])


def _precond_dot(precond, r: dict):
    """(z = M r, partial sums of r . z): the preconditioner's fused form
    where it has one (`BlockJacobi.apply_dot`: one launch per group), else
    the preconditioner and a dot kernel per group."""
    fused = getattr(precond, "apply_dot", None)
    if fused is not None:
        return fused(r)
    z = _contiguous(precond(r))
    return z, _cat([cg.dot_partials(r[k], z[k]) for k in r])


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
      (pd is sticky); a zero denominator or rz is replaced by 1 before
      dividing;
    * b2 = max(b . M^-1 b, 1e-30) under norm="precond", max(b . b, 1e-30)
      under norm="true";
    * ok = finite(x) and (pd or converged); x is zeroed when not ok.

    The loop is written on the wrappers of kernels/cg_step.py: on the card
    one iteration is three launches (`matvec.matvec_dot` where the operator
    has it, `cg_update_xr`, `cg_update_p` per part; a preconditioner adds
    its own and one dot, or one launch per part where it has `apply_dot`,
    as `BlockJacobi` has), every CG scalar stays in a device buffer, and the
    only host read is the continue flag, once per `unroll` iterations.
    A flat operator (one with `flatten` and `split`: core/sparse.py
    EllOperator, PairOperator) runs on one flat vector, every group's part
    in it (`_pcg_flat`): each vector kernel is one launch over all groups,
    the preconditioner's too. Without a preconditioner, where it offers
    `matvec_dot_p`, an iteration is two launches (`_pcg_two_launch`):
    `cg_update_xr` stores the step's scalars (its last block, through an
    arrival counter) and `matvec_dot_p` forms the next direction p = beta
    p + r as it multiplies, into the other of two p buffers; the first
    iteration (p = r) multiplies with `matvec_dot`. On one group the
    arithmetic is the three-launch step's on the group's part, bit for
    bit. There the card may place `cg_update_xr`'s blocks while the
    product still runs (a programmatic dependent launch).
    On CPU tensors the same calls run the plain versions. `b`, `x0` and
    the result are dicts of groups; `matvec` and `precond` map a dict of
    parts to a dict of parts (a flat operator: vector to vector, and
    `precond` the one-part dict {FLAT: vector}); x0 and b are not
    modified. Returns (x, ok) with ok a 0-dim bool tensor.
    """
    if hasattr(matvec, "flatten"):
        return _pcg_flat(matvec, b, precond, max_iter, tol, x0, unroll, norm)
    keys = list(b)
    precond_norm = norm == "precond"
    if x0 is None:
        x = {k: torch.zeros_like(b[k]) for k in keys}
    else:
        x = {k: x0[k].clone(memory_format=torch.contiguous_format)
             for k in keys}
    hx = _contiguous(matvec(x))
    r, p, rr, bb = {}, {}, [], []
    for k in keys:
        r[k], p[k], part_rr, part_bb = cg.cg_residual(b[k].contiguous(),
                                                      hx[k])
        rr.append(part_rr)
        bb.append(part_bb)
    part_rr, part_b2 = _cat(rr), _cat(bb)
    if precond is None:
        z, part_rz = r, part_rr
    else:
        z, part_rz = _precond_dot(precond, r)
        p = {k: z[k].clone() for k in keys}     # p is updated in place
        if precond_norm:
            _, part_b2 = _precond_dot(
                precond, {k: b[k].contiguous() for k in keys})
    scal = cg.new_scalars(part_rz)
    cg.cg_start(scal, part_rz, part_rr, part_b2, tol, precond_norm)
    i = 0
    while i < max_iter and bool(scal[cg.CONT].item()):
        for _ in range(unroll):
            hp, part_pap = _matvec_dot(matvec, p)
            part_rr = _cat([cg.cg_update_xr(scal, part_pap, x[k], r[k],
                                            p[k], hp[k]) for k in keys])
            if precond is None:
                part_rz = part_rr
            else:
                z, part_rz = _precond_dot(precond, r)
            for k in keys:
                cg.cg_update_p(scal, part_rz, part_rr, z[k], p[k],
                               precond_norm)
            i += 1
    ok = cg.cg_finish(scal, [x[k] for k in keys])
    return x, ok


def _pcg_flat(op, b, precond, max_iter, tol, x0, unroll, norm):
    """`pcg_solve` on a flat operator: b and x0 flattened once (`flatten`:
    an EllOperator's one group as it lies, a PairOperator's groups each
    vertex-major, one after another), the loop on the one flat vector,
    the result taken apart by `split`."""
    bf = op.flatten({k: v.contiguous() for k, v in b.items()})
    x0f = None if x0 is None else op.flatten(x0)
    if precond is None and hasattr(op, "matvec_dot_p"):
        x, ok = _pcg_two_launch(op, bf, max_iter, tol, x0f, unroll,
                                norm == "precond")
    else:
        x, ok = pcg_solve(_FlatParts(op), {FLAT: bf}, precond, max_iter,
                          tol, None if x0f is None else {FLAT: x0f}, unroll,
                          norm)
        x = x[FLAT]
    return op.split(x), ok


def _pcg_two_launch(op, b, max_iter, tol, x0, unroll, precond_norm):
    """`pcg_solve` without a preconditioner on a flat operator with
    `matvec_dot_p`: two launches per CG iteration on the flat b and x0."""
    if x0 is None:
        x = torch.zeros_like(b)
    else:
        x = x0.clone(memory_format=torch.contiguous_format)
    r, p, part_rr, part_b2 = cg.cg_residual(b, op(x).contiguous())
    scal = cg.new_scalars(part_rr)
    cg.cg_start(scal, part_rr, part_rr, part_b2, tol, precond_norm)
    arrivals = torch.zeros(1, dtype=torch.int32, device=scal.device)
    spare = _spare(p)
    i = 0
    while i < max_iter and bool(scal[cg.CONT].item()):
        for _ in range(unroll):
            if i == 0:
                hp, part_pap = op.matvec_dot(p)
            else:
                hp, part_pap = op.matvec_dot_p(scal, p, r, spare)
                p, spare = spare, p
            cg.cg_update_xr(scal, part_pap, x, r, p, hp, arrivals)
            i += 1
    return x, cg.cg_finish(scal, [x])


def _spare(like):
    """The second p buffer of the two-launch step: written before it is
    read, so it starts uninitialized."""
    return torch.empty_like(like)
