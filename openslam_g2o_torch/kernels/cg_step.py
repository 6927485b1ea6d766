"""K6: the conjugate-gradient step of the LM-PCG trial solve as a few fused
kernels with every CG scalar on the device (csrc/cg_step.cu).

Replaces the loop of `pcg_solve` (openslam_g2o_tpu/core/solvers.py:213-297).
core/solvers.py drives these wrappers on both devices; one CG iteration is
`spmv_dot`, `cg_update_xr`, `cg_update_p`, or without a preconditioner
`spmv_dot_p` (p's update folded into the product that reads p next) and
`cg_update_xr` with an arrival counter (its last block stores the scalars
`cg_update_p` stored), after a first iteration on `spmv_dot`. The scalars
live in one small tensor `scal` (dtype of the vectors) whose slots are
named below; a dot product is passed on as a tensor of per-block partial
sums, which the next kernel re-reduces in a fixed order (on the CPU the
plain versions hand on one partial: the torch.dot). The vector arguments
are flat or [D, N] contiguous tensors (D = 3 or 6: the vector kernels are
flat over the D N values, `spmv_dot` and `spmv_dot_p` are instantiated per
block width); x, r and p are updated in place.
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    BLOCK_WIDTHS, check_tensors, check_vectors, launch_device)
from openslam_g2o_torch.kernels.spmv import block_ell_spmv_plain

# slots of `scal` (mirrored in csrc/cg_step.cu)
RZ, R2, B2, THRESH, PD, CONT, RZ_OLD, PD_NEXT, ALPHA, BETA = range(10)
N_SCALARS = 10
# elements per block of the vector kernels (kChunk of csrc/common.cuh)
CHUNK = 1024
ROW_BLOCK = 256
# values per block of cg_update_xr (kXrShare of csrc/cg_step.cu): a
# constant, so that its r . r partials and their sums are the same on
# every card
XR_SHARE = 2048


def new_scalars(like):
    """An uninitialized scalar buffer for vectors like `like`."""
    return torch.empty(N_SCALARS, dtype=like.dtype, device=like.device)


def _chunks(n):
    return max((n + CHUNK - 1) // CHUNK, 1)


def xr_blocks(n):
    """The blocks, and so the r . r partials, of `cg_update_xr` on the card
    for n values: one per XR_SHARE values (xr_blocks of csrc/cg_step.cu)."""
    return max((n + XR_SHARE - 1) // XR_SHARE, 1)


def _partials(like, count):
    return torch.empty(count, dtype=like.dtype, device=like.device)


def _check_scal(name, scal, like, **partials):
    """The scalar buffer and the partial-sum tensors that go with it."""
    if scal.shape != (N_SCALARS,):
        raise ValueError(f"{name}: scal must have {N_SCALARS} entries")
    check_tensors(name, like.device, like.dtype, {"scal": scal, **partials},
                  {})


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1)).reshape(1)


# -- spmv_dot ---------------------------------------------------------------

def spmv_dot_plain(nb, values, p):
    hp = block_ell_spmv_plain(nb, values, p)
    return hp, _dot(p, hp)


def spmv_dot(nb, values, p):
    """(hp, partials): hp = H p on the block-ELL layout of kernel A and
    partial sums of p . hp."""
    K, N = nb.shape
    D = p.shape[0]
    if (D not in BLOCK_WIDTHS or values.shape != (K, D * D, N)
            or p.shape != (D, N)):
        raise ValueError(f"spmv_dot: values {tuple(values.shape)} and p "
                         f"{tuple(p.shape)} do not fit nb {(K, N)} for a "
                         f"block width in {BLOCK_WIDTHS}")
    check_tensors("spmv_dot", p.device, p.dtype,
                  {"values": values, "p": p}, {"nb": nb})
    if not launch_device("spmv_dot", p.device):
        return spmv_dot_plain(nb, values, p)
    hp = torch.empty_like(p)
    blocks = max((N + ROW_BLOCK - 1) // ROW_BLOCK, 1)
    partials = (_partials(p, blocks) if N
                else torch.zeros(1, dtype=p.dtype, device=p.device))
    if N == 0:
        return hp, partials
    build.launch("g2o_spmv_dot", p, nb.data_ptr(), values.data_ptr(),
                 p.data_ptr(), hp.data_ptr(), partials.data_ptr(), N, K, D)
    spmv_dot.launches += 1
    return hp, partials


spmv_dot.launches = 0


# -- spmv_dot_p -------------------------------------------------------------

def spmv_dot_p_plain(nb, values, scal, p, r, p_new):
    p_new.copy_(scal[BETA] * p + r)
    return spmv_dot_plain(nb, values, p_new)


def spmv_dot_p(nb, values, scal, p, r, p_new):
    """(hp, partials) for the next direction p_new = beta p + r (beta from
    `scal`, stored by the last `cg_update_xr` with an arrival counter),
    written into `p_new` (another buffer than p: the product gathers p at
    the neighbour columns): hp = H p_new on the block-ELL layout and partial
    sums of p_new . hp. The bits of `cg_update_p` (z = r) followed by
    `spmv_dot`."""
    K, N = nb.shape
    D = p.shape[0]
    if (D not in BLOCK_WIDTHS or values.shape != (K, D * D, N)
            or p.shape != (D, N)):
        raise ValueError(f"spmv_dot_p: values {tuple(values.shape)} and p "
                         f"{tuple(p.shape)} do not fit nb {(K, N)} for a "
                         f"block width in {BLOCK_WIDTHS}")
    check_vectors("spmv_dot_p", p, r=r, p_new=p_new)
    _check_scal("spmv_dot_p", scal, p, values=values)
    check_tensors("spmv_dot_p", p.device, p.dtype, {}, {"nb": nb})
    if p_new.data_ptr() == p.data_ptr():
        raise ValueError("spmv_dot_p: p_new must be another buffer than p")
    if not launch_device("spmv_dot_p", p.device):
        return spmv_dot_p_plain(nb, values, scal, p, r, p_new)
    hp = torch.empty_like(p)
    blocks = max((N + ROW_BLOCK - 1) // ROW_BLOCK, 1)
    partials = (_partials(p, blocks) if N
                else torch.zeros(1, dtype=p.dtype, device=p.device))
    if N == 0:
        return hp, partials
    build.launch("g2o_spmv_dot_p", p, nb.data_ptr(), values.data_ptr(),
                 scal.data_ptr(), p.data_ptr(), r.data_ptr(),
                 p_new.data_ptr(), hp.data_ptr(), partials.data_ptr(), N, K,
                 D)
    spmv_dot_p.launches += 1
    return hp, partials


spmv_dot_p.launches = 0


# -- dot_partials -----------------------------------------------------------

def dot_partials_plain(a, b):
    return _dot(a, b)


def dot_partials(a, b):
    """Partial sums of a . b (their sum, in order, is the dot product)."""
    check_vectors("dot_partials", a, a=a, b=b)
    if not launch_device("dot_partials", a.device):
        return dot_partials_plain(a, b)
    n = a.numel()
    partials = _partials(a, _chunks(n))
    build.launch("g2o_dot_partials", a, a.data_ptr(), b.data_ptr(),
                 partials.data_ptr(), n)
    dot_partials.launches += 1
    return partials


dot_partials.launches = 0


# -- cg_residual ------------------------------------------------------------

def cg_residual_plain(b, hx):
    r = b - hx
    return r, r.clone(), _dot(r, r), _dot(b, b)


def cg_residual(b, hx):
    """(r, p, partials of r . r, partials of b . b) with r = b - hx and p a
    separate copy of r."""
    check_vectors("cg_residual", b, b=b, hx=hx)
    if not launch_device("cg_residual", b.device):
        return cg_residual_plain(b, hx)
    n = b.numel()
    r, p = torch.empty_like(b), torch.empty_like(b)
    part_rr, part_bb = _partials(b, _chunks(n)), _partials(b, _chunks(n))
    build.launch("g2o_cg_residual", b, b.data_ptr(), hx.data_ptr(),
                 r.data_ptr(), p.data_ptr(), part_rr.data_ptr(),
                 part_bb.data_ptr(), n)
    cg_residual.launches += 1
    return r, p, part_rr, part_bb


cg_residual.launches = 0


# -- cg_start ---------------------------------------------------------------

def cg_start_plain(scal, part_rz, part_rr, part_b2, tol, precond_norm):
    rz = part_rz.sum()
    r2 = rz if precond_norm else part_rr.sum()
    b2 = torch.clamp_min(part_b2.sum(), 1e-30)
    thresh = tol * tol * b2
    scal.zero_()
    scal[RZ], scal[R2], scal[B2], scal[THRESH] = rz, r2, b2, thresh
    scal[RZ_OLD] = rz
    scal[PD] = 1.0
    scal[PD_NEXT] = 1.0
    scal[CONT] = (r2 > thresh).to(scal.dtype)


def cg_start(scal, part_rz, part_rr, part_b2, tol, precond_norm):
    """Fill `scal` for a fresh solve: rz and r2 (rz under the
    preconditioned norm, else r . r), b2 = max(sum part_b2, 1e-30),
    thresh = tol^2 b2, pd true, and the continue flag r2 > thresh."""
    _check_scal("cg_start", scal, part_rz, part_rz=part_rz, part_rr=part_rr,
                part_b2=part_b2)
    if not launch_device("cg_start", scal.device):
        return cg_start_plain(scal, part_rz, part_rr, part_b2, tol,
                              precond_norm)
    build.launch("g2o_cg_start", scal, scal.data_ptr(), part_rz.data_ptr(),
                 part_rz.numel(), part_rr.data_ptr(), part_rr.numel(),
                 part_b2.data_ptr(), part_b2.numel(), float(tol) * float(tol),
                 int(precond_norm))
    cg_start.launches += 1


cg_start.launches = 0


# -- cg_update_xr -----------------------------------------------------------

def _store_step(scal, rz_new, r2, beta):
    """The scalars that close a CG step: rz, r2, pd (from pd_next), beta
    and the continue flag pd and r2 > thresh."""
    pd = scal[PD_NEXT].clone()
    scal[RZ], scal[R2], scal[PD], scal[BETA] = rz_new, r2, pd, beta
    scal[CONT] = ((pd != 0) & (r2 > scal[THRESH])).to(scal.dtype)


def _beta(scal, rz_new):
    rz_old = scal[RZ_OLD]
    return rz_new / torch.where(rz_old == 0, torch.ones_like(rz_old), rz_old)


def cg_update_xr_plain(scal, part_pap, x, r, p, hp, arrivals=None):
    denom = part_pap.sum()
    rz = scal[RZ].clone()
    pd = (scal[PD] != 0) & (denom > 0)
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    alpha = torch.where(pd, rz / safe, torch.zeros_like(rz))
    x.copy_(alpha * p + x)
    r.copy_(-alpha * hp + r)
    scal[RZ_OLD] = rz
    scal[PD_NEXT] = pd.to(scal.dtype)
    scal[ALPHA] = alpha
    part_rr = _dot(r, r)
    if arrivals is not None:
        rz_new = part_rr.sum()
        _store_step(scal, rz_new, rz_new, _beta(scal, rz_new))
    return part_rr


def cg_update_xr(scal, part_pap, x, r, p, hp, arrivals=None):
    """denom = sum part_pap; pd &= denom > 0; alpha = pd ? rz / safe(denom)
    : 0; x += alpha p; r -= alpha hp (both in place). Returns the partial
    sums of r . r. With `arrivals` (one int32 counter at zero, left at
    zero) it also closes the step for z = r: it stores what `cg_update_p`
    stores, rz = r2 = r . r, beta, pd and the continue flag, and leaves p
    to `spmv_dot_p`. On the card it is a programmatic dependent launch:
    it may start while the kernel before it on the stream still runs, and
    its blocks wait for that kernel before they read anything."""
    check_vectors("cg_update_xr", x, x=x, r=r, p=p, hp=hp)
    _check_scal("cg_update_xr", scal, x, part_pap=part_pap)
    if arrivals is not None:
        check_tensors("cg_update_xr", x.device, x.dtype, {},
                      {"arrivals": arrivals})
        if arrivals.numel() != 1:
            raise ValueError("cg_update_xr: arrivals must hold one counter")
    if not launch_device("cg_update_xr", x.device):
        return cg_update_xr_plain(scal, part_pap, x, r, p, hp, arrivals)
    n = x.numel()
    part_rr = _partials(x, xr_blocks(n))
    build.launch("g2o_cg_update_xr", x, scal.data_ptr(), part_pap.data_ptr(),
                 part_pap.numel(), x.data_ptr(), r.data_ptr(), p.data_ptr(),
                 hp.data_ptr(), part_rr.data_ptr(), n,
                 None if arrivals is None else arrivals.data_ptr())
    cg_update_xr.launches += 1
    return part_rr


cg_update_xr.launches = 0


# -- cg_update_p ------------------------------------------------------------

def cg_update_p_plain(scal, part_rz, part_rr, z, p, precond_norm):
    rz_new = part_rz.sum()
    r2 = rz_new if precond_norm or part_rr is part_rz else part_rr.sum()
    beta = _beta(scal, rz_new)
    p.copy_(beta * p + z)
    _store_step(scal, rz_new, r2, beta)


def cg_update_p(scal, part_rz, part_rr, z, p, precond_norm):
    """rz_new = sum part_rz; beta = rz_new / safe(rz); p = z + beta p in
    place; stores rz, r2 (rz_new under the preconditioned norm, else sum
    part_rr), pd and the continue flag pd and r2 > thresh."""
    check_vectors("cg_update_p", p, z=z, p=p)
    _check_scal("cg_update_p", scal, p, part_rz=part_rz, part_rr=part_rr)
    if not launch_device("cg_update_p", p.device):
        return cg_update_p_plain(scal, part_rz, part_rr, z, p, precond_norm)
    build.launch("g2o_cg_update_p", p, scal.data_ptr(), part_rz.data_ptr(),
                 part_rz.numel(), part_rr.data_ptr(), part_rr.numel(),
                 z.data_ptr(), p.data_ptr(), p.numel(), int(precond_norm))
    cg_update_p.launches += 1


cg_update_p.launches = 0


# -- cg_finish --------------------------------------------------------------

def cg_finish_plain(scal, xs):
    finite = torch.stack([torch.isfinite(x).all() for x in xs]).all()
    ok = finite & ((scal[PD] != 0) | (scal[R2] <= scal[THRESH]))
    for x in xs:
        x.copy_(torch.where(ok, x, torch.zeros_like(x)))
    return ok


def cg_finish(scal, xs):
    """ok = every x finite and (pd or r2 <= thresh), a 0-dim bool tensor;
    the vectors `xs` are zeroed in place when not ok. Two launches per
    vector (the non-finite counts, then the flag and the zeroing), counted
    as one call."""
    xs = list(xs)
    for i, x in enumerate(xs):
        check_tensors("cg_finish", xs[0].device, xs[0].dtype,
                      {f"x[{i}]": x}, {})
    _check_scal("cg_finish", scal, xs[0])
    if not launch_device("cg_finish", scal.device):
        return cg_finish_plain(scal, xs)
    dev = scal.device
    counts = [_chunks(x.numel()) for x in xs]
    bad = torch.empty(sum(counts), dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    offset = 0
    for x, c in zip(xs, counts):
        build.launch("g2o_nonfinite_partials", x, x.data_ptr(),
                     bad.data_ptr() + 4 * offset, x.numel())
        offset += c
    for x in xs:
        build.launch("g2o_cg_finish", x, scal.data_ptr(), bad.data_ptr(),
                     bad.numel(), x.data_ptr(), ok.data_ptr(), x.numel())
    cg_finish.launches += 1
    return ok


cg_finish.launches = 0
