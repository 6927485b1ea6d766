"""K7: the candidate, its chi2 and the LM bookkeeping of one trial
(csrc/retract_chi2.cu for SE2 poses, csrc/retract_chi2_se3.cu for SE3).

Replaces, on the pose-graph LM-PCG path, `apply_update_parts`
(openslam_g2o_tpu/core/problem.py:557-565) with `se2_retract` /
`se3_retract_mqt` (ops/lie.py:96, :256), `robust_chi2`
(core/problem.py:302-329) and the trial body of `_lm_pcg_step`
(core/algorithms.py:306-332):

    retract_chi2  SE2: cand = retract(x, dx * free); partial sums of
                  dx . (lambda dx + b); per edge group, partial sums of
                  rho(e^T Omega e) at cand
    retract_se3   SE3: cand = x * fromVectorMQT(dx * free) and the partial
                  sums of dx . (lambda dx + b)
    se3_edge_chi2 SE3: one EDGE_SE3 group's partial sums of rho(e^T Omega e)
                  at cand
    lm_outcome    chi2_new, rho, accept, lambda, nu and the retry flag from
                  those sums, ok, lambda, nu and chi2_cur, all on the device

`lm_outcome` is also the bookkeeping of the dense LM trial
(core/algorithms.py `_lm_step`), which hands it its chi2 and its dot product
as one partial each.
"""
from __future__ import annotations

import math

import torch

from openslam_g2o_torch.core import robust
from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)
from openslam_g2o_torch.ops import lie

BLOCK = 256          # kThreads of csrc/common.cuh


def _blocks(n):
    return max((n + BLOCK - 1) // BLOCK, 1)


# -- retract_chi2 -----------------------------------------------------------

def retract_chi2_plain(x, dxT, free, bT, lam, edge_groups):
    """Plain PyTorch version: (cand [N, 3], the dot product as one partial,
    one chi2 partial per edge group)."""
    cand = lie.se2_retract(x, dxT.T * free[:, None])
    part_dot = torch.dot(dxT.reshape(-1),
                         (lam * dxT + bT).reshape(-1)).reshape(1)
    part_chi = []
    for ii, jj, meas, info, delta, kernel_id in edge_groups:
        r = lie.se2_error(lie.se2_inverse(meas), cand[ii.long()],
                          cand[jj.long()])
        e2 = (r[:, :, None] * info * r[:, None, :]).sum(dim=(1, 2))
        rho0, _, _ = robust.robustify(kernel_id, e2, delta)
        part_chi.append(rho0.sum())
    if not part_chi:
        part_chi.append(torch.zeros((), dtype=x.dtype, device=x.device))
    return cand, part_dot, torch.stack(part_chi)


def retract_chi2(x, dxT, free, bT, lam, edge_groups):
    """One trial's candidate and sums on an SE2 pose graph. x [N, 3]
    params, dxT and bT [3, N] lane-major step and gradient, free [N], lam a
    0-dim tensor, edge_groups a list of (ii [E] int32, jj [E] int32,
    meas [E, 3], info [E, 3, 3], delta [E], kernel_id) in the order of
    static.egroups. Returns (cand [N, 3], partial sums of dx . (lam dx + b),
    partial sums of sum rho(e^T Omega e) laid out group after group). K7 on
    CUDA tensors (one counted call launches the vertex kernel and one edge
    kernel per group), the plain version on CPU tensors."""
    N = x.shape[0]
    require(x.shape == (N, 3) and free.shape == (N,),
            "retract_chi2: x must be [N, 3] and free [N]")
    require(dxT.shape == (3, N) and bT.shape == (3, N),
            "retract_chi2: dxT and bT must be [3, N]")
    require(lam.dim() == 0, "retract_chi2: lam must be a 0-dim tensor")
    floats = {"x": x, "dxT": dxT, "free": free, "bT": bT, "lam": lam}
    ints = {}
    for g, (ii, jj, meas, info, delta, kernel_id) in enumerate(edge_groups):
        E = ii.shape[0]
        require(jj.shape == (E,) and meas.shape == (E, 3)
                and info.shape == (E, 3, 3) and delta.shape == (E,),
                f"retract_chi2: edge group {g} must be [E], [E], [E, 3], "
                "[E, 3, 3], [E]")
        require(0 <= kernel_id < len(robust.kernel_names()),
                f"retract_chi2: unknown robust kernel id {kernel_id}")
        floats.update({f"meas[{g}]": meas, f"info[{g}]": info,
                       f"delta[{g}]": delta})
        ints.update({f"ii[{g}]": ii, f"jj[{g}]": jj})
    check_tensors("retract_chi2", x.device, x.dtype, floats, ints)
    if not launch_device("retract_chi2", x.device):
        return retract_chi2_plain(x, dxT, free, bT, lam, edge_groups)
    cand = torch.empty_like(x)
    part_dot = torch.empty(_blocks(N), dtype=x.dtype, device=x.device)
    counts = [_blocks(g[0].shape[0]) for g in edge_groups]
    part_chi = torch.empty(max(sum(counts), 1), dtype=x.dtype,
                           device=x.device)
    if not counts:
        part_chi.zero_()
    build.launch("g2o_retract_se2", x, x.data_ptr(), dxT.data_ptr(),
                 free.data_ptr(), bT.data_ptr(), lam.data_ptr(),
                 cand.data_ptr(), part_dot.data_ptr(), N)
    offset = 0
    for (ii, jj, meas, info, delta, kernel_id), c in zip(edge_groups, counts):
        build.launch("g2o_se2_edge_chi2", x, cand.data_ptr(), ii.data_ptr(),
                     jj.data_ptr(), meas.data_ptr(), info.data_ptr(),
                     delta.data_ptr(), int(kernel_id),
                     part_chi.data_ptr() + offset * x.element_size(),
                     ii.shape[0])
        offset += c
    retract_chi2.launches += 1
    return cand, part_dot, part_chi


retract_chi2.launches = 0


# -- retract_se3 / se3_edge_chi2 ---------------------------------------------

def retract_se3_plain(x, dxT, free, bT, lam):
    """Plain PyTorch version: (cand [N, 7], the dot product as one
    partial)."""
    cand = lie.se3_retract_mqt(x, dxT.T * free[:, None])
    part_dot = torch.dot(dxT.reshape(-1),
                         (lam * dxT + bT).reshape(-1)).reshape(1)
    return cand, part_dot


def retract_se3(x, dxT, free, bT, lam):
    """One trial's candidate on an SE3 pose graph: x [N, 7] params, dxT and
    bT [6, N] lane-major step and gradient, free [N], lam a 0-dim tensor.
    Returns (cand [N, 7] = x * fromVectorMQT(dx * free) with the quaternion
    renormalized, partial sums of dx . (lam dx + b)). The kernel on CUDA
    tensors, the plain version on CPU tensors."""
    N = x.shape[0]
    require(x.shape == (N, 7) and free.shape == (N,),
            "retract_se3: x must be [N, 7] and free [N]")
    require(dxT.shape == (6, N) and bT.shape == (6, N),
            "retract_se3: dxT and bT must be [6, N]")
    require(lam.dim() == 0, "retract_se3: lam must be a 0-dim tensor")
    check_tensors("retract_se3", x.device, x.dtype,
                  {"x": x, "dxT": dxT, "free": free, "bT": bT, "lam": lam},
                  {})
    if not launch_device("retract_se3", x.device):
        return retract_se3_plain(x, dxT, free, bT, lam)
    cand = torch.empty_like(x)
    part_dot = torch.empty(_blocks(N), dtype=x.dtype, device=x.device)
    build.launch("g2o_retract_se3", x, x.data_ptr(), dxT.data_ptr(),
                 free.data_ptr(), bT.data_ptr(), lam.data_ptr(),
                 cand.data_ptr(), part_dot.data_ptr(), N)
    retract_se3.launches += 1
    return cand, part_dot


retract_se3.launches = 0


def se3_edge_chi2_plain(cand, ii, jj, meas, info, delta, kernel_id):
    """Plain PyTorch version: the group's robust chi2 as one partial."""
    r = lie.se3_error_mqt(lie.se3_inverse(meas), cand[ii.long()],
                          cand[jj.long()])
    e2 = (r[:, :, None] * info * r[:, None, :]).sum(dim=(1, 2))
    rho0, _, _ = robust.robustify(kernel_id, e2, delta)
    return rho0.sum().reshape(1)


def se3_edge_chi2(cand, ii, jj, meas, info, delta, kernel_id):
    """Partial sums of sum_e rho(e^T Omega e) of one EDGE_SE3 group at the
    poses cand [N, 7]: ii/jj [E] int32, meas [E, 7], info [E, 6, 6],
    delta [E]. The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    E = ii.shape[0]
    require(cand.dim() == 2 and cand.shape[1] == 7,
            "se3_edge_chi2: cand must be [N, 7]")
    require(jj.shape == (E,) and meas.shape == (E, 7)
            and info.shape == (E, 6, 6) and delta.shape == (E,),
            "se3_edge_chi2: edge arrays must be [E], [E, 7], [E, 6, 6], [E]")
    require(0 <= kernel_id < len(robust.kernel_names()),
            f"se3_edge_chi2: unknown robust kernel id {kernel_id}")
    check_tensors("se3_edge_chi2", cand.device, cand.dtype,
                  {"cand": cand, "meas": meas, "info": info, "delta": delta},
                  {"ii": ii, "jj": jj})
    if not launch_device("se3_edge_chi2", cand.device):
        return se3_edge_chi2_plain(cand, ii, jj, meas, info, delta, kernel_id)
    partials = torch.empty(_blocks(E), dtype=cand.dtype, device=cand.device)
    build.launch("g2o_se3_edge_chi2", cand, cand.data_ptr(), ii.data_ptr(),
                 jj.data_ptr(), meas.data_ptr(), info.data_ptr(),
                 delta.data_ptr(), int(kernel_id), partials.data_ptr(), E)
    se3_edge_chi2.launches += 1
    return partials


se3_edge_chi2.launches = 0


# -- lm_outcome -------------------------------------------------------------

def lm_outcome_plain(part_chi, part_dot, ok, lam, ni, chi_cur):
    """Plain PyTorch version: the reference's trial bookkeeping, every
    value a 0-dim tensor."""
    chi_new = part_chi.sum()
    # a non-finite trial chi2 behaves like a failed solve: rho is pinned
    # negative so the trial loop retries (a NaN rho would end it)
    solved = ok & torch.isfinite(chi_new)
    chi_new = torch.where(solved, chi_new, torch.full_like(chi_new, math.inf))
    scale = part_dot.sum() + 1e-3
    rho = torch.where(solved, (chi_cur - chi_new) / scale,
                      torch.full_like(chi_new, -1.0))
    accept = (rho > 0) & torch.isfinite(chi_new)
    t = 2.0 * rho - 1.0
    alpha = 1.0 - t * t * t
    good = torch.clamp_min(torch.clamp_max(alpha, 2.0 / 3.0), 1.0 / 3.0)
    lam_new = torch.where(accept, lam * good, lam * ni)
    ni_new = torch.where(accept, torch.full_like(ni, 2.0), ni * 2.0)
    return chi_new, rho, accept, lam_new, ni_new, (~accept) & (rho < 0)


def lm_outcome(part_chi, part_dot, ok, lam, ni, chi_cur):
    """The LM bookkeeping of one trial
    (optimization_algorithm_levenberg.cpp:57-147): with chi2 = sum part_chi
    and dot = sum part_dot,
        solved = ok and finite(chi2);  chi2_new = chi2 if solved else inf
        rho = (chi2_cur - chi2_new) / (dot + 1e-3) if solved else -1
        accept = rho > 0 and finite(chi2_new)
        lam_new = lam * clamp(1 - (2 rho - 1)^3, 1/3, 2/3) if accept
                  else lam * ni
        ni_new = 2 if accept else 2 ni;  retry = not accept and rho < 0
    ok is a 0-dim bool tensor, lam, ni and chi_cur 0-dim tensors of the
    partials' dtype. Returns (chi2_new, rho, accept, lam_new, ni_new, retry)
    as 0-dim tensors (accept and retry bool); nothing is read by the host.
    One one-block kernel on CUDA tensors, the plain version on CPU
    tensors."""
    require(part_chi.dim() == 1 and part_dot.dim() == 1
            and part_chi.numel() > 0 and part_dot.numel() > 0,
            "lm_outcome: the partial sums must be non-empty vectors")
    require(ok.dim() == 0 and ok.dtype == torch.bool
            and ok.device == part_chi.device,
            "lm_outcome: ok must be a 0-dim bool tensor on the partials' "
            "device")
    require(lam.dim() == 0 and ni.dim() == 0 and chi_cur.dim() == 0,
            "lm_outcome: lam, ni and chi_cur must be 0-dim tensors")
    check_tensors("lm_outcome", part_chi.device, part_chi.dtype,
                  {"part_chi": part_chi, "part_dot": part_dot, "lam": lam,
                   "ni": ni, "chi_cur": chi_cur}, {})
    if not launch_device("lm_outcome", part_chi.device):
        return lm_outcome_plain(part_chi, part_dot, ok, lam, ni, chi_cur)
    out = torch.empty(4, dtype=part_chi.dtype, device=part_chi.device)
    flags = torch.empty(2, dtype=torch.bool, device=part_chi.device)
    build.launch("g2o_lm_outcome", part_chi, part_chi.data_ptr(),
                 part_chi.numel(), part_dot.data_ptr(), part_dot.numel(),
                 ok.data_ptr(), lam.data_ptr(), ni.data_ptr(),
                 chi_cur.data_ptr(), out.data_ptr(), flags.data_ptr())
    lm_outcome.launches += 1
    # slots of csrc/retract_chi2.cu: chi_new, rho, lam_new, ni_new
    return out[0], out[1], flags[0], out[2], out[3], flags[1]


lm_outcome.launches = 0
