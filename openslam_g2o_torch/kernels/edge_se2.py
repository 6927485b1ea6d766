"""Kernel B: fused SE2 edge linearizer (csrc/edge_se2_blocks.cu).

Replaces the JAX chain `_edge_se2_error` / `_edge_se2_jacobian`
(openslam_g2o_tpu/models/slam2d.py:62-112), `linearize`
(core/problem.py:350-392) and `_edge_blocks` (core/sparse.py:620-636).
For one edge group it writes every edge's four blocks J_s^T rho' Omega J_t
and two gradients b_s = -J_s^T rho' Omega e into the contribution streams
that kernel C gathers:
    hblk [9, 4 * e_total]  block q = 2s+t of edge e in column q*e_total + col0 + e
    bblk [3, 2 * e_total]  b_s of edge e in column s*e_total + col0 + e
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.core import robust
from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)
from openslam_g2o_torch.models.slam2d import (
    _edge_se2_error, _edge_se2_jacobian)


def bmm_small(A, B):
    """C[..., i, j] = sum_k A[..., i, k] B[..., k, j] as elementwise
    products and a sum (sparse.py:61-65)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


def bmv_small(A, v):
    """y[..., i] = sum_k A[..., i, k] v[..., k] (sparse.py:68-70)."""
    return (A * v[..., None, :]).sum(dim=-1)


def edge_blocks_from_lin(resid, jacs, rho1, information):
    """Blocks {(s, t): [E, Ds, Dt]} and gradients {s: [E, Ds]} of one edge
    group from its linearization (the per-group body of sparse.py:620-636;
    the (1, 0) block is J_1^T W J_0, not a transpose)."""
    w_omega = rho1[:, None, None] * information
    jw = [bmm_small(j.transpose(1, 2), w_omega) for j in jacs]
    bvecs = {s: -bmv_small(jw[s], resid) for s in range(len(jacs))}
    blocks = {(s, t): bmm_small(jw[s], jacs[t])
              for s in range(len(jacs)) for t in range(len(jacs))}
    return blocks, bvecs


def edge_se2_blocks_plain(params, free, ii, jj, meas, info, delta, kernel_id,
                          hblk, bblk, col0):
    """Plain PyTorch version of kernel B: the model's error and analytic
    Jacobian, the robust weight, the fixed-column mask and the block
    products, written into the stream columns of this group."""
    E = ii.shape[0]
    e_total = hblk.shape[1] // 4
    iil, jjl = ii.long(), jj.long()
    vp = (params[iil], params[jjl])
    resid = _edge_se2_error(vp, meas, ())
    ji, jjac = _edge_se2_jacobian(vp, meas, ())
    e2 = (resid[:, :, None] * info * resid[:, None, :]).sum(dim=(1, 2))
    _, rho1, _ = robust.robustify(kernel_id, e2, delta)
    jacs = (ji * free[iil][:, None, None], jjac * free[jjl][:, None, None])
    blocks, bvecs = edge_blocks_from_lin(resid, jacs, rho1, info)
    for s in range(2):
        c = s * e_total + col0
        bblk[:, c:c + E] = bvecs[s].T
        for t in range(2):
            c = (2 * s + t) * e_total + col0
            hblk[:, c:c + E] = blocks[(s, t)].reshape(E, 9).T


def edge_se2_blocks(params, free, ii, jj, meas, info, delta, kernel_id,
                    hblk, bblk, col0):
    """Linearize one EDGE_SE2 group into the contribution streams; kernel B
    on CUDA tensors, the plain version on CPU tensors. params [N, 3],
    free [N], ii/jj [E] int32, meas [E, 3], info [E, 3, 3], delta [E]."""
    E = ii.shape[0]
    N = params.shape[0]
    require(params.shape == (N, 3) and free.shape == (N,),
            "edge_se2_blocks: params must be [N, 3] and free [N]")
    require(jj.shape == (E,) and meas.shape == (E, 3)
            and info.shape == (E, 3, 3) and delta.shape == (E,),
            "edge_se2_blocks: edge arrays must be [E], [E, 3], [E, 3, 3], [E]")
    e_total = hblk.shape[1] // 4
    require(hblk.shape == (9, 4 * e_total) and bblk.shape == (3, 2 * e_total),
            "edge_se2_blocks: hblk must be [9, 4 T] and bblk [3, 2 T]")
    require(0 <= col0 and col0 + E <= e_total,
            "edge_se2_blocks: edge group does not fit the stream")
    require(0 <= kernel_id < len(robust.kernel_names()),
            f"edge_se2_blocks: unknown robust kernel id {kernel_id}")
    check_tensors("edge_se2_blocks", params.device, params.dtype,
                  {"params": params, "free": free, "meas": meas,
                   "info": info, "delta": delta, "hblk": hblk, "bblk": bblk},
                  {"ii": ii, "jj": jj})
    if not launch_device("edge_se2_blocks", params.device):
        edge_se2_blocks_plain(params, free, ii, jj, meas, info, delta,
                              kernel_id, hblk, bblk, col0)
        return
    if E == 0:
        return
    build.launch("g2o_edge_se2_blocks", params, params.data_ptr(),
                 free.data_ptr(), ii.data_ptr(), jj.data_ptr(),
                 meas.data_ptr(), info.data_ptr(), delta.data_ptr(),
                 int(kernel_id), hblk.data_ptr(), bblk.data_ptr(), E, e_total,
                 int(col0))
    edge_se2_blocks.launches += 1


edge_se2_blocks.launches = 0
