"""K16: fused SE3 edge linearizer (csrc/edge_se3_blocks.cu).

Replaces the JAX chain `_edge_se3_error`
(openslam_g2o_tpu/models/slam3d.py:70-73) on `se3_error_mqt` /
`se3_retract_mqt` (ops/lie.py:236-268), `linearize` (core/problem.py:336-392,
vmap(jacfwd)) and `_edge_blocks` (core/sparse.py:620-636). For one EDGE_SE3
group it writes every edge's four blocks J_s^T rho' Omega J_t and two
gradients b_s = -J_s^T rho' Omega e into the contribution streams that
kernel C gathers:
    hblk [36, 4 * e_total]  block q = 2s+t of edge e in column q*e_total + col0 + e
    bblk [6, 2 * e_total]   b_s of edge e in column s*e_total + col0 + e
The Jacobians are taken in forward mode on both routes: inside the kernel
with a value-and-derivatives scalar over the kernel's own error code (a
thread takes several tangent directions of one vertex in one pass), in the
plain version with torch.func.jvp over the model's error
(core/problem.py `forward_jacobians`).
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.core import robust
from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)
from openslam_g2o_torch.kernels.edge_se2 import edge_blocks_from_lin


def edge_se3_blocks_plain(params, free, ii, jj, meas, info, delta, kernel_id,
                          hblk, bblk, col0):
    """Plain PyTorch version of K16: the model's error, its forward-mode
    Jacobians, the robust weight, the fixed-column mask and the block
    products, written into the stream columns of this group."""
    from openslam_g2o_torch.core import problem as P
    from openslam_g2o_torch.core import registry
    et = registry.edge_type("edge_se3")
    E = ii.shape[0]
    e_total = hblk.shape[1] // 4
    if E == 0:
        return
    iil, jjl = ii.long(), jj.long()
    vp = (params[iil], params[jjl])
    resid = et.error(vp, meas, ())
    ji, jjac = P.forward_jacobians(P.EGroup("edge_se3", et, kernel_id, E),
                                   vp, meas, ())
    e2 = (resid[:, :, None] * info * resid[:, None, :]).sum(dim=(1, 2))
    _, rho1, _ = robust.robustify(kernel_id, e2, delta)
    jacs = (ji * free[iil][:, None, None], jjac * free[jjl][:, None, None])
    blocks, bvecs = edge_blocks_from_lin(resid, jacs, rho1, info)
    for s in range(2):
        c = s * e_total + col0
        bblk[:, c:c + E] = bvecs[s].T
        for t in range(2):
            c = (2 * s + t) * e_total + col0
            hblk[:, c:c + E] = blocks[(s, t)].reshape(E, 36).T


def edge_se3_blocks(params, free, ii, jj, meas, info, delta, kernel_id,
                    hblk, bblk, col0):
    """Linearize one EDGE_SE3 group into the contribution streams; K16 on
    CUDA tensors, the plain version on CPU tensors. params [N, 7],
    free [N], ii/jj [E] int32, meas [E, 7], info [E, 6, 6], delta [E]."""
    E = ii.shape[0]
    N = params.shape[0]
    require(params.shape == (N, 7) and free.shape == (N,),
            "edge_se3_blocks: params must be [N, 7] and free [N]")
    require(jj.shape == (E,) and meas.shape == (E, 7)
            and info.shape == (E, 6, 6) and delta.shape == (E,),
            "edge_se3_blocks: edge arrays must be [E], [E, 7], [E, 6, 6], [E]")
    e_total = hblk.shape[1] // 4
    require(hblk.shape == (36, 4 * e_total)
            and bblk.shape == (6, 2 * e_total),
            "edge_se3_blocks: hblk must be [36, 4 T] and bblk [6, 2 T]")
    require(0 <= col0 and col0 + E <= e_total,
            "edge_se3_blocks: edge group does not fit the stream")
    require(0 <= kernel_id < len(robust.kernel_names()),
            f"edge_se3_blocks: unknown robust kernel id {kernel_id}")
    check_tensors("edge_se3_blocks", params.device, params.dtype,
                  {"params": params, "free": free, "meas": meas,
                   "info": info, "delta": delta, "hblk": hblk, "bblk": bblk},
                  {"ii": ii, "jj": jj})
    if not launch_device("edge_se3_blocks", params.device):
        edge_se3_blocks_plain(params, free, ii, jj, meas, info, delta,
                              kernel_id, hblk, bblk, col0)
        return
    if E == 0:
        return
    build.launch("g2o_edge_se3_blocks", params, params.data_ptr(),
                 free.data_ptr(), ii.data_ptr(), jj.data_ptr(),
                 meas.data_ptr(), info.data_ptr(), delta.data_ptr(),
                 int(kernel_id), hblk.data_ptr(), bblk.data_ptr(), E, e_total,
                 int(col0))
    edge_se3_blocks.launches += 1


edge_se3_blocks.launches = 0
