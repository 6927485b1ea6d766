"""K12: the reduced camera system S of the dense-Schur route
(csrc/ba_schur.cu).

Replaces the densified product of `_solve`
(openslam_g2o_tpu/core/ba_ell.py:727-756) and the densification of W into
B2 in `_build` (:647-668): S = -0.5 (S_corr + S_corr^T) + blockdiag(Hcc_d)
(+ Hpp_extra), S_corr = sum_l W_l Hinv_l W_l^T, is summed from its nonzero
terms through a destination-major table built on the host once per
topology (`build_schur_pairs`): for every camera pair c1 <= c2 that shares
a landmark, and every diagonal pair, the contributions (landmark l, slot k1
of an observation by c1, slot k2 of one by c2) sorted by (c1, c2, l, k1,
k2). S is [Tp, Tp] on the flat [C, Dp] ordering of the camera tangent.
`torch.matmul(B2, M2)` of the JAX route is what chip_smoke.py times beside
the kernel; the port never calls it.

The kernel reads W and Hinv as records (`ba_schur_records`): W per
observation slot [K L, Dp dl] and Hinv per landmark [L, dl^2], each row
padded with zeros to a multiple of 16 bytes, so that a contribution reads
a few whole sectors. core/ba_ell.py makes W's once per linearization on
the dense-Schur route; the wrapper makes Hinv's on every call.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)
from openslam_g2o_torch.kernels.ba_edge import BLOCK_DIMS


@dataclass
class SchurPairs:
    """Destination d is the block (c1[d], c2[d]), c1 <= c2; its
    contributions are m in ptr[d]:ptr[d+1], each W_lm column pos1[m] (of
    camera c1) and pos2[m] (of camera c2) of landmark lm[m]; a W_lm column
    is k L + l for slot k of landmark l."""
    n_cam: int
    n_lm: int
    k_width: int
    ptr: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor
    lm: torch.Tensor
    pos1: torch.Tensor
    pos2: torch.Tensor

    @property
    def n_dest(self):
        return self.c1.shape[0]

    @property
    def n_contrib(self):
        return self.lm.shape[0]


def build_schur_pairs(lm_cam: np.ndarray, n_cam: int, device) -> SchurPairs:
    """The destination table from the landmark slot table lm_cam [K, L]
    (camera of each slot, -1 on padding), vectorized numpy: every ordered
    slot pair (k1, k2) of a landmark with cam(k1) <= cam(k2)."""
    K, L = lm_cam.shape
    lms = np.arange(L, dtype=np.int64)
    parts = []
    for k1 in range(K):
        a = lm_cam[k1].astype(np.int64)
        for k2 in range(K):
            b = lm_cam[k2].astype(np.int64)
            keep = (a >= 0) & (b >= 0) & (a <= b)
            if keep.any():
                n = int(keep.sum())
                parts.append(np.stack([a[keep] * n_cam + b[keep], lms[keep],
                                       np.full(n, k1), np.full(n, k2)]))
    cat = (np.concatenate(parts, axis=1) if parts
           else np.zeros((4, 0), dtype=np.int64))
    order = np.lexsort((cat[3], cat[2], cat[1], cat[0]))
    key, lm, k1, k2 = cat[:, order]
    dests = np.union1d(key, np.arange(n_cam, dtype=np.int64) * (n_cam + 1))
    ptr = np.searchsorted(key, dests, side="left")
    ptr = np.concatenate([ptr, [len(key)]])
    i32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                                    device=device)
    return SchurPairs(n_cam, L, K, i32(ptr), i32(dests // n_cam),
                      i32(dests % n_cam), i32(lm), i32(k1 * L + lm),
                      i32(k2 * L + lm))


# the tables K12 reads as records: W at (Dp, dl) = (6, 3), (3, 2) and
# (9, 3), Hinv at dl = 3 and 2
RECORD_ROWS = (18, 9, 6, 4, 27)


def record_width(rows: int, dtype) -> int:
    """Values per record of a `rows`-value block: rows rounded up to a
    multiple of 16 bytes."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-rows // per) * per


def ba_schur_records_plain(x):
    """[rows, n] lane-major -> [n, record_width(rows)] records: row i holds
    column i of x, then zeros."""
    rows, n = x.shape
    out = torch.zeros((n, record_width(rows, x.dtype)), dtype=x.dtype,
                      device=x.device)
    out[:, :rows] = x.T
    return out


def ba_schur_records(x):
    """The records of a lane-major table x [rows, n] (W [Dp*dl, K*L] or
    Hinv [dl*dl, L], rows in RECORD_ROWS): [n, record_width(rows)], column
    i of x as row i, zero padded. A copy kernel on CUDA tensors, the plain
    version on CPU tensors."""
    require(x.dim() == 2 and x.shape[0] in RECORD_ROWS,
            f"ba_schur_records: x must be [rows, n], rows in {RECORD_ROWS}")
    check_tensors("ba_schur_records", x.device, x.dtype, {"x": x}, {})
    if not launch_device("ba_schur_records", x.device):
        return ba_schur_records_plain(x)
    rows, n = x.shape
    width = record_width(rows, x.dtype)
    out = torch.empty((n, width), dtype=x.dtype, device=x.device)
    build.launch("g2o_ba_records", x, x.data_ptr(), n, rows, width,
                 out.data_ptr())
    ba_schur_records.launches += 1
    return out


ba_schur_records.launches = 0


def ba_schur_dense_plain(pairs, w_lm, hinv, hcc_d, base=None):
    """Plain PyTorch version of K12 from the lane-major w_lm and hinv."""
    dl = int(round(hinv.shape[0] ** 0.5))
    dp = w_lm.shape[0] // dl
    C = pairs.n_cam
    Tp = C * dp
    Wf = w_lm.reshape(dp, dl, -1)
    W1 = Wf[:, :, pairs.pos1.long()]                          # [Dp, dl, M]
    W2 = Wf[:, :, pairs.pos2.long()]
    Mg = hinv.view(dl, dl, -1)[:, :, pairs.lm.long()]
    tmp = (W1[:, :, None] * Mg[None]).sum(dim=1)              # [Dp, dl, M]
    X = (tmp[:, None] * W2[None]).sum(dim=2)                  # [Dp, Dp, M]
    counts = (pairs.ptr[1:] - pairs.ptr[:-1]).long()
    owner = torch.repeat_interleave(
        torch.arange(pairs.n_dest, device=X.device), counts)
    Xd = torch.zeros((dp, dp, pairs.n_dest), dtype=X.dtype,
                     device=X.device).index_add_(2, owner, X)
    c1, c2 = pairs.c1.long(), pairs.c2.long()
    diag = c1 == c2
    blocks = torch.where(
        diag[None, None],
        -0.5 * (Xd + Xd.transpose(0, 1)) + hcc_d.view(dp, dp, -1)[:, :, c1],
        -Xd)                                                  # [Dp, Dp, n]
    S = (torch.zeros((Tp, Tp), dtype=X.dtype, device=X.device)
         if base is None else base.clone())
    ar = torch.arange(dp, device=X.device)
    rows = (c1[:, None] * dp + ar[None])[:, :, None]          # [n, Dp, 1]
    cols = (c2[:, None] * dp + ar[None])[:, None, :]          # [n, 1, Dp]
    S.index_put_((rows, cols), blocks.permute(2, 0, 1), accumulate=True)
    off = ~diag
    S.index_put_((cols[off].transpose(1, 2), rows[off].transpose(1, 2)),
                 blocks.permute(2, 1, 0)[off], accumulate=True)
    return S


def ba_schur_dense(pairs: SchurPairs, w_lm, hinv, hcc_d, base=None, *,
                   w_rec):
    """S [Tp, Tp] = base (or 0) + [-0.5 (S_corr + S_corr^T)
    + blockdiag(Hcc_d)] on every pair block of `pairs`, where S_corr =
    sum_l W_l Hinv_l W_l^T; blocks of camera pairs that share no landmark
    are base's (or 0). w_lm [Dp*dl, K, L], hinv [dl*dl, L], hcc_d
    [Dp*Dp, C], base [Tp, Tp] (Hpp_extra) or None; w_rec: W's records,
    `ba_schur_records(w_lm.view(Dp*dl, -1))`, made once per
    linearization. K12 on CUDA tensors (which reads w_rec), the plain
    version on CPU tensors (which reads w_lm); one counted call launches
    the zero fill of S (without base), Hinv's record copy and the pair
    kernel."""
    require(w_lm.dim() == 3 and w_lm.shape[1:] == (pairs.k_width,
                                                   pairs.n_lm),
            "ba_schur_dense: w_lm must be [Dp*dl, K, L] of the pair table")
    dl = int(round(hinv.shape[0] ** 0.5))
    dp = w_lm.shape[0] // dl
    require((dp, dl) in BLOCK_DIMS and hinv.shape == (dl * dl, pairs.n_lm)
            and hcc_d.shape == (dp * dp, pairs.n_cam),
            "ba_schur_dense: hinv / hcc_d shapes do not fit")
    Tp = pairs.n_cam * dp
    floats = {"w_lm": w_lm, "hinv": hinv, "hcc_d": hcc_d}
    if base is not None:
        require(base.shape == (Tp, Tp), f"ba_schur_dense: base must be "
                f"{(Tp, Tp)}")
        floats["base"] = base
    require(w_rec.shape == (pairs.k_width * pairs.n_lm,
                            record_width(dp * dl, hinv.dtype)),
            "ba_schur_dense: w_rec must be ba_schur_records of w_lm")
    floats["w_rec"] = w_rec
    check_tensors("ba_schur_dense", hinv.device, hinv.dtype, floats,
                  {"ptr": pairs.ptr, "lm": pairs.lm})
    if not launch_device("ba_schur_dense", hinv.device):
        return ba_schur_dense_plain(pairs, w_lm, hinv, hcc_d, base)
    h_rec = ba_schur_records(hinv)
    if base is None:
        S = torch.empty((Tp, Tp), dtype=hinv.dtype, device=hinv.device)
        build.launch("g2o_dense_zero", S, S.data_ptr(), S.numel())
    else:
        S = base.clone()
    build.launch("g2o_ba_schur", S, w_rec.data_ptr(), h_rec.data_ptr(),
                 hcc_d.data_ptr(), pairs.ptr.data_ptr(), pairs.c1.data_ptr(),
                 pairs.c2.data_ptr(), pairs.lm.data_ptr(),
                 pairs.pos1.data_ptr(), pairs.pos2.data_ptr(), pairs.n_dest,
                 pairs.n_cam, int(base is not None), dp, dl, S.data_ptr())
    ba_schur_dense.launches += 1
    return S


ba_schur_dense.launches = 0
