"""K13: the Schur coupling products of the BA solve (csrc/ba_coupling.cu).

Replaces `_apply_w_lane` (openslam_g2o_tpu/core/ba_ell.py:482-510),
`_sandwich_lane` (:513-534) and the implicit `s_matvec` (:774-797) with
the block applications around them, and the W products of the general
Schur path's `schur_solve` (openslam_g2o_tpu/core/ba.py:199-287). Vectors
are lane-major: pose vectors [Dp, N], landmark vectors [dl, L]. W is held
twice: landmark-major (W_lm [Dp*dl, K, L] with the slot table lm_cam
[K, L] of pose ids, -1 on padding) for W^T x, and pose-major (W_cam
[Dp*dl, M] in the CSR order of `PoseRows`) for W v and the preconditioner
blocks, as kernels/ba_edge.py and kernels/schur_general.py lay them out.

`SchurOperator` is the implicit reduced camera system of the dual-ELL
route, S = Hcc_d (+ Hpp_extra) - W Hinv W^T with a fused `matvec_dot`, so
that core/solvers.py `pcg_solve` drives it as it drives the pose-graph
operator: one S x is `ba_wtx` (W^T x, then Hinv) and `ba_wv` (Hcc_d x -
W v and the per-camera partial dots). core/ba.py builds the general path's
operator from the same three products.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)
from openslam_g2o_torch.kernels.ba_edge import BLOCK_DIMS


# the (Dp, dl) instantiations: the BA widths (the BAL camera's (9, 3)
# among them) and the intrinsics group of the general Schur path
DIMS = BLOCK_DIMS + ((4, 3),)
# pose groups of one `ba_wtx` launch (kMaxWtxGroups of csrc/ba_coupling.cu):
# the pose types that observe the SBA point (SE3 expmap and SBACam cameras,
# the shared intrinsics)
MAX_WTX_GROUPS = 3
CHUNK = 256                        # W entries per block of the first pass


@dataclass
class PoseRows:
    """The W entries of one pose group in pose-major CSR order: the entries
    of vertex n are positions ptr[n]:ptr[n+1]; lm [M] is the landmark of
    each position. The positions are cut into chunks of at most CHUNK
    consecutive entries of one vertex, at least one per vertex (an empty
    one where the vertex has no entry): chunk c is positions
    chunk_ptr[c]:chunk_ptr[c+1] of vertex chunk_row[c], and vertex n owns
    chunks row_chunk[n]:row_chunk[n+1]. `arrivals` [N] counts the chunks
    that have reached each vertex in one launch of `ba_wv`, `ba_sandwich`
    or kernels/ba_edge.py `ba_cam_sums`, the three kernels that finish a
    vertex in its last chunk's block. Each leaves every counter at zero
    when it ends, and they are launched on one stream, in order, so the
    three share it; one PoseRows serves one launch at a time. A launch
    that fails leaves the counters unknown, and the rows must then be
    built anew. All int32 on the device."""
    ptr: torch.Tensor
    lm: torch.Tensor
    chunk_ptr: torch.Tensor
    row_chunk: torch.Tensor
    chunk_row: torch.Tensor
    arrivals: torch.Tensor

    @property
    def n_rows(self):
        return self.ptr.shape[0] - 1

    @property
    def n_chunks(self):
        return self.chunk_ptr.shape[0] - 1

    @property
    def n_entries(self):
        return self.lm.shape[0]


def build_pose_rows(counts, lm_sorted, device) -> PoseRows:
    """PoseRows from the number of entries of every vertex (numpy [N]) and
    the landmark of every position in CSR order (numpy [M])."""
    counts = np.asarray(counts, dtype=np.int64)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    n_chunk = np.maximum((counts + CHUNK - 1) // CHUNK, 1)
    row_chunk = np.concatenate([[0], np.cumsum(n_chunk)])
    row_of = np.repeat(np.arange(len(counts)), n_chunk)
    starts = ptr[row_of] + (np.arange(len(row_of)) - row_chunk[row_of]) * CHUNK
    chunk_ptr = np.concatenate([starts, [ptr[-1]]])
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                    device=device)
    return PoseRows(i32(ptr), i32(lm_sorted), i32(chunk_ptr), i32(row_chunk),
                    i32(row_of), torch.zeros(len(counts), dtype=torch.int32,
                                             device=device))


def _row_ints(rows: PoseRows):
    return {"lm": rows.lm, "chunk_ptr": rows.chunk_ptr,
            "row_chunk": rows.row_chunk, "chunk_row": rows.chunk_row,
            "arrivals": rows.arrivals}


def _dims(w, dx_rows, name):
    for dp, dl in DIMS:
        if w.shape[0] == dp * dl and dx_rows in (dp, dl):
            return dp, dl
    raise ValueError(f"{name}: W of {w.shape[0]} rows fits no (Dp, dl) in "
                     f"{DIMS}")


def _lane_mv(A, x):
    """y[a, n] = sum_b A[a, b, n] x[b, n] for A lane-major [D*D, N]."""
    D = x.shape[0]
    return (A.view(D, D, -1) * x[None]).sum(dim=1)


def _groups(w_lm, lm_cam, x):
    """The pose groups of a W^T x call: one (w_lm, lm_cam, x) or equal-length
    sequences of them."""
    if isinstance(w_lm, torch.Tensor):
        return [(w_lm, lm_cam, x)]
    groups = list(zip(w_lm, lm_cam, x, strict=True))
    if not groups:
        raise ValueError("ba_wtx: no pose group")
    return groups


def check_wtx_groups(n_groups):
    """Raise ValueError unless one `ba_wtx` launch takes this many pose
    groups."""
    if n_groups > MAX_WTX_GROUPS:
        raise ValueError(f"ba_wtx: {n_groups} pose groups; one launch takes "
                         f"at most {MAX_WTX_GROUPS}")


def ba_wtx_plain(w_lm, lm_cam, x, hinv=None, b=None, free=None, acc=None):
    u = None
    for w_g, cam_g, x_g in _groups(w_lm, lm_cam, x):
        dp = x_g.shape[0]
        dl = w_g.shape[0] // dp
        K, L = cam_g.shape
        valid = cam_g >= 0
        xg = x_g[:, cam_g.clamp_min(0).long()]                   # [Dp, K, L]
        xg = torch.where(valid, xg, torch.zeros((), dtype=x_g.dtype,
                                                device=x_g.device))
        W4 = w_g.view(dp, dl, K, L)
        ug = (W4 * xg[:, None]).sum(dim=(0, 2))                  # [dl, L]
        u = ug if u is None else u + ug
    if acc is not None:
        u = acc + u
    r = u if b is None else b - u
    y = r if hinv is None else _lane_mv(hinv, r)
    return y if free is None else y * free[None]


def ba_wtx(w_lm, lm_cam, x, hinv=None, b=None, free=None, acc=None):
    """out [dl, L] = ((b - u) or u, then Hinv applied if given) times free
    if given, u = acc + sum over the pose groups of W^T x (acc optional):
    (W^T x)[t, l] = sum_k sum_s W[s, t, k, l] x[s, cam(k, l)]. w_lm
    [Dp*dl, K, L], lm_cam [K, L] and x [Dp, C] of one pose group, or
    sequences of them, one per group (each with its own Dp, K and C; one
    dl and L; at most MAX_WTX_GROUPS, summed in their order); hinv [dl*dl,
    L]; b, acc [dl, L]; free [L]. (Dp, dl) in DIMS. K13 on CUDA tensors,
    one launch; the plain version on CPU tensors."""
    # S x runs this once per CG iteration: the messages are only built on
    # failure
    groups = _groups(w_lm, lm_cam, x)
    dims = []
    for w_g, cam_g, x_g in groups:
        if not (x_g.dim() == 2 and w_g.dim() == 3 and cam_g.dim() == 2
                and w_g.shape[1:] == cam_g.shape
                and cam_g.shape[1] == groups[0][1].shape[1]):
            raise ValueError("ba_wtx: w_lm must be [Dp*dl, K, L], lm_cam "
                             "[K, L], x [Dp, C], one L for every group")
        dp, dl = _dims(w_g, x_g.shape[0], "ba_wtx")
        if x_g.shape[0] != dp:
            raise ValueError(f"ba_wtx: x must have {dp} rows")
        dims.append((dp, dl))
    dl = dims[0][1]
    if any(d[1] != dl for d in dims):
        raise ValueError("ba_wtx: the pose groups differ in landmark width")
    check_wtx_groups(len(groups))
    L = groups[0][1].shape[1]
    x0 = groups[0][2]
    floats = {}
    for i, (w_g, _, x_g) in enumerate(groups):
        floats[f"w_lm[{i}]"], floats[f"x[{i}]"] = w_g, x_g
    for name, t, shape in (("hinv", hinv, (dl * dl, L)), ("b", b, (dl, L)),
                           ("free", free, (L,)), ("acc", acc, (dl, L))):
        if t is not None:
            if t.shape != shape:
                raise ValueError(f"ba_wtx: {name} must be {shape}")
            floats[name] = t
    check_tensors("ba_wtx", x0.device, x0.dtype, floats,
                  {f"lm_cam[{i}]": g[1] for i, g in enumerate(groups)})
    if not launch_device("ba_wtx", x0.device):
        return ba_wtx_plain(*zip(*groups), hinv, b, free, acc)
    out = torch.empty((dl, L), dtype=x0.dtype, device=x0.device)
    if L == 0:
        return out
    args = []
    for w_g, cam_g, x_g in groups:
        args += (w_g.data_ptr(), cam_g.data_ptr(), x_g.data_ptr(),
                 cam_g.shape[0], x_g.shape[1], x_g.shape[0])
    args += (None, None, None, 0, 0, 0) * (MAX_WTX_GROUPS - len(groups))
    ptr = lambda t: None if t is None else t.data_ptr()
    build.launch("g2o_ba_wtx", x0, *args, L, ptr(hinv), ptr(b), ptr(free),
                 ptr(acc), dl, out.data_ptr())
    ba_wtx.launches += 1
    return out


ba_wtx.launches = 0


def _owner(rows):
    counts = (rows.ptr[1:] - rows.ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(rows.n_rows, device=rows.ptr.device), counts)


def ba_wv_plain(w_cam, rows, v, base=None, hcc_d=None, x=None, extra=None,
                free=None, want_dot=False):
    dl = v.shape[0]
    dp = w_cam.shape[0] // dl
    vg = v[:, rows.lm.long()]                                   # [dl, M]
    per = (w_cam.view(dp, dl, -1) * vg[None]).sum(dim=1)        # [Dp, M]
    wv = torch.zeros((dp, rows.n_rows), dtype=v.dtype,
                     device=v.device).index_add_(1, _owner(rows), per)
    head = torch.zeros_like(wv) if base is None else base
    if hcc_d is not None:
        hx = _lane_mv(hcc_d, x)
        head = hx if base is None else head + hx
    if extra is not None:
        head = head + extra
    y = head - wv
    if free is not None:
        y = y * free[None]
    if want_dot:
        return y, (x * y).sum(dim=0)
    return y


def ba_wv(w_cam, rows: PoseRows, v, base=None, hcc_d=None, x=None,
          extra=None, free=None, want_dot=False):
    """y [Dp, N] = (base + Hcc_d x + extra - W v) times free, every term
    but W v optional: (W v)[s, n] = sum over vertex n's entries j of
    sum_t W_cam[s, t, j] v[t, rows.lm[j]]. With want_dot also the partial
    sums of x . y, one per vertex, as (y, partials [N]). v [dl, L]; base,
    x, extra [Dp, N]; hcc_d [Dp*Dp, N]; free [N]. K13 on CUDA tensors (one
    launch: a block per chunk, the last block of each vertex finishes its
    row; `rows.arrivals` orders them), the plain version on CPU tensors."""
    if not (v.dim() == 2 and w_cam.dim() == 2
            and rows.lm.shape == (w_cam.shape[1],)):
        raise ValueError("ba_wv: w_cam must be [Dp*dl, M] with one landmark "
                         "per position of rows, v [dl, L]")
    dp, dl = _dims(w_cam, v.shape[0], "ba_wv")
    if v.shape[0] != dl:
        raise ValueError(f"ba_wv: v must have {dl} rows")
    if (hcc_d is not None or want_dot) and x is None:
        raise ValueError("ba_wv: hcc_d and the dot need x")
    N = rows.n_rows
    floats = {"w_cam": w_cam, "v": v}
    for name, t, shape in (("base", base, (dp, N)),
                           ("hcc_d", hcc_d, (dp * dp, N)), ("x", x, (dp, N)),
                           ("extra", extra, (dp, N)), ("free", free, (N,))):
        if t is not None:
            if t.shape != shape:
                raise ValueError(f"ba_wv: {name} must be {shape}")
            floats[name] = t
    check_tensors("ba_wv", v.device, v.dtype, floats, _row_ints(rows))
    if not launch_device("ba_wv", v.device):
        return ba_wv_plain(w_cam, rows, v, base, hcc_d, x, extra, free,
                           want_dot)
    y = torch.empty((dp, N), dtype=v.dtype, device=v.device)
    partials = (torch.empty(max(N, 1), dtype=v.dtype, device=v.device)
                if want_dot else None)
    if N == 0:
        if partials is not None:
            partials.zero_()
        return (y, partials) if want_dot else y
    part = torch.empty((dp, max(rows.n_chunks, 1)), dtype=v.dtype,
                       device=v.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    build.launch("g2o_ba_wv", v, w_cam.data_ptr(), rows.lm.data_ptr(),
                 rows.chunk_ptr.data_ptr(), rows.chunk_row.data_ptr(),
                 rows.row_chunk.data_ptr(), rows.arrivals.data_ptr(),
                 v.data_ptr(), v.shape[1], w_cam.shape[1], rows.n_chunks, N,
                 ptr(base), ptr(hcc_d), ptr(x), ptr(extra), ptr(free), dp, dl,
                 part.data_ptr(), y.data_ptr(), ptr(partials))
    ba_wv.launches += 1
    return (y, partials) if want_dot else y


ba_wv.launches = 0


def ba_sandwich_plain(w_cam, rows, hinv, hcc_d):
    dl = int(round(hinv.shape[0] ** 0.5))
    dp = w_cam.shape[0] // dl
    W4 = w_cam.view(dp, dl, -1)
    Mg = hinv.view(dl, dl, -1)[:, :, rows.lm.long()]            # [dl, dl, M]
    tmp = (W4[:, :, None] * Mg[None]).sum(dim=1)                # [Dp, dl, M]
    per = (tmp[:, None] * W4[None]).sum(dim=2)                  # [Dp, Dp, M]
    corr = torch.zeros((dp * dp, rows.n_rows), dtype=hinv.dtype,
                       device=hinv.device).index_add_(
        1, _owner(rows), per.reshape(dp * dp, -1))
    return hcc_d - corr


def ba_sandwich(w_cam, rows: PoseRows, hinv, hcc_d):
    """The block-Jacobi blocks of S: Hcc_d - sum_j W_j Hinv_lm(j) W_j^T per
    pose vertex, [Dp*Dp, N] (hinv [dl*dl, L], hcc_d [Dp*Dp, N]). K13 on CUDA
    tensors (one launch: a block per chunk, the last block of each vertex
    adds its chunks' sums in chunk order; `rows.arrivals` orders them), the
    plain version on CPU tensors."""
    require(hinv.dim() == 2 and w_cam.dim() == 2
            and rows.lm.shape == (w_cam.shape[1],),
            "ba_sandwich: w_cam must be [Dp*dl, M] with one landmark per "
            "position of rows, hinv [dl*dl, L]")
    dl = int(round(hinv.shape[0] ** 0.5))
    dp, _ = _dims(w_cam, dl, "ba_sandwich")
    N = rows.n_rows
    require(hcc_d.shape == (dp * dp, N) and hinv.shape[0] == dl * dl,
            f"ba_sandwich: hcc_d must be {(dp * dp, N)}")
    check_tensors("ba_sandwich", hinv.device, hinv.dtype,
                  {"w_cam": w_cam, "hinv": hinv, "hcc_d": hcc_d},
                  _row_ints(rows))
    if not launch_device("ba_sandwich", hinv.device):
        return ba_sandwich_plain(w_cam, rows, hinv, hcc_d)
    out = torch.empty_like(hcc_d)
    if N == 0:
        return out
    part = torch.empty((dp * dp, max(rows.n_chunks, 1)), dtype=hinv.dtype,
                       device=hinv.device)
    build.launch("g2o_ba_sandwich", hinv, w_cam.data_ptr(),
                 rows.lm.data_ptr(), rows.chunk_ptr.data_ptr(),
                 rows.chunk_row.data_ptr(), rows.row_chunk.data_ptr(),
                 rows.arrivals.data_ptr(), hinv.data_ptr(), hinv.shape[1],
                 w_cam.shape[1], rows.n_chunks, N, hcc_d.data_ptr(), dp, dl,
                 part.data_ptr(), out.data_ptr())
    ba_sandwich.launches += 1
    return out


ba_sandwich.launches = 0


class SchurOperator:
    """The implicit reduced camera system of one camera group `name`,
    S x = Hcc_d x (+ Hpp_extra x) - W Hinv W^T x (ba_ell.py:774-797), on
    dicts {name: [Dp, C]} as core/solvers.py `pcg_solve` passes them.
    Hpp_extra [Tp, Tp] (the pose-pose edges; None without them) is applied
    with torch.matmul on the flat [C, Dp] ordering, as the JAX code
    applies it with XLA."""

    def __init__(self, name, w_lm, lm_cam, w_cam, cam_rows, hinv, hcc_d,
                 hpp_extra=None):
        self.name = name
        self.w_lm, self.lm_cam = w_lm, lm_cam
        self.w_cam, self.cam_rows = w_cam, cam_rows
        self.hinv, self.hcc_d, self.hpp_extra = hinv, hcc_d, hpp_extra

    def _apply(self, x, want_dot):
        v = ba_wtx(self.w_lm, self.lm_cam, x, hinv=self.hinv)
        extra = None
        if self.hpp_extra is not None:
            dp, C = x.shape
            extra = (self.hpp_extra @ x.T.reshape(-1)).view(C, dp).T \
                .contiguous()
        return ba_wv(self.w_cam, self.cam_rows, v, hcc_d=self.hcc_d, x=x,
                     extra=extra, want_dot=want_dot)

    def __call__(self, p: dict) -> dict:
        return {self.name: self._apply(p[self.name], False)}

    def matvec_dot(self, p: dict):
        y, partials = self._apply(p[self.name], True)
        return {self.name: y}, partials
