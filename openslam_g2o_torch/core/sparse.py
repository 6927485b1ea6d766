"""Block-ELL sparse Hessian of a pose graph (one vertex group: SE2 poses
with 3x3 blocks or SE3 poses with 6x6 blocks), on one layout.

Counterpart of openslam_g2o_tpu/core/sparse.py (:61-70, :243-617,
:620-728, :871-908, :1143-1247) with ONE layout in place of the TPU's
variants (DIA band split, two-tier overflow, stream-shift assembly and the
scatter fallback were chosen for TPU gather costs; CHANGES.md lists what
each replaced):

    nb      [K, N] int32   column of neighbour slot k of block row n; slot 0
                           is always the row's own (diagonal) block, the
                           other slots follow in ascending column order, and
                           padding slots point at column 0 with zero values
    values  [K, D*D, N]    entry D s + t of the DxD block in slot k of row n
    xT, bT  [D, N]         lane-major vectors, as in the JAX package

D is the group's tangent width (3 or 6). Every row has a diagonal slot, so
LM damping always lands on it, also for a vertex without edges. Per
linearization: the edge type's linearizer kernel (kernel B,
kernels/edge_se2.py, for EDGE_SE2; K16, kernels/edge_se3.py, for EDGE_SE3)
writes the per-edge blocks into contribution streams, kernel C
(kernels/assemble.py) gathers them into `values` and b through the
destination-major tables built here once per topology, and kernel A
(kernels/spmv.py) is the CG matvec. Per trial, kernels/damp_chol.py damps
and factors the diagonal blocks, kernels/jacobi_scale.py scales the system,
and `EllOperator` hands the scaled system to the CG loop.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from openslam_g2o_torch import kernels

__all__ = ["EllPattern", "build_ell_pattern", "edge_blocks", "assemble_ell",
           "diag_blocks", "lane_block_mv", "ell_matvec_lane", "EllOperator"]


@dataclass
class EllPattern:
    """Static-topology block-ELL pattern and contributor tables.

    group: the vertex group (the only one: pose graphs).
    d: the group's tangent width, the block width D (3 or 6).
    nb: [K, N] int32 neighbour table (layout in the module docstring).
    e_total: the number of edges E.
    e_cols: the stream's columns per block, E rounded up to a multiple of
        STREAM_ALIGN (so that on the card every row of every block starts
        a 128-byte line and a warp's 32 consecutive stores fill whole
        lines; at an odd E each would straddle two).
    hidx: [mh, K*N] int32 destination-major contributor table: column ids
        into the linearizer's block stream hblk [D*D, 4 e_cols] of the
        contributions to slot (k, n) at column k*N + n, packed from row 0
        in stream order, -1 after the last (the -1 is the mask). Block q of
        edge e is column q*e_cols + e; the padding columns are never
        written or read.
    bidx: [mb, N] int32, the same for b into bblk [D, 2 e_cols].
    col0: edge group key -> first edge column of that group in the streams.
    """
    group: str
    d: int
    n: int
    k: int
    e_total: int
    nb: torch.Tensor
    hidx: torch.Tensor
    bidx: torch.Tensor
    col0: dict
    e_cols: int


# pose vertex group -> the edge type its linearizer kernel serves
_POSE_EDGE = {"se2": "edge_se2", "se3": "edge_se3"}
# stream columns a block's width is rounded up to (32 values: one 128-byte
# line in float32, two in float64)
STREAM_ALIGN = 32


def stream_columns(e_total: int) -> int:
    """Columns per block of the linearizer's streams for e_total edges:
    e_total rounded up to a multiple of STREAM_ALIGN."""
    return -(-e_total // STREAM_ALIGN) * STREAM_ALIGN


def _linearizer(group: str):
    """The wrapper of the group's linearizer kernel (kernel B for SE2 poses,
    K16 for SE3 poses), looked up at call time."""
    if group == "se3":
        return kernels.edge_se3.edge_se3_blocks
    return kernels.edge_se2.edge_se2_blocks


def _contrib_table(dest, n_dest, src):
    """[M, n_dest] int32 table: column d lists src[i] of every i with
    dest[i] == d, in the order of i, then -1 (sparse.py:202-240)."""
    counts = np.bincount(dest, minlength=n_dest)
    M = max(int(counts.max()) if len(dest) else 0, 1)
    order = np.argsort(dest, kind="stable")
    starts = np.zeros(n_dest + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    col = np.arange(len(dest), dtype=np.int64) - starts[dest[order]]
    tbl = np.full((M, n_dest), -1, dtype=np.int32)
    tbl[col, dest[order]] = src[order]
    return tbl


def build_ell_pattern(problem) -> EllPattern:
    """Host-side symbolic phase (sparse.py:243-617 without the TPU layout
    variants), vectorized numpy: neighbour slots of every block row and
    the destination-major contributor tables of kernel C. Repeated (i, j)
    pairs across edges share a slot, as the reference's shared mapped
    Hessian blocks do (block_solver.hpp:143-295)."""
    vgroups = problem.static.vgroups
    if len(vgroups) != 1 or vgroups[0].name not in _POSE_EDGE:
        raise NotImplementedError(
            "the block-ELL pattern of the port covers one vertex group of "
            f"{sorted(_POSE_EDGE)} poses; LM-PCG over several vertex groups "
            "is not ported (ROADMAP.md, 'Modules still to port')")
    g = vgroups[0]
    for eg in problem.static.egroups:
        if eg.etype.name != _POSE_EDGE[g.name]:
            raise NotImplementedError(
                f"the LM-PCG path of the port linearizes "
                f"{_POSE_EDGE[g.name]!r} edges between {g.name!r} poses, "
                f"not {eg.etype.name!r}")
    N = g.count
    col0, off = {}, 0
    ii_parts, jj_parts = [], []
    for eg in problem.static.egroups:
        col0[eg.key] = off
        off += eg.count
        ea = problem.edges[eg.key]
        ii_parts.append(ea.indices[0].cpu().numpy().astype(np.int64))
        jj_parts.append(ea.indices[1].cpu().numpy().astype(np.int64))
    E = off
    ii = np.concatenate(ii_parts) if ii_parts else np.zeros(0, np.int64)
    jj = np.concatenate(jj_parts) if jj_parts else np.zeros(0, np.int64)

    # contributions in stream column order: block q = 2s+t of edge e sits
    # in column q*W + e (W = e_cols) and lands at (row of slot s, column of
    # slot t)
    ends = (ii, jj)
    rows = np.concatenate([ends[q // 2] for q in range(4)])
    cols = np.concatenate([ends[q % 2] for q in range(4)])
    # sort key per row: the diagonal first, then ascending columns; every
    # row gets its diagonal slot even without edges
    key = np.concatenate([
        np.arange(N, dtype=np.int64) * (N + 1),
        rows * (N + 1) + np.where(cols == rows, 0, cols + 1)])
    uniq, inverse = np.unique(key, return_inverse=True)
    u_rows = uniq // (N + 1)
    u_ck = uniq % (N + 1)
    u_cols = np.where(u_ck == 0, u_rows, u_ck - 1)
    slot = np.arange(len(uniq)) - np.searchsorted(u_rows, np.arange(N))[u_rows]
    K = int(np.bincount(u_rows, minlength=N).max()) if N else 1
    nb = np.zeros((K, N), dtype=np.int32)
    nb[slot, u_rows] = u_cols
    inv_c = inverse[N:]
    dest = slot[inv_c] * N + u_rows[inv_c]
    dev = problem.device
    W = stream_columns(E)
    column = lambda blocks: (np.arange(blocks, dtype=np.int64)[:, None] * W
                             + np.arange(E, dtype=np.int64)).reshape(-1)
    hidx = _contrib_table(dest, K * N, column(4))
    bidx = _contrib_table(np.concatenate([ii, jj]), N, column(2))
    return EllPattern(g.name, g.tangent_dim, N, K, E,
                      torch.as_tensor(nb, device=dev),
                      torch.as_tensor(hidx, device=dev),
                      torch.as_tensor(bidx, device=dev), col0, W)


def edge_blocks(problem, pattern: EllPattern):
    """The edge type's linearizer kernel over every edge group: the
    contribution streams (hblk [D*D, 4W], bblk [D, 2W], W =
    pattern.e_cols) at the problem's current params."""
    dt, dev = problem.dtype, problem.device
    E, D = pattern.e_cols, pattern.d
    hblk = torch.empty((D * D, 4 * E), dtype=dt, device=dev)
    bblk = torch.empty((D, 2 * E), dtype=dt, device=dev)
    params = problem.params[pattern.group]
    free = problem.free[pattern.group]
    linearize_group = _linearizer(pattern.group)
    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        linearize_group(
            params, free, ea.indices[0], ea.indices[1], ea.measurement,
            ea.information, ea.delta, eg.kernel_id, hblk, bblk,
            pattern.col0[eg.key])
    return hblk, bblk


def assemble_ell(problem, pattern: EllPattern):
    """Linearize and assemble: (values [K, D*D, N], bT {group: [D, N]}) with
    b = -J^T W r (the linearizer, then kernel C; sparse.py:681-693)."""
    hblk, bblk = edge_blocks(problem, pattern)
    values, b = kernels.assemble.assemble_gather(
        hblk, bblk, pattern.hidx, pattern.bidx, pattern.k, pattern.n)
    return values, {pattern.group: b}


def diag_blocks(pattern: EllPattern, values):
    """{group: [N, D, D]} diagonal blocks: slot 0 of every row."""
    D = pattern.d
    return {pattern.group: values[0].reshape(D, D, pattern.n).permute(2, 0, 1)}


def lane_block_mv(mats_lane: dict, xT: dict, transpose: bool = False):
    """y[a, n] = sum_b M[a, b, n] x[b, n] per group (transpose: M^T x), the
    lane-major batched block application (sparse.py:871-880); mats_lane
    holds the [D*D, N] tables of kernels/damp_chol.py."""
    return {k: kernels.jacobi_scale.lane_block_mv(M, xT[k].contiguous(),
                                                  transpose)
            for k, M in mats_lane.items()}


def ell_matvec_lane(pattern: EllPattern, values, xT: dict):
    """y = H x on lane-major dicts (kernel A; sparse.py:883-908)."""
    g = pattern.group
    return {g: kernels.spmv.block_ell_spmv(pattern.nb, values,
                                           xT[g].contiguous())}


class EllOperator:
    """The block-ELL matrix `values` on `pattern` as the operator of
    `pcg_solve`: calling it is the matvec, `matvec_dot` is the fused form
    the CG step uses (kernels/cg_step.py `spmv_dot`), and `matvec_dot_p`
    the form with the next direction folded in (`spmv_dot_p`), which the
    CG step takes when it has no preconditioner."""

    def __init__(self, pattern: EllPattern, values):
        self.pattern = pattern
        self.values = values

    def __call__(self, xT: dict) -> dict:
        return ell_matvec_lane(self.pattern, self.values, xT)

    def matvec_dot(self, pT: dict):
        """({group: H p}, partial sums of p . H p)."""
        g = self.pattern.group
        hp, partials = kernels.cg_step.spmv_dot(
            self.pattern.nb, self.values, pT[g].contiguous())
        return {g: hp}, partials

    def matvec_dot_p(self, scal, pT: dict, rT: dict, p_newT: dict):
        """({group: H p_new}, partial sums of p_new . H p_new) with p_new =
        beta p + r written into p_newT (beta in `scal`)."""
        g = self.pattern.group
        hp, partials = kernels.cg_step.spmv_dot_p(
            self.pattern.nb, self.values, scal, pT[g], rT[g], p_newT[g])
        return {g: hp}, partials
