"""Block-ELL sparse Hessian, on one layout: of a pose graph (one vertex
group: SE2 poses with 3x3 blocks or SE3 poses with 6x6 blocks,
`EllPattern`), and of any other graph as one table per (row group, column
group) pair (`PairPattern`, at the end of this module).

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

__all__ = ["EllPattern", "PairPattern", "PairTable", "build_ell_pattern",
           "build_pair_pattern", "edge_blocks", "assemble_ell",
           "pair_sources", "assemble_pairs", "diag_blocks", "lane_block_mv",
           "ell_matvec_lane", "EllOperator", "PairOperator"]


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

    # the LM-PCG trial's operations on this layout; PairPattern has the
    # same methods over its pair tables, so callers never ask which
    # pattern they hold

    def assemble(self, problem):
        """(values [K, D*D, N], bT {group: [D, N]}) with b = -J^T W r: the
        linearizer, then kernel C (sparse.py:681-693)."""
        hblk, bblk = edge_blocks(problem, self)
        values, b = kernels.assemble.assemble_gather(
            hblk, bblk, self.hidx, self.bidx, self.k, self.n)
        return values, {self.group: b}

    def diag_values(self, values):
        """{group: the table whose slot 0 K3 damps and factors}."""
        return {self.group: values}

    def diag_blocks(self, values):
        """{group: [N, D, D]} diagonal blocks: slot 0 of every row."""
        D = self.d
        return {self.group: values[0].reshape(D, D, self.n).permute(2, 0, 1)}

    def scale(self, values, linv: dict, extra: dict):
        """K4: the damped, Jacobi-scaled values (L^-1 and the damping from
        K3)."""
        return kernels.jacobi_scale.jacobi_scale(
            self.nb, values, linv[self.group], extra[self.group])

    def operator(self, values):
        return EllOperator(self, values)

    def row_bound(self, svals):
        """The Gershgorin bound of the scaled system (K8)."""
        return kernels.chebyshev.gershgorin_bound(svals)

    def trial_outcome(self, work, bT: dict, dxT: dict, ok, lam, ni,
                      chi_cur):
        """Candidate and LM bookkeeping of one trial on
        kernels/retract_chi2.py, whose kernels serve this pattern's graphs
        (one vertex group of SE2 poses with EDGE_SE2 groups, or of SE3
        poses with EDGE_SE3 groups; the group's type picks them): (cand,
        chi_new, accept, lam_new, ni_new, retry), all on the device."""
        g = self.group
        groups = []
        for eg in work.static.egroups:
            ea = work.edges[eg.key]
            groups.append((ea.indices[0], ea.indices[1], ea.measurement,
                           ea.information, ea.delta, eg.kernel_id))
        rc = kernels.retract_chi2
        if g == "se3":
            cand, part_dot = rc.retract_se3(work.params[g], dxT[g],
                                            work.free[g], bT[g], lam)
            parts = [rc.se3_edge_chi2(cand, *grp)
                     for grp in groups] or [cand.new_zeros(1)]
            part_chi = parts[0] if len(parts) == 1 else torch.cat(parts)
        else:
            cand, part_dot, part_chi = rc.retract_chi2(
                work.params[g], dxT[g], work.free[g], bT[g], lam, groups)
        chi_new, _, accept, lam_new, ni_new, retry = rc.lm_outcome(
            part_chi, part_dot, ok, lam, ni, chi_cur)
        return {g: cand}, chi_new, accept, lam_new, ni_new, retry


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


def _pose_graph(problem) -> bool:
    """One vertex group of SE2 or SE3 poses whose edges are all EDGE_SE2,
    respectively EDGE_SE3: the graphs of `EllPattern` and its kernels."""
    vgroups = problem.static.vgroups
    return (len(vgroups) == 1 and vgroups[0].name in _POSE_EDGE
            and all(eg.etype.name == _POSE_EDGE[vgroups[0].name]
                    for eg in problem.static.egroups))


def build_ell_pattern(problem):
    """Host-side symbolic phase (sparse.py:243-617 without the TPU layout
    variants), vectorized numpy: neighbour slots of every block row and
    the destination-major contributor tables of the assembly. Repeated
    (i, j) pairs across edges share a slot, as the reference's shared
    mapped Hessian blocks do (block_solver.hpp:143-295). A pose graph of
    one SE2 or SE3 group with only EDGE_SE2 / EDGE_SE3 edges gets the
    `EllPattern` of kernels B / K16, C and A; every other graph the
    `PairPattern` of the pair kernels (`build_pair_pattern`)."""
    if not _pose_graph(problem):
        return build_pair_pattern(problem)
    g = problem.static.vgroups[0]
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


def assemble_ell(problem, pattern):
    """Linearize and assemble (sparse.py:681-693): on an EllPattern (values
    [K, D*D, N], bT {group: [D, N]}) with b = -J^T W r; on a PairPattern
    (a tuple of values per pair table, bT per vertex group)."""
    return pattern.assemble(problem)


def diag_blocks(pattern, values):
    """{group: [N, D, D]} diagonal blocks: slot 0 of every row (of each
    group's square pair table on a PairPattern)."""
    return pattern.diag_blocks(values)


def lane_block_mv(mats_lane: dict, xT: dict, transpose: bool = False):
    """y[a, n] = sum_b M[a, b, n] x[b, n] per group (transpose: M^T x), the
    lane-major batched block application (sparse.py:871-880); mats_lane
    holds the [D*D, N] tables of kernels/damp_chol.py."""
    return {k: kernels.jacobi_scale.lane_block_mv(M, xT[k].contiguous(),
                                                  transpose)
            for k, M in mats_lane.items()}


def ell_matvec_lane(pattern, values, xT: dict):
    """y = H x on lane-major dicts (sparse.py:883-908): kernel A on an
    EllPattern, K5' on a PairPattern (one launch per row group over its
    pairs)."""
    return pattern.operator(values)({k: v.contiguous()
                                     for k, v in xT.items()})


class EllOperator:
    """The block-ELL matrix `values` on `pattern` as the operator of
    `pcg_solve`: calling it is the matvec, `matvec_dot` is the fused form
    the CG step uses (kernels/cg_step.py `spmv_dot`), and `matvec_dot_p`
    the form with the next direction folded in (`spmv_dot_p`), which the
    CG step takes when it has no preconditioner. `PairOperator` is its
    counterpart on a PairPattern."""

    def __init__(self, pattern: EllPattern, values):
        self.pattern = pattern
        self.values = values

    def __call__(self, xT: dict) -> dict:
        g = self.pattern.group
        return {g: kernels.spmv.block_ell_spmv(self.pattern.nb, self.values,
                                               xT[g].contiguous())}

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


# ---------------------------------------------------------------------------
# LM-PCG over several vertex groups: one table per (row group, column group)
# ---------------------------------------------------------------------------

@dataclass
class PairTable:
    """The blocks of one (row group, column group) pair (sparse.py:243-617
    per pair): nb [K, N] int32 (the column, in group `cg`, of slot k of row
    n; padding slots point at column 0 with zero values), values
    [K, Dr*Dc, N] by K2'. A square pair (rg == cg) keeps slot 0 for the
    row's own diagonal block, also for a vertex without edges, and its other
    slots in ascending column order; a rectangular pair's slots are in
    ascending column order. cnt [N] int32: the used slots of each row (the
    slots from cnt[n] on are padding). sources: the (edge group index, s,
    t) whose contributions it sums, in the JAX package's order; table:
    K2''s destination-major table over them."""
    rg: str
    cg: str
    dr: int
    dc: int
    n: int
    k: int
    nb: torch.Tensor
    cnt: torch.Tensor
    sources: tuple
    table: object

    @property
    def square(self):
        return self.rg == self.cg


@dataclass
class PairPattern:
    """The block-ELL pattern of any graph as pair tables.

    groups: the vertex groups' names in the problem's order; widths /
    counts: their tangent widths and sizes. pairs: the PairTables in the
    JAX package's first-seen order over edge groups and slot pairs, then a
    square table for every group no edge reaches. square: group -> the
    index of its square pair. rows: group -> the indices of the pairs of
    that row group, in pattern order. b_sources / b_tables: per group, the
    (edge group index, slot) whose -J_s^T W e it sums and K2''s table over
    them."""
    groups: tuple
    widths: dict
    counts: dict
    pairs: tuple
    square: dict
    rows: dict
    b_sources: dict
    b_tables: dict

    def row_operands(self, g, values, xT):
        """(nbs, cnts, values, xs) of row group g's pairs for K5'."""
        idx = self.rows[g]
        return ([self.pairs[i].nb for i in idx],
                [self.pairs[i].cnt for i in idx], [values[i] for i in idx],
                [xT[self.pairs[i].cg] for i in idx])

    def bound_rows(self, values):
        """K8''s rows: per row group (width, its pairs' values, their
        cnt)."""
        return [(self.widths[g], [values[i] for i in self.rows[g]],
                 [self.pairs[i].cnt for i in self.rows[g]])
                for g in self.groups]

    # the LM-PCG trial's operations, as EllPattern's

    def assemble(self, problem):
        """(a tuple of values per pair table, bT per vertex group): K17,
        then K2' (`assemble_pairs`)."""
        return assemble_pairs(problem, self)

    def diag_values(self, values):
        """{group: its square pair table, whose slot 0 K3 damps and
        factors}, in the groups' order."""
        return {g: values[self.square[g]] for g in self.groups}

    def diag_blocks(self, values):
        return {g: v[0].reshape(self.widths[g], self.widths[g],
                                -1).permute(2, 0, 1)
                for g, v in self.diag_values(values).items()}

    def scale(self, values, linv: dict, extra: dict):
        """K4' per pair table: the row factors from its row group, the
        column factors from its column group, the damping on square pairs
        only."""
        return tuple(
            kernels.pair_ell.pair_scale(pt.nb, pt.cnt, v, linv[pt.rg],
                                        linv[pt.cg],
                                        extra[pt.rg] if pt.square else None)
            for pt, v in zip(self.pairs, values))

    def operator(self, values):
        return PairOperator(self, values)

    def row_bound(self, svals):
        """The Gershgorin bound of the scaled system (K8')."""
        return kernels.pair_ell.pair_gershgorin(self.bound_rows(svals))

    def trial_outcome(self, work, bT: dict, dxT: dict, ok, lam, ni,
                      chi_cur):
        """Candidate and LM bookkeeping of one trial: core/problem.py
        `lm_trial_outcome`, i.e. K7's `trial_retract_*` per vertex group
        and `trial_chi2_*` per edge group on the lane-major step and b,
        read by strides."""
        from openslam_g2o_torch.core.problem import lm_trial_outcome
        return lm_trial_outcome(work, {g: v.T for g, v in dxT.items()},
                                {g: v.T for g, v in bT.items()}, ok, lam, ni,
                                chi_cur)


def build_pair_pattern(problem) -> PairPattern:
    """The pair tables of any graph whose vertex groups have widths in
    kernels/_checks.py PAIR_WIDTHS and whose edge residuals are at most
    pair_ell.MAX_RESIDUAL wide; NotImplementedError otherwise, on either
    device (ROADMAP.md §3)."""
    from openslam_g2o_torch.kernels import _checks, pair_ell
    st, dev = problem.static, problem.device
    for g in st.vgroups:
        if g.tangent_dim not in _checks.PAIR_WIDTHS:
            raise NotImplementedError(
                f"LM-PCG over vertex group {g.name!r}: block width "
                f"{g.tangent_dim} has no instantiation of the pair kernels "
                f"(widths {_checks.PAIR_WIDTHS})")
    for eg in st.egroups:
        if eg.etype.error_dim > pair_ell.MAX_RESIDUAL:
            raise NotImplementedError(
                f"LM-PCG over edge type {eg.etype.name!r}: residual width "
                f"{eg.etype.error_dim} > {pair_ell.MAX_RESIDUAL}")
    idx = [[problem.edges[eg.key].indices[s].cpu().numpy().astype(np.int64)
            for s in range(eg.etype.num_vertices)] for eg in st.egroups]
    order, srcs = [], {}
    for gi, eg in enumerate(st.egroups):
        for s, gs in enumerate(eg.slots):
            for t, gt in enumerate(eg.slots):
                if (gs, gt) not in srcs:
                    order.append((gs, gt))
                    srcs[(gs, gt)] = []
                srcs[(gs, gt)].append((gi, s, t))
    for g in st.vgroups:
        if (g.name, g.name) not in srcs:
            order.append((g.name, g.name))
            srcs[(g.name, g.name)] = []
    pairs, square, rows = [], {}, {g.name: [] for g in st.vgroups}
    for rg, cg in order:
        R, C = st.vgroup(rg), st.vgroup(cg)
        N, Nc = R.count, C.count
        src = srcs[(rg, cg)]
        if len(src) > pair_ell.MAX_SOURCES:
            raise NotImplementedError(
                f"LM-PCG: pair ({rg}, {cg}) sums {len(src)} edge group slot "
                f"pairs, more than the {pair_ell.MAX_SOURCES} of one launch")
        r_all = [idx[gi][s] for gi, s, _ in src]
        c_all = [idx[gi][t] for gi, _, t in src]
        r = np.concatenate(r_all) if r_all else np.zeros(0, np.int64)
        c = np.concatenate(c_all) if c_all else np.zeros(0, np.int64)
        if rg == cg:
            # the diagonal first (also for a row without edges), then
            # ascending columns
            key = np.concatenate([np.arange(N, dtype=np.int64) * (Nc + 1),
                                  r * (Nc + 1) + np.where(c == r, 0, c + 1)])
        else:
            key = r * (Nc + 1) + c + 1
        uniq, inverse = np.unique(key, return_inverse=True)
        u_rows = uniq // (Nc + 1)
        u_ck = uniq % (Nc + 1)
        u_cols = np.where(u_ck == 0, u_rows, u_ck - 1)
        slot = (np.arange(len(uniq))
                - np.searchsorted(u_rows, np.arange(N))[u_rows])
        used = np.bincount(u_rows, minlength=N)
        K = max(int(used.max()) if N else 1, 1)
        nb = np.zeros((K, N), dtype=np.int32)
        nb[slot, u_rows] = u_cols
        inv = inverse[N:] if rg == cg else inverse
        dest = slot[inv] * N + u_rows[inv]
        cuts = np.cumsum([0] + [len(x) for x in r_all])
        table = pair_ell.assembly_table(
            [dest[cuts[i]:cuts[i + 1]] for i in range(len(src))], N, K * N,
            R.tangent_dim, C.tangent_dim, dev, cnt=used)
        if rg == cg:
            square[rg] = len(pairs)
        rows[rg].append(len(pairs))
        pairs.append(PairTable(
            rg, cg, R.tangent_dim, C.tangent_dim, N, K,
            torch.as_tensor(nb, device=dev), table.cnt, tuple(src), table))
    for g, idx_rows in rows.items():
        if len(idx_rows) > pair_ell.MAX_PAIRS:
            raise NotImplementedError(
                f"LM-PCG: row group {g!r} has {len(idx_rows)} pair tables, "
                f"more than the {pair_ell.MAX_PAIRS} of one launch")
    b_sources, b_tables = {}, {}
    for g in st.vgroups:
        bs = tuple((gi, s) for gi, eg in enumerate(st.egroups)
                   for s, gs in enumerate(eg.slots) if gs == g.name)
        if len(bs) > pair_ell.MAX_SOURCES:
            raise NotImplementedError(
                f"LM-PCG: b of group {g.name!r} sums {len(bs)} edge group "
                f"slots, more than the {pair_ell.MAX_SOURCES} of one launch")
        b_sources[g.name] = bs
        b_tables[g.name] = pair_ell.assembly_table(
            [idx[gi][s] for gi, s in bs], g.count, g.count, g.tangent_dim,
            0, dev)
    return PairPattern(
        tuple(g.name for g in st.vgroups),
        {g.name: g.tangent_dim for g in st.vgroups},
        {g.name: g.count for g in st.vgroups}, tuple(pairs), square,
        {k: tuple(v) for k, v in rows.items()}, b_sources, b_tables)


def pair_sources(problem, pattern: PairPattern):
    """Every edge group linearized by K17 (core/problem.py
    `linearize_group`), as K2''s inputs: (per pair table the Sources of
    its slot pairs, per vertex group those of its b), in table order."""
    from openslam_g2o_torch.core.problem import linearize_group
    Source = kernels.pair_ell.Source
    lin = []
    for eg in problem.static.egroups:
        resid, jacs, rho1 = linearize_group(problem, eg)
        lin.append((resid.contiguous(), [j.contiguous() for j in jacs],
                    rho1.contiguous(), problem.edges[eg.key].information))
    pairs = [[Source(lin[gi][0], lin[gi][1][s], lin[gi][1][t], lin[gi][2],
                     lin[gi][3]) for gi, s, t in pt.sources]
             for pt in pattern.pairs]
    b = {g: [Source(lin[gi][0], lin[gi][1][s], None, lin[gi][2], lin[gi][3])
             for gi, s in pattern.b_sources[g]] for g in pattern.groups}
    return pairs, b


def assemble_pairs(problem, pattern: PairPattern):
    """(values: a tuple of [K, Dr*Dc, N] per pair table, bT {group: [D,
    N]}): `pair_sources`, then K2' once per pair table and once per vertex
    group (sparse.py:620-728). A group no edge reaches has zero blocks and
    a zero b."""
    zeros = lambda *shape: torch.zeros(shape, dtype=problem.dtype,
                                       device=problem.device)
    pairs, b = pair_sources(problem, pattern)
    values = tuple(
        kernels.pair_ell.pair_assemble(src, pt.table) if src
        else zeros(pt.k, pt.dr * pt.dc, pt.n)
        for pt, src in zip(pattern.pairs, pairs))
    bT = {g: kernels.pair_ell.pair_assemble(b[g], pattern.b_tables[g])
          if b[g] else zeros(pattern.widths[g], pattern.counts[g])
          for g in pattern.groups}
    return values, bT


class PairOperator:
    """The pair tables `values` on a PairPattern as the operator of
    `pcg_solve`: the matvec is K5' per row group, `matvec_dot` its fused
    form, whose p . H p partials every row group writes into one table.
    The partials table and each row group's K5' arguments (`RowArgs`) are
    made at the first call and reused by every later one. It offers no
    `matvec_dot_p`, so the CG loop takes its three-launch step."""

    def __init__(self, pattern: PairPattern, values):
        self.pattern = pattern
        self.values = values
        self._args = {}
        self._partials = None

    def _operands(self, g, xT):
        nbs, cnts, vals, xs = self.pattern.row_operands(g, self.values, xT)
        args = self._args.get(g)
        if args is None:
            args = self._args[g] = kernels.pair_ell.row_args(
                nbs, cnts, vals, xs, self.pattern.widths[g])
        return (nbs, cnts, vals, xs), args

    def __call__(self, xT: dict) -> dict:
        out = {}
        for g in self.pattern.groups:
            ops, args = self._operands(g, xT)
            out[g] = kernels.pair_ell.pair_spmv(*ops, self.pattern.widths[g],
                                                args=args)
        return out

    def matvec_dot(self, pT: dict):
        """({group: H p}, partial sums of p . H p over every group)."""
        pe, pa = self.pattern, kernels.pair_ell
        if self._partials is None:
            like = self.values[0]
            counts = [pa.partial_count(
                pe.counts[g], max(pe.pairs[i].k for i in pe.rows[g]),
                like.device) for g in pe.groups]
            self._partials = (torch.empty(sum(counts), dtype=like.dtype,
                                          device=like.device), counts)
        part, counts = self._partials
        hp, off = {}, 0
        for g, c in zip(pe.groups, counts):
            ops, args = self._operands(g, pT)
            hp[g], _ = pa.pair_spmv_dot(*ops, pT[g], part[off:off + c],
                                        args=args)
            off += c
        return hp, part
