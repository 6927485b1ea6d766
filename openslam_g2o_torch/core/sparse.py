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
           "pair_linearize", "pair_sources", "assemble_pairs", "diag_blocks", "lane_block_mv",
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
    EllPattern, K5' on a PairPattern (one launch over every row group, on
    K4''s scaled tables), through the pattern's flat operator."""
    op = pattern.operator(values)
    return op.split(op(op.flatten(xT)))


class EllOperator:
    """The block-ELL matrix `values` on `pattern` as the flat operator of
    `pcg_solve`: its vectors are flat (`flatten`: the group's [D, N] part
    as D N values; `split` takes one apart), calling it is the matvec,
    `matvec_dot` is the fused form the CG step uses (kernels/cg_step.py
    `spmv_dot`), and `matvec_dot_p` the form with the next direction
    folded in (`spmv_dot_p`), which the CG step takes when it has no
    preconditioner. `PairOperator` is its counterpart on a PairPattern."""

    def __init__(self, pattern: EllPattern, values):
        self.pattern = pattern
        self.values = values

    def flatten(self, parts: dict):
        return parts[self.pattern.group].contiguous().reshape(-1)

    def split(self, flat) -> dict:
        return {self.pattern.group: flat.view(self.pattern.d, -1)}

    def __call__(self, x):
        pe = self.pattern
        return kernels.spmv.block_ell_spmv(pe.nb, self.values,
                                           x.view(pe.d, -1)).reshape(-1)

    def matvec_dot(self, p):
        """(H p, partial sums of p . H p)."""
        pe = self.pattern
        hp, partials = kernels.cg_step.spmv_dot(pe.nb, self.values,
                                                p.view(pe.d, -1))
        return hp.reshape(-1), partials

    def matvec_dot_p(self, scal, p, r, p_new):
        """(H p_new, partial sums of p_new . H p_new) with p_new = beta p + r
        written into p_new (beta in `scal`)."""
        d = self.pattern.d
        hp, partials = kernels.cg_step.spmv_dot_p(
            self.pattern.nb, self.values, scal, p.view(d, -1),
            r.view(d, -1), p_new.view(d, -1))
        return hp.reshape(-1), partials


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
    slots from cnt[n] on are padding). The used-slot layout of K4''s scaled
    values: rowptr [N + 1] int32 (row n's used slots are rowptr[n] ..
    rowptr[n + 1] - 1), cols [U] int32 their columns, U = `used`.
    sources: the (edge group index, s, t) whose contributions it sums, in
    the JAX package's order; table: K2''s destination-major table over
    them."""
    rg: str
    cg: str
    dr: int
    dc: int
    n: int
    k: int
    nb: torch.Tensor
    cnt: torch.Tensor
    rowptr: torch.Tensor
    cols: torch.Tensor
    sources: tuple
    table: object

    @property
    def square(self):
        return self.rg == self.cg

    @property
    def used(self):
        return self.cols.shape[0]


@dataclass
class PairPattern:
    """The block-ELL pattern of any graph as pair tables.

    groups: the vertex groups' names in the problem's order; widths /
    counts: their tangent widths and sizes; offsets: each group's place in
    the flat CG vectors of K5' (its part at offsets[g], vertex-major
    [N, D], the groups one after another: `flatten`, `split`). pairs:
    the PairTables in the JAX package's first-seen order over edge groups
    and slot pairs, then a square table for every group no edge reaches. square: group -> the index of its square pair.
    rows: group -> the indices of the pairs of that row group, in pattern
    order. b_sources / b_tables: per group, the (edge group index, slot)
    whose -J_s^T W e it sums and K2''s table over them. plan: K2''s
    AssemblyPlan over the pair tables and the b tables."""
    groups: tuple
    widths: dict
    counts: dict
    offsets: dict
    pairs: tuple
    square: dict
    rows: dict
    b_sources: dict
    b_tables: dict
    plan: object

    def flatten(self, parts: dict):
        """The flat vector of {group: [D, N] lane-major}: each group's part
        vertex-major, the groups one after another (a copy)."""
        return torch.cat([parts[g].T.reshape(-1) for g in self.groups])

    def split(self, flat) -> dict:
        """{group: its part of a flat vector, lane-major [D, N]} (contiguous
        copies)."""
        return {g: flat[self.offsets[g]:self.offsets[g] + self.widths[g]
                        * self.counts[g]].view(self.counts[g],
                                               self.widths[g]).T.contiguous()
                for g in self.groups}

    def flat_layout(self, svals):
        """K5''s and K8''s FlatLayout of the scaled tables `svals` (K4''s
        used-slot layout, one per pair table)."""
        pa = kernels.pair_ell
        return pa.FlatLayout([
            pa.FlatGroup(self.widths[g], self.counts[g], self.offsets[g],
                         tuple(pa.FlatTable(
                             self.pairs[i].rowptr, self.pairs[i].cols,
                             svals[i], self.pairs[i].dc,
                             self.offsets[self.pairs[i].cg],
                             self.counts[self.pairs[i].cg])
                               for i in self.rows[g]))
            for g in self.groups])

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
        only; the scaled tables in the used-slot layout."""
        return tuple(
            kernels.pair_ell.pair_scale(pt.nb, pt.rowptr, v, linv[pt.rg],
                                        linv[pt.cg],
                                        extra[pt.rg] if pt.square else None,
                                        pt.used)
            for pt, v in zip(self.pairs, values))

    def operator(self, values):
        return PairOperator(self, values)

    def row_bound(self, svals):
        """The Gershgorin bound of the scaled system (K8')."""
        return kernels.pair_ell.pair_gershgorin(self.flat_layout(svals))

    def trial_outcome(self, work, bT: dict, dxT: dict, ok, lam, ni,
                      chi_cur):
        """Candidate and LM bookkeeping of one trial: core/problem.py
        `lm_trial_outcome`, i.e. K7's `trial_retract_groups` over the
        vertex groups and `trial_chi2_*` per edge group on the lane-major step and b,
        read by strides."""
        from openslam_g2o_torch.core.problem import lm_trial_outcome
        return lm_trial_outcome(work, {g: v.T for g, v in dxT.items()},
                                {g: v.T for g, v in bT.items()}, ok, lam, ni,
                                chi_cur)


def build_pair_pattern(problem) -> PairPattern:
    """The pair tables of any graph whose vertex groups have widths in
    kernels/_checks.py PAIR_WIDTHS, whose edges join at most
    pair_ell.MAX_SLOTS vertices with residuals at most pair_ell.MAX_RESIDUAL
    wide, and whose row groups have at most pair_ell.MAX_PAIRS pair tables
    each; NotImplementedError otherwise, on either device (ROADMAP.md
    §3)."""
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
        if eg.etype.num_vertices > pair_ell.MAX_SLOTS:
            raise NotImplementedError(
                f"LM-PCG over edge type {eg.etype.name!r}: "
                f"{eg.etype.num_vertices} vertices > {pair_ell.MAX_SLOTS}")
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
    i32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                                    device=dev)
    pairs, square, rows = [], {}, {g.name: [] for g in st.vgroups}
    for rg, cg in order:
        R, C = st.vgroup(rg), st.vgroup(cg)
        N, Nc = R.count, C.count
        src = srcs[(rg, cg)]
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
        # the used slots, row by row in slot order: u = rowptr[row] + slot
        uniq, inverse = np.unique(key, return_inverse=True)
        u_rows = uniq // (Nc + 1)
        u_ck = uniq % (Nc + 1)
        u_cols = np.where(u_ck == 0, u_rows, u_ck - 1)
        used = np.bincount(u_rows, minlength=N)
        rowptr = np.zeros(N + 1, dtype=np.int64)
        np.cumsum(used, out=rowptr[1:])
        slot = np.arange(len(uniq)) - rowptr[u_rows]
        K = max(int(used.max()) if N else 1, 1)
        nb = np.zeros((K, N), dtype=np.int32)
        nb[slot, u_rows] = u_cols
        inv = inverse[N:] if rg == cg else inverse
        dest = slot[inv] * N + u_rows[inv]
        cuts = np.cumsum([0] + [len(x) for x in r_all])
        table = pair_ell.assembly_table(
            [dest[cuts[i]:cuts[i + 1]] for i in range(len(src))], N, K * N,
            R.tangent_dim, C.tangent_dim, dev)
        if rg == cg:
            square[rg] = len(pairs)
        rows[rg].append(len(pairs))
        pairs.append(PairTable(
            rg, cg, R.tangent_dim, C.tangent_dim, N, K,
            torch.as_tensor(nb, device=dev), i32(used), i32(rowptr),
            i32(u_cols), tuple(src), table))
    for g, idx_rows in rows.items():
        if len(idx_rows) > pair_ell.MAX_PAIRS:
            raise NotImplementedError(
                f"LM-PCG: row group {g!r} has {len(idx_rows)} pair tables, "
                f"more than the {pair_ell.MAX_PAIRS} of one K5' row group")
    b_sources, b_tables = {}, {}
    for g in st.vgroups:
        bs = tuple((gi, s) for gi, eg in enumerate(st.egroups)
                   for s, gs in enumerate(eg.slots) if gs == g.name)
        b_sources[g.name] = bs
        b_tables[g.name] = pair_ell.assembly_table(
            [idx[gi][s] for gi, s in bs], g.count, g.count, g.tangent_dim,
            0, dev)
    # pass 1's units: slot s of each edge group, its block (s, t) to the
    # pair table of (slots[s], slots[t]), its b part to slots[s]'s b
    index = {(pt.rg, pt.cg): i for i, pt in enumerate(pairs)}
    groups = [g.name for g in st.vgroups]
    units = []
    for gi, eg in enumerate(st.egroups):
        for s, gs in enumerate(eg.slots):
            targets = []
            for t, gt in enumerate(eg.slots):
                pi = index[(gs, gt)]
                targets.append((pi, pairs[pi].sources.index((gi, s, t))))
            units.append(pair_ell.Unit(
                gi, s, tuple(targets),
                (len(pairs) + groups.index(gs),
                 b_sources[gs].index((gi, s)))))
    plan = pair_ell.assembly_plan(
        [pt.table for pt in pairs] + [b_tables[g] for g in groups], units)
    offsets, off = {}, 0
    for g in st.vgroups:
        offsets[g.name] = off
        off += g.tangent_dim * g.count
    return PairPattern(
        tuple(groups), {g.name: g.tangent_dim for g in st.vgroups},
        {g.name: g.count for g in st.vgroups}, offsets, tuple(pairs), square,
        {k: tuple(v) for k, v in rows.items()}, b_sources, b_tables, plan)


def pair_linearize(problem):
    """Every edge group linearized by K17 (core/problem.py
    `linearize_group`), as K2''s pass 1 reads it: per edge group (resid
    [E, D], [J_s [E, D, D_s] per slot], rho' [E], Omega [E, D, D])."""
    from openslam_g2o_torch.core.problem import linearize_group
    lin = []
    for eg in problem.static.egroups:
        resid, jacs, rho1 = linearize_group(problem, eg)
        lin.append((resid.contiguous(), [j.contiguous() for j in jacs],
                    rho1.contiguous(), problem.edges[eg.key].information))
    return lin


def pair_sources(problem, pattern: PairPattern, lin=None):
    """The linearization (`pair_linearize`, or `lin`) as per-table inputs:
    (per pair table the Sources of its slot pairs, per vertex group those
    of its b), in table order (what the plain yardsticks read)."""
    Source = kernels.pair_ell.Source
    if lin is None:
        lin = pair_linearize(problem)
    pairs = [[Source(lin[gi][0], lin[gi][1][s], lin[gi][1][t], lin[gi][2],
                     lin[gi][3]) for gi, s, t in pt.sources]
             for pt in pattern.pairs]
    b = {g: [Source(lin[gi][0], lin[gi][1][s], None, lin[gi][2], lin[gi][3])
             for gi, s in pattern.b_sources[g]] for g in pattern.groups}
    return pairs, b


def assemble_pairs(problem, pattern: PairPattern, lin=None):
    """(values: a tuple of [K, Dr*Dc, N] per pair table, bT {group: [D,
    N]}): `pair_linearize` (or `lin`), then K2''s two passes over every
    table (sparse.py:620-728). A group no edge reaches has zero blocks and
    a zero b."""
    pa = kernels.pair_ell
    if lin is None:
        lin = pair_linearize(problem)
    plan = pattern.plan
    if plan.units:
        stream = pa.pair_stream(plan, lin)
    else:
        stream = torch.zeros(1, dtype=problem.dtype, device=problem.device)
    outs = pa.pair_assemble(plan, stream)
    n = len(pattern.pairs)
    return tuple(outs[:n]), dict(zip(pattern.groups, outs[n:]))


class PairOperator:
    """The scaled pair tables `values` (K4''s used-slot layout) on a
    PairPattern as the flat operator of `pcg_solve`: K5' over every row
    group on flat vectors (`flatten`: the groups' parts vertex-major, one
    after another; `split` takes one apart). Its FlatLayout (every table
    checked and laid out once) and its partials table are made at the
    first call and reused by every later one."""

    def __init__(self, pattern: PairPattern, values):
        self.pattern = pattern
        self.values = values
        self._layout = None
        self._partials = None

    def flatten(self, parts: dict):
        return self.pattern.flatten(parts)

    def split(self, flat) -> dict:
        return self.pattern.split(flat)

    @property
    def layout(self):
        if self._layout is None:
            self._layout = self.pattern.flat_layout(self.values)
            self._partials = torch.empty(
                self._layout.blocks, dtype=self._layout.dtype,
                device=self._layout.device)
        return self._layout

    def __call__(self, x):
        return kernels.pair_ell.pair_spmv(self.layout, x)

    def matvec_dot(self, p):
        """(H p, partial sums of p . H p over every group)."""
        return kernels.pair_ell.pair_spmv_dot(self.layout, p, self._partials)

    def matvec_dot_p(self, scal, p, r, p_new):
        """(H p_new, partial sums of p_new . H p_new) with p_new = beta p + r
        written into p_new (beta in `scal`)."""
        return kernels.pair_ell.pair_spmv_dot_p(self.layout, scal, p, r,
                                                p_new, self._partials)
