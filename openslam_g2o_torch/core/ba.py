"""Schur-complement bundle adjustment, the general path: LM with the
landmarks eliminated, for edges of any arity and any number of pose groups.

Counterpart of openslam_g2o_tpu/core/ba.py (`LevenbergMarquardtSchur`
:340-382 and everything it runs), the reference's BlockSolver Schur path
(block_solver.hpp:143-295 buildStructure, :353-486 solve). The landmark
group (the one marginalized vertex group) is never materialized with the
poses: per linearization

* Hpp [Tp, Tp] and b_p are assembled densely over the pose block from the
  pose slots of every edge (K15, kernels/dense_assemble.py, restricted to
  those slots: an edge of EDGE_PROJECT_PSI2UV adds its two cameras' blocks
  and their coupling, the sum of a block and its transpose where both
  cameras are one);
* Hll [dl*dl, L] and b_l are per-landmark sums of the per-edge blocks, and
  every (edge, pose slot) gives a W entry W_e = J_t^T w Omega J_l (K14,
  kernels/schur_general.py; the landmark blocks summed by K10's
  `ba_lm_sums`);

and per LM trial the reduced system S = Hpp_d - W Hll_d^-1 W^T is solved by
block-Jacobi PCG matrix-free (`pcg_solve`, 250 iterations at tol 1e-8 by
default, as in JAX): one S x is K13's `ba_wtx` over all pose groups, the
dense Hpp_d x (torch.matmul, which the JAX package leaves to XLA too) and
K13's `ba_wv` per pose group; the preconditioner blocks are K13's
`ba_sandwich` on the diagonal blocks of Hpp_d, inverted by K11 and applied
with r . z by K4's `lane_block_mv_dot` (`BlockJacobi`). The landmarks follow by
back-substitution dx_l = Hinv (b_l - W^T dx_p) (`ba_wtx`).

The JAX module sorts every (edge group, landmark slot, pose slot) by
landmark and by camera so that its sums are sorted segment sums, because
random scatters serialize on the TPU (`schur_build`, ba.py:157-160). The
port builds the same orderings on the host once per topology as
destination-major tables (`build_schur_pattern`) and sums through them in
a fixed order, without atomics.

Vectors are lane-major per pose group ([D, N], as K13 reads them); Hpp_d is
formed per trial in the matching lane order (row offset + a N + n of a
group for entry a of vertex n), so that the dense product needs no
transposes. The candidate, its chi2 and the LM bookkeeping are K7's, by
core/problem.py `lm_trial_outcome`, as on the dual-ELL route
(core/ba_ell.py) and the dense LM.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from openslam_g2o_torch.core.algorithms import _select
from openslam_g2o_torch.core.problem import (
    Problem, linearize, lm_trial_outcome, robust_chi2)
from openslam_g2o_torch.core.solvers import BlockJacobi, pcg_solve
from openslam_g2o_torch.kernels import (
    ba_coupling, ba_edge, ba_inv, dense_assemble, schur_general)

__all__ = ["SchurPattern", "build_schur_pattern", "schur_build",
           "schur_solve", "lm_schur_step", "LevenbergMarquardtSchur"]


def _landmark_group(problem: Problem):
    mg = problem.static.marginalized_groups
    if len(mg) != 1:
        raise ValueError(
            f"Schur solver expects exactly one marginalized group, got "
            f"{[g.name for g in mg]}")
    return mg[0]


@dataclass
class LandmarkEdges:
    """One edge group with a landmark slot: its landmark blocks are columns
    offset .. offset + count of the landmark streams."""
    egkey: str
    lm_slot: int
    offset: int
    count: int


@dataclass
class CrossEntry:
    """The W entries of one (edge group, pose slot): entry e sits at flat
    slot lm_pos[e] of its pose group's landmark-major table and at
    position pose_pos[e] of its CSR order; lm_order and pose_order are the
    orders K14 writes the two layouts in (`schur_general.edge_orders`).
    int32 [E] on the device."""
    egkey: str
    slot: int
    group: str
    lm_pos: torch.Tensor
    pose_pos: torch.Tensor
    lm_order: torch.Tensor
    pose_order: torch.Tensor


@dataclass
class PoseGroupTables:
    """One pose group: tangent block [offset, offset + dim count), its W
    entries' landmark slot table lm_pose [K, L] (pose vertex, -1 on
    padding) and pose-major rows (`ba_coupling.PoseRows`)."""
    name: str
    dim: int
    count: int
    offset: int
    lm_pose: torch.Tensor
    rows: ba_coupling.PoseRows

    @property
    def size(self):
        return self.dim * self.count

    @property
    def n_entries(self):
        return self.rows.n_entries


@dataclass
class SchurPattern:
    """Host-built tables of one graph topology (the analogue of
    buildStructure's symbolic phase, block_solver.hpp:143-295).

    lm_edge [K, L]: the landmark-stream column of slot k of landmark l
    (-1 on padding); hpp_keys: per edge group with a pose slot, (key, pose
    slots), the groups K15 assembles Hpp from, with its pattern
    hpp_pattern (on the card only); perm [Tp]: the vertex-order index of
    each lane-order pose index."""
    lm_name: str
    n_lm: int
    dl: int
    pose_dim: int
    lm_edges: tuple
    n_lm_edges: int
    lm_edge: torch.Tensor
    pose_groups: tuple
    cross: tuple
    hpp_keys: tuple
    hpp_pattern: Optional[object]
    perm: torch.Tensor


def _slots(owner: np.ndarray, n_owners: int):
    """(K, slot of every entry): entry i is the slot-th entry of its owner
    in entry order; K the largest count (at least 1)."""
    counts = np.bincount(owner, minlength=n_owners)
    K = max(int(counts.max()) if len(owner) else 1, 1)
    order = np.argsort(owner, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.empty(len(owner), dtype=np.int64)
    slot[order] = np.arange(len(owner)) - starts[owner[order]]
    return K, slot


def build_schur_pattern(problem: Problem) -> SchurPattern:
    """Host symbolic phase (openslam_g2o_tpu/core/ba.py:51-78): the
    landmark slot tables and pose CSR lists of every W entry, the landmark
    stream table and K15's Hpp pattern. Raises ValueError where the JAX
    package does (not one marginalized group, an edge on two landmarks)
    and NotImplementedError for block widths no kernel is built for."""
    lg = _landmark_group(problem)
    static = problem.static
    dev = problem.device
    L, dl = lg.count, lg.tangent_dim
    pose_groups = sorted((g for g in static.vgroups
                          if g.offset < static.pose_dim),
                         key=lambda g: g.offset)
    host = lambda t: t.cpu().numpy().astype(np.int64)
    lm_edges, lis, hpp = [], [], []
    per_group = {g.name: [] for g in pose_groups}   # (cross index, li, pi)
    cross_meta = []
    offset = 0
    for eg in static.egroups:
        ea = problem.edges[eg.key]
        lm_slots = [s for s, n in enumerate(eg.slots) if n == lg.name]
        if len(lm_slots) > 1:
            raise ValueError(
                f"edge {eg.key} touches {len(lm_slots)} marginalized "
                f"vertices; Schur requires at most one (landmark "
                f"independence)")
        pose_slots = tuple(s for s in range(eg.etype.num_vertices)
                           if s not in lm_slots)
        if pose_slots:
            hpp.append((eg, pose_slots))
        if not lm_slots:
            continue
        sl = lm_slots[0]
        R = eg.etype.error_dim
        # K14's instantiations: every pose slot's (Dp, dl) at residual
        # width R (a landmark edge without a pose slot: the default one)
        for dp in [static.vgroup(eg.slots[t]).tangent_dim
                   for t in pose_slots] or [6 if dl == 3 else 3]:
            schur_general.check_served(R, dp, dl, f"edge group {eg.key}")
        li = host(ea.indices[sl])
        lm_edges.append(LandmarkEdges(eg.key, sl, offset, len(li)))
        lis.append(li)
        offset += len(li)
        for t in pose_slots:
            g = static.vgroup(eg.slots[t])
            per_group[g.name].append((len(cross_meta), li,
                                      host(ea.indices[t])))
            cross_meta.append((eg.key, t, g.name))
    if dl not in (2, 3):
        raise NotImplementedError(f"landmark tangent width {dl} is not "
                                  "served (2 or 3)")
    try:        # one ba_wtx launch takes the W^T x of every pose group
        ba_coupling.check_wtx_groups(sum(1 for g in pose_groups
                                         if per_group[g.name]))
    except ValueError as err:
        raise NotImplementedError(str(err)) from None
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                    device=dev)
    li_all = np.concatenate(lis) if lis else np.zeros(0, dtype=np.int64)
    K, slot = _slots(li_all, L)
    lm_edge = np.full((K, L), -1, dtype=np.int64)
    lm_edge[slot, li_all] = np.arange(len(li_all))
    positions = [None] * len(cross_meta)
    tables = []
    for g in pose_groups:
        entries = per_group[g.name]
        lm_cat = (np.concatenate([li for _, li, _ in entries]) if entries
                  else np.zeros(0, dtype=np.int64))
        pose_cat = (np.concatenate([pi for _, _, pi in entries]) if entries
                    else np.zeros(0, dtype=np.int64))
        Kg, gslot = _slots(lm_cat, L)
        lm_pose = np.full((Kg, L), -1, dtype=np.int64)
        lm_pose[gslot, lm_cat] = pose_cat
        lm_pos = gslot * L + lm_cat
        order = np.argsort(pose_cat, kind="stable")
        pose_pos = np.empty(len(pose_cat), dtype=np.int64)
        pose_pos[order] = np.arange(len(pose_cat))
        rows = ba_coupling.build_pose_rows(
            np.bincount(pose_cat, minlength=g.count), lm_cat[order], dev)
        start = 0
        for ci, li, _ in entries:
            positions[ci] = (lm_pos[start:start + len(li)],
                             pose_pos[start:start + len(li)])
            start += len(li)
        tables.append(PoseGroupTables(g.name, g.tangent_dim, g.count,
                                      g.offset, i32(lm_pose), rows))
    cross = tuple(CrossEntry(key, t, gname, i32(positions[i][0]),
                             i32(positions[i][1]),
                             *map(i32, schur_general.edge_orders(
                                 *positions[i])))
                  for i, (key, t, gname) in enumerate(cross_meta))
    hpp_pattern = None
    if hpp and dev.type == "cuda":
        hpp_pattern = dense_assemble.build_dense_pattern(
            problem, egroups=[eg for eg, _ in hpp],
            total_dim=static.pose_dim, slots=[ps for _, ps in hpp])
    perm = (np.concatenate([
        g.offset + (np.arange(g.count)[None, :] * g.tangent_dim
                    + np.arange(g.tangent_dim)[:, None]).reshape(-1)
        for g in pose_groups]) if pose_groups else np.zeros(0, np.int64))
    return SchurPattern(
        lg.name, L, dl, static.pose_dim, tuple(lm_edges), len(li_all),
        i32(lm_edge), tuple(tables), cross,
        tuple((eg.key, ps) for eg, ps in hpp), hpp_pattern,
        torch.as_tensor(perm, dtype=torch.long, device=dev))


def _egroup(problem, key):
    return next(e for e in problem.static.egroups if e.key == key)


def schur_build(problem: Problem, params: Optional[dict] = None,
                lin: Optional[dict] = None,
                pattern: Optional[SchurPattern] = None) -> dict:
    """Assemble {Hpp [Tp, Tp], b_p [Tp] (vertex order, without the unit
    diagonal of fixed slots), Hll [dl*dl, L], b_l [dl, L] (lane-major),
    W_lm {pose group: [Dp*dl, K, L]}, W_pose {pose group: [Dp*dl, M]}} and
    the pattern ("pattern") (openslam_g2o_tpu/core/ba.py:81-168). Fixed
    vertices are masked out of the Jacobians by `linearize`."""
    pattern = build_schur_pattern(problem) if pattern is None else pattern
    work = problem if params is None else problem.with_params(params)
    if lin is None:
        lin = linearize(work)
    static, dt, dev = work.static, work.dtype, work.device
    Tp, dl, L = pattern.pose_dim, pattern.dl, pattern.n_lm
    # Hpp and b_p: K15 on the pose slots of every edge
    groups = []
    for i, (key, ps) in enumerate(pattern.hpp_keys):
        eg = _egroup(work, key)
        ea = work.edges[key]
        resid, jacs, rho1 = lin[key]
        offs = (pattern.hpp_pattern.offsets[i]
                if pattern.hpp_pattern is not None else
                tuple(dense_assemble.slot_offsets(static, eg, ea)[s]
                      for s in ps))
        groups.append(dense_assemble.EdgeBlocks(
            resid.contiguous(), tuple(jacs[s].contiguous() for s in ps),
            rho1.contiguous(), ea.information, offs))
    zeros = torch.zeros(Tp, dtype=dt, device=dev)
    if groups:
        Hpp, b_p, _ = dense_assemble.dense_assemble(
            groups, Tp, zeros, pattern.hpp_pattern, add_fixed_diag=False)
    else:
        Hpp, b_p = torch.zeros((Tp, Tp), dtype=dt, device=dev), zeros
    # the landmark blocks and the W entries: K14, then K10's landmark sums
    streams = ba_edge.LandmarkStreams(
        torch.empty((dl * dl, pattern.n_lm_edges), dtype=dt, device=dev),
        torch.empty((dl, pattern.n_lm_edges), dtype=dt, device=dev))
    W_lm = {pg.name: torch.zeros((pg.dim * dl,) + tuple(pg.lm_pose.shape),
                                 dtype=dt, device=dev)
            for pg in pattern.pose_groups}
    W_pose = {pg.name: torch.empty((pg.dim * dl, pg.n_entries), dtype=dt,
                                   device=dev)
              for pg in pattern.pose_groups}
    for le in pattern.lm_edges:
        ea = work.edges[le.egkey]
        resid, jacs, rho1 = lin[le.egkey]
        resid, rho1 = resid.contiguous(), rho1.contiguous()
        jl = jacs[le.lm_slot].contiguous()
        first = True
        for ce in pattern.cross:
            if ce.egkey != le.egkey:
                continue
            schur_general.schur_edge_blocks(
                resid, jl, jacs[ce.slot].contiguous(), rho1, ea.information,
                streams.hll if first else None, streams.bl if first else None,
                le.offset, W_lm[ce.group], ce.lm_pos, W_pose[ce.group],
                ce.pose_pos, ce.lm_order, ce.pose_order)
            first = False
        if first:                        # a landmark edge without a pose
            schur_general.schur_edge_blocks(
                resid, jl, None, rho1, ea.information, streams.hll,
                streams.bl, le.offset)
    Hll, b_l, _ = ba_edge.ba_lm_sums(streams, pattern.lm_edge, with_w=False)
    return {"Hpp": Hpp, "b_p": b_p, "Hll": Hll, "b_l": b_l, "W_lm": W_lm,
            "W_pose": W_pose, "pattern": pattern}


def _lane(pattern: SchurPattern, flat):
    """A [Tp] lane-order pose vector as {pose group: [D, N] view}."""
    return {pg.name: flat[pg.offset:pg.offset + pg.size].view(pg.dim,
                                                              pg.count)
            for pg in pattern.pose_groups}


class SchurOperator:
    """The reduced pose system S x = Hpp_d x - W Hinv W^T x on dicts
    {pose group: [D, N]} (openslam_g2o_tpu/core/ba.py:229-241), with the
    fused `matvec_dot` that core/solvers.py `pcg_solve` calls: one
    `ba_wtx` over the pose groups that have W entries (Hinv applied to
    their sum), Hpp_d x by torch.matmul on the lane-order concatenation,
    and `ba_wv` per pose group with the partial dots."""

    def __init__(self, pattern: SchurPattern, sys: dict, hinv, hpp_d):
        self.pattern, self.sys = pattern, sys
        self.hinv, self.hpp_d = hinv, hpp_d
        self.wtx_groups = [pg for pg in pattern.pose_groups if pg.n_entries]

    def landmark_side(self, x: dict, **epilogue):
        """W^T x summed over the pose groups in one `ba_wtx` launch,
        with its keyword arguments (hinv, b, free) applied to the sum; None
        without W entries."""
        gs = self.wtx_groups
        if not gs:
            return None
        return ba_coupling.ba_wtx([self.sys["W_lm"][pg.name] for pg in gs],
                                  [pg.lm_pose for pg in gs],
                                  [x[pg.name] for pg in gs], **epilogue)

    def _apply(self, p: dict, want_dot: bool):
        pat = self.pattern
        v = self.landmark_side(p, hinv=self.hinv)
        if v is None:
            v = torch.zeros((pat.dl, pat.n_lm), dtype=self.hinv.dtype,
                            device=self.hinv.device)
        names = [pg.name for pg in pat.pose_groups]
        flat = (p[names[0]].reshape(-1) if len(names) == 1
                else torch.cat([p[n].reshape(-1) for n in names]))
        hx = _lane(pat, self.hpp_d @ flat)
        out, parts = {}, []
        for pg in pat.pose_groups:
            res = ba_coupling.ba_wv(
                self.sys["W_pose"][pg.name], pg.rows, v, x=p[pg.name],
                extra=hx[pg.name], want_dot=want_dot)
            if want_dot:
                out[pg.name], part = res
                parts.append(part)
            else:
                out[pg.name] = res
        if want_dot:
            return out, parts[0] if len(parts) == 1 else torch.cat(parts)
        return out

    def __call__(self, p: dict) -> dict:
        return self._apply(p, False)

    def matvec_dot(self, p: dict):
        return self._apply(p, True)


def diag_blocks(hpp_d, pg: PoseGroupTables):
    """The diagonal blocks of one pose group of the lane-order Hpp_d
    [Tp, Tp], lane-major [D*D, N] as K13 reads them: entry (a, b) of
    vertex n is row pg.offset + a N + n, column pg.offset + b N + n."""
    D, N = pg.dim, pg.count
    idx = (pg.offset + torch.arange(D, device=hpp_d.device)[:, None] * N
           + torch.arange(N, device=hpp_d.device)[None, :])     # [D, N]
    return hpp_d[idx[:, None, :], idx[None, :, :]].reshape(D * D, N)


def _solve(problem: Problem, sys: dict, lam, pcg_iters: int,
           pcg_tol: float = 1e-8):
    """The damped Schur solve (openslam_g2o_tpu/core/ba.py:199-287):
    (dxT, ok, bT), the step and the right-hand side as lane-major dicts
    {group: [D, N]} over the pose groups and the landmarks, ok a 0-dim
    bool tensor."""
    pat = sys["pattern"]
    lm = pat.lm_name
    free_l = problem.free[lm]
    # damped landmark blocks (a fixed landmark gets + I), inverse, Hinv b_l
    _, Hinv, hib = ba_inv.ba_block_inv(sys["Hll"], ba_inv.LANDMARK, free_l,
                                       lam, b=sys["b_l"])
    # Hpp_d = Hpp + diag(lam free + fixed), in lane order
    free_p = torch.cat([problem.free[pg.name][None].expand(
        pg.dim, pg.count).reshape(-1) for pg in pat.pose_groups])
    Hpp_d = sys["Hpp"][pat.perm[:, None], pat.perm[None, :]]
    Hpp_d.diagonal().add_(lam * free_p + (1.0 - free_p))
    b_p = _lane(pat, sys["b_p"][pat.perm])
    # reduced right-hand side b_p - W Hinv b_l
    b_red = {pg.name: ba_coupling.ba_wv(
                sys["W_pose"][pg.name], pg.rows, hib, base=b_p[pg.name])
             for pg in pat.pose_groups}
    op = SchurOperator(pat, sys, Hinv, Hpp_d)
    # block-Jacobi preconditioner: the diagonal blocks of S per pose group
    # (exact when each (pose, landmark) pair appears in one edge; kept as
    # the JAX package has it for the anchored edges too)
    binv = {pg.name: ba_inv.ba_block_inv(ba_coupling.ba_sandwich(
                sys["W_pose"][pg.name], pg.rows, Hinv,
                diag_blocks(Hpp_d, pg)))[1]
            for pg in pat.pose_groups}
    x, ok = pcg_solve(op, b_red, precond=BlockJacobi(binv),
                      max_iter=pcg_iters, tol=pcg_tol)
    dx = {pg.name: x[pg.name] * problem.free[pg.name][None]
          for pg in pat.pose_groups}
    # back-substitution dx_l = Hinv (b_l - W^T dx_p), free
    dx_l = op.landmark_side(dx, hinv=Hinv, b=sys["b_l"], free=free_l)
    if dx_l is None:
        dx_l = hib * free_l[None]
    dx[lm] = dx_l
    b_p[lm] = sys["b_l"]
    return dx, ok, b_p


def schur_solve(problem: Problem, sys: dict, lam, pcg_iters: int = 250,
                pcg_tol: float = 1e-8):
    """Solve the damped system by the reduced pose system and
    back-substitution (openslam_g2o_tpu/core/ba.py:199-287). Returns
    (dx [T], ok, b_full [T], raw_diag [T]) over the global tangent vector
    in vertex order, as the JAX function does; damping adds lam to every
    free diagonal entry (block_solver.hpp:564-589)."""
    pat = sys["pattern"]
    lam = torch.as_tensor(lam, dtype=problem.dtype, device=problem.device)
    dxT, ok, bT = _solve(problem, sys, lam, pcg_iters, pcg_tol)

    def flat(parts):
        pose = torch.cat([parts[pg.name].reshape(-1)
                          for pg in pat.pose_groups])
        vert = torch.empty_like(pose)
        vert[pat.perm] = pose
        return torch.cat([vert, parts[pat.lm_name].T.reshape(-1)])

    dl = pat.dl
    raw_diag = torch.cat([sys["Hpp"].diagonal(),
                          sys["Hll"][0::dl + 1].T.reshape(-1)])
    return flat(dxT), ok, flat(bT), raw_diag


def _trial(work: Problem, sys: dict, lam, ni, chi_cur, pcg_iters):
    """One LM trial (the trial body of openslam_g2o_tpu/core/ba.py:
    309-322): the solve, then the candidate, its chi2 and `lm_outcome` by
    core/problem.py `lm_trial_outcome` (K7), on the device. Returns (cand,
    chi_new, accept, lam_new, ni_new, retry)."""
    dxT, ok, bT = _solve(work, sys, lam, pcg_iters)
    return lm_trial_outcome(work, {k: v.T for k, v in dxT.items()},
                            {k: v.T for k, v in bT.items()}, ok, lam, ni,
                            chi_cur)


def lm_schur_step(prob: Problem, pattern: SchurPattern, params: dict, lam,
                  ni, chi_cur, max_trials: int = 10, pcg_iters: int = 250):
    """One LM iteration with Schur landmark elimination (`_lm_schur_step`,
    openslam_g2o_tpu/core/ba.py:290-328; optimization_algorithm_levenberg
    .cpp:95-142): linearize and build once, then trials while the last was
    rejected with rho < 0 and fewer than max_trials ran; the host reads
    the retry flag once per trial. CG stops at tol 1e-8, as in JAX.
    Returns (params, lam, ni, chi, trials, accepted)."""
    work = prob.with_params(params)
    sys = schur_build(work, pattern=pattern)
    best_params, best_chi = params, chi_cur
    trials = 0
    while True:
        cand, chi_new, accept, lam, ni, retry = _trial(
            work, sys, lam, ni, chi_cur, pcg_iters)
        best_params = _select(accept, cand, best_params)
        best_chi = torch.where(accept, chi_new, best_chi)
        trials += 1
        if trials >= max_trials or not bool(retry.item()):
            break
    return best_params, lam, ni, best_chi, trials, accept


class LevenbergMarquardtSchur:
    """LM with Schur landmark marginalization, the `lm_fix6_3`
    configuration of the reference (requiresMarginalize algorithms,
    solver_csparse.cpp:104-124; openslam_g2o_tpu/core/ba.py:340-382). The
    pattern is built on the host once per graph topology."""

    name = "lm_schur"

    def __init__(self, initial_lambda: float = 0.0,
                 max_trials_after_failure: int = 10, tau: float = 1e-5,
                 pcg_iters: int = 250):
        self.initial_lambda = initial_lambda
        self.max_trials = max_trials_after_failure
        self.tau = tau
        self.pcg_iters = pcg_iters
        self._pattern = None
        self._pattern_for = None

    def pattern(self, prob: Problem) -> SchurPattern:
        if self._pattern_for is not prob.static:
            self._pattern = build_schur_pattern(prob)
            self._pattern_for = prob.static
        return self._pattern

    def init(self, prob: Problem):
        pattern = self.pattern(prob)
        scalar = lambda v: torch.tensor(v, dtype=prob.dtype,
                                        device=prob.device)
        if self.initial_lambda > 0:
            lam = scalar(self.initial_lambda)
        else:
            # tau * max |diag H| over Hpp and the landmark blocks
            # (`_schur_lambda_init`, ba.py:331-337)
            sys = schur_build(prob, pattern=pattern)
            diag_l = sys["Hll"][0::pattern.dl + 1]
            lam = scalar(self.tau) * torch.maximum(
                sys["Hpp"].diagonal().abs().max(), diag_l.abs().max())
        return {"params": prob.params, "lam": lam, "ni": scalar(2.0),
                "chi2": robust_chi2(prob)}

    def step(self, prob: Problem, state: dict):
        params, lam, ni, chi, trials, accepted = lm_schur_step(
            prob, self.pattern(prob), state["params"], state["lam"],
            state["ni"], state["chi2"], max_trials=self.max_trials,
            pcg_iters=self.pcg_iters)
        new_state = {"params": params, "lam": lam, "ni": ni, "chi2": chi}
        info = {"chi2": float(chi), "lambda": float(lam),
                "levenberg_iters": int(trials), "ok": bool(accepted)}
        return new_state, info
