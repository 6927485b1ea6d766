"""Schur-complement bundle adjustment: the dual-ELL Schur solver.

Counterpart of openslam_g2o_tpu/core/ba_ell.py (`LevenbergMarquardtSchurELL`
:1099-1154 and everything it runs). The landmarks (the one marginalizable
vertex group) are eliminated: per LM trial the reduced camera system
S = Hcc_d - W Hll_d^-1 W^T is solved, densely by Cholesky when the pose
block is small (`dense_schur_ok`), else matrix-free by block-Jacobi PCG,
and the landmarks follow by back-substitution (block_solver.hpp:353-486;
LM trial semantics of optimization_algorithm_levenberg.cpp:95-142).

The observations of every projection edge group (binary landmark-pose
edges) share two host-built tables: the landmark slot table [K, L] and the
camera CSR lists. The hot loops are the hand-written kernels:

    K10  kernels/ba_edge.py      per-edge blocks (fused for
                                 EDGE_PROJECT_XYZ2UV, generic otherwise)
                                 and the owner sums, W laid out twice
    K11  kernels/ba_inv.py       the damped block inverses
    K12  kernels/ba_schur.py     S of the dense route, from its nonzero terms
    K13  kernels/ba_coupling.py  W^T x, W v, the preconditioner blocks and
                                 the implicit S x (`SchurOperator`)

Pose-pose edges go to a dense Hpp_extra [Tp, Tp] through K15
(kernels/dense_assemble.py) on the pose block, as the JAX code scatters
them; S's factorization is `solve_dense_cholesky` (cuSOLVER) and the
implicit route's CG loop is core/solvers.py `pcg_solve`.

What the JAX module carries for its TPU toolchain is not ported: the
degree-bucketed tables (`_bucketize`, `_BUCKET_*`, `_place`,
`_bucket_scan`), the K-axis chunking (`_K_CHUNK`), the one-hot MXU operands
(`lm_cam_onehot`, `cam_onehot`) and the densified B2, the peeled and
host-driven trial variants (`peel`, `_lm_ba_ell_step_host`,
`_wants_host_trials`, `_has_chunked`, `_fused_chunk_unsafe`) and the
guards of `ba_ell_optimize_fused` that refused them. The loops are Python
loops with one host read per LM trial, as in core/algorithms.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from openslam_g2o_torch.core.algorithms import _select
from openslam_g2o_torch.core.problem import (
    Problem, linearize_group, lm_trial_outcome, robust_chi2)
from openslam_g2o_torch.core.solvers import (
    BlockJacobi, pcg_solve, solve_dense_cholesky)
from openslam_g2o_torch.kernels import (
    ba_coupling, ba_edge, ba_inv, ba_schur, dense_assemble)

__all__ = ["BAEllPattern", "build_ba_ell_pattern", "dense_schur_ok",
           "dense_schur_ok_sizes", "ba_ell_step", "ba_ell_optimize_fused",
           "LevenbergMarquardtSchurELL"]

# The dense-Schur routing gates of the JAX package (ba_ell.py:249-250 and
# the operand gates of :309-310): S is formed densely and factored when the
# pose tangent block is at most this wide; tests set it to -1 to force the
# implicit route in both packages.
_DENSE_SCHUR_MAX_TP = 1536
_DENSE_SCHUR_MAX_OPERAND_BYTES = 3e8
# the landmark degree above which the JAX package's landmark table is
# chunked (2 * its _K_CHUNK), which takes it off the dense route
_DENSE_SCHUR_MAX_K = 1024


@dataclass
class ProjGroup:
    """One projection edge group: its observations are columns offset ..
    offset + count of the per-edge streams; k_l is its own landmark table
    width (the JAX predicate reads it per group)."""
    egkey: str
    lm_slot: int
    cam_slot: int
    offset: int
    count: int
    k_l: int
    fused: bool


@dataclass
class BAEllPattern:
    """Host-built tables of one graph topology (the analogue of
    buildStructure's symbolic phase, block_solver.hpp:143-295).

    lm_edge [K, L]: observation id of slot k of landmark l (-1 on padding),
    slots in observation order; lm_cam [K, L]: its camera (-1 on padding);
    cam_rows (K13's `PoseRows`: cam_ptr [C + 1], cam_lm [E] and the chunks
    of its W products and of K10's camera sums), cam_edge [E]: the
    observations of camera c are cam_edge[cam_ptr[c]:cam_ptr[c+1]] in
    observation order, cam_lm their landmarks; cam_pos [E], its inverse
    permutation: observation e's place in its camera's list, where the
    edge kernels write its camera record. extra_pattern: K15's tables of
    the pose-pose edges on the pose block (on the card only)."""
    lm_name: str
    cam_name: str
    n_lm: int
    dl: int
    n_cam: int
    dp: int
    pose_dim: int
    proj: tuple
    pose_only_keys: tuple
    lm_edge: torch.Tensor
    lm_cam: torch.Tensor
    cam_rows: ba_coupling.PoseRows
    cam_edge: torch.Tensor
    cam_pos: torch.Tensor
    extra_pattern: Optional[object] = None
    lm_cam_host: Optional[np.ndarray] = None
    _pairs: Optional[object] = field(default=None, repr=False)

    @property
    def cam_ptr(self):
        return self.cam_rows.ptr

    @property
    def cam_lm(self):
        return self.cam_rows.lm

    @property
    def n_obs(self):
        return self.cam_edge.shape[0]

    def schur_pairs(self):
        """K12's destination table: built with the pattern where the dense
        route applies, else on first use."""
        if self._pairs is None:
            self._pairs = ba_schur.build_schur_pairs(
                self.lm_cam_host, self.n_cam, self.lm_cam.device)
        return self._pairs


def dense_schur_ok_sizes(pose_dim: int, dl: int, n_lm: int, n_cam: int,
                         k_ls, itemsize: int) -> bool:
    """The JAX routing predicate (ba_ell.py:253-270 with its one-hot and
    chunk gates :309-310, bucketing disabled) as a function of the sizes it
    reads: the pose block at most _DENSE_SCHUR_MAX_TP wide, every
    projection group's one-hot operand C K_l L s and the densified W
    Tp dl L s at most 3e8 bytes, K_l at most 1024."""
    k_ls = list(k_ls)
    return bool(
        pose_dim <= _DENSE_SCHUR_MAX_TP and k_ls
        and all(n_cam * k * n_lm * itemsize <= _DENSE_SCHUR_MAX_OPERAND_BYTES
                and k <= _DENSE_SCHUR_MAX_K for k in k_ls)
        and pose_dim * dl * n_lm * itemsize <= _DENSE_SCHUR_MAX_OPERAND_BYTES)


def dense_schur_ok(problem: Problem, pattern: BAEllPattern) -> bool:
    """True when the trial forms S densely and factors it (the JAX
    package's answer on the same problem)."""
    itemsize = torch.empty((), dtype=problem.dtype).element_size()
    return dense_schur_ok_sizes(pattern.pose_dim, pattern.dl, pattern.n_lm,
                                pattern.n_cam,
                                [pg.k_l for pg in pattern.proj], itemsize)


def _slot_table(owner: np.ndarray, n_owners: int):
    """[E] owner ids -> [K, n_owners] table of the edge ids of each owner in
    edge order, -1 on padding (the K-major form of `_ell_tables`,
    ba_ell.py:108-122, vectorized)."""
    E = len(owner)
    counts = np.bincount(owner, minlength=n_owners)
    K = max(int(counts.max()) if E else 1, 1)
    order = np.argsort(owner, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    sorted_owner = owner[order]
    slot = np.arange(E) - starts[sorted_owner]
    tbl = np.full((K, n_owners), -1, dtype=np.int64)
    tbl[slot, sorted_owner] = order
    return tbl


def build_ba_ell_pattern(problem: Problem) -> BAEllPattern:
    """Host symbolic phase (ba_ell.py:273-337). Requires exactly one
    marginalized vertex group, every edge group with a landmark slot to be
    binary (landmark, pose), and one pose group."""
    static = problem.static
    mg = static.marginalized_groups
    if len(mg) != 1:
        raise ValueError("dual-ELL Schur expects exactly one marginalized "
                         "group")
    lg = mg[0]
    pose_groups = [g for g in static.vgroups if g.offset < static.pose_dim]
    if len(pose_groups) != 1:
        raise NotImplementedError(
            "the port's Schur solver takes one pose vertex group, got "
            f"{[g.name for g in pose_groups]}")
    cg = pose_groups[0]
    dp, dl = cg.tangent_dim, lg.tangent_dim
    if (dp, dl) not in ba_edge.BLOCK_DIMS:
        raise NotImplementedError(
            f"(pose, landmark) tangent widths {(dp, dl)} are not among the "
            f"kernels' instantiations {ba_edge.BLOCK_DIMS}")
    proj, pose_only, lis, cis = [], [], [], []
    offset = 0
    for eg in static.egroups:
        lm_slots = [s for s, g in enumerate(eg.slots) if g == lg.name]
        if not lm_slots:
            pose_only.append(eg)
            continue
        if len(lm_slots) != 1 or eg.etype.num_vertices != 2:
            raise ValueError(
                f"edge group {eg.key} is not a binary (landmark, pose) "
                f"projection edge; use the general Schur solver")
        sl = lm_slots[0]
        sc = 1 - sl
        ea = problem.edges[eg.key]
        li = ea.indices[sl].cpu().numpy().astype(np.int64)
        ci = ea.indices[sc].cpu().numpy().astype(np.int64)
        k_l = max(int(np.bincount(li, minlength=lg.count).max())
                  if len(li) else 1, 1)
        fused = eg.etype.name == "edge_project_xyz2uv"
        proj.append(ProjGroup(eg.key, sl, sc, offset, len(li), k_l, fused))
        lis.append(li)
        cis.append(ci)
        offset += len(li)
    li_all = np.concatenate(lis) if lis else np.zeros(0, dtype=np.int64)
    ci_all = np.concatenate(cis) if cis else np.zeros(0, dtype=np.int64)
    lm_edge = _slot_table(li_all, lg.count)
    lm_cam = np.where(lm_edge >= 0, ci_all[np.maximum(lm_edge, 0)]
                      if len(ci_all) else -1, -1)
    cam_order = np.argsort(ci_all, kind="stable")
    cam_pos = np.empty_like(cam_order)
    cam_pos[cam_order] = np.arange(len(cam_order))
    dev = problem.device
    i32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                                    device=dev)
    extra_pattern = None
    if pose_only and dev.type == "cuda":
        extra_pattern = dense_assemble.build_dense_pattern(
            problem, egroups=pose_only, total_dim=static.pose_dim)
    pattern = BAEllPattern(
        lg.name, cg.name, lg.count, dl, cg.count, dp, static.pose_dim,
        tuple(proj), tuple(eg.key for eg in pose_only), i32(lm_edge),
        i32(lm_cam), ba_coupling.build_pose_rows(
            np.bincount(ci_all, minlength=cg.count), li_all[cam_order], dev),
        i32(cam_order), i32(cam_pos), extra_pattern, lm_cam)
    if dense_schur_ok(problem, pattern):
        pattern.schur_pairs()            # the dense route's table, up front
    return pattern


def _egroup(problem, key):
    return next(e for e in problem.static.egroups if e.key == key)


def _lane_diag(A):
    """The diagonal entries of every block of a lane-major [D*D, N] table."""
    D = int(round(A.shape[0] ** 0.5))
    return A[0::D + 1]


def _build(problem: Problem, pattern: BAEllPattern):
    """The per-linearization quantities (ba_ell.py:537-672): Hll [dl*dl, L],
    b_l [dl, L], Hcc [Dp*Dp, C], b_p [Dp, C], W landmark-major
    [Dp*dl, K, L] and camera-major [Dp*dl, E], on the dense-Schur route
    W's records for K12 [K*L, Dp*dl padded] (else None), and the dense
    pose-pose extra Hpp_extra [Tp, Tp], b_extra [Tp] (None without
    pose-pose edges)."""
    params, free = problem.params, problem.free
    lm, cam = pattern.lm_name, pattern.cam_name
    streams = ba_edge.EdgeStreams.empty(pattern.n_obs, pattern.dp,
                                        pattern.dl, problem.dtype,
                                        problem.device, pattern.cam_pos)
    for pg in pattern.proj:
        eg = _egroup(problem, pg.egkey)
        ea = problem.edges[pg.egkey]
        if pg.fused:
            ba_edge.ba_xyz2uv_blocks(
                params[lm], params[cam], ea.indices[pg.lm_slot],
                ea.indices[pg.cam_slot], ea.measurement, ea.information,
                ea.delta, ea.pdata[0], free[lm], free[cam], eg.kernel_id,
                streams, pg.offset)
        else:
            resid, jacs, rho1 = linearize_group(problem, eg)
            ba_edge.ba_edge_blocks(
                resid.contiguous(), jacs[pg.lm_slot].contiguous(),
                jacs[pg.cam_slot].contiguous(), rho1.contiguous(),
                ea.information, streams, pg.offset)
    Hll, b_l, W_lm = ba_edge.ba_lm_sums(streams, pattern.lm_edge)
    Hcc, b_p, W_cam = ba_edge.ba_cam_sums(streams, pattern.cam_rows)
    del streams
    W_rec = (ba_schur.ba_schur_records(W_lm.view(W_lm.shape[0], -1))
             if dense_schur_ok(problem, pattern) else None)
    Hpp_extra = b_extra = None
    if pattern.pose_only_keys:
        groups = []
        for key in pattern.pose_only_keys:
            eg = _egroup(problem, key)
            ea = problem.edges[key]
            resid, jacs, rho1 = linearize_group(problem, eg)
            offsets = dense_assemble.slot_offsets(problem.static, eg, ea)
            groups.append(dense_assemble.EdgeBlocks(
                resid.contiguous(), tuple(j.contiguous() for j in jacs),
                rho1.contiguous(), ea.information, offsets))
        zeros = torch.zeros(pattern.pose_dim, dtype=problem.dtype,
                            device=problem.device)
        Hpp_extra, b_extra, _ = dense_assemble.dense_assemble(
            groups, pattern.pose_dim, zeros, pattern.extra_pattern,
            add_fixed_diag=False)
    return {"Hll": Hll, "b_l": b_l, "Hcc": Hcc, "b_p": b_p, "W_lm": W_lm,
            "W_cam": W_cam, "W_rec": W_rec, "Hpp_extra": Hpp_extra,
            "b_extra": b_extra}


def _solve(problem: Problem, pattern: BAEllPattern, sys, lam,
           pcg_iters: int, pcg_tol: float = 1e-10):
    """Damped Schur solve (ba_ell.py:675-830). Returns (dxT, ok, bT): the
    step and the right-hand side as lane-major dicts {group: [D, N]} over
    both groups, ok a 0-dim bool tensor."""
    lm, cam = pattern.lm_name, pattern.cam_name
    free_l, free_c = problem.free[lm], problem.free[cam]
    dp, C = pattern.dp, pattern.n_cam
    _, Hinv, hib = ba_inv.ba_block_inv(
        sys["Hll"], ba_inv.LANDMARK, free_l, lam, b=sys["b_l"])
    Hcc_d, _, _ = ba_inv.ba_block_inv(
        sys["Hcc"], ba_inv.CAMERA, free_c, lam, want_inv=False)
    b_p = sys["b_p"]
    if sys["b_extra"] is not None:
        b_p = b_p + sys["b_extra"].view(C, dp).T
    # reduced right-hand side (b_p - W Hinv b_l) free
    b_red = ba_coupling.ba_wv(sys["W_cam"], pattern.cam_rows, hib, base=b_p,
                              free=free_c)
    if dense_schur_ok(problem, pattern):
        S = ba_schur.ba_schur_dense(pattern.schur_pairs(), sys["W_lm"], Hinv,
                                    Hcc_d, base=sys["Hpp_extra"],
                                    w_rec=sys["W_rec"])
        dx_flat, ok = solve_dense_cholesky(S, b_red.T.reshape(-1))
        del S
        dx_p = (dx_flat.view(C, dp).T * free_c[None]).contiguous()
    else:
        op = ba_coupling.SchurOperator(
            cam, sys["W_lm"], pattern.lm_cam, sys["W_cam"], pattern.cam_rows,
            Hinv, Hcc_d, sys["Hpp_extra"])
        s_blocks = ba_coupling.ba_sandwich(
            sys["W_cam"], pattern.cam_rows, Hinv, Hcc_d)
        _, s_binv, _ = ba_inv.ba_block_inv(s_blocks)
        x, ok = pcg_solve(op, {cam: b_red},
                          precond=BlockJacobi({cam: s_binv}),
                          max_iter=pcg_iters, tol=pcg_tol, norm="precond",
                          unroll=2)
        dx_p = x[cam] * free_c[None]
    # back-substitution dx_l = Hinv (b_l - W^T dx_p) free
    dx_l = ba_coupling.ba_wtx(sys["W_lm"], pattern.lm_cam, dx_p, hinv=Hinv,
                              b=sys["b_l"], free=free_l)
    return {cam: dx_p, lm: dx_l}, ok, {cam: b_p, lm: sys["b_l"]}


def _trial(work: Problem, pattern: BAEllPattern, sys, lam, ni, chi_cur,
           pcg_iters, pcg_tol):
    """One LM trial (the trial body of ba_ell.py:853-876): the solve, then
    the candidate, its chi2 and the bookkeeping by core/problem.py
    `lm_trial_outcome` (K7), all on the device. Returns (cand, chi_new,
    accept, lam_new, ni_new, retry)."""
    dxT, ok, bT = _solve(work, pattern, sys, lam, pcg_iters, pcg_tol)
    return lm_trial_outcome(work, {k: v.T for k, v in dxT.items()},
                            {k: v.T for k, v in bT.items()}, ok, lam, ni,
                            chi_cur)


def ba_ell_step(prob: Problem, pattern: BAEllPattern, params: dict, lam, ni,
                chi_cur, max_trials: int = 10, pcg_iters: int = 100,
                pcg_tol: float = 1e-10):
    """One LM iteration on the Schur solver (`_lm_ba_ell_step`,
    ba_ell.py:833-892, and `ba_ell_step` :997-1010): linearize and build
    once, then trials while the last was rejected with rho < 0 and fewer
    than max_trials ran; the host reads the retry flag once per trial.
    Returns (params, lam, ni, chi, trials, accepted)."""
    work = prob.with_params(params)
    sys = _build(work, pattern)
    best_params, best_chi = params, chi_cur
    trials = 0
    while True:
        cand, chi_new, accept, lam, ni, retry = _trial(
            work, pattern, sys, lam, ni, chi_cur, pcg_iters, pcg_tol)
        best_params = _select(accept, cand, best_params)
        best_chi = torch.where(accept, chi_new, best_chi)
        trials += 1
        if trials >= max_trials or not bool(retry.item()):
            break
    return best_params, lam, ni, best_chi, trials, accept


def ba_ell_optimize_fused(prob: Problem, pattern: BAEllPattern, params: dict,
                          lam, ni, chi, n_iters: int = 10,
                          max_trials: int = 10, pcg_iters: int = 100,
                          pcg_tol: float = 1e-10,
                          trial_per_iter: bool = True):
    """n_iters Schur LM iterations without a host read between them but
    the CG stop tests (ba_ell.py:1013-1096; a Python loop in place of
    lax.scan). trial_per_iter=True runs ONE trial per iteration: a rejected
    trial leaves params unchanged and raises lambda, and the next iteration
    re-linearizes the same system (n_iters counts trials; max_trials is not
    read). trial_per_iter=False runs `ba_ell_step` per iteration. Returns
    (params, lam, ni, chi, chi_trajectory [n_iters] tensor)."""
    traj = []
    for _ in range(n_iters):
        if trial_per_iter:
            work = prob.with_params(params)
            sys = _build(work, pattern)
            cand, chi_new, accept, lam, ni, _ = _trial(
                work, pattern, sys, lam, ni, chi, pcg_iters, pcg_tol)
            del sys
            params = _select(accept, cand, params)
            chi = torch.where(accept, chi_new, chi)
        else:
            params, lam, ni, chi, _, _ = ba_ell_step(
                prob, pattern, params, lam, ni, chi, max_trials=max_trials,
                pcg_iters=pcg_iters, pcg_tol=pcg_tol)
        traj.append(chi)
    return params, lam, ni, chi, torch.stack(traj)


class LevenbergMarquardtSchurELL:
    """LM on the dual-ELL Schur solver (ba_ell.py:1099-1154). The pattern
    is built on the host once per graph topology."""

    name = "lm_schur_ell"

    def __init__(self, initial_lambda: float = 0.0,
                 max_trials_after_failure: int = 10, tau: float = 1e-5,
                 pcg_iters: int = 100, pcg_tol: float = 1e-10):
        self.initial_lambda = initial_lambda
        self.max_trials = max_trials_after_failure
        self.tau = tau
        self.pcg_iters = pcg_iters
        self.pcg_tol = pcg_tol
        self._pattern = None
        self._pattern_for = None

    def pattern(self, prob: Problem) -> BAEllPattern:
        if self._pattern_for is not prob.static:
            self._pattern = build_ba_ell_pattern(prob)
            self._pattern_for = prob.static
        return self._pattern

    def init(self, prob: Problem):
        pattern = self.pattern(prob)
        scalar = lambda v: torch.tensor(v, dtype=prob.dtype,
                                        device=prob.device)
        if self.initial_lambda > 0:
            lam = scalar(self.initial_lambda)
        else:
            # tau * max |diag(H)| over landmark and camera blocks and the
            # pose-pose extra (computeLambdaInit,
            # optimization_algorithm_levenberg.cpp:149-163)
            sys = _build(prob, pattern)
            diags = [_lane_diag(sys["Hll"]), _lane_diag(sys["Hcc"])]
            if sys["Hpp_extra"] is not None:
                diags.append(sys["Hpp_extra"].diagonal())
            lam = scalar(self.tau) * torch.stack(
                [d.abs().max() for d in diags]).max()
        return {"params": prob.params, "lam": lam, "ni": scalar(2.0),
                "chi2": robust_chi2(prob)}

    def step(self, prob: Problem, state: dict):
        params, lam, ni, chi, trials, accepted = ba_ell_step(
            prob, self.pattern(prob), state["params"], state["lam"],
            state["ni"], state["chi2"], max_trials=self.max_trials,
            pcg_iters=self.pcg_iters, pcg_tol=self.pcg_tol)
        new_state = {"params": params, "lam": lam, "ni": ni, "chi2": chi}
        info = {"chi2": float(chi), "lambda": float(lam),
                "levenberg_iters": int(trials), "ok": bool(accepted)}
        return new_state, info
