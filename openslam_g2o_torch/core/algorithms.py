"""Levenberg-Marquardt with matrix-free, block-Jacobi-scaled PCG.

Counterpart of openslam_g2o_tpu/core/algorithms.py:184-510 and :817-876.
The JAX package jits the trial loop into one device program; here the
loops are Python loops over eagerly launched device work, and every LM
quantity (lambda, nu, chi2, rho, the accept flag) stays a 0-dim tensor on
the device, updated with torch.where exactly as the JAX code does. The host
reads the device once per two CG iterations (the CG stop test) and, in the
while-loop step, once per LM trial (the retry test).

Semantics follow optimization_algorithm_levenberg.cpp:57-163: damping
adds lambda to the free diagonal and 1 to fixed slots; the gain ratio is
rho = (chi - chi_new) / (dx . (lambda dx + b) + 1e-3) with the UNSCALED b;
a failed solve or a non-finite trial chi2 pins rho to -1 and retries.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

import torch

from openslam_g2o_torch import kernels
from openslam_g2o_torch.core.problem import (
    Problem, apply_update_parts, robust_chi2)
from openslam_g2o_torch.core.solvers import (
    _tree_dot, make_chebyshev_precond, pcg_solve)
from openslam_g2o_torch.core.sparse import (
    EllOperator, EllPattern, assemble_ell, build_ell_pattern, diag_blocks,
    lane_block_mv)

__all__ = ["LevenbergMarquardtPCG", "lm_pcg_optimize_fused", "optimize",
           "TerminateCriterion"]

# Lower edge of the Chebyshev spectral bracket, as a fraction of the
# Gershgorin upper bound of the Jacobi-scaled system (algorithms.py:35-43).
# The scaled system has unit diagonal blocks, so its spectrum clusters near
# 1; lambda_min can sit far below lo, which only weakens the preconditioner
# (it stays SPD for any lo > 0).
_CHEBY_LO_FRAC = 0.02


def _pcg_precomp(work: Problem, pattern: EllPattern):
    """Per-linearization quantities of the LM-PCG trial: assembled values
    and the lane-major rhs (algorithms.py:184-204)."""
    values, bT = assemble_ell(work, pattern)
    return {"values": values, "bT": bT}


def _pcg_trial(work: Problem, pattern: EllPattern, pre, lam, dx0T,
               pcg_iters, pcg_tol, pcg_cheby):
    """One damped, Jacobi-scaled CG solve on the precomputed system
    (algorithms.py:207-253). Returns (dxT lane-major, ok)."""
    g = pattern.group
    # damping lam*free + (1 - free), L and L^-1 of the damped diagonal
    # blocks and Linv b; a non-SPD block gives NaN factors -> ok False ->
    # retry
    linv, lchol, bhat, extra = kernels.damp_chol.damp_chol(
        pre["values"], work.free[g], pre["bT"][g], lam)
    svals = kernels.jacobi_scale.jacobi_scale(pattern.nb, pre["values"],
                                              linv, extra)
    op = EllOperator(pattern, svals)
    x0hat = None
    if dx0T is not None:
        x0hat = lane_block_mv({g: lchol}, dx0T, transpose=True)  # L^T dx0
    # the system is already Jacobi-scaled, hence the preconditioned-norm
    # stop test
    if pcg_cheby > 1:
        # the Gershgorin row bound never underestimates lambda_max, so the
        # polynomial bracketed by it stays positive on the spectrum
        hi = kernels.chebyshev.gershgorin_bound(svals)
        pre_c = make_chebyshev_precond(op, hi * _CHEBY_LO_FRAC, hi, pcg_cheby)
        xhat, ok = pcg_solve(op, {g: bhat}, precond=pre_c,
                             max_iter=max(pcg_iters // pcg_cheby, 1),
                             tol=pcg_tol, unroll=1, norm="precond", x0=x0hat)
    else:
        # no preconditioner; the stop test is read every 2 iterations
        xhat, ok = pcg_solve(op, {g: bhat}, max_iter=pcg_iters, tol=pcg_tol,
                             unroll=2, norm="precond", x0=x0hat)
    return lane_block_mv({g: linv}, xhat, transpose=True), ok


def _trial_outcome(work: Problem, bT: dict, dxT: dict, ok, lam, ni,
                   chi_cur):
    """Candidate and LM bookkeeping of one trial (the body shared by
    algorithms.py:306-332 and :472-497): (cand, chi_new, rho, accept,
    lam_new, ni_new), all on the device."""
    cand = apply_update_parts(work, {k: v.T for k, v in dxT.items()})
    chi_new = robust_chi2(work, cand)
    # a non-finite trial chi2 behaves like a failed solve: rho is pinned
    # negative so the trial loop retries (a NaN rho would end it)
    solved = ok & torch.isfinite(chi_new)
    chi_new = torch.where(solved, chi_new, torch.full_like(chi_new, math.inf))
    scale = _tree_dot(dxT, {k: lam * d + bT[k] for k, d in dxT.items()}) + 1e-3
    rho = torch.where(solved, (chi_cur - chi_new) / scale,
                      torch.full_like(chi_new, -1.0))
    accept = (rho > 0) & torch.isfinite(chi_new)
    t = 2.0 * rho - 1.0
    alpha = 1.0 - t * t * t
    good = torch.clamp_min(torch.clamp_max(alpha, 2.0 / 3.0), 1.0 / 3.0)
    lam_new = torch.where(accept, lam * good, lam * ni)
    ni_new = torch.where(accept, torch.full_like(ni, 2.0), ni * 2.0)
    return cand, chi_new, rho, accept, lam_new, ni_new


def _select(accept, new: dict, old: dict) -> dict:
    return {k: torch.where(accept, new[k], old[k]) for k in new}


def _lm_pcg_step(prob: Problem, pattern: EllPattern, params: dict, lam, ni,
                 chi_cur, dx0T=None, max_trials: int = 10,
                 pcg_iters: int = 150, pcg_tol: float = 1e-8,
                 pcg_cheby: int = 0):
    """One LM iteration with its trial loop, solving H dx = b by the
    block-ELL PCG (algorithms.py:256-344). The first trial always runs;
    later ones only while the last was rejected (rho < 0) and fewer than
    max_trials ran. Returns (params, lam, ni, chi, trials, accepted, dxT)."""
    work = prob.with_params(params)
    pre = _pcg_precomp(work, pattern)
    best_params, best_chi = params, chi_cur
    best_dxT = {g.name: torch.zeros((g.tangent_dim, g.count), dtype=prob.dtype,
                                    device=prob.device)
                for g in prob.static.vgroups}
    trials = 0
    while True:
        dxT, ok = _pcg_trial(work, pattern, pre, lam, dx0T, pcg_iters,
                             pcg_tol, pcg_cheby)
        cand, chi_new, rho, accept, lam, ni = _trial_outcome(
            work, pre["bT"], dxT, ok, lam, ni, chi_cur)
        best_params = _select(accept, cand, best_params)
        best_dxT = _select(accept, dxT, best_dxT)
        best_chi = torch.where(accept, chi_new, best_chi)
        trials += 1
        if trials >= max_trials or not bool(((~accept) & (rho < 0)).item()):
            break
    return best_params, lam, ni, best_chi, trials, accept, best_dxT


def _lambda_init_pcg(prob: Problem, pattern: EllPattern, params: dict, tau):
    """lambda0 = tau * max |diag(H)| over free vertices
    (optimization_algorithm_levenberg.cpp:149-163; algorithms.py:347-358)."""
    values, _ = assemble_ell(prob.with_params(params), pattern)
    d = torch.diagonal(diag_blocks(pattern, values)[pattern.group],
                       dim1=1, dim2=2).abs()
    m = torch.clamp_min((d * prob.free[pattern.group][:, None]).max(), 0.0)
    return tau * m


class LevenbergMarquardtPCG:
    """LM + block-ELL matrix-free block-Jacobi PCG (`lm_var_pcg`). The ELL
    pattern is built on the host once per graph topology (the analogue of
    buildStructure's symbolic phase, block_solver.hpp:143-295)."""

    name = "lm_pcg"

    def __init__(self, initial_lambda: float = 0.0,
                 max_trials_after_failure: int = 10, tau: float = 1e-5,
                 pcg_iters: int = 150, pcg_tol: float = 1e-8,
                 pcg_cheby: int = 0):
        """pcg_tol is the inexact-Newton forcing tolerance (relative
        residual in the preconditioned norm). pcg_cheby > 1 preconditions
        CG with a Chebyshev polynomial of that degree: each outer iteration
        then runs pcg_cheby matvecs and the outer budget is pcg_iters //
        pcg_cheby."""
        self.initial_lambda = initial_lambda
        self.max_trials = max_trials_after_failure
        self.tau = tau
        self.pcg_iters = pcg_iters
        self.pcg_tol = pcg_tol
        self.pcg_cheby = pcg_cheby
        self._pattern = None
        self._pattern_for = None

    def pattern(self, prob: Problem) -> EllPattern:
        if self._pattern_for is not prob.static:
            self._pattern = build_ell_pattern(prob)
            self._pattern_for = prob.static
        return self._pattern

    def init(self, prob: Problem):
        pattern = self.pattern(prob)
        scalar = lambda v: torch.tensor(v, dtype=prob.dtype, device=prob.device)
        if self.initial_lambda > 0:
            lam = scalar(self.initial_lambda)
        else:
            lam = _lambda_init_pcg(prob, pattern, prob.params,
                                   scalar(self.tau))
        return {"params": prob.params, "lam": lam, "ni": scalar(2.0),
                "chi2": robust_chi2(prob)}

    def step(self, prob: Problem, state: dict):
        params, lam, ni, chi, trials, accepted, _ = _lm_pcg_step(
            prob, self.pattern(prob), state["params"], state["lam"],
            state["ni"], state["chi2"], max_trials=self.max_trials,
            pcg_iters=self.pcg_iters, pcg_tol=self.pcg_tol,
            pcg_cheby=self.pcg_cheby)
        new_state = {"params": params, "lam": lam, "ni": ni, "chi2": chi}
        info = {"chi2": float(chi), "lambda": float(lam),
                "levenberg_iters": int(trials), "ok": bool(accepted)}
        return new_state, info


def lm_pcg_optimize_fused(prob: Problem, pattern: EllPattern, params: dict,
                          lam, ni, chi, n_iters: int = 10,
                          max_trials: int = 10, pcg_iters: int = 75,
                          pcg_tol: float = 1e-8, warm: bool = False,
                          pcg_cheby: int = 0, trial_per_iter: bool = False):
    """Run n_iters LM-PCG iterations (algorithms.py:431-510; a Python loop
    in place of lax.scan).

    trial_per_iter=True runs ONE trial per iteration: a rejected trial
    leaves params unchanged and raises lambda, and the next iteration
    re-linearizes the same system (n_iters then counts trials).
    warm=True starts each PCG from the last accepted step. chi=None
    computes the initial chi2 first. Returns (params, lam, ni, chi,
    chi_trajectory [n_iters] tensor)."""
    if chi is None:
        chi = robust_chi2(prob.with_params(params))
    dxT = {g.name: torch.zeros((g.tangent_dim, g.count), dtype=prob.dtype,
                               device=prob.device)
           for g in prob.static.vgroups}
    traj = []
    for _ in range(n_iters):
        if trial_per_iter:
            work = prob.with_params(params)
            pre = _pcg_precomp(work, pattern)
            dxT_new, ok = _pcg_trial(work, pattern, pre, lam,
                                     dxT if warm else None, pcg_iters,
                                     pcg_tol, pcg_cheby)
            cand, chi_new, _, accept, lam, ni = _trial_outcome(
                work, pre["bT"], dxT_new, ok, lam, ni, chi)
            params = _select(accept, cand, params)
            dxT = _select(accept, dxT_new, dxT)
            chi = torch.where(accept, chi_new, chi)
        else:
            params, lam, ni, chi, _, _, dxT = _lm_pcg_step(
                prob, pattern, params, lam, ni, chi,
                dx0T=dxT if warm else None, max_trials=max_trials,
                pcg_iters=pcg_iters, pcg_tol=pcg_tol, pcg_cheby=pcg_cheby)
        traj.append(chi)
    return params, lam, ni, chi, torch.stack(traj)


@dataclass
class TerminateCriterion:
    """SparseOptimizerTerminateAction analogue
    (sparse_optimizer_terminate_action.cpp:21-45): stop when the relative
    chi2 gain drops below `gain_threshold`."""
    gain_threshold: float = 1e-6
    max_iterations: int = 0  # 0: use the optimize() budget only

    def should_stop(self, prev_chi, chi, iteration):
        if self.max_iterations and iteration >= self.max_iterations:
            return True
        if prev_chi is None:
            return False
        if chi == 0:
            return True
        gain = (prev_chi - chi) / chi
        return 0 <= gain < self.gain_threshold


def _synchronize(prob: Problem):
    if prob.device.type == "cuda":
        torch.cuda.synchronize(prob.device)


def optimize(prob: Problem, algorithm=None, iterations: int = 10,
             verbose: bool = False,
             terminate: Optional[TerminateCriterion] = None,
             pre_iteration=None, post_iteration=None):
    """Run the outer iteration loop (SparseOptimizer::optimize,
    sparse_optimizer.cpp:354-419; algorithms.py:836-876). The default
    algorithm is LevenbergMarquardtPCG, the only one ported so far.
    Returns (optimized Problem, one stats dict per iteration)."""
    algorithm = algorithm or LevenbergMarquardtPCG()
    state = algorithm.init(prob)
    stats = []
    prev_chi = None
    cum_time = 0.0
    for it in range(iterations):
        if pre_iteration is not None:
            pre_iteration(it, state)
        t0 = time.monotonic()
        state, info = algorithm.step(prob, state)
        _synchronize(prob)
        dt = time.monotonic() - t0
        cum_time += dt
        info.update({"iteration": it, "time": dt, "cum_time": cum_time})
        stats.append(info)
        if post_iteration is not None and post_iteration(it, state):
            break
        if verbose:
            extras = ""
            if "lambda" in info:
                extras = (f"\t lambda= {info['lambda']:.6g}\t levenbergIter= "
                          f"{info['levenberg_iters']}")
            print(f"iteration= {it}\t chi2= {info['chi2']:.6f}\t time= "
                  f"{dt:.5f}\t cumTime= {cum_time:.5f}{extras}")
        if terminate is not None and terminate.should_stop(
                prev_chi, info["chi2"], it):
            break
        prev_chi = info["chi2"]
    return prob.with_params(state["params"]), stats
