"""Outer iteration strategies: Gauss-Newton and Levenberg-Marquardt on the
dense normal equations, and Levenberg-Marquardt with matrix-free,
block-Jacobi-scaled PCG.

Counterpart of openslam_g2o_tpu/core/algorithms.py:50-177, :184-510 and
:817-876. The JAX package jits the trial loop into one device program
(lax.while_loop); here the loops are Python loops over eagerly launched
device work, and every LM quantity (lambda, nu, chi2, rho, the accept flag)
stays a 0-dim tensor on the device: one kernel computes a trial's
bookkeeping (kernels/retract_chi2.py `lm_outcome`). The host reads the
device once per LM trial (the retry flag) and, in the PCG solve, once per
two CG iterations (the CG stop test).

Semantics follow optimization_algorithm_levenberg.cpp:57-163: damping
adds lambda to the free diagonal and 1 to fixed slots; the gain ratio is
rho = (chi - chi_new) / (dx . (lambda dx + b) + 1e-3) with the UNSCALED b;
a failed solve or a non-finite trial chi2 pins rho to -1 and retries.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from openslam_g2o_torch import kernels
from openslam_g2o_torch.core.problem import (
    Problem, apply_update, build_dense_system, linearize, lm_trial_outcome,
    robust_chi2, tangent_masks, tangent_parts)
from openslam_g2o_torch.core.solvers import (
    make_chebyshev_precond, pcg_solve, solve_dense_cholesky)
from openslam_g2o_torch.core.sparse import (
    assemble_ell, build_ell_pattern, diag_blocks, lane_block_mv)

__all__ = ["GaussNewton", "LevenbergMarquardt", "LevenbergMarquardtPCG",
           "lm_pcg_optimize_fused", "optimize", "TerminateCriterion"]

# Lower edge of the Chebyshev spectral bracket, as a fraction of the
# Gershgorin upper bound of the Jacobi-scaled system (algorithms.py:35-43).
# The scaled system has unit diagonal blocks, so its spectrum clusters near
# 1; lambda_min can sit far below lo, which only weakens the preconditioner
# (it stays SPD for any lo > 0).
_CHEBY_LO_FRAC = 0.02


class _DensePatternCache:
    """The dense assembly's destination tables, built on the host once per
    graph topology and only where the kernel runs (on the card)."""

    _pattern = None
    _pattern_for = None

    def dense_pattern(self, prob: Problem):
        if prob.device.type != "cuda":
            return None
        if self._pattern_for is not prob.static:
            self._pattern = kernels.dense_assemble.build_dense_pattern(prob)
            self._pattern_for = prob.static
        return self._pattern


# ---------------------------------------------------------------------------
# Gauss-Newton
# ---------------------------------------------------------------------------

def _gn_step(prob: Problem, params: dict, pattern=None):
    """One GN iteration (optimization_algorithm_gauss_newton.cpp:50-90):
    linearize, solve H dx = b, retract."""
    work = prob.with_params(params)
    H, b, _ = build_dense_system(work, pattern=pattern)
    dx, ok = solve_dense_cholesky(H, b)
    new_params = apply_update(work, dx)
    return new_params, robust_chi2(work, new_params), ok


class GaussNewton(_DensePatternCache):
    """Stateless Gauss-Newton algorithm (init and step)."""

    name = "gn"

    def init(self, prob: Problem):
        return {"params": prob.params}

    def step(self, prob: Problem, state: dict):
        params, chi, ok = _gn_step(prob, state["params"],
                                   self.dense_pattern(prob))
        return {"params": params}, {"chi2": float(chi), "ok": bool(ok)}


# ---------------------------------------------------------------------------
# Levenberg-Marquardt on the dense system
# ---------------------------------------------------------------------------

def _select(accept, new: dict, old: dict) -> dict:
    return {k: torch.where(accept, new[k], old[k]) for k in new}


def _lm_step(prob: Problem, params: dict, lam, ni, chi_cur,
             max_trials: int = 10, pattern=None):
    """One LM outer iteration with its trial loop (algorithms.py:79-129;
    optimization_algorithm_levenberg.cpp:57-147). The first trial always
    runs; later ones only while the last was rejected with rho < 0 (a
    failed solve or a non-finite trial chi2 pins rho to -1) and fewer than
    max_trials ran. Damping adds lambda to the free slots' diagonal of a
    copy of H (the reference builds a dense lambda * diag(free) for it).
    Returns (params, lam, ni, chi, trials, accepted, raw_diag)."""
    work = prob.with_params(params)
    H, b, raw_diag = build_dense_system(work, lin=linearize(work),
                                        pattern=pattern)
    free_t, _ = tangent_masks(work)
    best_params, best_chi = params, chi_cur
    trials = 0
    while True:
        damped = H.clone()
        damped.diagonal().add_(lam * free_t)
        dx, ok = solve_dense_cholesky(damped, b)
        del damped
        cand, chi_new, accept, lam, ni, retry = lm_trial_outcome(
            work, tangent_parts(work, dx), tangent_parts(work, b), ok, lam,
            ni, chi_cur)
        best_params = _select(accept, cand, best_params)
        best_chi = torch.where(accept, chi_new, best_chi)
        trials += 1
        if trials >= max_trials or not bool(retry.item()):
            break
    return best_params, lam, ni, best_chi, trials, accept, raw_diag


def _lambda_init(prob: Problem, params: dict, tau, pattern=None):
    """tau * max |diag(H)| (optimization_algorithm_levenberg.cpp:149-163)."""
    _, _, raw_diag = build_dense_system(prob.with_params(params),
                                        pattern=pattern)
    return tau * raw_diag.abs().max()


class LevenbergMarquardt(_DensePatternCache):
    """Levenberg-Marquardt on the dense system. Properties mirror the
    reference's (initialLambda, maxTrialsAfterFailure,
    optimization_algorithm_levenberg.cpp:47-48)."""

    name = "lm"

    def __init__(self, initial_lambda: float = 0.0,
                 max_trials_after_failure: int = 10, tau: float = 1e-5):
        self.initial_lambda = initial_lambda
        self.max_trials = max_trials_after_failure
        self.tau = tau

    def init(self, prob: Problem):
        scalar = lambda v: torch.tensor(v, dtype=prob.dtype, device=prob.device)
        if self.initial_lambda > 0:
            lam = scalar(self.initial_lambda)
        else:
            lam = _lambda_init(prob, prob.params, scalar(self.tau),
                               self.dense_pattern(prob))
        return {"params": prob.params, "lam": lam, "ni": scalar(2.0),
                "chi2": robust_chi2(prob)}

    def step(self, prob: Problem, state: dict):
        params, lam, ni, chi, trials, accepted, _ = _lm_step(
            prob, state["params"], state["lam"], state["ni"], state["chi2"],
            max_trials=self.max_trials, pattern=self.dense_pattern(prob))
        new_state = {"params": params, "lam": lam, "ni": ni, "chi2": chi}
        info = {"chi2": float(chi), "lambda": float(lam),
                "levenberg_iters": int(trials), "ok": bool(accepted)}
        return new_state, info


# ---------------------------------------------------------------------------
# Levenberg-Marquardt with matrix-free PCG
# ---------------------------------------------------------------------------

def _pcg_precomp(work: Problem, pattern):
    """Per-linearization quantities of the LM-PCG trial: assembled values
    and the lane-major rhs (algorithms.py:184-204)."""
    values, bT = assemble_ell(work, pattern)
    return {"values": values, "bT": bT}


def _pcg_trial(work: Problem, pattern, pre, lam, dx0T, pcg_iters, pcg_tol,
               pcg_cheby):
    """One damped, Jacobi-scaled CG solve on the precomputed system
    (algorithms.py:207-253), the same on either pattern: K3 per vertex
    group, the pattern's scaling (K4, or K4' per pair table), CG on its
    operator (kernel A, or K5' per row group). Returns (dxT lane-major,
    ok)."""
    # damping lam*free + (1 - free), L and L^-1 of the damped diagonal
    # blocks and Linv b; a non-SPD block gives NaN factors -> ok False ->
    # retry
    linv, lchol, bhat, extra = {}, {}, {}, {}
    for g, v in pattern.diag_values(pre["values"]).items():
        linv[g], lchol[g], bhat[g], extra[g] = kernels.damp_chol.damp_chol(
            v, work.free[g], pre["bT"][g], lam)
    svals = pattern.scale(pre["values"], linv, extra)
    op = pattern.operator(svals)
    x0hat = None
    if dx0T is not None:
        x0hat = lane_block_mv(lchol, dx0T, transpose=True)      # L^T dx0
    # the system is already Jacobi-scaled, hence the preconditioned-norm
    # stop test
    if pcg_cheby > 1:
        # the Gershgorin row bound never underestimates lambda_max, so the
        # polynomial bracketed by it stays positive on the spectrum
        hi = pattern.row_bound(svals)
        pre_c = make_chebyshev_precond(op, hi * _CHEBY_LO_FRAC, hi, pcg_cheby)
        xhat, ok = pcg_solve(op, bhat, precond=pre_c,
                             max_iter=max(pcg_iters // pcg_cheby, 1),
                             tol=pcg_tol, unroll=1, norm="precond", x0=x0hat)
    else:
        # no preconditioner; the stop test is read every 2 iterations
        xhat, ok = pcg_solve(op, bhat, max_iter=pcg_iters, tol=pcg_tol,
                             unroll=2, norm="precond", x0=x0hat)
    return lane_block_mv(linv, xhat, transpose=True), ok


def _trial_outcome(work: Problem, pattern, bT: dict, dxT: dict,
                   ok, lam, ni, chi_cur):
    """Candidate and LM bookkeeping of one trial (the body shared by
    algorithms.py:306-332 and :472-497) on K7, as the pattern runs it
    (`trial_outcome`): (cand, chi_new, accept, lam_new, ni_new, retry),
    all on the device."""
    return pattern.trial_outcome(work, bT, dxT, ok, lam, ni, chi_cur)


def _lm_pcg_step(prob: Problem, pattern, params: dict, lam, ni,
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
        cand, chi_new, accept, lam, ni, retry = _trial_outcome(
            work, pattern, pre["bT"], dxT, ok, lam, ni, chi_cur)
        best_params = _select(accept, cand, best_params)
        best_dxT = _select(accept, dxT, best_dxT)
        best_chi = torch.where(accept, chi_new, best_chi)
        trials += 1
        if trials >= max_trials or not bool(retry.item()):
            break
    return best_params, lam, ni, best_chi, trials, accept, best_dxT


def _lambda_init_pcg(prob: Problem, pattern, params: dict, tau):
    """lambda0 = tau * max |diag(H)| over the free vertices of every group
    (optimization_algorithm_levenberg.cpp:149-163; algorithms.py:347-358)."""
    values, _ = assemble_ell(prob.with_params(params), pattern)
    m = None
    for g, blocks in diag_blocks(pattern, values).items():
        d = torch.diagonal(blocks, dim1=1, dim2=2).abs()
        if d.numel():
            mg = (d * prob.free[g][:, None]).max()
            m = mg if m is None else torch.maximum(m, mg)
    if m is None:
        return tau * 0.0
    return tau * torch.clamp_min(m, 0.0)


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

    def pattern(self, prob: Problem):
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


def lm_pcg_optimize_fused(prob: Problem, pattern, params: dict,
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
            cand, chi_new, accept, lam, ni, _ = _trial_outcome(
                work, pattern, pre["bT"], dxT_new, ok, lam, ni, chi)
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
    algorithm is the dense LevenbergMarquardt, as in the JAX package.
    Returns (optimized Problem, one stats dict per iteration)."""
    algorithm = algorithm or LevenbergMarquardt()
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
