"""LM-PCG main path of the port against the JAX package, float64 on CPU.

* closed-form 3x3 (and 1x1, 2x2) Cholesky factors against JAX; a non-SPD
  block gives NaN (the LM retry signal);
* pcg_solve against JAX's on one Jacobi-scaled SPD system: equal iteration
  counts, x to rtol 1e-10 (same float64 recurrence; the matvec sums in
  another order);
* the LM-PCG chi2 trajectory against JAX on the 64-pose ring
  (__graft_entry__._make_ring_graph, rebuilt with the port's Graph) and on
  the 2000-pose serpentine, 5 iterations, warm and trial_per_iter both
  ways: rtol 1e-8 (rounding differences of ~1e-16 pass through at most
  5 x 60 CG iterations and the gain-ratio branches, which stay on the same
  side at this margin);
* the non-finite trial-chi2 retry of tests/test_nan_trial_retry.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__
from openslam_g2o_tpu.apps.simulator import (
    synthetic_pose_graph_2d as j_synthetic)
from openslam_g2o_tpu.core import algorithms as jalg
from openslam_g2o_tpu.core import solvers as jsolvers
from openslam_g2o_tpu.core.problem import robust_chi2 as j_robust_chi2
from openslam_g2o_tpu.core.sparse import build_ell_pattern as j_pattern

from openslam_g2o_torch.apps.simulator import (
    synthetic_pose_graph_2d as t_synthetic)
from openslam_g2o_torch.core import algorithms as talg
from openslam_g2o_torch.core import solvers as tsolvers
from openslam_g2o_torch.core import sparse as tsparse
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.interop import problem_arrays
from openslam_g2o_torch.kernels.damp_chol import damp_chol
from openslam_g2o_torch.kernels.jacobi_scale import jacobi_scale
from openslam_g2o_torch.utils import np_lie

torch.set_num_threads(1)

PCG_ITERS, PCG_TOL = 60, 1e-6


def make_ring_graph(n_poses=64, seed=0):
    """__graft_entry__._make_ring_graph built with the port's Graph."""
    rng = np.random.default_rng(seed)
    g = TGraph()
    gt, pose = [], np.zeros(3)
    step = np.array([1.0, 0.0, 2 * np.pi / n_poses])
    for _ in range(n_poses):
        gt.append(pose.copy())
        pose = np_lie.se2_compose(pose, step)
    info = np.diag([100.0, 100.0, 400.0])
    for i, p in enumerate(gt):
        noisy = p + (rng.normal(0, 0.05, 3) if i else 0.0)
        g.add_vertex(i, "se2", noisy, fixed=(i == 0))
    rel = lambda i, j: np_lie.se2_compose(np_lie.se2_inverse(gt[i]), gt[j])
    for i in range(n_poses - 1):
        g.add_edge("edge_se2", (i, i + 1), rel(i, i + 1), info)
    g.add_edge("edge_se2", (n_poses - 1, 0), rel(n_poses - 1, 0), info)
    for i in range(0, n_poses - n_poses // 4, n_poses // 4):
        g.add_edge("edge_se2", (i, i + n_poses // 4),
                   rel(i, i + n_poses // 4), info)
    return g


def _problems(kind):
    if kind == "ring64":
        jprob = __graft_entry__._make_ring_graph(64).compile(dtype=jnp.float64)
        tprob = make_ring_graph(64).compile(dtype=torch.float64, device="cpu")
    else:
        jprob, _ = j_synthetic(n_poses=2000, grid=20)
        tprob, _ = t_synthetic(n_poses=2000, grid=20, device="cpu")
    return jprob, tprob


@pytest.fixture(scope="module", params=["ring64", "serpentine2k"])
def problems(request):
    jprob, tprob = _problems(request.param)
    ja, ta = problem_arrays(jprob), problem_arrays(tprob)
    np.testing.assert_array_equal(ta["params"]["se2"], ja["params"]["se2"])
    np.testing.assert_array_equal(
        ta["edges"]["edge_se2"]["measurement"],
        ja["edges"]["edge_se2"]["measurement"])
    return jprob, tprob


# ---------------------------------------------------------------------------
# small-block Cholesky
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 2, 3])
def test_batched_chol_match_jax(D):
    rng = np.random.default_rng(D)
    M = rng.normal(size=(50, D, D))
    A = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(D)
    for tf, jf in ((tsolvers.batched_chol_inv_lower,
                    jsolvers.batched_chol_inv_lower),
                   (tsolvers.batched_chol_lower, jsolvers.batched_chol_lower)):
        np.testing.assert_allclose(tf(torch.as_tensor(A)).numpy(),
                                   np.asarray(jf(jnp.asarray(A))),
                                   rtol=1e-12, atol=1e-12)
    L = tsolvers.batched_chol_lower(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(L @ L.transpose(0, 2, 1), A, rtol=1e-12,
                               atol=1e-12)


def test_non_spd_block_gives_nan():
    A = torch.tensor([[[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                      [[4.0, 0.0, 0.0], [0.0, 4.0, 0.0], [0.0, 0.0, 4.0]]],
                     dtype=torch.float64)
    linv = tsolvers.batched_chol_inv_lower(A)
    assert torch.isnan(linv[0]).any()
    assert torch.isfinite(linv[1]).all()
    assert torch.isnan(tsolvers.batched_chol_lower(A)[0]).any()


# ---------------------------------------------------------------------------
# PCG
# ---------------------------------------------------------------------------

def _scaled_system():
    """Dense Jacobi-scaled damped system of the 64-ring at lambda0."""
    from tests.test_torch_assembly import ell_to_dense
    tprob = make_ring_graph(64).compile(dtype=torch.float64, device="cpu")
    alg = talg.LevenbergMarquardtPCG()
    state = alg.init(tprob)
    pattern = alg.pattern(tprob)
    pre = talg._pcg_precomp(tprob, pattern)
    linv, _, bhat, extra = damp_chol(pre["values"], tprob.free["se2"],
                                     pre["bT"]["se2"], state["lam"])
    S = jacobi_scale(pattern.nb, pre["values"], linv, extra)
    return ell_to_dense(pattern.nb, S), bhat.numpy()


def _run_both_pcg(S, b, **kw):
    N = b.shape[1]
    counts = {"jax": 0, "torch": 0}

    def bump():
        counts["jax"] += 1

    def jmv(xT):
        jax.debug.callback(bump)
        return {"v": (jnp.asarray(S) @ xT["v"].T.reshape(-1)).reshape(N, 3).T}

    def tmv(xT):
        counts["torch"] += 1
        return {"v": (torch.as_tensor(S) @ xT["v"].T.reshape(-1)).reshape(N, 3).T}

    jx, jok = jsolvers.pcg_solve(jmv, {"v": jnp.asarray(b)}, **kw)
    jax.block_until_ready(jx)
    jax.effects_barrier()
    tx, tok = tsolvers.pcg_solve(tmv, {"v": torch.as_tensor(b)}, **kw)
    return (np.asarray(jx["v"]), bool(jok)), (tx["v"].numpy(), bool(tok)), \
        counts


@pytest.mark.parametrize("max_iter,tol", [(200, 1e-8), (25, 1e-12), (7, 0.15)])
def test_pcg_solve_matches_jax(max_iter, tol):
    S, b = _scaled_system()
    (jx, jok), (tx, tok), counts = _run_both_pcg(
        S, b, max_iter=max_iter, tol=tol, unroll=2, norm="precond")
    assert counts["torch"] == counts["jax"] > 1
    assert tok == jok
    np.testing.assert_allclose(tx, jx, rtol=1e-10,
                               atol=1e-10 * np.abs(jx).max())


def test_pcg_solve_indefinite_fails_like_jax():
    S, b = _scaled_system()
    S = S.copy()
    S[5, 5] = -50.0                     # negative curvature direction
    (jx, jok), (tx, tok), _ = _run_both_pcg(S, b, max_iter=100, tol=1e-10,
                                            unroll=2, norm="precond")
    assert not jok and not tok
    assert not tx.any() and not jx.any()


# ---------------------------------------------------------------------------
# LM-PCG trajectories
# ---------------------------------------------------------------------------

def test_lambda_init_matches_jax(problems):
    jprob, tprob = problems
    jl = jalg._lambda_init_pcg(jprob, j_pattern(jprob), jprob.params,
                               jnp.asarray(1e-5, jnp.float64))
    tl = talg._lambda_init_pcg(tprob, tsparse.build_ell_pattern(tprob),
                               tprob.params,
                               torch.tensor(1e-5, dtype=torch.float64))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-12)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("trial_per_iter", [False, True],
                         ids=["step", "trial"])
def test_lm_pcg_trajectory_matches_jax(problems, warm, trial_per_iter):
    jprob, tprob = problems
    jpat = j_pattern(jprob)
    jlam = jalg._lambda_init_pcg(jprob, jpat, jprob.params,
                                 jnp.asarray(1e-5, jnp.float64))
    jout = jalg.lm_pcg_optimize_fused(
        jprob, jpat, jprob.params, jlam, jnp.asarray(2.0, jnp.float64),
        j_robust_chi2(jprob), n_iters=5, pcg_iters=PCG_ITERS,
        pcg_tol=PCG_TOL, warm=warm, trial_per_iter=trial_per_iter)
    alg = talg.LevenbergMarquardtPCG()
    state = alg.init(tprob)
    tout = talg.lm_pcg_optimize_fused(
        tprob, alg.pattern(tprob), state["params"], state["lam"],
        state["ni"], state["chi2"], n_iters=5, pcg_iters=PCG_ITERS,
        pcg_tol=PCG_TOL, warm=warm, trial_per_iter=trial_per_iter)
    jtraj = np.asarray(jout[4])
    np.testing.assert_allclose(tout[4].numpy(), jtraj, rtol=1e-8)
    assert jtraj[-1] < float(state["chi2"])
    np.testing.assert_allclose(float(tout[1]), float(jout[1]), rtol=1e-8)
    np.testing.assert_allclose(tout[0]["se2"].numpy(),
                               np.asarray(jout[0]["se2"]), rtol=1e-6,
                               atol=1e-8)


def test_optimize_matches_jax_on_ring():
    """The public entry point: optimize(prob, LevenbergMarquardtPCG())
    per-step stats (chi2, lambda, trials) against JAX's optimize."""
    jprob, tprob = _problems("ring64")
    _, jstats = jalg.optimize(jprob, jalg.LevenbergMarquardtPCG(
        pcg_iters=PCG_ITERS, pcg_tol=PCG_TOL), iterations=4)
    _, tstats = talg.optimize(tprob, talg.LevenbergMarquardtPCG(
        pcg_iters=PCG_ITERS, pcg_tol=PCG_TOL), iterations=4)
    assert len(tstats) == len(jstats)
    for t, j in zip(tstats, jstats):
        assert t["levenberg_iters"] == j["levenberg_iters"]
        assert t["ok"] == j["ok"]
        np.testing.assert_allclose([t["chi2"], t["lambda"]],
                                   [j["chi2"], j["lambda"]], rtol=1e-8)


def test_chebyshev_not_ported_raises():
    """pcg_cheby=3 once raised NotImplementedError; it now runs the
    Chebyshev-preconditioned solve and decreases chi2 (the trajectories are
    held against JAX in test_torch_chebyshev.py)."""
    tprob, _ = t_synthetic(n_poses=50, grid=5, device="cpu")
    chi0 = float(talg.robust_chi2(tprob))
    _, stats = talg.optimize(tprob, talg.LevenbergMarquardtPCG(pcg_cheby=3),
                             iterations=1)
    assert stats[0]["ok"] and np.isfinite(stats[0]["chi2"])
    assert stats[0]["chi2"] < chi0


# ---------------------------------------------------------------------------
# non-finite trial chi2 retry (tests/test_nan_trial_retry.py scenario)
# ---------------------------------------------------------------------------

def test_nonfinite_trial_chi2_is_retried(monkeypatch):
    """Vertex 1 starts at the origin and its edge asks for x = 2, so the
    undamped step has length 2 (initial chi2 4). A domain boundary at x = 1
    is emulated by making the trial chi2 NaN past it, as the log-domain
    edge of the JAX test does. The step must reject the non-finite trials,
    retry with larger lambda and accept a damped step inside the domain."""
    g = TGraph()
    g.add_vertex(0, "se2", [0.0, 0.0, 0.0], fixed=True)
    g.add_vertex(1, "se2", [0.0, 0.0, 0.0])
    g.add_edge("edge_se2", (0, 1), [2.0, 0.0, 0.0], np.eye(3))
    prob = g.compile(device="cpu")
    K7 = talg.kernels.retract_chi2
    real = K7.retract_chi2

    def domain_chi2(*args):
        cand, part_dot, part_chi = real(*args)
        return cand, part_dot, torch.where(
            cand[1, 0] < 1.0, part_chi,
            torch.full_like(part_chi, float("nan")))

    monkeypatch.setattr(K7, "retract_chi2", domain_chi2)
    out, stats = talg.optimize(prob, talg.LevenbergMarquardtPCG(
        pcg_iters=50, pcg_tol=1e-10), iterations=1)
    assert stats[-1]["ok"], stats
    assert stats[-1]["levenberg_iters"] > 1
    assert np.isfinite(stats[-1]["chi2"])
    assert stats[-1]["chi2"] < 4.0 - 1e-3
    assert float(out.params["se2"][1, 0]) < 1.0
