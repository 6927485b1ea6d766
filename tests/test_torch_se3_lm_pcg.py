"""The SE3 pose-graph paths of the port against the JAX package, float64 on
the CPU, from the same numpy inputs.

* LM-PCG on `create_sphere(n_laps=8, n_per_lap=25, radius=20, seed=1)` (200
  poses, 6x6 blocks): the chi2 trajectory of `lm_pcg_optimize_fused` for
  pcg_cheby 0 and 4, warm and trial_per_iter both ways, and the public
  `optimize(prob, LevenbergMarquardtPCG())`: rtol 1e-8 (rounding differences
  of ~1e-16 pass through at most 5 x 60 CG iterations and the gain-ratio
  branches, which stay on the same side at this margin);
* the dense route on a `Simulator3D` graph (poses, XYZ landmarks, the offset
  parameter): GN and LM trajectories to rtol 1e-7, lambda and trial counts
  only while an iteration still gains (at the plateau they are rounding
  noise);
* the LM retry after a non-SPD 6x6 diagonal block (NaN factor -> failed
  solve -> larger lambda) and after a non-finite trial chi2;
* the noise floor: the converged chi2 of a sphere drawn with the sigmas of
  its information matrix is 6E - 6(N - 1) to its statistical spread.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.apps import simulator as jsim
from openslam_g2o_tpu.core import algorithms as jalg
from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core.sparse import build_ell_pattern as j_pattern

from openslam_g2o_torch.apps import simulator as tsim
from openslam_g2o_torch.core import algorithms as talg
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core import sparse as tsparse
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import damp_chol as K3

torch.set_num_threads(2)

PCG_ITERS, PCG_TOL = 60, 1e-6
SPHERE = dict(n_laps=8, n_per_lap=25, radius=20.0, seed=1)


@pytest.fixture(scope="module")
def sphere():
    jprob = jsim.create_sphere(**SPHERE)[0].compile(dtype=jnp.float64)
    tprob = tsim.create_sphere(**SPHERE)[0].compile(dtype=torch.float64,
                                                    device="cpu")
    ja, ta = problem_arrays(jprob), problem_arrays(tprob)
    np.testing.assert_array_equal(ta["params"]["se3"], ja["params"]["se3"])
    np.testing.assert_array_equal(ta["edges"]["edge_se3"]["measurement"],
                                  ja["edges"]["edge_se3"]["measurement"])
    return jprob, tprob


@pytest.mark.parametrize("cheby", [0, 4], ids=["cg", "cheby4"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("trial_per_iter", [False, True],
                         ids=["step", "trial"])
def test_lm_pcg_trajectory_matches_jax(sphere, cheby, warm, trial_per_iter):
    jprob, tprob = sphere
    jpat = j_pattern(jprob)
    jlam = jalg._lambda_init_pcg(jprob, jpat, jprob.params,
                                 jnp.asarray(1e-5, jnp.float64))
    jout = jalg.lm_pcg_optimize_fused(
        jprob, jpat, jprob.params, jlam, jnp.asarray(2.0, jnp.float64),
        jproblem.robust_chi2(jprob), n_iters=5, pcg_iters=PCG_ITERS,
        pcg_tol=PCG_TOL, warm=warm, trial_per_iter=trial_per_iter,
        pcg_cheby=cheby)
    alg = talg.LevenbergMarquardtPCG(pcg_cheby=cheby)
    state = alg.init(tprob)
    np.testing.assert_allclose(float(state["lam"]), float(jlam), rtol=1e-10)
    tout = talg.lm_pcg_optimize_fused(
        tprob, alg.pattern(tprob), state["params"], state["lam"],
        state["ni"], state["chi2"], n_iters=5, pcg_iters=PCG_ITERS,
        pcg_tol=PCG_TOL, warm=warm, trial_per_iter=trial_per_iter,
        pcg_cheby=cheby)
    jtraj = np.asarray(jout[4])
    np.testing.assert_allclose(tout[4].numpy(), jtraj, rtol=1e-8)
    assert jtraj[-1] < 0.1 * float(state["chi2"])
    np.testing.assert_allclose(float(tout[1]), float(jout[1]), rtol=1e-8)
    np.testing.assert_allclose(tout[0]["se3"].numpy(),
                               np.asarray(jout[0]["se3"]), rtol=1e-6,
                               atol=1e-8)


def test_optimize_matches_jax_on_the_sphere(sphere):
    """`tests/test_simulator.py`'s own route: create_sphere ->
    LevenbergMarquardtPCG(pcg_iters=100) through optimize()."""
    jprob, tprob = sphere
    _, jstats = jalg.optimize(jprob, jalg.LevenbergMarquardtPCG(
        pcg_iters=100), iterations=4)
    _, tstats = talg.optimize(tprob, talg.LevenbergMarquardtPCG(
        pcg_iters=100), iterations=4)
    assert len(tstats) == len(jstats)
    for t, j in zip(tstats, jstats):
        assert t["levenberg_iters"] == j["levenberg_iters"]
        assert t["ok"] == j["ok"]
        np.testing.assert_allclose([t["chi2"], t["lambda"]],
                                   [j["chi2"], j["lambda"]], rtol=1e-8)


def test_float32_sphere_converges_like_float64(sphere):
    _, tprob = sphere
    prob32 = tsim.create_sphere(**SPHERE)[0].compile(dtype=torch.float32,
                                                     device="cpu")
    runs = []
    for prob in (tprob, prob32):
        _, stats = talg.optimize(prob, talg.LevenbergMarquardtPCG(
            pcg_iters=100), iterations=5)
        runs.append([s["chi2"] for s in stats])
    np.testing.assert_allclose(runs[1], runs[0], rtol=5e-3)


@pytest.mark.parametrize("kind", ["gn", "lm"])
def test_dense_route_on_simulator3d_matches_jax(kind):
    kw = dict(n_landmarks=40, seed=0)
    jprob = jsim.Simulator3D(**kw).simulate(40)[0].compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    assert [g.name for g in tprob.static.vgroups] == ["se3", "point_xyz"]
    if kind == "gn":
        _, jstats = jalg.optimize(jprob, jalg.GaussNewton(), iterations=6)
        _, tstats = talg.optimize(tprob, talg.GaussNewton(), iterations=6)
        assert [s["ok"] for s in tstats] == [s["ok"] for s in jstats]
    else:
        _, jstats = jalg.optimize(jprob, iterations=8)
        _, tstats = talg.optimize(tprob, iterations=8)
        jchi = [float(jproblem.robust_chi2(jprob))] + [s["chi2"]
                                                       for s in jstats]
        gains = [(a - b) / b for a, b in zip(jchi, jchi[1:])]
        live = next((i for i, g in enumerate(gains) if g <= 1e-10),
                    len(gains))
        assert live >= 3
        assert ([s["levenberg_iters"] for s in tstats[:live]]
                == [s["levenberg_iters"] for s in jstats[:live]])
        np.testing.assert_allclose([s["lambda"] for s in tstats[:live]],
                                   [s["lambda"] for s in jstats[:live]],
                                   rtol=1e-7)
        chi = [s["chi2"] for s in tstats]
        assert all(b <= a for a, b in zip(chi, chi[1:]))
    np.testing.assert_allclose([s["chi2"] for s in tstats],
                               [s["chi2"] for s in jstats], rtol=1e-7)
    assert tstats[-1]["chi2"] < 0.5 * float(tproblem.robust_chi2(tprob))


def test_non_spd_6x6_block_is_retried(sphere, monkeypatch):
    """The first trial sees diagonal block 5 with a negative pivot: its
    factor is NaN, the solve fails, lambda grows and the retry (on the true
    blocks) is accepted."""
    _, tprob = sphere
    real = K3.damp_chol
    calls = []

    def spoiled(values, free, b, lam):
        calls.append(float(lam))
        if len(calls) == 1:
            values = values.clone()
            values[0, 14, 5] = -1e9
        return real(values, free, b, lam)

    monkeypatch.setattr(K3, "damp_chol", spoiled)
    alg = talg.LevenbergMarquardtPCG(pcg_iters=PCG_ITERS, pcg_tol=PCG_TOL)
    state = alg.init(tprob)
    new_state, info = alg.step(tprob, state)
    assert info["levenberg_iters"] == 2 and info["ok"]
    assert calls[1] == pytest.approx(2.0 * calls[0])
    assert np.isfinite(info["chi2"])
    assert info["chi2"] < float(state["chi2"])
    monkeypatch.undo()
    _, clean = alg.step(tprob, state)
    assert clean["levenberg_iters"] == 1 and clean["chi2"] < info["chi2"] * 1.5


def test_nonfinite_se3_trial_chi2_is_retried(sphere, monkeypatch):
    _, tprob = sphere
    K7 = talg.kernels.retract_chi2
    real = K7.se3_edge_chi2
    seen = []

    def first_is_nan(*args):
        out = real(*args)
        seen.append(1)
        return out * float("nan") if len(seen) == 1 else out

    monkeypatch.setattr(K7, "se3_edge_chi2", first_is_nan)
    alg = talg.LevenbergMarquardtPCG(pcg_iters=PCG_ITERS, pcg_tol=PCG_TOL)
    state = alg.init(tprob)
    _, info = alg.step(tprob, state)
    assert info["levenberg_iters"] == 2 and info["ok"]
    assert np.isfinite(info["chi2"]) and info["chi2"] < float(state["chi2"])


def test_converged_sphere_sits_at_its_noise_floor():
    """Noise drawn with the information matrix's sigmas: the converged chi2
    is 6E - 6(N - 1) up to the spread sqrt(2 dof) of a chi2 variable."""
    g, _ = tsim.create_sphere(n_laps=10, n_per_lap=30, radius=8.0,
                              trans_noise=(0.03, 0.03, 0.03),
                              rot_noise=0.002, seed=4)
    prob = g.compile(device="cpu")
    _, stats = talg.optimize(prob, talg.LevenbergMarquardtPCG(
        pcg_iters=300, pcg_tol=1e-8), iterations=12)
    E, N = prob.static.egroups[0].count, prob.static.vgroups[0].count
    dof = 6.0 * E - 6.0 * (N - 1)
    assert abs(stats[-1]["chi2"] - dof) < 4.0 * np.sqrt(2.0 * dof)
    pattern = tsparse.build_ell_pattern(prob)
    assert (pattern.d, pattern.n, pattern.e_total) == (6, N, E)
