"""The Chebyshev-preconditioned configuration (pcg_cheby > 1) of the port
against the JAX package, float64 on CPU.

* `make_chebyshev_precond` on a random SPD operator, degrees 2-5: rtol
  1e-12 (the same recurrence; the coefficient scalars and the axpys round
  alike, the matvec sums in another order);
* `gershgorin_bound` against JAX `hot_gershgorin_bound` on the same scaled
  values, and against lambda_max of the dense matrix;
* float64 chi2 trajectories of the while-loop step (`_lm_pcg_step` through
  `lm_pcg_optimize_fused`) and of `lm_pcg_optimize_fused(trial_per_iter=
  True, warm=True)` with pcg_cheby 3 and 4 on the 64-pose ring and the
  2000-pose serpentine, 5 iterations: rtol 1e-8, as
  tests/test_torch_lm_pcg.py holds pcg_cheby = 0.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.core import algorithms as jalg
from openslam_g2o_tpu.core import solvers as jsolvers
from openslam_g2o_tpu.core import sparse as jsparse
from openslam_g2o_tpu.core.problem import robust_chi2 as j_robust_chi2

from openslam_g2o_torch.core import algorithms as talg
from openslam_g2o_torch.core import solvers as tsolvers
from openslam_g2o_torch.core import sparse as tsparse
from openslam_g2o_torch.kernels import chebyshev
from openslam_g2o_torch.kernels.damp_chol import damp_chol
from openslam_g2o_torch.kernels.jacobi_scale import jacobi_scale
from tests.test_torch_assembly import ell_to_dense
from tests.test_torch_lm_pcg import PCG_ITERS, PCG_TOL, _problems

torch.set_num_threads(1)


def _spd(seed, n=3 * 25, lo=0.05, hi=4.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (Q * np.geomspace(lo, hi, n)) @ Q.T, rng.normal(size=(3, n // 3))


@pytest.mark.parametrize("degree", [2, 3, 4, 5])
def test_chebyshev_precond_matches_jax(degree):
    S, r = _spd(degree)
    lo, hi = 0.08, 4.4
    Sj, St = jnp.asarray(S), torch.as_tensor(S)
    jmv = lambda x: {"v": (Sj @ x["v"].reshape(-1)).reshape(3, -1)}
    tmv = lambda x: {"v": (St @ x["v"].reshape(-1)).reshape(3, -1)}
    jz = jsolvers.make_chebyshev_precond(jmv, lo, hi, degree)(
        {"v": jnp.asarray(r)})["v"]
    apply = tsolvers.make_chebyshev_precond(tmv, lo, hi, degree)
    rt = {"v": torch.as_tensor(r)}
    tz = apply(rt)["v"]
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jz)).max())
    np.testing.assert_array_equal(rt["v"].numpy(), r)   # r is not modified
    # device-scalar bounds give the same polynomial, and a second
    # application reuses the coefficients
    apply_t = tsolvers.make_chebyshev_precond(
        tmv, torch.tensor(lo, dtype=torch.float64),
        torch.tensor(hi, dtype=torch.float64), degree)
    assert torch.equal(apply_t(rt)["v"], tz)
    assert torch.equal(apply(rt)["v"], tz)
    # z = p(S) r approximates S^-1 r better than the scaled residual r/theta
    exact = np.linalg.solve(S, r.reshape(-1))
    err = lambda z: np.linalg.norm(z.reshape(-1) - exact)
    assert err(tz.numpy()) < err(r / ((hi + lo) / 2))


def test_chebyshev_coefficients_follow_saad():
    lo, hi, degree = 0.1, 3.0, 5
    coef = chebyshev.chebyshev_coeffs(torch.tensor(lo, dtype=torch.float64),
                                      torch.tensor(hi, dtype=torch.float64),
                                      degree).numpy()
    theta, delta = (hi + lo) / 2, (hi - lo) / 2
    sigma1 = theta / delta
    rho, want = 1.0 / sigma1, [theta]
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        want += [rho_new * rho, 2.0 * rho_new / delta]
        rho = rho_new
    assert coef.shape == (2 * degree - 1,)
    np.testing.assert_allclose(coef, want, rtol=1e-15)
    # a degenerate bracket keeps delta at its floor instead of dividing by 0
    flat = chebyshev.chebyshev_coeffs(torch.tensor(2.0, dtype=torch.float64),
                                      torch.tensor(2.0, dtype=torch.float64),
                                      2)
    assert torch.isfinite(flat).all()
    with pytest.raises(ValueError, match="0-dim"):
        chebyshev.chebyshev_coeffs(torch.tensor([lo]), torch.tensor([hi]), 3)


@pytest.fixture(scope="module", params=["ring64", "serpentine2k"])
def problems(request):
    return _problems(request.param)


def test_gershgorin_bound_matches_jax_and_dominates(problems):
    jprob, tprob = problems
    alg = talg.LevenbergMarquardtPCG()
    state = alg.init(tprob)
    pattern = alg.pattern(tprob)
    pre = talg._pcg_precomp(tprob, pattern)
    linv, _, _, extra = damp_chol(pre["values"], tprob.free["se2"],
                                  pre["bT"]["se2"], state["lam"])
    svals = jacobi_scale(pattern.nb, pre["values"], linv, extra)
    hi = float(chebyshev.gershgorin_bound(svals))
    # JAX's bound on the same numbers, handed over as one K-major table
    jpat = jsparse.build_ell_pattern(jprob)
    assert list(jpat.pairs) == [("se2", "se2")]
    hot = (("k", jnp.asarray(svals.permute(1, 0, 2).numpy()), None),)
    jhi = float(jsparse.hot_gershgorin_bound(jprob, jpat, hot))
    np.testing.assert_allclose(hi, jhi, rtol=1e-12)
    assert hi >= 1e-3
    if pattern.n <= 100:
        lam_max = np.linalg.eigvalsh(ell_to_dense(pattern.nb, svals)).max()
    else:                       # power iteration from a seeded start
        x = {"se2": torch.as_tensor(
            np.random.default_rng(0).normal(size=(3, pattern.n)))}
        for _ in range(200):
            y = tsparse.ell_matvec_lane(pattern, svals, x)["se2"]
            lam_max = float(torch.linalg.norm(y)
                            / torch.linalg.norm(x["se2"]))
            x = {"se2": y / torch.linalg.norm(y)}
    assert hi >= lam_max * (1 - 1e-12)
    assert hi < 20 * lam_max
    nan_vals = svals.clone()
    nan_vals[1, 4, 3] = float("nan")
    assert torch.isnan(chebyshev.gershgorin_bound(nan_vals))


@pytest.mark.parametrize("cheby", [3, 4])
@pytest.mark.parametrize("mode", ["step", "trial_warm"])
def test_chebyshev_lm_pcg_trajectory_matches_jax(problems, cheby, mode):
    jprob, tprob = problems
    kw = dict(n_iters=5, pcg_iters=PCG_ITERS, pcg_tol=PCG_TOL,
              pcg_cheby=cheby)
    if mode == "trial_warm":
        kw.update(trial_per_iter=True, warm=True)
    jpat = jsparse.build_ell_pattern(jprob)
    jlam = jalg._lambda_init_pcg(jprob, jpat, jprob.params,
                                 jnp.asarray(1e-5, jnp.float64))
    jout = jalg.lm_pcg_optimize_fused(
        jprob, jpat, jprob.params, jlam, jnp.asarray(2.0, jnp.float64),
        j_robust_chi2(jprob), **kw)
    alg = talg.LevenbergMarquardtPCG(pcg_cheby=cheby)
    state = alg.init(tprob)
    tout = talg.lm_pcg_optimize_fused(
        tprob, alg.pattern(tprob), state["params"], state["lam"],
        state["ni"], state["chi2"], **kw)
    jtraj = np.asarray(jout[4])
    np.testing.assert_allclose(tout[4].numpy(), jtraj, rtol=1e-8)
    assert jtraj[-1] < float(state["chi2"])
    np.testing.assert_allclose(float(tout[1]), float(jout[1]), rtol=1e-8)
    np.testing.assert_allclose(tout[0]["se2"].numpy(),
                               np.asarray(jout[0]["se2"]), rtol=1e-6,
                               atol=1e-8)


def test_optimize_with_chebyshev_matches_jax_on_ring():
    """The public entry point with pcg_cheby=4: per-step chi2, lambda and
    trial counts against JAX's optimize."""
    jprob, tprob = _problems("ring64")
    kw = dict(pcg_iters=PCG_ITERS, pcg_tol=PCG_TOL, pcg_cheby=4)
    _, jstats = jalg.optimize(jprob, jalg.LevenbergMarquardtPCG(**kw),
                              iterations=4)
    _, tstats = talg.optimize(tprob, talg.LevenbergMarquardtPCG(**kw),
                              iterations=4)
    assert len(tstats) == len(jstats)
    for t, j in zip(tstats, jstats):
        assert t["levenberg_iters"] == j["levenberg_iters"]
        assert t["ok"] == j["ok"]
        np.testing.assert_allclose([t["chi2"], t["lambda"]],
                                   [j["chi2"], j["lambda"]], rtol=1e-8)
