"""LM on the port's Schur BA solver against the JAX package, float64 on the
CPU (the kernels' plain versions).

* lambda init (tau max |diag H| over landmark and camera blocks and the
  pose-pose extra): rtol 1e-12; lambda per iteration to 1e-6 (it follows
  the gain ratio, which divides a chi2 difference);
* chi2, lambda and levenberg_iters per iteration of
  optimize(..., LevenbergMarquardtSchurELL()) (ba_ell_step per iteration)
  and the chi2 trajectory of ba_ell_optimize_fused with trial_per_iter True
  and False, on the dense and the implicit route (_DENSE_SCHUR_MAX_TP = -1
  in both packages), on the synthetic BAL problem, on the all-types
  scene (pose-pose edges, Huber, a fixed point, the stereo edge) and (the
  lambda init and optimize) on a BAL file of the 9-wide camera: rtol 1e-8
  for every iteration that still gains more than 1e-10 of chi2 (below that
  the sign of the gain ratio is rounding noise in either package; the
  iterative solves and two Cholesky implementations order sums
  differently);
* a Simulator2D and a Simulator3D landmark world (generic edge entry,
  (Dp, dl) = (3, 2) and (6, 3)) on both routes, likewise;
* a non-finite trial chi2 is a retry with a larger lambda, as in JAX;
* float32 past convergence: chi2 never rises, the parameters stay finite,
  nothing raises while lambda grows without bound.

The JAX steps are jitted afresh in every comparison, so that no trace of
the other route is reused.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.apps.simulator import (
    Simulator2D as JSim2D, Simulator3D as JSim3D,
    synthetic_bal_problem as j_bal)
from openslam_g2o_tpu.core import ba_ell as jba
from openslam_g2o_tpu.core import registry as jregistry
from openslam_g2o_tpu.core.algorithms import optimize as j_optimize
from openslam_g2o_tpu.core.graph import Graph as JGraph

from openslam_g2o_torch.apps.simulator import (
    Simulator2D as TSim2D, Simulator3D as TSim3D,
    synthetic_bal_problem as t_bal)
from openslam_g2o_torch.core import ba_ell as tba
from openslam_g2o_torch.core import registry as tregistry
from openslam_g2o_torch.core.algorithms import optimize as t_optimize
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from tests.test_torch_ba_types import build_ba_graph
from tests.test_torch_bal import bal_camera_jax_problem

torch.set_num_threads(1)

RTOL = 1e-8
RTOL_LAMBDA = 1e-6
GAIN_FLOOR = 1e-10
PCG = dict(pcg_iters=40, pcg_tol=1e-8)


def _fresh_jax(monkeypatch, implicit):
    """The implicit route in both packages if asked, and a JAX step jitted
    afresh: the JAX predicate is read while tracing, and jax.jit caches a
    trace by the function it wraps, so the step is wrapped in a new
    functools.partial that no earlier trace is keyed by."""
    if implicit:
        for mod in (jba, tba):
            monkeypatch.setattr(mod, "_DENSE_SCHUR_MAX_TP", -1)
    monkeypatch.setattr(jba, "_lm_ba_ell_step", jax.jit(
        functools.partial(jba._lm_ba_ell_step.__wrapped__),
        static_argnames=("max_trials", "pcg_iters", "pcg_tol", "peel")))


def _pair(kind):
    if kind == "bal":
        jprob, _ = j_bal(n_cams=24, n_points=400, dtype=jnp.float64)
    elif kind == "bal_camera":
        jprob = bal_camera_jax_problem()
    else:
        jprob = build_ba_graph(JGraph).compile(dtype=jnp.float64)
    return jprob, problem_from_numpy(**problem_arrays(jprob), device="cpu")


def _gaining(chis, chi0):
    prev = np.concatenate([[chi0], chis[:-1]])
    return (prev - chis) > GAIN_FLOOR * np.abs(chis)


def _compare_stats(jstats, tstats, chi0):
    jc = np.array([s["chi2"] for s in jstats])
    tc = np.array([s["chi2"] for s in tstats])
    keep = _gaining(jc, chi0)
    assert keep[:3].all(), jc
    np.testing.assert_allclose(tc[keep], jc[keep], rtol=RTOL)
    # lambda follows the gain ratio, a quotient of a chi2 difference, which
    # carries the solves' rounding one step further
    np.testing.assert_allclose([s["lambda"] for s in tstats],
                               [s["lambda"] for s in jstats], rtol=RTOL_LAMBDA)
    assert ([s["levenberg_iters"] for s, k in zip(tstats, keep) if k]
            == [s["levenberg_iters"] for s, k in zip(jstats, keep) if k])


@pytest.mark.parametrize("kind", ["bal", "scene", "bal_camera"])
def test_lambda_init_matches_jax(kind):
    jprob, tprob = _pair(kind)
    jst = jba.LevenbergMarquardtSchurELL().init(jprob)
    tst = tba.LevenbergMarquardtSchurELL().init(tprob)
    np.testing.assert_allclose(float(tst["lam"]), float(jst["lam"]),
                               rtol=1e-12)
    np.testing.assert_allclose(float(tst["chi2"]), float(jst["chi2"]),
                               rtol=1e-12)
    assert float(tst["ni"]) == 2.0


@pytest.mark.parametrize("kind", ["bal", "scene", "bal_camera"])
@pytest.mark.parametrize("route", ["dense", "implicit"])
def test_optimize_matches_jax(kind, route, monkeypatch):
    _fresh_jax(monkeypatch, route == "implicit")
    jprob, tprob = _pair(kind)
    pattern = tba.build_ba_ell_pattern(tprob)
    assert tba.dense_schur_ok(tprob, pattern) == (route == "dense")
    _, jstats = j_optimize(jprob, jba.LevenbergMarquardtSchurELL(**PCG),
                           iterations=6)
    _, tstats = t_optimize(tprob, tba.LevenbergMarquardtSchurELL(**PCG),
                           iterations=6)
    _compare_stats(jstats, tstats,
                   float(tba.LevenbergMarquardtSchurELL().init(tprob)["chi2"]))
    assert all(s["ok"] for s in tstats[:3])


@pytest.mark.parametrize("route", ["dense", "implicit"])
@pytest.mark.parametrize("trial_per_iter", [True, False])
def test_fused_matches_jax(route, trial_per_iter, monkeypatch):
    _fresh_jax(monkeypatch, route == "implicit")
    jprob, tprob = _pair("bal")
    ja, ta = jba.LevenbergMarquardtSchurELL(), tba.LevenbergMarquardtSchurELL()
    js, ts = ja.init(jprob), ta.init(tprob)
    fused = jax.jit(functools.partial(jba.ba_ell_optimize_fused.__wrapped__),
                    static_argnames=("n_iters", "max_trials", "pcg_iters",
                                     "pcg_tol", "peel", "trial_per_iter"))
    jout = fused(jprob, ja.pattern(jprob), js["params"], js["lam"], js["ni"],
                 js["chi2"], n_iters=5, trial_per_iter=trial_per_iter, **PCG)
    tout = tba.ba_ell_optimize_fused(
        tprob, ta.pattern(tprob), ts["params"], ts["lam"], ts["ni"],
        ts["chi2"], n_iters=5, trial_per_iter=trial_per_iter, **PCG)
    jc, tc = np.asarray(jout[4]), tout[4].numpy()
    keep = _gaining(jc, float(js["chi2"]))
    assert keep[:3].all()
    np.testing.assert_allclose(tc[keep], jc[keep], rtol=RTOL)
    np.testing.assert_allclose(float(tout[1]), float(jout[1]),
                               rtol=RTOL_LAMBDA)
    for k in jout[0]:
        np.testing.assert_allclose(tout[0][k].numpy(), np.asarray(jout[0][k]),
                                   rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("world", ["2d", "3d"])
@pytest.mark.parametrize("route", ["dense", "implicit"])
def test_slam_world_matches_jax(world, route, monkeypatch):
    """Landmark worlds through the generic edge entry and K15's pose-pose
    extra: each package's own generator (equal to the bit). The 2D chain's
    reduced system is so ill-conditioned that 40 CG iterations of either
    package end 1e-2 apart (CG's rounding there is not the port's); solved
    to 1e-12 they agree to 3e-13, so that world runs CG to convergence."""
    _fresh_jax(monkeypatch, route == "implicit")
    pcg = PCG if world == "3d" else dict(pcg_iters=2000, pcg_tol=1e-12)
    if world == "2d":
        jg, _ = JSim2D(n_landmarks=20, seed=0).simulate(40)
        tg, _ = TSim2D(n_landmarks=20, seed=0).simulate(40)
    else:
        jg, _ = JSim3D(n_landmarks=20, seed=0).simulate(20)
        tg, _ = TSim3D(n_landmarks=20, seed=0).simulate(20)
    jprob, tprob = jg.compile(dtype=jnp.float64), tg.compile(device="cpu")
    assert tba.dense_schur_ok(tprob, tba.build_ba_ell_pattern(tprob)) \
        == (route == "dense")
    _, jstats = j_optimize(jprob, jba.LevenbergMarquardtSchurELL(**pcg),
                           iterations=5)
    _, tstats = t_optimize(tprob, tba.LevenbergMarquardtSchurELL(**pcg),
                           iterations=5)
    _compare_stats(jstats, tstats,
                   float(tba.LevenbergMarquardtSchurELL().init(tprob)["chi2"]))


@pytest.mark.parametrize("world", ["2d", "3d"])
def test_landmark_world_implicit_route_ends_where_jax_does(world,
                                                           monkeypatch):
    """The default LevenbergMarquardtSchurELL() on the implicit route, on
    landmark worlds large enough that its 100 CG iterations truncate the
    steps (block-Jacobi blocks without the odometry of Hpp_extra, in both
    packages): after 10 iterations both packages end the same distance
    above the dense LM's chi2. Truncated CG amplifies the rounding of
    either package's sums, so their ends agree to 1e-2, and their margins
    over the dense LM to a tenth of the margin. Run with -s to print the
    margins."""
    _fresh_jax(monkeypatch, True)
    if world == "2d":
        kw = dict(world_size=20.0, n_landmarks=150, trans_noise=(0.02, 0.01),
                  rot_noise=0.002)
        jg, _ = JSim2D(**kw).simulate(300)
        tg, _ = TSim2D(**kw).simulate(300)
    else:
        kw = dict(world_size=16.0, n_landmarks=200,
                  trans_noise=(0.02,) * 3, rot_noise=0.002)
        jg, _ = JSim3D(**kw).simulate(250)
        tg, _ = TSim3D(**kw).simulate(250)
    jprob, tprob = jg.compile(dtype=jnp.float64), tg.compile(device="cpu")
    assert not tba.dense_schur_ok(tprob, tba.build_ba_ell_pattern(tprob))
    _, lm_stats = t_optimize(tprob, iterations=10)
    _, jstats = j_optimize(jprob, jba.LevenbergMarquardtSchurELL(),
                           iterations=10)
    _, tstats = t_optimize(tprob, tba.LevenbergMarquardtSchurELL(),
                           iterations=10)
    lm_end = lm_stats[-1]["chi2"]
    jend, tend = float(jstats[-1]["chi2"]), tstats[-1]["chi2"]
    jmargin, tmargin = (jend - lm_end) / lm_end, (tend - lm_end) / lm_end
    print(f"{world} world, Tp={tprob.static.pose_dim}: dense LM {lm_end:.6f}; "
          f"LevenbergMarquardtSchurELL() implicit route: JAX {jend:.6f} "
          f"(margin {100 * jmargin:+.4f}%), port {tend:.6f} "
          f"(margin {100 * tmargin:+.4f}%)")
    assert tend == pytest.approx(jend, rel=1e-2)
    assert abs(tmargin - jmargin) <= 0.1 * abs(jmargin)


def _log_domain(lib, stack, log):
    def error(vparams, meas, pdata):
        x, l = vparams
        return stack([log(1.0 - (l[..., 0] - x[..., 0])) - meas[..., 0],
                      l[..., 1] - x[..., 1]])
    return error


def _register_log_domain_edges():
    name = "edge_log_domain_schur_test"
    if name not in tregistry._EDGE_TYPES:
        for reg, error in (
                (tregistry, _log_domain(
                    torch, lambda v: torch.stack(v, dim=-1), torch.log)),
                (jregistry, _log_domain(jnp, jnp.stack, jnp.log))):
            reg.register_edge_type(reg.EdgeType(
                name=name, tag="EDGE_LOG_DOMAIN_SCHUR_TEST",
                vertex_types=("se2", "point_xy"), error_dim=2,
                measurement_dim=1, error=error))
    return name


def test_nonfinite_trial_chi2_is_retried(monkeypatch):
    """A fixed pose and one landmark at l0 = 0 with r = [log(1 - l0) + 2,
    l1]: the undamped step is dl0 = 2, past the l0 = 1 boundary where log
    goes NaN, so only a damped step is accepted and the trial loop must
    retry after the non-finite first trial."""
    _fresh_jax(monkeypatch, False)
    name = _register_log_domain_edges()
    runs = {}
    for label, Graph, opt, mod, kw in (
            ("jax", JGraph, j_optimize, jba, {"dtype": jnp.float64}),
            ("torch", TGraph, t_optimize, tba, {"device": "cpu"})):
        g = Graph()
        g.add_vertex(0, "se2", [0.0, 0.0, 0.0], fixed=True)
        g.add_vertex(1, "point_xy", [0.0, 0.0])
        g.add_edge(name, (0, 1), [-2.0], np.eye(2))
        out, stats = opt(g.compile(**kw), mod.LevenbergMarquardtSchurELL(),
                         iterations=3)
        runs[label] = (np.asarray(out.params["point_xy"])[0], stats)
    x, stats = runs["torch"]
    assert stats[0]["ok"] and stats[0]["levenberg_iters"] > 1
    assert np.isfinite(stats[0]["chi2"]) and stats[0]["chi2"] < 4.0 - 1e-3
    assert x[0] < 1.0
    jx, jstats = runs["jax"]
    assert ([s["levenberg_iters"] for s in stats]
            == [s["levenberg_iters"] for s in jstats])
    np.testing.assert_allclose([s["chi2"] for s in stats],
                               [s["chi2"] for s in jstats], rtol=1e-9)
    np.testing.assert_allclose(x, jx, rtol=1e-9)


@pytest.mark.parametrize("route", ["dense", "implicit"])
def test_float32_past_convergence_keeps_chi2_and_params(route, monkeypatch):
    """The float32 plateau: once no step gains, every trial is rejected and
    lambda grows to inf; chi2 must stay where it was and nothing raise."""
    if route == "implicit":
        monkeypatch.setattr(tba, "_DENSE_SCHUR_MAX_TP", -1)
    prob, _ = t_bal(n_cams=12, n_points=150, dtype=torch.float32,
                    device="cpu")
    alg = tba.LevenbergMarquardtSchurELL(pcg_iters=30, pcg_tol=0.05)
    st = alg.init(prob)
    out = tba.ba_ell_optimize_fused(
        prob, alg.pattern(prob), st["params"], st["lam"], st["ni"],
        st["chi2"], n_iters=60, pcg_iters=30, pcg_tol=0.05)
    traj = out[4].numpy()
    assert np.all(np.isfinite(traj))
    assert np.all(np.diff(np.concatenate([[float(st["chi2"])], traj])) <= 0)
    assert all(bool(torch.isfinite(v).all()) for v in out[0].values())
    assert float(out[1]) > 1e6 or float(out[1]) == float("inf")
    _, stats = t_optimize(prob.with_params(out[0]), alg, iterations=3)
    assert all(np.isfinite(s["chi2"]) for s in stats)
