"""The dense GN/LM route of the port against the JAX package, float64 on CPU.

Problems are built by the JAX package (Simulator2D worlds, the all-types
graph of test_torch_slam2d_types.py, an offset-sensor graph) and carried
across with interop.problem_from_numpy.

* build_dense_system H, b, raw_diag: rtol 1e-12 relative to the largest
  entry (the same per-edge products; one block's contributions are summed in
  another order than XLA's scatter), with and without fixed vertices,
  robust kernels and add_fixed_diag;
* the dense assembly's destination tables (the CUDA kernel's input), walked
  in numpy the way the kernel walks them, against the plain version;
* solve_dense_cholesky and batched_small_inv against JAX; a non-SPD matrix
  gives ok False and x = 0;
* GaussNewton 8 iterations and LevenbergMarquardt 10 iterations: chi2 per
  iteration to rtol 1e-7 (another LAPACK orders the factorization
  differently), lambda (rtol 1e-7) and levenberg_iters (equal) for every
  iteration that still gains more than 1e-10 of chi2: below that the gain
  ratio's sign, hence accept or retry, is rounding noise in either package;
* the non-finite trial chi2 of tests/test_nan_trial_retry.py for the dense
  LevenbergMarquardt, step by step against JAX;
* optimize() defaults to the dense LevenbergMarquardt, as JAX's does.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.apps.simulator import Simulator2D as JSimulator2D
from openslam_g2o_tpu.core import algorithms as jalg
from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core import registry as jregistry
from openslam_g2o_tpu.core import solvers as jsolvers
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.utils import np_lie

from openslam_g2o_torch.core import algorithms as talg
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core import registry as tregistry
from openslam_g2o_torch.core import solvers as tsolvers
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import dense_assemble as K15
from tests.test_torch_slam2d_types import build_all_types_graph

torch.set_num_threads(1)

RTOL_ASSEMBLY = 1e-12
RTOL_TRAJECTORY = 1e-7


def offset_sensor_graph(Graph, seed=4, n=25, n_lm=8):
    """Poses on an arc seen through two offset sensors: EDGE_SE2_OFFSET
    between consecutive poses (and a few closures), EDGE_SE2_POINTXY_OFFSET
    to landmarks."""
    rng = np.random.default_rng(seed)
    g = Graph()
    off_a, off_b = np.array([0.3, 0.1, 0.2]), np.array([-0.2, 0.05, -0.1])
    g.add_parameter(1, "se2_offset", off_a)
    g.add_parameter(2, "se2_offset", off_b)
    gt = [np.zeros(3)]
    for _ in range(n - 1):
        gt.append(np_lie.se2_compose(gt[-1], np.array([1.0, 0.0, 0.3])))
    lms = rng.uniform(-4, 6, size=(n_lm, 2))
    for i, p in enumerate(gt):
        g.add_vertex(i, "se2", p + (rng.normal(0, 0.08, 3) if i else 0.0),
                     fixed=i == 0)
    for k, l in enumerate(lms):
        g.add_vertex(500 + k, "point_xy", l + rng.normal(0, 0.2, 2))
    info3, info2 = np.diag([400.0, 400.0, 900.0]), np.diag([300.0, 300.0])
    rel = lambda a, b: np_lie.se2_compose(np_lie.se2_inverse(a), b)
    pairs = [(i, i + 1) for i in range(n - 1)] + [(0, 20), (3, 23), (5, 24)]
    for i, j in pairs:
        si = np_lie.se2_compose(gt[i], off_a)
        sj = np_lie.se2_compose(gt[j], off_b)
        g.add_edge("edge_se2_offset", (i, j),
                   rel(si, sj) + rng.normal(0, 0.02, 3), info3,
                   param_ids=(1, 2))
    for i in range(n):
        for k in (i % n_lm, (i + 3) % n_lm):
            sensor = np_lie.se2_compose(gt[i], off_b)
            local = np_lie.se2_apply(np_lie.se2_inverse(sensor), lms[k])
            g.add_edge("edge_se2_xy_offset", (i, 500 + k),
                       local + rng.normal(0, 0.03, 2), info2, param_ids=(2,))
    return g


def _jax_problem(kind):
    if kind == "landmark":
        g, _ = JSimulator2D(n_landmarks=20, seed=0).simulate(40)
    elif kind == "landmark_free":          # no fixed vertex, no robust kernel
        g, _ = JSimulator2D(n_landmarks=20, seed=1).simulate(30)
        g.vertices[0].fixed = False
    elif kind == "bearing":
        g, _ = JSimulator2D(n_landmarks=15, seed=2, world_size=12.0).simulate(
            60, bearing_only=True)
    elif kind == "offset":
        g = offset_sensor_graph(JGraph)
    elif kind == "all_types":
        g = build_all_types_graph(JGraph)
    elif kind == "shared_vertex":
        # slots 0 and 2 of a calibration edge on ONE vertex, and a pose pair
        # linked in both directions: the destination tables' flags 2 and 1
        g = build_all_types_graph(JGraph)
        info = np.diag([50.0, 60.0])
        g.add_edge("edge_se2_xy_calib", (3, 101, 3), [0.4, -0.2], info)
        g.add_edge("edge_se2_xy_calib", (50, 104, 50), [1.0, 0.3], info)
        g.add_edge("edge_se2", (4, 3), [-1.0, 0.1, -0.4], np.eye(3) * 70.0)
        g.add_edge("edge_se2", (9, 2), [0.3, 0.2, 0.1], np.eye(3) * 30.0)
    return g.compile(dtype=jnp.float64)


@pytest.fixture(scope="module")
def problems():
    cache = {}

    def get(kind):
        if kind not in cache:
            jprob = _jax_problem(kind)
            cache[kind] = (jprob, problem_from_numpy(
                **problem_arrays(jprob), device="cpu"))
        return cache[kind]
    return get


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("add_fixed_diag", [True, False])
@pytest.mark.parametrize("kind", ["landmark", "landmark_free", "all_types",
                                  "shared_vertex", "bearing", "offset"])
def test_build_dense_system_matches_jax(problems, kind, add_fixed_diag):
    jprob, tprob = problems(kind)
    jH, jb, jraw = jproblem.build_dense_system(
        jprob, add_fixed_diag=add_fixed_diag)
    tH, tb, traw = tproblem.build_dense_system(
        tprob, add_fixed_diag=add_fixed_diag)
    T = tprob.static.total_dim
    assert tH.shape == (T, T) and tb.shape == (T,) and traw.shape == (T,)
    _close(tH, jH, RTOL_ASSEMBLY)
    _close(tb, jb, RTOL_ASSEMBLY)
    _close(traw, jraw, RTOL_ASSEMBLY)
    fixed = tproblem.tangent_masks(tprob)[1].bool()
    if add_fixed_diag:
        assert (tH.diagonal()[fixed] == 1.0).all()
    else:
        assert (tH.diagonal()[fixed] == 0.0).all()
    assert (traw[fixed] == 0.0).all()


def _walk_tables(groups, pattern, total_dim, fixed_t, add_fixed_diag):
    """The CUDA kernel's algorithm in numpy: per edge group and slot pair,
    every destination reads its block, adds its contributors in table
    order under their flags, and writes the block and its mirror."""
    H = np.zeros((total_dim, total_dim))
    b = np.zeros(total_dim)
    for g, tables in zip(groups, pattern.pairs):
        w_omega = (g.rho1[:, None, None] * g.info).numpy()
        jacs = [j.numpy() for j in g.jacs]
        for tb in tables:
            ptr, edge, flag = (x.numpy() for x in (tb.ptr, tb.edge, tb.flag))
            ds, dt = jacs[tb.s].shape[2], jacs[tb.t].shape[2]
            for d in range(tb.n_dest):
                p, q = int(tb.dest_p[d]), int(tb.dest_q[d])
                acc = H[p:p + ds, q:q + dt].copy()
                for m in range(ptr[d], ptr[d + 1]):
                    e = edge[m]
                    jw = jacs[tb.s][e].T @ w_omega[e]
                    blk = jw @ jacs[tb.t][e]
                    acc += (blk if flag[m] == 0 else blk.T if flag[m] == 1
                            else blk + blk.T)
                    if tb.s == tb.t:
                        b[p:p + ds] -= jw @ g.resid[e].numpy()
                H[p:p + ds, q:q + dt] = acc
                if p != q:
                    H[q:q + dt, p:p + ds] = acc.T
    raw = H.diagonal().copy()
    if add_fixed_diag:
        H[np.diag_indices(total_dim)] += fixed_t.numpy()
    return H, b, raw


@pytest.mark.parametrize("kind", ["landmark", "shared_vertex", "offset"])
def test_destination_tables_give_the_plain_system(problems, kind):
    _, tprob = problems(kind)
    pattern = K15.build_dense_pattern(tprob)
    lin = tproblem.linearize(tprob)
    groups = [K15.EdgeBlocks(*lin[eg.key][:1], lin[eg.key][1], lin[eg.key][2],
                             tprob.edges[eg.key].information,
                             pattern.offsets[i])
              for i, eg in enumerate(tprob.static.egroups)]
    T = tprob.static.total_dim
    fixed_t = tproblem.tangent_masks(tprob)[1]
    H, b, raw = _walk_tables(groups, pattern, T, fixed_t, True)
    pH, pb, praw = K15.dense_assemble_plain(groups, T, fixed_t)
    _close(pH, H, RTOL_ASSEMBLY)
    _close(pb, b, RTOL_ASSEMBLY)
    _close(praw, raw, RTOL_ASSEMBLY)
    # mirrored writes: exactly symmetric outside the diagonal blocks (which
    # are at most 3 wide)
    i, j = np.indices(H.shape)
    np.testing.assert_array_equal(np.where(abs(i - j) >= 3, H - H.T, 0.0), 0.0)
    # every table is a partition of its group's edges, in edge order
    flags = set()
    for eg, tables in zip(tprob.static.egroups, pattern.pairs):
        k = eg.etype.num_vertices
        assert [(t.s, t.t) for t in tables] == [
            (s, t) for s in range(k) for t in range(s, k)]
        for tb in tables:
            ptr, edge = tb.ptr.numpy(), tb.edge.numpy()
            assert ptr[0] == 0 and ptr[-1] == eg.count == len(edge)
            assert sorted(edge) == list(range(eg.count))
            for d in range(tb.n_dest):
                assert list(edge[ptr[d]:ptr[d + 1]]) == sorted(
                    edge[ptr[d]:ptr[d + 1]])
            assert tb.ptr.dtype == torch.int32
            flags |= set(tb.flag.tolist())
    if kind == "shared_vertex":
        assert flags == {0, 1, 2}


def test_dense_assemble_wrapper_checks_arguments(problems):
    _, tprob = problems("landmark")
    lin = tproblem.linearize(tprob)
    eg = tprob.static.egroups[0]
    ea = tprob.edges[eg.key]
    resid, jacs, w = lin[eg.key]
    offs = K15.slot_offsets(tprob.static, eg, ea)
    T = tprob.static.total_dim
    fixed_t = tproblem.tangent_masks(tprob)[1]
    good = K15.EdgeBlocks(resid, jacs, w, ea.information, offs)
    K15.dense_assemble.launches = 0
    K15.dense_assemble([good], T, fixed_t)
    assert K15.dense_assemble.launches == 0          # CPU: the plain version
    with pytest.raises(ValueError, match="fixed_t"):
        K15.dense_assemble([good], T + 1, fixed_t)
    with pytest.raises(ValueError, match="int32"):
        K15.dense_assemble([K15.EdgeBlocks(
            resid, jacs, w, ea.information,
            tuple(o.long() for o in offs))], T, fixed_t)
    with pytest.raises(ValueError, match="rho1"):
        K15.dense_assemble([K15.EdgeBlocks(
            resid, jacs, w[:-1], ea.information, offs)], T, fixed_t)


def test_apply_update_matches_jax(problems):
    jprob, tprob = problems("all_types")
    dx = np.random.default_rng(0).normal(0, 2.0, tprob.static.total_dim)
    jout = jproblem.apply_update(jprob, jnp.asarray(dx))
    tout = tproblem.apply_update(tprob, torch.as_tensor(dx))
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_batched_small_inv_matches_jax(D):
    rng = np.random.default_rng(D)
    M = rng.normal(size=(40, D, D))
    A = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(D)
    got = tsolvers.batched_small_inv(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jsolvers.batched_small_inv(jnp.asarray(A))),
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got @ A, np.broadcast_to(np.eye(D), A.shape),
                               atol=1e-9)


def test_solve_dense_cholesky_matches_jax_and_flags_non_spd():
    rng = np.random.default_rng(1)
    M = rng.normal(size=(30, 30))
    A, b = M @ M.T + np.eye(30), rng.normal(size=30)
    x, ok = tsolvers.solve_dense_cholesky(torch.as_tensor(A),
                                          torch.as_tensor(b))
    jx, jok = jsolvers.solve_dense_cholesky(jnp.asarray(A), jnp.asarray(b))
    assert bool(ok) and bool(jok) and ok.dtype == torch.bool and ok.dim() == 0
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-9)
    bad = A.copy()
    bad[4, 4] = -5.0                                 # not SPD
    x, ok = tsolvers.solve_dense_cholesky(torch.as_tensor(bad),
                                          torch.as_tensor(b))
    jx, jok = jsolvers.solve_dense_cholesky(jnp.asarray(bad), jnp.asarray(b))
    assert not bool(ok) and not bool(jok)
    assert (x == 0).all() and (np.asarray(jx) == 0).all()
    x, ok = tsolvers.solve_dense_cholesky(
        torch.as_tensor(A), torch.as_tensor(b * np.nan))
    assert not bool(ok) and (x == 0).all()


def test_lambda_init_matches_jax(problems):
    jprob, tprob = problems("landmark")
    jl = jalg._lambda_init(jprob, jprob.params, jnp.asarray(1e-5))
    tl = talg._lambda_init(tprob, tprob.params, torch.tensor(1e-5,
                                                             dtype=torch.float64))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL_ASSEMBLY)


@pytest.mark.parametrize("kind", ["landmark", "offset"])
def test_gauss_newton_trajectory_matches_jax(problems, kind):
    jprob, tprob = problems(kind)
    _, jstats = jalg.optimize(jprob, jalg.GaussNewton(), iterations=8)
    _, tstats = talg.optimize(tprob, talg.GaussNewton(), iterations=8)
    assert [s["ok"] for s in tstats] == [s["ok"] for s in jstats]
    np.testing.assert_allclose([s["chi2"] for s in tstats],
                               [s["chi2"] for s in jstats],
                               rtol=RTOL_TRAJECTORY)
    assert tstats[-1]["chi2"] < float(tproblem.robust_chi2(tprob))


@pytest.mark.parametrize("kind", ["landmark", "bearing", "offset",
                                  "all_types"])
def test_levenberg_marquardt_trajectory_matches_jax(problems, kind):
    jprob, tprob = problems(kind)
    jout, jstats = jalg.optimize(jprob, jalg.LevenbergMarquardt(),
                                 iterations=10)
    tout, tstats = talg.optimize(tprob, talg.LevenbergMarquardt(),
                                 iterations=10)
    np.testing.assert_allclose([s["chi2"] for s in tstats],
                               [s["chi2"] for s in jstats],
                               rtol=RTOL_TRAJECTORY)
    chi = [s["chi2"] for s in tstats]
    assert all(b <= a for a, b in zip(chi, chi[1:]))
    jchi = [float(jproblem.robust_chi2(jprob))] + [s["chi2"] for s in jstats]
    gains = [(a - b) / b for a, b in zip(jchi, jchi[1:])]
    live = next((i for i, g in enumerate(gains) if g <= 1e-10), len(gains))
    assert live >= 4
    assert ([s["levenberg_iters"] for s in tstats[:live]]
            == [s["levenberg_iters"] for s in jstats[:live]])
    assert ([s["ok"] for s in tstats[:live]]
            == [s["ok"] for s in jstats[:live]])
    np.testing.assert_allclose([s["lambda"] for s in tstats[:live]],
                               [s["lambda"] for s in jstats[:live]],
                               rtol=RTOL_TRAJECTORY)
    for k in jout.params:
        np.testing.assert_allclose(tout.params[k].numpy(),
                                   np.asarray(jout.params[k]), rtol=1e-6,
                                   atol=1e-7)


def test_optimize_defaults_to_dense_levenberg_marquardt(problems):
    jprob, tprob = problems("landmark")
    _, default = talg.optimize(tprob, iterations=3)
    _, explicit = talg.optimize(tprob, talg.LevenbergMarquardt(),
                                iterations=3)
    _, jdefault = jalg.optimize(jprob, iterations=3)
    assert [s["chi2"] for s in default] == [s["chi2"] for s in explicit]
    assert all("lambda" in s and "levenberg_iters" in s for s in default)
    np.testing.assert_allclose([s["chi2"] for s in default],
                               [s["chi2"] for s in jdefault],
                               rtol=RTOL_TRAJECTORY)


def test_terminate_criterion_and_callbacks_on_the_dense_route(problems):
    _, tprob = problems("landmark")
    seen = []
    _, stats = talg.optimize(
        tprob, iterations=30, terminate=talg.TerminateCriterion(1e-6),
        pre_iteration=lambda it, st: seen.append(it))
    assert 2 < len(stats) < 30 and seen == list(range(len(stats)))


# ---------------------------------------------------------------------------
# non-finite trial chi2 (tests/test_nan_trial_retry.py scenario)
# ---------------------------------------------------------------------------

def _log_domain_error_jax(vparams, meas, pdata):
    (x,) = vparams
    return jnp.stack([jnp.log(1.0 - x[0]) - meas[0], x[1]])


def _log_domain_error_torch(vparams, meas, pdata):
    (x,) = vparams
    return torch.stack([torch.log(1.0 - x[..., 0]) - meas[..., 0], x[..., 1]],
                       dim=-1)


def _register_log_domain_edges():
    name = "edge_log_domain_torch_test"
    if name not in tregistry._EDGE_TYPES:
        tregistry.register_edge_type(tregistry.EdgeType(
            name=name, tag="EDGE_LOG_DOMAIN_TORCH_TEST",
            vertex_types=("point_xy",), error_dim=2, measurement_dim=1,
            error=_log_domain_error_torch))
        jregistry.register_edge_type(jregistry.EdgeType(
            name=name, tag="EDGE_LOG_DOMAIN_TORCH_TEST",
            vertex_types=("point_xy",), error_dim=2, measurement_dim=1,
            error=_log_domain_error_jax))
    return name


def test_nonfinite_trial_chi2_is_retried_dense_lm():
    """At x0 = 0 the undamped step is dx0 = 2, past the x0 = 1 boundary
    where log goes NaN: only a damped step can be accepted, so the trial
    loop must retry after the non-finite first trial."""
    name = _register_log_domain_edges()
    runs = {}
    for label, Graph, mod, kw in (("jax", JGraph, jalg, {"dtype": jnp.float64}),
                                  ("torch", TGraph, talg, {"device": "cpu"})):
        g = Graph()
        g.add_vertex(0, "point_xy", [0.0, 0.0])
        g.add_edge(name, (0,), [-2.0], np.eye(2))
        out, stats = mod.optimize(g.compile(**kw), mod.LevenbergMarquardt(),
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
    np.testing.assert_allclose([s["lambda"] for s in stats],
                               [s["lambda"] for s in jstats], rtol=1e-9)
    np.testing.assert_allclose(x, jx, rtol=1e-9)
