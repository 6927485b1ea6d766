"""The general Schur path of the port (core/ba.py, `LevenbergMarquardtSchur`,
K14) and its routing (core/factory.py `_SchurAuto`) against the JAX package,
float64 on the CPU (the kernels' plain versions).

Scenes (chip_smoke.py's scene functions, at small sizes; each is built
through either package's Graph API, or carried across with interop):
* "test_ba": the anchored inverse-depth scene of tests/test_ba.py (every
  point anchored at the fixed camera 0);
* "psi2uv": the BAL geometry as ternary EDGE_PROJECT_PSI2UV anchored at each
  point's first camera, only camera 0 fixed, so one edge per point has its
  two pose slots on one free camera;
* "p2mc_intrinsics": the BAL geometry as EDGE_PROJECT_P2MC_INTRINSICS, two
  pose groups (the shared intrinsics vertex, of degree E, then VERTEX_CAM);
* "round2_free": the P2MC_INTRINSICS scene of tests/test_round2_gaps.py
  with free cameras but the first and marginalized points;
* "all_types": tests/test_torch_sba_cam_types.py's graph: three pose groups,
  P2MC, P2MC_INTRINSICS, P2SC and PSI2UV on one landmark group with a fixed
  point, and the pose-pose EDGE_CAM and EDGE_SCALE;
* "bal": the binary synthetic BAL problem through the general path;
* "bal_camera": the 9-wide Snavely camera of models/bal.py, (Dp, dl) =
  (9, 3) (tests/test_torch_bal.py `bal_camera_jax_problem`: 10 cameras,
  120 points, T = 450, read from a BAL file by the JAX loader); its
  schur_solve case also runs the dense route at block width 9.

Tolerances, each relative to the largest entry of the JAX value:
* schur_build's Hpp, b_p, Hll, b_l and every W block: rtol 1e-12;
* schur_solve at lambda 1e-3, pcg 500 / tol 1e-12 (the form of
  tests/test_ba.py:84-103): dx against JAX and against the port's dense
  solve of the damped full system 1e-6, the JAX test's bound (CG stops on
  the residual, 1e-12 of |b|; on these scenes that leaves both packages up
  to 2.3e-7 of max |dx| from the dense solution), b_full and raw_diag
  1e-12;
* LevenbergMarquardtSchur: lambda init 1e-12, chi2 per iteration 1e-8
  while an iteration gains more than 1e-10 of chi2 (below that the sign of
  the gain ratio is rounding noise, as in tests/test_torch_ba_lm.py).

`_SchurAuto` picks the dual-ELL solver on BAL and on a P2SC stereo scene,
the general path on the anchored and intrinsics scenes, and, unlike the
JAX package, the general path on a binary graph with two pose groups
(ROADMAP.md queue 3, route difference).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scenes
from openslam_g2o_tpu.core import ba as jba
from openslam_g2o_tpu.core import ba_ell as jba_ell
from openslam_g2o_tpu.core import factory as jfactory
from openslam_g2o_tpu.core.algorithms import optimize as j_optimize
from openslam_g2o_tpu.core.graph import Graph as JGraph

from openslam_g2o_torch import kernels
from openslam_g2o_torch.core import ba as tba
from openslam_g2o_torch.core import ba_ell as tba_ell
from openslam_g2o_torch.core import factory as tfactory
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core.algorithms import optimize as t_optimize
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.core.solvers import solve_dense_cholesky
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import ba_coupling
from tests.test_torch_sba_cam_types import build_sba_cam_graph

torch.set_num_threads(1)

RTOL = 1e-12
RTOL_LM = 1e-8
GAIN_FLOOR = 1e-10
GEOMETRY = (10, 120)             # cameras, points of the small BAL scenes


def _geo():
    return scenes.bal_geometry(*GEOMETRY)


def _round2_free(Graph):
    """tests/test_round2_gaps.py:20-46 with the cameras free but the first
    (gauge), marginalized points and perturbed intrinsics."""
    rng = np.random.default_rng(7)
    intr_gt = np.array([500.0, 480.0, 320.0, 240.0, 0.1])
    g = Graph()
    g.add_vertex(100, "intrinsics", intr_gt + np.array([3.0, 3, 3, 3, 0]))
    pts = rng.uniform(-1.5, 1.5, size=(20, 3)) + np.array([0, 0, 6.0])
    cams = []
    for c in range(3):
        t = np.array([0.6 * c - 0.6, 0.1 * c, 0.0])
        cam = np.concatenate([t, [0.0, 0.0, 0.0, 1.0], intr_gt])
        cams.append(cam)
        g.add_vertex(c, "cam", cam + np.concatenate(
            [rng.normal(0, 0.02, 3), np.zeros(9)]) * (c > 0), fixed=(c == 0))
    for i, p in enumerate(pts):
        g.add_vertex(1000 + i, "sba_point_xyz", p + rng.normal(0, 0.05, 3),
                     marginalized=True)
    for c, cam in enumerate(cams):
        for i, p in enumerate(pts):
            pc = p - cam[:3]
            u = (intr_gt[0] * pc[0] + intr_gt[2] * pc[2]) / pc[2]
            v = (intr_gt[1] * pc[1] + intr_gt[3] * pc[2]) / pc[2]
            g.add_edge("edge_project_p2mc_intrinsics", (1000 + i, c, 100),
                       np.array([u, v]) + rng.normal(0, 0.5, 2), np.eye(2))
    return g


def _test_ba_scene(Graph):
    from tests.test_ba import TestAnchoredInverseDepth
    if Graph is not JGraph:
        raise ValueError("the tests/test_ba.py scene is built in JAX")
    g, _, _ = TestAnchoredInverseDepth()._scene()
    return g


SCENES = {
    "test_ba": _test_ba_scene,
    "psi2uv": lambda G: scenes.psi2uv_graph(G, _geo()),
    "p2mc_intrinsics": lambda G: scenes.p2mc_intrinsics_graph(G, _geo()),
    "round2_free": _round2_free,
    "all_types": build_sba_cam_graph,
}


def _pair(name):
    if name == "bal":
        from openslam_g2o_tpu.apps.simulator import synthetic_bal_problem
        jprob, _ = synthetic_bal_problem(*GEOMETRY, 8, dtype=jnp.float64)
    elif name == "bal_camera":
        from tests.test_torch_bal import bal_camera_jax_problem
        jprob = bal_camera_jax_problem()
    else:
        jprob = SCENES[name](JGraph).compile(dtype=jnp.float64)
    return jprob, problem_from_numpy(**problem_arrays(jprob), device="cpu")


_cache = {}


def pair(name):
    if name not in _cache:
        _cache[name] = _pair(name)
    return _cache[name]


def _close(t, j, rtol=RTOL):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=rtol * max(float(np.abs(j).max()), 1e-300))


def test_psi2uv_scene_has_edges_on_one_camera_twice():
    _, tprob = pair("psi2uv")
    ea = tprob.edges["edge_project_psi2uv"]
    same = ea.indices[1] == ea.indices[2]
    free = tprob.free["se3_expmap"][ea.indices[1].long()] > 0
    assert int((same & free).sum()) >= GEOMETRY[1] // 2
    _, tprob = pair("p2mc_intrinsics")
    pat = tba.build_schur_pattern(tprob)
    assert [(pg.name, pg.offset, pg.n_entries) for pg in pat.pose_groups] \
        == [("intrinsics", 0, GEOMETRY[1] * 8), ("cam", 4, GEOMETRY[1] * 8)]
    assert pat.pose_groups[0].rows.n_chunks \
        == -(-GEOMETRY[1] * 8 // ba_coupling.CHUNK)


@pytest.mark.parametrize("name", ["test_ba", "psi2uv", "p2mc_intrinsics",
                                  "round2_free", "all_types", "bal_camera"])
def test_schur_build_matches_jax(name):
    jprob, tprob = pair(name)
    js = jba.schur_build(jprob)
    ts = tba.schur_build(tprob)
    dl, L = js["dl"], js["L"]
    _close(ts["Hpp"], js["Hpp"])
    _close(ts["b_p"], js["b_p"])
    _close(ts["Hll"].view(dl, dl, L).permute(2, 0, 1), js["Hll"])
    _close(ts["b_l"].T, js["b_l"])
    pat = ts["pattern"]
    assert len(pat.cross) == len(js["cross"])
    for ce, je in zip(pat.cross, js["cross"], strict=True):
        assert ce.group == je["group"].name
        E, dp, _ = je["W"].shape
        w_pose = ts["W_pose"][ce.group][:, ce.pose_pos.long()]
        _close(w_pose.T.reshape(E, dp, dl), je["W"])
        w_lm = ts["W_lm"][ce.group].reshape(dp * dl, -1)[:, ce.lm_pos.long()]
        assert torch.equal(w_lm, w_pose)


def _dense_step(tprob, lam):
    H, b, _ = tproblem.build_dense_system(tprob)
    free_t, _ = tproblem.tangent_masks(tprob)
    dx, ok = solve_dense_cholesky(H + lam * torch.diag(free_t), b)
    return dx * free_t, b, ok


@pytest.mark.parametrize("name", ["test_ba", "psi2uv", "p2mc_intrinsics",
                                  "round2_free", "all_types", "bal_camera"])
def test_schur_solve_matches_jax_and_the_dense_solve(name):
    jprob, tprob = pair(name)
    lam = 1e-3
    jdx, jok, jb, jraw = jba.schur_solve(jprob, jba.schur_build(jprob),
                                         jnp.asarray(lam), pcg_iters=500,
                                         pcg_tol=1e-12)
    tdx, tok, tb, traw = tba.schur_solve(tprob, tba.schur_build(tprob), lam,
                                         pcg_iters=500, pcg_tol=1e-12)
    assert bool(jok) and bool(tok)
    _close(tdx, jdx, 1e-6)
    _close(tb, jb)
    _close(traw, jraw)
    ddx, db, dok = _dense_step(tprob, lam)
    assert bool(dok)
    _close(tb, db.numpy())
    _close(tdx, ddx.numpy(), 1e-6)


def _lm_pair(name, iters):
    jprob, tprob = pair(name)
    jalg, talg = jba.LevenbergMarquardtSchur(), tba.LevenbergMarquardtSchur()
    np.testing.assert_allclose(float(talg.init(tprob)["lam"]),
                               float(jalg.init(jprob)["lam"]), rtol=RTOL)
    _, jst = j_optimize(jprob, jalg, iterations=iters)
    kernels.reset_launch_counts()
    _, tst = t_optimize(tprob, talg, iterations=iters)
    assert not any(kernels.launch_counts().values())   # plain versions
    return [s["chi2"] for s in jst], [s["chi2"] for s in tst], tst


@pytest.mark.parametrize("name", ["psi2uv", "p2mc_intrinsics", "round2_free",
                                  "all_types", "bal", "bal_camera"])
def test_lm_schur_trajectory_matches_jax(name):
    jchi, tchi, tst = _lm_pair(name, 6)
    chi0 = float(tproblem.robust_chi2(pair(name)[1]))
    prev = chi0
    for j, t in zip(jchi, tchi, strict=True):
        if prev - j <= GAIN_FLOOR * prev:
            break
        np.testing.assert_allclose(t, j, rtol=RTOL_LM)
        prev = j
    assert tchi[-1] < chi0 and all(s["ok"] for s in tst[:2])
    assert np.all(np.diff([chi0] + tchi) <= 0)


def _route(alg):
    impl = getattr(alg, "impl", None) or getattr(alg, "_impl", None)
    return ("ell" if "ELL" in type(impl).__name__ else "general")


def _stereo_pair():
    jprob = scenes.stereo_sba_graph(JGraph).compile(dtype=jnp.float64)
    return jprob, problem_from_numpy(**problem_arrays(jprob), device="cpu")


def _two_groups_pair():
    geo = _geo()
    jprob = scenes.two_pose_group_graph(JGraph, geo).compile(
        dtype=jnp.float64)
    tprob = scenes.two_pose_group_graph(TGraph, geo).compile(device="cpu")
    return jprob, tprob


@pytest.mark.parametrize("name,want", [
    ("bal", "ell"), ("stereo_p2sc", "ell"), ("psi2uv", "general"),
    ("p2mc_intrinsics", "general"), ("all_types", "general")])
def test_schur_auto_routes_as_jax(name, want):
    jprob, tprob = _stereo_pair() if name == "stereo_p2sc" else pair(name)
    jalg, talg = jfactory._SchurAuto(), tfactory._SchurAuto()
    jalg.init(jprob)
    talg.init(tprob)
    assert _route(jalg) == _route(talg) == want


def test_schur_auto_routes_two_pose_groups_to_the_general_path():
    """The documented route difference: JAX's dual-ELL pattern takes a
    binary graph with two pose groups; the port's refuses it with
    NotImplementedError, which `_SchurAuto` catches, so the general path
    runs it. Both end at the same chi2."""
    jprob, tprob = _two_groups_pair()
    assert [g.name for g in tprob.static.vgroups] == [
        "se3_expmap", "cam", "sba_point_xyz"]
    jba_ell.build_ba_ell_pattern(jprob)                # JAX: ELL
    with pytest.raises(NotImplementedError, match="one pose vertex group"):
        tba_ell.build_ba_ell_pattern(tprob)
    jalg, talg = jfactory._SchurAuto(), tfactory._SchurAuto()
    _, jst = j_optimize(jprob, jalg, iterations=8)
    _, tst = t_optimize(tprob, talg, iterations=8)
    assert (_route(jalg), _route(talg)) == ("ell", "general")
    _, gst = j_optimize(jprob, jba.LevenbergMarquardtSchur(), iterations=8)
    np.testing.assert_allclose([s["chi2"] for s in tst][:3],
                               [s["chi2"] for s in gst][:3], rtol=RTOL_LM)
    np.testing.assert_allclose(tst[-1]["chi2"], jst[-1]["chi2"], rtol=1e-6)


def test_schur_auto_passes_the_properties_on():
    _, tprob = pair("psi2uv")
    alg = tfactory._SchurAuto(pcg_iters=17, pcg_tol=1e-5, tau=1e-4,
                              not_a_property=3)
    alg.init(tprob)
    assert isinstance(alg.impl, tba.LevenbergMarquardtSchur)
    assert (alg.impl.pcg_iters, alg.impl.tau) == (17, 1e-4)
    _, bal = pair("bal")
    alg = tfactory._SchurAuto(pcg_iters=17, pcg_tol=1e-5)
    alg.init(bal)
    assert isinstance(alg.impl, tba_ell.LevenbergMarquardtSchurELL)
    assert (alg.impl.pcg_iters, alg.impl.pcg_tol) == (17, 1e-5)


def test_pattern_refuses_what_jax_refuses():
    g = TGraph()
    g.add_parameter(0, "camera_parameters", [500.0, 0, 0, 0.1])
    g.add_vertex(0, "se3_expmap", [0, 0, 0, 0, 0, 0, 1.0], fixed=True)
    g.add_vertex(1, "se3_expmap", [0.1, 0, 0, 0, 0, 0, 1.0])
    g.add_vertex(2, "sba_point_xyz", [0, 0, 1.0], marginalized=True)
    g.add_vertex(3, "sba_point_xyz", [0, 0, 1.0], marginalized=True)
    g.add_edge("edge_project_psi2uv", (2, 0, 1), [0.0, 0.0], np.eye(2),
               param_ids=[0])
    tba.build_schur_pattern(g.compile(device="cpu"))
    g.add_vertex(4, "point_xy", [0.0, 1.0])
    with pytest.raises(ValueError, match="exactly one marginalized"):
        tba.build_schur_pattern(g.compile(device="cpu"))


@pytest.mark.parametrize("counts", [[0, 3, 0, 700, 256, 257, 1, 0],
                                    [80000], [0], []])
def test_pose_rows_cut_long_lists_into_chunks(counts):
    """Each chunk holds 1..CHUNK consecutive entries of one vertex, the
    chunks of a vertex tile its CSR list in order, a vertex without entries
    owns one empty chunk (so that `ba_wv` finishes its row), and a vertex of
    degree 80,000 (the shared intrinsics vertex of chip_smoke.py's scene)
    becomes ceil(80000 / CHUNK) chunks."""
    rng = np.random.default_rng(0)
    M = int(np.sum(counts))
    rows = ba_coupling.build_pose_rows(counts, rng.integers(0, 9, M),
                                       torch.device("cpu"))
    ptr, cp, rc = (t.numpy() for t in (rows.ptr, rows.chunk_ptr,
                                       rows.row_chunk))
    assert rows.n_rows == len(counts) and rows.n_entries == M
    assert cp[0] == 0 and cp[-1] == M
    for n, c in enumerate(counts):
        sizes = np.diff(cp[rc[n]:rc[n + 1] + 1])
        assert len(sizes) == max(-(-c // ba_coupling.CHUNK), 1)
        assert sizes.sum() == c and (sizes <= ba_coupling.CHUNK).all()
        assert (sizes >= 1).all() if c else sizes.tolist() == [0]
        assert cp[rc[n]] == ptr[n] and cp[rc[n + 1]] == ptr[n + 1]


def test_dense_pair_tables_cut_hub_lists_into_chunks():
    """K15's tables on the pose slots of the shared-intrinsics scene: the
    intrinsics block's list (every observation) and the camera-intrinsics
    lists are cut into chunks of 1..DENSE_CHUNK contributions of one
    destination that tile its list in order."""
    from openslam_g2o_torch.kernels import dense_assemble
    _, tprob = pair("p2mc_intrinsics")
    pat = tba.build_schur_pattern(tprob)
    egs = [next(e for e in tprob.static.egroups if e.key == k)
           for k, _ in pat.hpp_keys]
    dp = dense_assemble.build_dense_pattern(
        tprob, egroups=egs, total_dim=pat.pose_dim,
        slots=[ps for _, ps in pat.hpp_keys])
    longest = 0
    for tb in (tb for tables in dp.pairs for tb in tables):
        ptr, cp, dc = (t.numpy() for t in (tb.ptr, tb.chunk_ptr,
                                           tb.dest_chunk))
        assert cp[0] == 0 and cp[-1] == ptr[-1] and len(dc) == tb.n_dest + 1
        for d in range(tb.n_dest):
            n = ptr[d + 1] - ptr[d]
            sizes = np.diff(cp[dc[d]:dc[d + 1] + 1])
            assert len(sizes) == -(-n // dense_assemble.DENSE_CHUNK)
            assert cp[dc[d]] == ptr[d] and cp[dc[d + 1]] == ptr[d + 1]
            assert (sizes >= 1).all() \
                and (sizes <= dense_assemble.DENSE_CHUNK).all()
            longest = max(longest, n)
    assert longest == GEOMETRY[1] * 8      # the intrinsics block
