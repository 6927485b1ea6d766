"""models/bal.py of the port (the 9-wide Snavely camera of BAL, its
projection edge and the BAL text format) against the JAX package, float64
on the CPU, where every wrapper runs its plain version.

* `snavely_project` on tests/test_bal.py's six-camera scene (every camera
  at omega = 0) and on cameras at omega = 0 with distortion, at theta^2 =
  1.13e-12 (just above so3_exp's Taylor branch) and turned: rtol 1e-12;
* the edge error and the plain Jacobians (torch.func.jvp through
  so3_exp's branches) against JAX's `linearize` (jacfwd) on that scene
  with those cameras: rtol 1e-12 with an absolute floor of 1e-12 of the
  largest entry (tests/test_torch_edge_lin.py's floor);
* `load_bal_problem` on one file: the same arrays, groups, offsets and
  meta in both packages; `save_bal_problem`: the same bytes, float64 and
  float32;
* a .g2o string with VERTEX_CAMERA_BAL / EDGE_PROJECT_BAL lines parsed
  alike (models/bal.py is imported by the package, so the tags register);
* `_SchurAuto` picks the dual-ELL solver for a BAL graph in both packages;
* the dense route at block width 9 (K15's plain version): build_dense_system
  on the file against JAX's, H, b and raw_diag at rtol 1e-12 of the largest
  entry, with and without the unit diagonal of the fixed camera 0; K15's
  destination tables with the rectangular 3 x 9 point-camera pair (and the
  general path's camera-slot table) walked as the kernel walks them,
  against the plain version; the dense LevenbergMarquardt (10 iterations)
  and GaussNewton (5) on `bal_camera_graph` with cameras 0 and 2 fixed
  (one fixed camera leaves BAL's scale free: H is singular and the two
  packages' Cholesky factorizations disagree on failing), chi2 per
  iteration rtol 1e-7 while it gains more than 1e-10 (the dense route
  tests' precedent);
* what no kernel serves is refused: a (Dp, dl) pair outside the dual-ELL
  and the general path's instantiations, and a 3-wide residual at (9, 3)
  on the general path (K14's tile would stage more than a static shared
  array takes);
* the slice as a whole: test_bal.py's file through
  LevenbergMarquardtSchurELL(pcg_iters=100) and through the general path's
  LevenbergMarquardtSchur() against JAX's chi2 trajectories (rtol 1e-8
  while an iteration gains more than 1e-10 of chi2, the Schur LM tests'
  precedent), the first then saved and read back with the final chi2.

`bal_camera_jax_problem` (chip_smoke.py's phase-4p scene at a small size,
read by the JAX package's loader) serves tests/test_torch_ba_kernels.py
and tests/test_torch_ba_lm.py as their "bal_camera" problem.
"""
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scenes
from openslam_g2o_tpu.core import algorithms as jalg
from openslam_g2o_tpu.core import ba as jba
from openslam_g2o_tpu.core import ba_ell as jba_ell
from openslam_g2o_tpu.core import factory as jfactory
from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.io import g2o_format as jio
from openslam_g2o_tpu.models import bal as jbal
from tests.test_bal import make_bal_file

import openslam_g2o_torch
from openslam_g2o_torch.core import algorithms as talg
from openslam_g2o_torch.core import ba as tba
from openslam_g2o_torch.core import ba_ell as tba_ell
from openslam_g2o_torch.core import factory as tfactory
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core import registry
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import dense_assemble as K15
from openslam_g2o_torch.kernels import schur_general
from openslam_g2o_torch.models import bal as tbal
from tests.test_torch_dense_route import _walk_tables

torch.set_num_threads(1)

RTOL = 1e-12
RTOL_SCHUR = 1e-8
RTOL_DENSE = 1e-7
GAIN_FLOOR = 1e-10


@functools.lru_cache(maxsize=None)
def bal_camera_jax_problem(n_cams=10, n_points=120):
    """The JAX package's Problem of chip_smoke.py's BAL camera scene
    (`bal_camera_scene`, phase 4p's) at a small size, read from its BAL
    file by the JAX loader (float64)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scene.bal")
        scenes.bal_camera_scene(path, n_cams, n_points)
        jprob, _ = jbal.load_bal_problem(path)
    return jprob


def _special_cameras(rng, n):
    """Cameras at omega = 0 with distortion, at theta^2 = 1.13e-12, and n
    turned by up to 0.3 rad, at z = 8 over the origin."""
    cams = np.zeros((n + 2, 9))
    cams[1, :3] = (8e-7, 7e-7, 0.0)
    cams[2:, :3] = rng.uniform(-0.3, 0.3, (n, 3))
    cams[:, 3:6] = rng.uniform(-0.5, 0.5, (n + 2, 3)) + [0.0, 0.0, 8.0]
    cams[:, 6] = rng.uniform(700, 900, n + 2)
    cams[:, 7] = rng.uniform(-0.1, 0.1, n + 2)
    cams[:, 8] = rng.uniform(-0.02, 0.02, n + 2)
    return cams


def _bal_file(path, seed=4):
    """tests/test_bal.py's file (six cameras at omega = 0, no distortion),
    with the special cameras appended to its camera list (cameras 6 and
    up, started at their truth; each observes every true point with pixel
    noise 0.5)."""
    truth = make_bal_file(path)
    with open(path) as f:
        data = np.array(f.read().split(), dtype=np.float64)
    C, P, E = (int(v) for v in data[:3])
    obs = data[3:3 + 4 * E].reshape(E, 4)
    cams = data[3 + 4 * E:3 + 4 * E + 9 * C].reshape(C, 9)
    pts = data[3 + 4 * E + 9 * C:].reshape(P, 3)
    rng = np.random.default_rng(seed)
    extra = _special_cameras(rng, 4)
    with torch.no_grad():
        uv = tbal.snavely_project(torch.as_tensor(extra)[:, None],
                                  torch.as_tensor(truth)[None]).numpy()
    uv = uv + rng.normal(0, 0.5, uv.shape)
    rows = [(int(c), int(p), u, v) for c, p, u, v in obs]
    rows += [(C + i, j, uv[i, j, 0], uv[i, j, 1])
             for i in range(len(extra)) for j in range(P)]
    cams = np.concatenate([cams, extra])
    with open(path, "w") as f:
        f.write(f"{len(cams)} {P} {len(rows)}\n")
        for c, p, u, v in rows:
            f.write(f"{c} {p} {float(u)!r} {float(v)!r}\n")
        for v in cams.reshape(-1):
            f.write(f"{float(v)!r}\n")
        for v in pts.reshape(-1):
            f.write(f"{float(v)!r}\n")
    return path


@pytest.fixture(scope="module")
def bal_path(tmp_path_factory):
    return _bal_file(str(tmp_path_factory.mktemp("bal") / "scene.bal"))


@pytest.fixture(scope="module")
def pair(bal_path):
    jprob, jmeta = jbal.load_bal_problem(bal_path)
    tprob, tmeta = tbal.load_bal_problem(bal_path, device="cpu")
    assert jmeta == tmeta
    return jprob, tprob


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=RTOL,
                               atol=1e-12 * max(float(np.abs(j).max()), 1.0))


def test_snavely_project_matches_jax(bal_path):
    jprob, _ = jbal.load_bal_problem(bal_path)
    cams = np.asarray(jprob.params["bal_camera"])
    pts = np.asarray(jprob.params["sba_point_xyz"])
    assert (cams[:6, :3] == 0).all() and (cams[6, :3] == 0).all()
    assert 1e-12 < float((cams[7, :3] ** 2).sum()) < 1.2e-12
    want = jax.vmap(jax.vmap(jbal.snavely_project, (None, 0)), (0, None))(
        jnp.asarray(cams), jnp.asarray(pts))
    got = tbal.snavely_project(torch.tensor(cams)[:, None],
                               torch.tensor(pts)[None])
    assert got.shape == (len(cams), len(pts), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_edge_error_and_plain_jacobian_match_jax(pair):
    """The residual, both slots' Jacobians (point, then the 9-wide camera;
    camera 0's columns zeroed) and rho' of `linearize` against JAX's."""
    jprob, tprob = pair
    jr, jjacs, jw = jproblem.linearize(jprob)["edge_project_bal"]
    tr, tjacs, tw = tproblem.linearize(tprob)["edge_project_bal"]
    _close(tr, jr)
    _close(tw, jw)
    assert [tuple(j.shape[1:]) for j in tjacs] == [(2, 3), (2, 9)]
    for tj, jj in zip(tjacs, jjacs):
        _close(tj, jj)
    cam0 = tprob.edges["edge_project_bal"].indices[1] == 0
    assert cam0.any() and (tjacs[1][cam0] == 0).all()


def test_load_bal_problem_matches_jax(pair):
    jprob, tprob = pair
    ja, ta = problem_arrays(jprob), problem_arrays(tprob)
    for part in ("params", "free"):
        assert list(ja[part]) == list(ta[part]) == ["bal_camera",
                                                    "sba_point_xyz"]
        for k in ja[part]:
            np.testing.assert_array_equal(ta[part][k], ja[part][k])
    (jk, je), = ja["edges"].items()
    (tk, te), = ta["edges"].items()
    assert jk == tk == "edge_project_bal"
    for name in ("measurement", "information", "delta"):
        np.testing.assert_array_equal(te[name], je[name])
    for ti, ji in zip(te["indices"], je["indices"]):
        np.testing.assert_array_equal(ti, ji)
    assert te["kernel_id"] == je["kernel_id"] and te["pdata"] == ()
    assert [(g.name, g.count, g.offset) for g in tprob.static.vgroups] \
        == [(g.name, g.count, g.offset) for g in jprob.static.vgroups]
    assert (tprob.static.total_dim, tprob.static.pose_dim) \
        == (jprob.static.total_dim, jprob.static.pose_dim)
    assert float(tprob.free["bal_camera"][0]) == 0.0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_save_bal_problem_writes_the_same_bytes(bal_path, tmp_path, dtype):
    jprob, _ = jbal.load_bal_problem(bal_path, dtype=getattr(jnp, dtype))
    tprob, _ = tbal.load_bal_problem(bal_path, dtype=getattr(torch, dtype),
                                     device="cpu")
    jbal.save_bal_problem(jprob, str(tmp_path / "jax.bal"))
    tbal.save_bal_problem(tprob, str(tmp_path / "port.bal"))
    assert (tmp_path / "jax.bal").read_bytes() \
        == (tmp_path / "port.bal").read_bytes()


def test_g2o_string_with_the_bal_tags_parses_alike():
    g = scenes.bal_camera_graph(JGraph, 4, 6, seed=2)
    text = jio.save_g2o(g)
    assert "VERTEX_CAMERA_BAL" in text and "EDGE_PROJECT_BAL" in text
    jprob = jio.loads_g2o(text).compile(dtype=jnp.float64)
    tprob = openslam_g2o_torch.loads_g2o(text).compile(dtype=torch.float64,
                                                       device="cpu")
    ja, ta = problem_arrays(jprob), problem_arrays(tprob)
    for part in ("params", "free"):
        assert list(ja[part]) == list(ta[part])
        for k in ja[part]:
            np.testing.assert_array_equal(ta[part][k], ja[part][k])
    for k, je in ja["edges"].items():
        np.testing.assert_array_equal(ta["edges"][k]["measurement"],
                                      je["measurement"])
        for ti, ji in zip(ta["edges"][k]["indices"], je["indices"]):
            np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(float(tproblem.chi2(tprob)),
                               float(jproblem.chi2(jprob)), rtol=RTOL)
    assert openslam_g2o_torch.save_g2o(
        openslam_g2o_torch.loads_g2o(text)) == text


def test_schur_auto_picks_the_dual_ell_solver(pair):
    jprob, tprob = pair
    jauto, tauto = jfactory._SchurAuto(), tfactory._SchurAuto()
    jauto.init(jprob)
    tauto.init(tprob)
    assert type(jauto._impl).__name__ == type(tauto.impl).__name__ \
        == "LevenbergMarquardtSchurELL"


def _abs_close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("add_fixed_diag", [True, False])
def test_build_dense_system_at_block_width_9_matches_jax(pair,
                                                          add_fixed_diag):
    jprob, tprob = pair
    jH, jb, jraw = jproblem.build_dense_system(
        jprob, add_fixed_diag=add_fixed_diag)
    tH, tb, traw = tproblem.build_dense_system(
        tprob, add_fixed_diag=add_fixed_diag)
    T = tprob.static.total_dim
    counts = {g.name: g.count for g in tprob.static.vgroups}
    assert tH.shape == (T, T) and T == (9 * counts["bal_camera"]
                                        + 3 * counts["sba_point_xyz"])
    _abs_close(tH, jH, RTOL)
    _abs_close(tb, jb, RTOL)
    _abs_close(traw, jraw, RTOL)
    fixed = tproblem.tangent_masks(tprob)[1].bool()
    assert int(fixed.sum()) == 9                      # camera 0
    assert (tH.diagonal()[fixed] == (1.0 if add_fixed_diag else 0.0)).all()
    assert (traw[fixed] == 0.0).all()


def test_dense_tables_with_the_rectangular_pair_give_the_plain_system(pair):
    """K15's destination tables of EDGE_PROJECT_BAL (point 3, camera 9):
    the (0, 1) pair's destinations are (point, camera) blocks of flag 0
    (the two slots name vertices of two groups), walked as the kernel
    walks them (tests/test_torch_dense_route.py) with the mirror written
    at (camera, point): the plain version's H, b and raw_diag; likewise
    the general Schur path's table of the camera slot alone on Hpp."""
    _, tprob = pair
    eg = tprob.static.egroups[0]
    resid, jacs, rho1 = tproblem.linearize(tprob)[eg.key]
    info = tprob.edges[eg.key].information
    fixed_t = tproblem.tangent_masks(tprob)[1]
    T, Tp = tprob.static.total_dim, tprob.static.pose_dim
    for slots, total, fix in (((0, 1), T, fixed_t),
                              ((1,), Tp, torch.zeros(Tp, dtype=resid.dtype))):
        pattern = K15.build_dense_pattern(tprob, total_dim=total,
                                          slots=[slots])
        groups = [K15.EdgeBlocks(resid, tuple(jacs[s] for s in slots), rho1,
                                 info, pattern.offsets[0])]
        H, b, raw = _walk_tables(groups, pattern, total, fix, True)
        pH, pb, praw = K15.dense_assemble_plain(groups, total, fix)
        _abs_close(pH, H, RTOL)
        _abs_close(pb, b, RTOL)
        _abs_close(praw, raw, RTOL)
        tables = pattern.pairs[0]
        widths = [jacs[s].shape[2] for s in slots]
        assert [(tb.s, tb.t) for tb in tables] == [
            (a, c) for a in range(len(slots)) for c in range(a, len(slots))]
        for tb in tables:
            if widths[tb.s] == widths[tb.t]:
                continue
            assert (widths[tb.s], widths[tb.t]) == (3, 9)
            assert not bool(tb.flag.any())
            p, q = tb.dest_p.long(), tb.dest_q.long()
            assert bool((p >= Tp).all()) and bool((q < Tp).all())
            assert tb.n_dest == len(set(zip(p.tolist(), q.tolist())))
            blocks = torch.stack([
                pH[pp:pp + 3, qq:qq + 9] for pp, qq in zip(p, q)])
            mirrors = torch.stack([
                pH[qq:qq + 9, pp:pp + 3] for pp, qq in zip(p, q)])
            assert torch.equal(blocks.transpose(1, 2), mirrors)
            # zero exactly where the camera is the fixed camera 0
            assert torch.equal(blocks.abs().amax(dim=(1, 2)) > 0, q != 0)


def _fixed_cameras_pair():
    """bal_camera_graph (6 cameras, 40 points) with cameras 0 and 2 fixed,
    built in JAX and carried across."""
    g = scenes.bal_camera_graph(JGraph, 6, 40)
    g.vertices[2].fixed = True
    jprob = g.compile(dtype=jnp.float64)
    return jprob, problem_from_numpy(**problem_arrays(jprob), device="cpu")


@pytest.mark.parametrize("algorithm,iters", [("LevenbergMarquardt", 10),
                                             ("GaussNewton", 5)])
def test_dense_route_at_block_width_9_matches_jax(algorithm, iters):
    jprob, tprob = _fixed_cameras_pair()
    chi0 = float(tproblem.robust_chi2(tprob))
    _, jst = jalg.optimize(jprob, getattr(jalg, algorithm)(),
                           iterations=iters)
    _, tst = talg.optimize(tprob, getattr(talg, algorithm)(),
                           iterations=iters)
    jchi = np.array([s["chi2"] for s in jst])
    tchi = np.array([s["chi2"] for s in tst])
    prev = np.concatenate([[chi0], jchi[:-1]])
    live = (prev - jchi) > GAIN_FLOOR * np.abs(jchi)
    live = live & (np.cumsum(~live) == 0)        # up to the first stall
    assert live[:3].all(), jchi
    np.testing.assert_allclose(tchi[live], jchi[live], rtol=RTOL_DENSE)
    assert tchi[-1] < 0.05 * chi0
    if algorithm == "LevenbergMarquardt":
        assert np.all(np.diff(np.concatenate([[chi0], tchi])) <= 0)
        assert ([s["levenberg_iters"] for s, k in zip(tst, live) if k]
                == [s["levenberg_iters"] for s, k in zip(jst, live) if k])


def _registered_edge(name, vertex_types, error_dim, error):
    if name not in registry._EDGE_TYPES:
        registry.register_edge_type(registry.EdgeType(
            name=name, tag=name.upper(), vertex_types=vertex_types,
            error_dim=error_dim, measurement_dim=error_dim, error=error))
    return name


def _two_camera_graph(name, lm_type, lm_start, meas):
    """Two BAL cameras (camera 0 fixed) and one marginalized landmark of
    `lm_type`, seen by both through the edge type `name`."""
    g = TGraph()
    g.add_vertex(0, "bal_camera", [0, 0, 0, 0, 0, 8.0, 800.0, 0, 0],
                 fixed=True)
    g.add_vertex(1, "bal_camera", [0, 0, 0, 1.0, 0, 8.0, 800.0, 0, 0])
    g.add_vertex(2, lm_type, lm_start, marginalized=True)
    for c in (0, 1):
        g.add_edge(name, (2, c), meas, np.eye(len(meas)))
    return g.compile(dtype=torch.float64, device="cpu")


def test_the_dual_ell_pattern_refuses_other_widths():
    """(Dp, dl) = (9, 2), a landmark edge from the BAL camera to a 2D point
    (a type registered at run time), is no instantiation of K10-K13 nor of
    K14: the dual-ELL and the general path's patterns refuse it."""
    name = _registered_edge(
        "test_bal_camera_xy", ("point_xy", "bal_camera"), 2,
        lambda vp, meas, pdata: vp[0] + vp[1][..., :2] - meas)
    prob = _two_camera_graph(name, "point_xy", [0.5, 0.5], [1.0, 1.0])
    with pytest.raises(NotImplementedError, match="instantiations"):
        tba_ell.build_ba_ell_pattern(prob)
    with pytest.raises(NotImplementedError, match=r"\(9, 2\)"):
        tba.build_schur_pattern(prob)


def test_k14_refuses_a_3_wide_residual_at_9_3():
    """K14 at (9, 3) serves residual widths 1 and 2 (a float64 tile of
    3-wide residuals would stage 50,176 bytes of shared memory): a 3-wide
    landmark edge on the BAL camera is refused by the general path's
    pattern and by the wrapper, on CPU tensors as on the card."""
    name = _registered_edge(
        "test_bal_camera_xyz3", ("sba_point_xyz", "bal_camera"), 3,
        lambda vp, meas, pdata: vp[0] + vp[1][..., 3:6] - meas)
    prob = _two_camera_graph(name, "sba_point_xyz", [0.5, 0.5, 1.0],
                             [1.0, 1.0, 9.0])
    with pytest.raises(NotImplementedError, match="residual width 3"):
        tba.build_schur_pattern(prob)
    E, R = 4, 3
    z = lambda *shape: torch.zeros(shape, dtype=torch.float64)
    idx = torch.arange(E, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=r"residual width 3 at "
                       r"\(Dp, dl\) = \(9, 3\)"):
        schur_general.schur_edge_blocks(
            z(E, R), z(E, R, 3), z(E, R, 9), z(E), z(E, R, R), z(9, E),
            z(3, E), 0, z(27, 1, E), idx, z(27, E), idx, idx, idx)
    for r in (1, 2):                   # the served widths pass the check
        schur_general.check_served(r, 9, 3)
    assert (9, 3) in schur_general.DIMS


def test_lm_schur_general_on_the_bal_file_matches_jax(pair):
    """The general path's LevenbergMarquardtSchur() (K14 at (9, 3), K15 on
    the 9-wide camera slots) against JAX's chi2 trajectory."""
    jprob, tprob = pair
    chi0 = float(tproblem.robust_chi2(tprob))
    _, jst = jalg.optimize(jprob, jba.LevenbergMarquardtSchur(),
                           iterations=8)
    _, tst = talg.optimize(tprob, tba.LevenbergMarquardtSchur(),
                           iterations=8)
    jchi = np.array([s["chi2"] for s in jst])
    tchi = np.array([s["chi2"] for s in tst])
    prev = np.concatenate([[chi0], jchi[:-1]])
    keep = (prev - jchi) > GAIN_FLOOR * np.abs(jchi)
    assert keep[:3].all(), jchi
    np.testing.assert_allclose(tchi[keep], jchi[keep], rtol=RTOL_SCHUR)
    assert tchi[-1] < 0.05 * chi0
    assert np.all(np.diff(np.concatenate([[chi0], tchi])) <= 0)


def test_lm_schur_ell_on_the_bal_file_matches_jax_and_round_trips(
        pair, tmp_path):
    jprob, tprob = pair
    chi0 = float(tproblem.robust_chi2(tprob))
    _, jst = jalg.optimize(
        jprob, jba_ell.LevenbergMarquardtSchurELL(pcg_iters=100),
        iterations=8)
    out, tst = talg.optimize(
        tprob, tba_ell.LevenbergMarquardtSchurELL(pcg_iters=100),
        iterations=8)
    jchi = np.array([s["chi2"] for s in jst])
    tchi = np.array([s["chi2"] for s in tst])
    prev = np.concatenate([[chi0], jchi[:-1]])
    keep = (prev - jchi) > GAIN_FLOOR * np.abs(jchi)
    assert keep[:3].all(), jchi
    np.testing.assert_allclose(tchi[keep], jchi[keep], rtol=RTOL_SCHUR)
    assert tchi[-1] < 0.05 * chi0
    assert np.all(np.diff(np.concatenate([[chi0], tchi])) <= 0)
    path = str(tmp_path / "out.bal")
    tbal.save_bal_problem(out, path)
    back, _ = tbal.load_bal_problem(path, device="cpu")
    np.testing.assert_allclose(float(tproblem.robust_chi2(back)), tchi[-1],
                               rtol=1e-12)
