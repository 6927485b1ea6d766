"""The edge linearizers of kernels/edge_lin.py (K17: every edge type of
openslam_g2o_torch.models, twenty-one in forward mode, EDGE_SE2 and the
XYZ2UV / XYZ2UVU projections in closed form) against the JAX package,
float64 on the CPU, where every wrapper runs its plain version. The
kernels themselves run on the card only (tests/test_torch_kernels.py holds them against these
plain versions).

* per edge type and robust kernel (Huber, Cauchy), a small numpy-seeded
  graph built through either package's Graph API, with a fixed vertex in
  every vertex group (and SE3 quaternions stored with q_w < 0 or 5e-4 off
  unit, so the renormalizations and the sign flip are differentiated):
  the wrapper's residual, per-slot Jacobians and rho' against JAX's
  `linearize` (jacfwd, or the analytic branch for the three closed forms)
  to rtol 1e-12 with an absolute floor of 1e-12 of the largest entry (the
  floor of tests/test_torch_sba_cam_types.py: the same float64 formulas,
  differentiated by jvp against jacfwd); the types without a scene of
  their own are taken on phase 4o's three worlds of chip_smoke.py, small;
* the three closed forms at group sizes around the kernels' tiles (1,
  127-129 and 255-257 edges: the graph's own edges of the type taken in
  turn): `linearize_group` against JAX's `linearize` as above, and
  `robust_chi2_parts` summed against JAX's `robust_chi2` to rtol 1e-12;
* a PSI2UV group whose anchor is the observing camera: each of the two
  camera slots gets its own columns, equal to JAX's; where that camera is
  free the two are opposite (the edge projects exp(d1) T T^-1 exp(-d2)
  psi, so its error does not depend on the camera);
* on CPU tensors `linearize_group` takes the plain route (no launch is
  counted), `LINEARIZERS` names every edge type the models register, a
  type registered at run time has no wrapper and keeps the generic route,
  and the C entries and their ctypes signatures are the table's;
* the slice as a whole, under robust kernels (which the other trajectory
  tests leave out): a small Simulator3D world with every edge under Cauchy
  through `optimize()` (the dense LM) against JAX's chi2 trajectory to
  rtol 1e-7 (the dense route's float64 precedent: factorizations and sums
  in another order), and chip_smoke.py's anchored PSI2UV scene with every edge under Huber
  through LevenbergMarquardtSchur to rtol 1e-8 while an iteration gains
  more than 1e-10 of chi2 (the general Schur path's precedent,
  tests/test_torch_schur_general.py).

tests/test_torch_edge_lin_4o.py holds phase 4o's worlds and two branches.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scenes
from openslam_g2o_tpu.apps.simulator import Simulator3D as JSimulator3D
from openslam_g2o_tpu.core import algorithms as jalg
from openslam_g2o_tpu.core import ba as jba
from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.utils import np_lie

from openslam_g2o_torch import kernels
from openslam_g2o_torch.core import algorithms as talg
from openslam_g2o_torch.core import ba as tba
from openslam_g2o_torch.core import registry
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import edge_lin

torch.set_num_threads(1)

RTOL = 1e-12
RTOL_DENSE = 1e-7
RTOL_SCHUR = 1e-8
GAIN_FLOOR = 1e-10
TYPES = ("edge_se3", "edge_se3_xyz", "edge_project_p2mc_intrinsics",
         "edge_project_psi2uv", "edge_se2", "edge_se2_xy",
         "edge_se2_xy_bearing", "edge_se2_prior", "edge_se2_prior_xy",
         "edge_se2_xy_calib", "edge_se2_offset", "edge_se2_xy_offset",
         "edge_se3_depth", "edge_se3_disparity", "edge_se3_prior",
         "edge_se3_offset", "edge_se3_expmap", "edge_project_xyz2uv",
         "edge_project_xyz2uvu", "edge_project_p2mc", "edge_project_p2sc",
         "edge_sba_cam", "edge_sba_scale", "edge_project_bal")
KERNELS = (("Huber", 1.5), ("Cauchy", 0.8))
K = np.array([505.0, 490.0, 318.0, 242.0, 0.1])      # fx, fy, cx, cy, b
CAMP = np.array([480.0, 310.0, 245.0, 0.1])           # focal, cx, cy, b


def _small_quat(rng, scale):
    v = rng.normal(0, scale, 3)
    return np.array([*v, np.sqrt(1 - v @ v)])


def _pose_graph(Graph, kernel, seed=3, n=8, n_lm=6):
    """SE3 poses on a curve (vertex 1 fixed; some quaternions stored with
    q_w < 0, some 5e-4 off unit), XYZ landmarks (landmark 2 fixed) seen
    through an offset parameter, odometry and two loop closures; every
    edge under `kernel`."""
    rng = np.random.default_rng(seed)
    name, width = kernel
    g = Graph()
    off = np.concatenate([[0.1, -0.05, 0.2], _small_quat(rng, 0.2)])
    g.add_parameter(0, "se3_offset", off)
    gt = [np.array([0.2, 0.1, -0.3, 0.0, 0.0, 0.0, 1.0])]
    for _ in range(n - 1):
        gt.append(np_lie.se3_compose(gt[-1], np.concatenate(
            [[0.8, 0.1, 0.05], _small_quat(rng, 0.15)])))
    for i, p in enumerate(gt):
        x = np_lie.se3_compose(p, np.concatenate(
            [rng.normal(0, 0.05, 3), _small_quat(rng, 0.02)]))
        if i % 3 == 2:
            x[3:] *= -1.0
        if i % 4 == 3:
            x[3:] *= 1.0005
        g.add_vertex(i, "se3", x, fixed=(i == 1))
    lms = rng.uniform(-2, 2, (n_lm, 3)) + gt[n // 2][:3]
    for k, lm in enumerate(lms):
        g.add_vertex(100 + k, "point_xyz", lm + rng.normal(0, 0.1, 3),
                     fixed=(k == 2))
    M = rng.normal(size=(6, 6))
    info6 = M @ M.T + 4.0 * np.eye(6)
    rel = lambda i, j: np_lie.se3_compose(np_lie.se3_inverse(gt[i]), gt[j])
    for i, j in [(i, i + 1) for i in range(n - 1)] + [(0, 5), (6, 2)]:
        z = np_lie.se3_compose(rel(i, j), np.concatenate(
            [rng.normal(0, 0.3, 3), _small_quat(rng, 0.1)]))
        g.add_edge("edge_se3", (i, j), z, info6, kernel=name,
                   kernel_delta=width)
    info3 = np.diag([30.0, 40.0, 50.0]) + 1.0
    for i in range(n):
        sensor = np_lie.se3_inverse(np_lie.se3_compose(gt[i], off))
        for k in range(i % 2, n_lm, 2):
            g.add_edge("edge_se3_xyz", (i, 100 + k),
                       np_lie.se3_apply(sensor, lms[k])
                       + rng.normal(0, 0.1, 3), info3, param_ids=[0],
                       kernel=name, kernel_delta=width)
    return g


def _intrinsics_graph(Graph, kernel, seed=5, n_cams=4, n_points=12):
    """One shared VERTEX_INTRINSICS (added first), VERTEX_CAM cameras on a
    line looking down +z (camera 0 fixed), points (point 3 fixed), every
    camera observing every point through EDGE_PROJECT_P2MC_INTRINSICS."""
    rng = np.random.default_rng(seed)
    name, width = kernel
    g = Graph()
    g.add_vertex(500, "intrinsics",
                 K + rng.normal(0, 2.0, 5) * [1, 1, 1, 1, 0])
    cams = []
    for i in range(n_cams):
        t = np.array([0.4 * i - 0.6, 0.05 * i, 0.0]) + rng.normal(0, 0.02, 3)
        c2w = np.concatenate([t, _small_quat(rng, 0.05)])
        if i == 2:
            c2w[3:] *= -1.0
        cams.append(c2w)
        g.add_vertex(i, "cam", np.concatenate([c2w, K]), fixed=(i == 0))
    pts = rng.uniform(-1.5, 1.5, (n_points, 3)) + np.array([0, 0, 6.0])
    for j, p in enumerate(pts):
        g.add_vertex(1000 + j, "sba_point_xyz", p + rng.normal(0, 0.1, 3),
                     fixed=(j == 3), marginalized=True)
        for i, c2w in enumerate(cams):
            pc = np_lie.se3_apply(np_lie.se3_inverse(c2w), p)
            uv = (K[:2] * pc[:2] + K[2:4] * pc[2]) / pc[2]
            g.add_edge("edge_project_p2mc_intrinsics", (1000 + j, i, 500),
                       uv + rng.normal(0, 2.0, 2), np.eye(2) * 0.8,
                       kernel=name, kernel_delta=width)
    return g


def _psi2uv_graph(Graph, kernel, seed=9, n_cams=4, n_points=10):
    """World-to-camera expmap cameras (camera 0 fixed), inverse-depth
    points anchored at camera j % n_cams (point 4 fixed), every camera
    observing every point through EDGE_PROJECT_PSI2UV, so one edge per
    point has its anchor as the observing camera."""
    rng = np.random.default_rng(seed)
    name, width = kernel
    g = Graph()
    g.add_parameter(0, "camera_parameters", CAMP)
    w2cs = []
    for i in range(n_cams):
        c2w = np.concatenate([[0.3 * i - 0.5, 0.04 * i, 0.0],
                              _small_quat(rng, 0.05)])
        w2c = np_lie.se3_inverse(c2w)
        w2cs.append(w2c)
        g.add_vertex(i, "se3_expmap", w2c, fixed=(i == 0))
    pts = rng.uniform(-1.5, 1.5, (n_points, 3)) + np.array([0, 0, 7.0])
    for j, p in enumerate(pts):
        anchor = j % n_cams
        pa = np_lie.se3_apply(w2cs[anchor], p + rng.normal(0, 0.1, 3))
        g.add_vertex(1000 + j, "sba_point_xyz",
                     np.array([pa[0], pa[1], 1.0]) / pa[2],
                     fixed=(j == 4), marginalized=True)
        for i, w2c in enumerate(w2cs):
            pc = np_lie.se3_apply(w2c, p)
            uv = pc[:2] / pc[2] * CAMP[0] + CAMP[1:3]
            g.add_edge("edge_project_psi2uv", (1000 + j, i, anchor),
                       uv + rng.normal(0, 1.0, 2), np.eye(2),
                       param_ids=[0], kernel=name, kernel_delta=width)
    return g


def _robust(graph, kernel, width):
    for e in graph.edges:
        e.kernel, e.kernel_delta = kernel, width
    return graph


def _world2d(Graph, kernel):
    """Phase 4o's 2D world, small: every SE2 edge type."""
    g = scenes.world2d_all_graph(Graph, 40, 30, seed=2, prior_every=4)
    return _robust(scenes.fix_one_per_slot(g), *kernel)


def _world3d(Graph, kernel):
    """Phase 4o's 3D world, small: depth, disparity, prior, offset."""
    g = scenes.world3d_all_graph(Graph, 30, 24, seed=2)
    return _robust(scenes.fix_one_per_slot(g), *kernel)


def _sba(Graph, kernel):
    """Phase 4o's SBA world, small: the SBACam and expmap types."""
    g = scenes.sba_all_graph(Graph, 20, 40, seed=2)
    return _robust(scenes.fix_one_per_slot(g), *kernel)


def _bal(Graph, kernel):
    """chip_smoke.py's small BAL graph: the 9-wide camera at omega = 0,
    at theta^2 just above so3_exp's Taylor branch and turned, with
    distortion; camera 0 and one point fixed."""
    g = scenes.bal_camera_graph(Graph, 6, 40, seed=4)
    return _robust(scenes.fix_one_per_slot(g), *kernel)


BUILDERS = {"edge_se3": _pose_graph, "edge_se3_xyz": _pose_graph,
            "edge_project_p2mc_intrinsics": _intrinsics_graph,
            "edge_project_psi2uv": _psi2uv_graph,
            **{t: _world2d for t in TYPES if t.startswith("edge_se2")},
            **{t: _world3d for t in ("edge_se3_depth", "edge_se3_disparity",
                                     "edge_se3_prior", "edge_se3_offset")},
            **{t: _sba for t in ("edge_se3_expmap", "edge_project_xyz2uv",
                                 "edge_project_xyz2uvu", "edge_project_p2mc",
                                 "edge_project_p2sc", "edge_sba_cam",
                                 "edge_sba_scale")},
            "edge_project_bal": _bal}

_cache = {}


def _pair(tname, kernel):
    """(JAX problem, port problem on the CPU, the group key) of the graph
    that holds `tname` under `kernel`."""
    key = (BUILDERS[tname], kernel)
    if key not in _cache:
        jprob = BUILDERS[tname](JGraph, kernel).compile(dtype=jnp.float64)
        _cache[key] = (jprob, problem_from_numpy(**problem_arrays(jprob),
                                                 device="cpu"),
                       jproblem.linearize(jprob))
    jprob, tprob, jlin = _cache[key]
    return jprob, tprob, jlin, f"{tname}#{kernel[0]}"


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=RTOL,
                               atol=1e-12 * max(float(np.abs(j).max()), 1.0))


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k[0])
@pytest.mark.parametrize("tname", TYPES)
def test_plain_version_matches_jax_linearize(tname, kernel):
    _, tprob, jlin, key = _pair(tname, kernel)
    eg = next(e for e in tprob.static.egroups if e.key == key)
    ea = tprob.edges[key]
    wrapper = edge_lin.linearizer(tname)
    args = (tuple(tprob.params[g] for g in eg.slots),
            tuple(tprob.free[g] for g in eg.slots), ea.indices,
            ea.measurement, ea.information, ea.delta, ea.pdata, eg.kernel_id)
    kernels.reset_launch_counts()
    resid, jacs, rho1 = wrapper(*args)
    assert wrapper.launches == 0
    jr, jjacs, jw = jlin[key]
    _close(resid, jr)
    _close(rho1, jw)
    assert float(rho1.min()) < 1.0            # the kernel's outlier branch
    assert len(jacs) == len(jjacs) == len(eg.slots)
    for s, (tj, jj) in enumerate(zip(jacs, jjacs)):
        assert tuple(tj.shape) == jj.shape
        _close(tj, jj)
        fixed = tprob.free[eg.slots[s]][ea.indices[s].long()] == 0
        # every slot sees a fixed vertex, but one that names a single
        # shared vertex (the intrinsics, the 2D calibration)
        assert fixed.any() or ea.indices[s].unique().numel() == 1
        assert (tj[fixed] == 0).all()
    # the plain version is the wrapper's on CPU tensors, value for value
    for got, want in zip((resid, *jacs, rho1),
                         (lambda o: (o[0], *o[1], o[2]))(
                             getattr(edge_lin, edge_lin.LINEARIZERS[tname]
                                     + "_plain")(*args))):
        assert torch.equal(got, want)


# group sizes around the tiles of the closed forms' kernel (128 edges) and
# of the trial chi2's (256)
TILE_SIZES = (1, 127, 128, 129, 255, 256, 257)
CLOSED_FORMS = ("edge_se2", "edge_project_xyz2uv", "edge_project_xyz2uvu")
_sized_cache = {}


def _sized_pair(tname, E):
    """(JAX problem, port problem on the CPU) of BUILDERS[tname]'s graph
    under Huber with only its `tname` edges, taken in turn until there are
    E of them."""
    if (tname, E) not in _sized_cache:
        g = BUILDERS[tname](JGraph, KERNELS[0])
        own = [e for e in g.edges if e.etype.name == tname]
        g.edges = [own[k % len(own)] for k in range(E)]
        jprob = g.compile(dtype=jnp.float64)
        _sized_cache[(tname, E)] = (jprob, problem_from_numpy(
            **problem_arrays(jprob), device="cpu"))
    return _sized_cache[(tname, E)]


@pytest.mark.parametrize("E", TILE_SIZES)
@pytest.mark.parametrize("tname", CLOSED_FORMS)
def test_closed_form_linearize_group_at_tile_sizes_matches_jax(tname, E):
    """linearize_group of a closed-form group of E edges against JAX's
    `linearize` (its analytic branch); on CPU tensors no kernel runs."""
    jprob, tprob = _sized_pair(tname, E)
    (eg,) = tprob.static.egroups
    assert eg.etype.name == tname and eg.count == E
    kernels.reset_launch_counts()
    resid, jacs, rho1 = tproblem.linearize_group(tprob, eg)
    assert not any(kernels.launch_counts().values())
    jr, jjacs, jw = jproblem.linearize(jprob)[eg.key]
    _close(resid, jr)
    _close(rho1, jw)
    assert len(jacs) == len(jjacs) == 2
    for tj, jj in zip(jacs, jjacs):
        assert tuple(tj.shape) == jj.shape == (E, *jj.shape[1:])
        _close(tj, jj)


@pytest.mark.parametrize("E", TILE_SIZES)
@pytest.mark.parametrize("tname", CLOSED_FORMS)
def test_trial_chi2_parts_at_tile_sizes_sum_to_jax_robust_chi2(tname, E):
    """robust_chi2_parts of the same groups, summed, against JAX's
    robust_chi2 to rtol 1e-12 (one sum of E float64 terms in another
    order); on the CPU one partial a group."""
    jprob, tprob = _sized_pair(tname, E)
    kernels.reset_launch_counts()
    parts = tproblem.robust_chi2_parts(tprob)
    assert not any(kernels.launch_counts().values())
    assert parts.shape == (1,)
    want = float(jproblem.robust_chi2(jprob))
    np.testing.assert_allclose(float(parts.sum()), want, rtol=RTOL)
    assert float(tproblem.robust_chi2(tprob)) == float(parts.sum())


def test_psi2uv_anchor_on_the_observing_camera():
    _, tprob, jlin, key = _pair("edge_project_psi2uv", KERNELS[0])
    ea = tprob.edges[key]
    same = ea.indices[1] == ea.indices[2]
    free = tprob.free["se3_expmap"][ea.indices[1].long()] == 1
    assert int(same.sum()) == 10 and bool((same & free).any())
    resid, (jpsi, jobs, janc), rho1 = tproblem.linearize_group(
        tprob, next(e for e in tprob.static.egroups if e.key == key))
    _, (_, jjobs, jjanc), _ = jlin[key]
    _close(jobs[same], np.asarray(jjobs)[same.numpy()])
    _close(janc[same], np.asarray(jjanc)[same.numpy()])
    # one vertex in both slots: jacfwd gives each slot its own columns,
    # and they cancel, since exp(d1) T (exp(d2) T)^-1 = exp(d1) exp(-d2)
    both = same & free
    torch.testing.assert_close(jobs[both], -janc[both], rtol=1e-9,
                               atol=1e-9 * float(jobs.abs().max()))
    assert float(jobs[both].abs().max()) > 1.0


def _model_types():
    """The edge types registered by openslam_g2o_torch.models."""
    return {name for name, et in registry._EDGE_TYPES.items()
            if et.error.__module__.startswith("openslam_g2o_torch.models.")}


def test_cpu_linearize_takes_the_plain_route_and_the_table_is_exact():
    assert set(edge_lin.LINEARIZERS) == _model_types() == set(TYPES)
    assert all(edge_lin.linearizer(t) is not None for t in TYPES)
    assert {t for t in TYPES if registry.edge_type(t).jacobian
            is not None} == {"edge_se2", "edge_project_xyz2uv",
                             "edge_project_xyz2uvu"}
    assert {w.__name__ for w in kernels.WRAPPERS} >= set(
        edge_lin.LINEARIZERS.values())
    kernels.reset_launch_counts()
    for tname in ("edge_se3", "edge_project_p2mc_intrinsics",
                  "edge_project_psi2uv", "edge_se2", "edge_se3_depth",
                  "edge_se3_expmap"):
        _, tprob, _, _ = _pair(tname, KERNELS[1])
        tproblem.linearize(tprob)
    assert not any(kernels.launch_counts().values())


def test_a_type_registered_at_run_time_keeps_the_generic_route():
    """A caller's edge type has no wrapper: `linearize_group` runs the
    error and torch.func.jvp for it (here on the CPU; on the card too)."""
    name = "test_runtime_range_xy"
    if name not in registry._EDGE_TYPES:
        registry.register_edge_type(registry.EdgeType(
            name=name, tag="TEST_RUNTIME_RANGE_XY",
            vertex_types=("se2", "point_xy"), error_dim=1,
            measurement_dim=1,
            error=lambda vp, meas, pdata: torch.sqrt(
                ((vp[1] - vp[0][..., :2]) ** 2).sum(-1, keepdim=True))
            - meas))
    assert edge_lin.linearizer(name) is None
    g = TGraph()
    g.add_vertex(0, "se2", [0.0, 0.0, 0.3], fixed=True)
    g.add_vertex(1, "se2", [1.0, 0.5, -0.2])
    g.add_vertex(2, "point_xy", [3.0, 4.0])
    for i in (0, 1):
        g.add_edge(name, (i, 2), [4.0], np.eye(1))
    g.add_edge("edge_se2", (0, 1), [1.0, 0.5, -0.5], np.eye(3))
    prob = g.compile(dtype=torch.float64, device="cpu")
    eg = next(e for e in prob.static.egroups if e.etype.name == name)
    resid, (jx, jl), rho1 = tproblem.linearize_group(prob, eg)
    d = np.array([[3.0, 4.0], [2.0, 3.5]])
    r = np.linalg.norm(d, axis=1)
    np.testing.assert_allclose(resid.numpy()[:, 0], r - 4.0, rtol=1e-12)
    np.testing.assert_allclose(jl.numpy()[:, 0], d / r[:, None],
                               rtol=1e-12)
    np.testing.assert_allclose(jx.numpy()[1, 0, :2], -d[1] / r[1],
                               rtol=1e-12)
    assert (jx[0] == 0).all() and float(jx[1, 0, 2]) == 0.0
    assert torch.equal(rho1, torch.ones(2, dtype=torch.float64))


def test_the_c_entries_and_signatures_are_the_tables():
    """edge_lin.cu exports one entry pair per LINEARIZERS wrapper, and
    build.py declares each one's ctypes signature."""
    from pathlib import Path
    import re
    from openslam_g2o_torch.kernels import build
    src = (Path(build.CSRC) / "edge_lin.cu").read_text()
    entries = set(re.findall(r"G2O_EDGE_LIN_ENTRIES\((g2o_edge_lin_\w+),",
                             src))
    want = {"g2o_" + w for w in edge_lin.LINEARIZERS.values()}
    assert entries == want
    assert {k for k in build._SIGNATURES if k.startswith("g2o_edge_lin_")} \
        == want
    assert len({build._SIGNATURES[k] for k in want}) == 1


def test_wrapper_rejects_bad_arguments():
    _, tprob, _, key = _pair("edge_se3_xyz", KERNELS[0])
    eg = next(e for e in tprob.static.egroups if e.key == key)
    ea = tprob.edges[key]
    params = tuple(tprob.params[g] for g in eg.slots)
    free = tuple(tprob.free[g] for g in eg.slots)
    args = [params, free, ea.indices, ea.measurement, ea.information,
            ea.delta, ea.pdata, eg.kernel_id]
    with pytest.raises(ValueError, match="robust kernel"):
        edge_lin.edge_lin_se3_xyz(*args[:7], 99)
    with pytest.raises(ValueError, match="pdata"):
        edge_lin.edge_lin_se3_xyz(*args[:6], (), eg.kernel_id)
    with pytest.raises(ValueError, match="slot 1"):
        edge_lin.edge_lin_se3_xyz((params[0], params[0]), *args[1:])
    with pytest.raises(ValueError, match="int32"):
        edge_lin.edge_lin_se3_xyz(params, free, tuple(i.long() for i in
                                                      ea.indices), *args[3:])
    with pytest.raises(ValueError, match="dtype"):
        edge_lin.edge_lin_se3_xyz(params, free, ea.indices,
                                  ea.measurement.float(), *args[4:])


def test_dense_lm_on_a_simulator3d_world_matches_jax():
    """The dense LM (both types through `linearize_group`) on a small
    Simulator3D world under Cauchy against JAX's trajectory."""
    world = dict(world_size=10.0, n_landmarks=30, seed=4)
    jg, _ = JSimulator3D(**world).simulate(40)
    jprob = _robust(jg, "Cauchy", 2.0).compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    assert {eg.etype.name for eg in tprob.static.egroups} == {
        "edge_se3", "edge_se3_xyz"}
    _, jst = jalg.optimize(jprob, jalg.LevenbergMarquardt(), iterations=8)
    kernels.reset_launch_counts()
    _, tst = talg.optimize(tprob, talg.LevenbergMarquardt(), iterations=8)
    assert not any(kernels.launch_counts().values())
    jchi, tchi = [s["chi2"] for s in jst], [s["chi2"] for s in tst]
    np.testing.assert_allclose(tchi, jchi, rtol=RTOL_DENSE)
    chi0 = float(tproblem.robust_chi2(tprob))
    assert tchi[-1] < 0.5 * chi0 and np.all(np.diff([chi0] + tchi) <= 0)


def test_lm_schur_on_the_anchored_scene_matches_jax():
    """LevenbergMarquardtSchur on chip_smoke.py's anchored PSI2UV scene
    (the BAL geometry, anchors at each point's first camera) under Huber
    against JAX's trajectory."""
    geo = scenes.bal_geometry(10, 120)
    jprob = _robust(scenes.psi2uv_graph(JGraph, geo), "Huber",
                    2.0).compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    _, jst = jalg.optimize(jprob, jba.LevenbergMarquardtSchur(), iterations=6)
    _, tst = talg.optimize(tprob, tba.LevenbergMarquardtSchur(), iterations=6)
    prev = chi0 = float(tproblem.robust_chi2(tprob))
    checked = 0
    for j, t in zip([s["chi2"] for s in jst], [s["chi2"] for s in tst],
                    strict=True):
        if prev - j <= GAIN_FLOOR * prev:
            break
        np.testing.assert_allclose(t, j, rtol=RTOL_SCHUR)
        prev, checked = j, checked + 1
    assert checked >= 2 and tst[-1]["chi2"] < chi0
