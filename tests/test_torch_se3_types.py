"""The 3D SLAM types of the port against the JAX package, float64 on the CPU.

One graph holding every type of models/slam3d.py (SE3 poses with two fixed
vertices and stored quaternions with q_w < 0 and |q| != 1, XYZ landmarks,
the offset and camera parameters, a Cauchy edge group) is built through
either package's Graph API; the JAX Problem is carried into the port with
interop.problem_from_numpy.

* registry records: dimensions, tags, slots, parameter slots;
* build_problem and interop: group order, 7-wide params, 7- and 11-wide
  pdata, 6x6 information;
* residuals and forward-mode Jacobians of every edge group against JAX's
  `linearize` (vmap(jacfwd) there, one forward-mode jvp here): rtol 1e-10,
  the same float64 operations differentiated by another rule set, through
  quat_normalize, the sign flip to q_w >= 0 and the clamp of
  quat_from_compact;
* `create_sphere` and `Simulator3D` equal to the bit for two seeds each;
* .g2o round trip of the 3D tags (21 information entries for a 6-dim
  edge, the three parameter tags), and a text saved by the JAX writer.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.apps import simulator as jsim
from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core import registry as jregistry
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.io.g2o_format import save_g2o as j_save_g2o
from openslam_g2o_tpu.utils import np_lie

from openslam_g2o_torch import loads_g2o, save_g2o
from openslam_g2o_torch.apps import simulator as tsim
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core import registry as tregistry
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy

torch.set_num_threads(1)

RTOL = 1e-10
VERTEX_TYPES = ("se3", "point_xyz")
EDGE_TYPES = ("edge_se3", "edge_se3_xyz", "edge_se3_depth",
              "edge_se3_disparity", "edge_se3_prior", "edge_se3_offset")
PARAM_TYPES = ("se3_offset", "camera_calib", "stereo_camera_calib")


def _quat(rng, scale=1.0):
    q = rng.normal(size=4)
    return scale * q / np.linalg.norm(q)


def build_all_types_graph(Graph, seed=21, n=10, n_lm=6):
    """Every 3D type in one graph, through either package's Graph API."""
    rng = np.random.default_rng(seed)
    g = Graph()
    gt = [np.array([0.5, -0.3, 0.2, 0.0, 0.0, 0.0, 1.0])]
    step = np.array([1.0, 0.1, -0.05, 0.05, -0.1, 0.2, 0.0])
    step[6] = np.sqrt(1 - (step[3:6] ** 2).sum())
    for _ in range(n - 1):
        gt.append(np_lie.se3_compose(gt[-1], step))
    lms = rng.uniform(1.0, 5.0, size=(n_lm, 3)) + gt[n // 2][:3]
    off_a = np.concatenate([[0.1, 0.0, 0.05], _quat(rng)])
    off_b = np.concatenate([[-0.05, 0.1, 0.0], _quat(rng)])
    ident = np.array([0, 0, 0, 0, 0, 0, 1.0])
    cam = np.concatenate([ident, [500.0, 480.0, 320.0, 240.0]])
    g.add_parameter(0, "se3_offset", off_a)
    g.add_parameter(3, "se3_offset", off_b)
    g.add_parameter(5, "camera_calib", cam)
    g.add_parameter(9, "stereo_camera_calib", np.concatenate([cam, [0.12]]))
    for i, p in enumerate(gt):
        noisy = np_lie.se3_compose(p, np.concatenate(
            [rng.normal(0, 0.05, 3), _quat_near_identity(rng, 0.02)]))
        if i % 3 == 1:
            noisy[3:] *= -1.0                  # stored with q_w < 0
        if i % 4 == 2:
            noisy[3:] *= 1.0005                # unit only to "rounding"
        g.add_vertex(i, "se3", noisy, fixed=i in (0, 6))
    for k, l in enumerate(lms):
        g.add_vertex(100 + k, "point_xyz", l + rng.normal(0, 0.05, 3),
                     fixed=k == 2)
    rel = lambda i, j: np_lie.se3_compose(np_lie.se3_inverse(gt[i]), gt[j])
    M = rng.normal(size=(6, 6))
    info6 = M @ M.T + 6.0 * np.eye(6)
    info3 = np.diag([40.0, 50.0, 60.0]) + 2.0
    for i in range(n - 1):
        z = np_lie.se3_compose(rel(i, i + 1), np.concatenate(
            [rng.normal(0, 0.02, 3), _quat_near_identity(rng, 0.01)]))
        g.add_edge("edge_se3", (i, i + 1), z, info6)
    g.add_edge("edge_se3", (0, 4), rel(0, 4), info6, kernel="Cauchy",
               kernel_delta=0.5)
    g.add_edge("edge_se3", (7, 2), rel(7, 2), 2 * info6, kernel="Cauchy",
               kernel_delta=0.5)
    g.add_edge("edge_se3_prior", (3,), np_lie.se3_compose(gt[3], off_a),
               info6, param_ids=[0])
    g.add_edge("edge_se3_offset", (1, 5),
               np_lie.se3_compose(np_lie.se3_inverse(
                   np_lie.se3_compose(gt[1], off_a)),
                   np_lie.se3_compose(gt[5], off_b)), info6,
               param_ids=[0, 3])
    for i in range(0, n, 2):
        for k in range(n_lm):
            sensor = np_lie.se3_inverse(np_lie.se3_compose(gt[i], off_a))
            g.add_edge("edge_se3_xyz", (i, 100 + k),
                       np_lie.se3_apply(sensor, lms[k])
                       + rng.normal(0, 0.02, 3), info3, param_ids=[0])
    for i in (n // 2, n // 2 + 1):
        for k in range(n_lm):
            pc = np_lie.se3_apply(np_lie.se3_inverse(gt[i]), lms[k])
            if pc[2] < 0.5:
                continue
            u = cam[7] * pc[0] / pc[2] + cam[9]
            v = cam[8] * pc[1] / pc[2] + cam[10]
            g.add_edge("edge_se3_depth", (i, 100 + k), [u, v, pc[2]],
                       np.diag([1.0, 1.0, 100.0]), param_ids=[5])
            g.add_edge("edge_se3_disparity", (i, 100 + k),
                       [u, v, 1.0 / pc[2]], np.diag([1.0, 1.0, 1e4]),
                       param_ids=[5])
    return g


def _quat_near_identity(rng, scale):
    v = rng.normal(0, scale, 3)
    return np.array([*v, np.sqrt(1 - v @ v)])


@pytest.fixture(scope="module")
def pair():
    jprob = build_all_types_graph(JGraph).compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    return jprob, tprob


@pytest.fixture(scope="module")
def linearized(pair):
    """Both packages' linearization and residuals of every group, once."""
    jprob, tprob = pair
    return (jproblem.linearize(jprob), tproblem.linearize(tprob),
            jproblem.compute_errors(jprob), tproblem.compute_errors(tprob))


@pytest.mark.parametrize("name", VERTEX_TYPES)
def test_vertex_type_records_match(name):
    jt, tt = jregistry.vertex_type(name), tregistry.vertex_type(name)
    for f in ("tag", "ambient_dim", "tangent_dim", "marginalizable", "io_dim"):
        assert getattr(jt, f) == getattr(tt, f), f
    np.testing.assert_array_equal(np.asarray(jt.origin(jnp.float64)),
                                  tt.origin(torch.float64).numpy())
    assert tregistry.vertex_type_by_tag(jt.tag) is tt


@pytest.mark.parametrize("name", EDGE_TYPES)
def test_edge_type_records_match(name):
    je, te = jregistry.edge_type(name), tregistry.edge_type(name)
    for f in ("tag", "vertex_types", "error_dim", "measurement_dim",
              "param_types", "io_meas_dim"):
        assert getattr(je, f) == getattr(te, f), f
    assert je.jacobian is None and te.jacobian is None
    assert (je.initial_estimate is None) == (te.initial_estimate is None)
    assert tregistry.edge_type_by_tag(je.tag) is te


@pytest.mark.parametrize("name", PARAM_TYPES)
def test_parameter_type_records_match(name):
    jp, tp = jregistry.parameter_type(name), tregistry.parameter_type(name)
    assert (jp.tag, jp.dim, jp.io_dim) == (tp.tag, tp.dim, tp.io_dim)
    assert tregistry.parameter_type_by_tag(jp.tag) is tp


@pytest.mark.parametrize("slot", [0, 1])
def test_initial_estimate_of_edge_se3(slot):
    rng = np.random.default_rng(slot)
    a = np.concatenate([rng.normal(size=3), _quat(rng)])
    z = np.concatenate([rng.normal(size=3), _quat(rng)])
    vp = (a, None) if slot == 1 else (None, a)
    np.testing.assert_array_equal(
        tregistry.edge_type("edge_se3").initial_estimate(vp, z, (), slot),
        jregistry.edge_type("edge_se3").initial_estimate(vp, z, (), slot))


def test_build_problem_matches_jax():
    jprob = build_all_types_graph(JGraph).compile(dtype=jnp.float64)
    tprob = build_all_types_graph(TGraph).compile(device="cpu")
    assert ([(g.name, g.count, g.offset, g.tangent_dim)
             for g in tprob.static.vgroups]
            == [(g.name, g.count, g.offset, g.tangent_dim)
                for g in jprob.static.vgroups])
    assert [g.name for g in tprob.static.vgroups] == ["se3", "point_xyz"]
    assert tprob.static.total_dim == jprob.static.total_dim == 6 * 10 + 3 * 6
    assert tprob.static.pose_dim == jprob.static.pose_dim == 60
    ja, ta = problem_arrays(jprob), problem_arrays(tprob)
    assert list(ta["edges"]) == list(ja["edges"])
    assert set(eg.etype.name for eg in tprob.static.egroups) == set(EDGE_TYPES)
    for k in ja["params"]:
        np.testing.assert_array_equal(ta["params"][k], ja["params"][k])
        np.testing.assert_array_equal(ta["free"][k], ja["free"][k])
    for key, e in ja["edges"].items():
        for f in ("measurement", "information", "delta", "kernel_id"):
            np.testing.assert_array_equal(ta["edges"][key][f], e[f])
        assert len(ta["edges"][key]["pdata"]) == len(e["pdata"])
        for a, b in zip(ta["edges"][key]["pdata"], e["pdata"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ta["edges"][key]["indices"], e["indices"]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(float(tproblem.robust_chi2(tprob)),
                               float(jproblem.robust_chi2(jprob)), rtol=1e-12)


def test_interop_carries_se3_params_pdata_and_information(pair):
    jprob, tprob = pair
    assert tprob.params["se3"].shape == (10, 7)
    assert tprob.edges["edge_se3"].information.shape[1:] == (6, 6)
    assert tprob.edges["edge_se3"].measurement.shape[1] == 7
    assert [tuple(p.shape[1:]) for p in tprob.edges["edge_se3_offset"].pdata] \
        == [(7,), (7,)]
    assert tprob.edges["edge_se3_depth"].pdata[0].shape[1] == 11
    assert "edge_se3#Cauchy" in tprob.edges
    for key in ("edge_se3_offset", "edge_se3_xyz", "edge_se3_depth"):
        for t, j in zip(tprob.edges[key].pdata, jprob.edges[key].pdata):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # and back out again: the arrays survive a second crossing unchanged
    again = problem_from_numpy(**problem_arrays(tprob), device="cpu")
    for k in tprob.params:
        assert torch.equal(again.params[k], tprob.params[k])
    assert torch.equal(again.edges["edge_se3"].information,
                       tprob.edges["edge_se3"].information)


def _group_keys():
    return list(problem_arrays(
        build_all_types_graph(JGraph).compile(dtype=jnp.float64))["edges"])


@pytest.mark.parametrize("key", _group_keys())
def test_error_and_jacobians_match_jax(pair, linearized, key):
    _, tprob = pair
    jlin, tlin, jerr, terr = linearized
    jr, jjacs, jw = jlin[key]
    tr, tjacs, tw = tlin[key]
    np.testing.assert_allclose(terr[key].numpy(), np.asarray(jerr[key]),
                               rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL,
                               atol=1e-13)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL)
    assert len(tjacs) == len(jjacs)
    for tj, jj in zip(tjacs, jjacs):
        assert tuple(tj.shape) == jj.shape
        scale = float(np.abs(np.asarray(jj)).max())
        np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=RTOL,
                                   atol=1e-12 * max(scale, 1.0))
    eg = next(e for e in tprob.static.egroups if e.key == key)
    for s, gname in enumerate(eg.slots):
        fixed = tprob.free[gname][tprob.edges[key].indices[s].long()] == 0
        assert (tjacs[s][fixed] == 0).all()


def test_pose_graph_chi2_and_apply_update_match_jax(pair):
    jprob, tprob = pair
    rng = np.random.default_rng(2)
    dx = rng.normal(scale=0.05, size=jprob.static.total_dim)
    jnew = jproblem.apply_update(jprob, jnp.asarray(dx))
    tnew = tproblem.apply_update(tprob, torch.as_tensor(dx))
    for k in jnew:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   rtol=1e-12, atol=1e-14)
    # fixed vertices keep their pose up to the renormalization
    np.testing.assert_allclose(tnew["se3"][0, :3].numpy(),
                               tprob.params["se3"][0, :3].numpy())
    np.testing.assert_allclose(
        float(tproblem.robust_chi2(tprob, tnew)),
        float(jproblem.robust_chi2(jprob, jnew)), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 3])
def test_create_sphere_equals_jax_to_the_bit(seed):
    kw = dict(n_laps=6, n_per_lap=20, radius=15.0, seed=seed)
    (jg, jgt), (tg, tgt) = jsim.create_sphere(**kw), tsim.create_sphere(**kw)
    _same_graph(jg, tg)
    np.testing.assert_array_equal(tgt, jgt)
    assert tg.vertices[0].fixed and tg.num_vertices() == 120
    assert all(e.etype.name == "edge_se3" for e in tg.edges)


@pytest.mark.parametrize("seed", [0, 3])
def test_simulator3d_equals_jax_to_the_bit(seed):
    kw = dict(n_landmarks=40, seed=seed)
    jg, jgt = jsim.Simulator3D(**kw).simulate(120)
    tg, tgt = tsim.Simulator3D(**kw).simulate(120)
    _same_graph(jg, tg)
    np.testing.assert_array_equal(tgt, jgt)
    names = {e.etype.name for e in tg.edges}
    assert names == {"edge_se3", "edge_se3_xyz"}
    # odometry alone gives n - 1 edges: the rest are loop closures
    assert sum(e.etype.name == "edge_se3" for e in tg.edges) > 119
    assert list(tg.parameters) == [0]


def _same_graph(jg, tg):
    assert list(tg.vertices) == list(jg.vertices)
    for vid, jv in jg.vertices.items():
        tv = tg.vertices[vid]
        assert tv.vtype.name == jv.vtype.name and tv.fixed == jv.fixed
        np.testing.assert_array_equal(tv.params, jv.params)
    assert len(tg.edges) == len(jg.edges)
    for te, je in zip(tg.edges, jg.edges):
        assert te.etype.name == je.etype.name
        assert te.vertex_ids == je.vertex_ids
        assert tuple(te.param_ids) == tuple(je.param_ids)
        np.testing.assert_array_equal(te.measurement, je.measurement)
        np.testing.assert_array_equal(te.information, je.information)
    assert sorted(tg.parameters) == sorted(jg.parameters)
    for pid in jg.parameters:
        np.testing.assert_array_equal(tg.parameters[pid][1],
                                      jg.parameters[pid][1])


def test_g2o_round_trip_of_the_3d_tags():
    g = build_all_types_graph(TGraph)
    text = save_g2o(g)
    for tag in ("VERTEX_SE3:QUAT", "VERTEX_TRACKXYZ", "PARAMS_SE3OFFSET",
                "PARAMS_CAMERACALIB", "PARAMS_STEREOCAMERACALIB",
                "EDGE_SE3:QUAT", "EDGE_SE3_TRACKXYZ", "EDGE_PROJECT_DEPTH",
                "EDGE_PROJECT_DISPARITY", "EDGE_SE3_PRIOR",
                "EDGE_SE3_OFFSET"):
        assert any(ln.startswith(tag + " ") for ln in text.splitlines()), tag
    # a 6-dim edge: 2 ids, 7 measurement values, 21 information entries
    line = next(ln for ln in text.splitlines()
                if ln.startswith("EDGE_SE3:QUAT "))
    assert len(line.split()) == 1 + 2 + 7 + 21
    g2 = loads_g2o(text)
    assert list(g2.vertices) == list(g.vertices)
    assert sorted(g2.parameters) == [0, 3, 5, 9]
    for pid in g.parameters:
        assert g2.parameters[pid][0] is g.parameters[pid][0]
        np.testing.assert_array_equal(g2.parameters[pid][1],
                                      g.parameters[pid][1])
    assert [v for v in g2.vertices if g2.vertices[v].fixed] == [0, 6, 102]
    assert len(g2.edges) == len(g.edges)
    for a, b in zip(g2.edges, g.edges):
        assert a.etype is b.etype and a.vertex_ids == b.vertex_ids
        assert a.param_ids == b.param_ids
        np.testing.assert_array_equal(a.measurement, b.measurement)
        np.testing.assert_allclose(a.information, b.information, rtol=1e-15)
    for e in g.edges:                      # the format carries no kernels
        e.kernel = "None"
    assert float(tproblem.robust_chi2(g.compile(device="cpu"))) \
        == float(tproblem.robust_chi2(g2.compile(device="cpu")))


def test_short_information_row_is_refused():
    with pytest.raises(ValueError, match="21 information"):
        loads_g2o("VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\n"
                  "VERTEX_SE3:QUAT 1 1 0 0 0 0 0 1\n"
                  "EDGE_SE3:QUAT 0 1 1 0 0 0 0 0 1 " + "1 " * 20 + "\n")


def test_jax_saved_3d_graph_loads_in_port():
    text = j_save_g2o(build_all_types_graph(JGraph))
    tg = loads_g2o(text)
    ref = build_all_types_graph(TGraph)
    assert tg.num_vertices() == ref.num_vertices()
    assert [e.etype.name for e in tg.edges] == [e.etype.name
                                                for e in ref.edges]
    for a, b in zip(tg.edges, ref.edges):
        np.testing.assert_array_equal(a.measurement, b.measurement)
        assert a.param_ids == b.param_ids
    # an edge to a vertex the file never declares: created at the origin
    tg2 = loads_g2o("VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\n"
                    "EDGE_SE3:QUAT 0 4 1 0 0 0 0 0 1 "
                    + " ".join(["1"] * 21) + "\n")
    np.testing.assert_array_equal(tg2.vertices[4].params,
                                  [0, 0, 0, 0, 0, 0, 1])
