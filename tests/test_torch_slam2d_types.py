"""The 2D SLAM types of the port against the JAX package, float64 on CPU.

One graph holding every type of models/slam2d.py (two fixed vertices, a
Cauchy edge group, offset parameters, a calibration vertex, an edge on
level 1) is built through either package's Graph API; the JAX Problem is
carried into the port with interop.problem_from_numpy.

* registry records: dimensions, tags, slots, parameter slots;
* build_problem: group order (poses before landmarks), pdata, indices;
* residuals and Jacobians of every edge group against JAX's `linearize`
  (jacfwd under vmap there, one forward-mode jvp here): rtol 1e-12, the same
  float64 operations differentiated by another forward-mode rule set;
* the forward-mode Jacobian of EDGE_SE2 against its analytic one (1e-12);
* the level filter: compile(level=1) against JAX;
* .g2o round trip of the new tags through save_g2o / loads_g2o, and a text
  saved by the JAX writer.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core import registry as jregistry
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.io.g2o_format import save_g2o as j_save_g2o
from openslam_g2o_tpu.utils import np_lie

from openslam_g2o_torch import loads_g2o, save_g2o
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core import registry as tregistry
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy

torch.set_num_threads(1)

RTOL = 1e-12
VERTEX_TYPES = ("se2", "point_xy")
EDGE_TYPES = ("edge_se2", "edge_se2_xy", "edge_se2_xy_bearing",
              "edge_se2_prior", "edge_se2_prior_xy", "edge_se2_xy_calib",
              "edge_se2_offset", "edge_se2_xy_offset")


def build_all_types_graph(Graph, seed=11, n=12, n_lm=6):
    """Every 2D type in one graph, through either package's Graph API."""
    rng = np.random.default_rng(seed)
    g = Graph()
    gt = [np.array([0.5, -0.3, 0.2])]
    for _ in range(n - 1):
        gt.append(np_lie.se2_compose(gt[-1], np.array([1.0, 0.1, 0.45])))
    lms = rng.uniform(-3, 6, size=(n_lm, 2))
    calib = np.array([0.1, -0.05, 0.03])
    off_a, off_b = np.array([0.2, 0.0, 0.1]), np.array([-0.1, 0.15, -0.2])
    g.add_parameter(0, "se2_offset", off_a)
    g.add_parameter(7, "se2_offset", off_b)
    for i, p in enumerate(gt):
        g.add_vertex(i, "se2", p + rng.normal(0, 0.05, 3), fixed=i in (0, 5))
    for k, l in enumerate(lms):
        g.add_vertex(100 + k, "point_xy", l + rng.normal(0, 0.1, 2),
                     fixed=k == 2)
    g.add_vertex(50, "se2", calib + rng.normal(0, 0.01, 3))   # calibration
    sym = lambda d: (lambda m: m @ m.T + d * np.eye(len(m)))(
        rng.normal(size=(d, d)))
    rel = lambda a, b: np_lie.se2_compose(np_lie.se2_inverse(a), b)
    for i in range(n - 1):
        g.add_edge("edge_se2", (i, i + 1),
                   rel(gt[i], gt[i + 1]) + rng.normal(0, 0.02, 3), sym(3))
    g.add_edge("edge_se2", (8, 1), rel(gt[8], gt[1]), sym(3), kernel="Cauchy",
               kernel_delta=0.7)
    g.add_edge("edge_se2", (2, 9), rel(gt[2], gt[9]) + 0.5, sym(3),
               kernel="Cauchy", kernel_delta=0.7)
    for i in range(n):
        for k in ((i + 0) % n_lm, (i + 2) % n_lm):
            local = np_lie.se2_apply(np_lie.se2_inverse(gt[i]), lms[k])
            g.add_edge("edge_se2_xy", (i, 100 + k),
                       local + rng.normal(0, 0.03, 2), sym(2))
        k = (i + 1) % n_lm
        local = np_lie.se2_apply(np_lie.se2_inverse(gt[i]), lms[k])
        g.add_edge("edge_se2_xy_bearing", (i, 100 + k),
                   [np.arctan2(local[1], local[0]) + rng.normal(0, 0.01)],
                   [[400.0]])
    g.add_edge("edge_se2_prior", (3,), gt[3] + rng.normal(0, 0.02, 3), sym(3))
    g.add_edge("edge_se2_prior", (5,), gt[5], sym(3))          # fixed vertex
    g.add_edge("edge_se2_prior_xy", (7,), gt[7][:2] + 0.01, sym(2))
    for i in (1, 4, 6, 10):
        sensor = np_lie.se2_compose(gt[i], calib)
        local = np_lie.se2_apply(np_lie.se2_inverse(sensor), lms[i % n_lm])
        g.add_edge("edge_se2_xy_calib", (i, 100 + i % n_lm, 50),
                   local + rng.normal(0, 0.03, 2), sym(2))
    for i, j in ((0, 4), (6, 3), (9, 11)):
        si = np_lie.se2_compose(gt[i], off_a)
        sj = np_lie.se2_compose(gt[j], off_b)
        g.add_edge("edge_se2_offset", (i, j),
                   rel(si, sj) + rng.normal(0, 0.02, 3), sym(3),
                   param_ids=(0, 7))
    for i in (2, 8):
        sensor = np_lie.se2_compose(gt[i], off_b)
        local = np_lie.se2_apply(np_lie.se2_inverse(sensor), lms[3])
        g.add_edge("edge_se2_xy_offset", (i, 103),
                   local + rng.normal(0, 0.03, 2), sym(2), param_ids=(7,))
    # a second level: one more closure and one more observation
    g.add_edge("edge_se2", (0, 10), rel(gt[0], gt[10]), sym(3), level=1)
    g.add_edge("edge_se2_xy", (4, 101),
               np_lie.se2_apply(np_lie.se2_inverse(gt[4]), lms[1]), sym(2),
               level=1)
    return g


@pytest.fixture(scope="module")
def pair():
    jprob = build_all_types_graph(JGraph).compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    return jprob, tprob


@pytest.mark.parametrize("name", VERTEX_TYPES)
def test_vertex_type_records_match(name):
    jt, tt = jregistry.vertex_type(name), tregistry.vertex_type(name)
    for f in ("tag", "ambient_dim", "tangent_dim", "marginalizable", "io_dim"):
        assert getattr(jt, f) == getattr(tt, f), f
    np.testing.assert_array_equal(np.asarray(jt.origin(jnp.float64)),
                                  tt.origin(torch.float64).numpy())


@pytest.mark.parametrize("name", EDGE_TYPES)
def test_edge_type_records_match(name):
    je, te = jregistry.edge_type(name), tregistry.edge_type(name)
    for f in ("tag", "vertex_types", "error_dim", "measurement_dim",
              "param_types", "io_meas_dim"):
        assert getattr(je, f) == getattr(te, f), f
    assert (je.jacobian is None) == (te.jacobian is None)
    assert (je.initial_estimate is None) == (te.initial_estimate is None)
    assert tregistry.edge_type_by_tag(je.tag) is te


def test_parameter_type_record_matches():
    jp = jregistry.parameter_type("se2_offset")
    tp = tregistry.parameter_type("se2_offset")
    assert (jp.tag, jp.dim, jp.io_dim) == (tp.tag, tp.dim, tp.io_dim)
    assert tregistry.parameter_type_by_tag("PARAMS_SE2OFFSET") is tp


def test_initial_estimate_of_landmark_edge():
    te = tregistry.edge_type("edge_se2_xy")
    je = jregistry.edge_type("edge_se2_xy")
    x, z = np.array([1.0, 2.0, 0.7]), np.array([0.5, -0.25])
    np.testing.assert_array_equal(te.initial_estimate((x, None), z, (), 1),
                                  je.initial_estimate((x, None), z, (), 1))
    assert te.initial_estimate((None, z), z, (), 0) is None


@pytest.mark.parametrize("level", [0, 1])
def test_build_problem_matches_jax(level):
    """The port's own lowering of the same graph (level 0 and the level
    filter) against JAX's: group order, tangent offsets, every array."""
    jprob = build_all_types_graph(JGraph).compile(dtype=jnp.float64,
                                                  level=level)
    tprob = build_all_types_graph(TGraph).compile(device="cpu", level=level)
    assert [g.name for g in tprob.static.vgroups] == ["se2", "point_xy"]
    assert ([(g.name, g.count, g.offset) for g in tprob.static.vgroups]
            == [(g.name, g.count, g.offset) for g in jprob.static.vgroups])
    assert tprob.static.total_dim == jprob.static.total_dim
    assert tprob.static.pose_dim == jprob.static.pose_dim
    ja, ta = problem_arrays(jprob), problem_arrays(tprob)
    assert list(ta["edges"]) == list(ja["edges"])
    if level == 1:
        assert list(ta["edges"]) == ["edge_se2", "edge_se2_xy"]
        assert [eg.count for eg in tprob.static.egroups] == [1, 1]
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
                               float(jproblem.robust_chi2(jprob)), rtol=RTOL)


def test_interop_carries_pdata_and_groups(pair):
    jprob, tprob = pair
    assert [g.name for g in tprob.static.vgroups] == ["se2", "point_xy"]
    assert len(tprob.edges["edge_se2_offset"].pdata) == 2
    assert len(tprob.edges["edge_se2_xy_offset"].pdata) == 1
    np.testing.assert_array_equal(
        tprob.edges["edge_se2_offset"].pdata[1].numpy(),
        np.asarray(jprob.edges["edge_se2_offset"].pdata[1]))
    assert "edge_se2#Cauchy" in tprob.edges
    assert set(eg.etype.name for eg in tprob.static.egroups) == set(EDGE_TYPES)


def _group_keys():
    return list(problem_arrays(
        build_all_types_graph(JGraph).compile(dtype=jnp.float64))["edges"])


@pytest.mark.parametrize("key", _group_keys())
def test_error_and_jacobians_match_jax(pair, key):
    jprob, tprob = pair
    jr, jjacs, jw = jproblem.linearize(jprob)[key]
    tr, tjacs, tw = tproblem.linearize(tprob)[key]
    np.testing.assert_allclose(
        tproblem.compute_errors(tprob)[key].numpy(),
        np.asarray(jproblem.compute_errors(jprob)[key]), rtol=RTOL,
        atol=1e-14)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL,
                               atol=1e-14)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL)
    assert len(tjacs) == len(jjacs)
    for tj, jj in zip(tjacs, jjacs):
        assert tuple(tj.shape) == jj.shape
        np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=RTOL,
                                   atol=1e-13)
    # fixed vertices' columns are zero
    eg = next(e for e in tprob.static.egroups if e.key == key)
    for s, gname in enumerate(eg.slots):
        fixed = tprob.free[gname][tprob.edges[key].indices[s].long()] == 0
        assert (tjacs[s][fixed] == 0).all()


def test_forward_jacobian_equals_analytic_edge_se2(pair):
    _, tprob = pair
    eg = next(e for e in tprob.static.egroups if e.key == "edge_se2")
    ea = tprob.edges["edge_se2"]
    vp = tproblem._gather_vertex_params(eg, ea, tprob.params)
    analytic = eg.etype.jacobian(vp, ea.measurement, ea.pdata)
    forward = tproblem.forward_jacobians(eg, vp, ea.measurement, ea.pdata)
    for a, f in zip(analytic, forward):
        np.testing.assert_allclose(f.numpy(), a.numpy(), rtol=RTOL,
                                   atol=1e-13)


def test_forward_jacobian_of_registered_log_edge():
    """The user-registered error of tests/test_nan_trial_retry.py,
    log(1 - x), goes through the forward-mode linearizer."""
    name = "edge_log_forward_test"
    if name not in tregistry._EDGE_TYPES:
        tregistry.register_edge_type(tregistry.EdgeType(
            name=name, tag="EDGE_LOG_FORWARD_TEST",
            vertex_types=("point_xy",), error_dim=2, measurement_dim=1,
            error=lambda vp, meas, pdata: torch.stack(
                [torch.log(1.0 - vp[0][..., 0]) - meas[..., 0],
                 vp[0][..., 1]], dim=-1)))
    g = TGraph()
    g.add_vertex(0, "point_xy", [0.25, 0.5])
    g.add_edge(name, (0,), [-2.0], np.eye(2))
    prob = g.compile(device="cpu")
    resid, (jac,), w = tproblem.linearize(prob)[name]
    np.testing.assert_allclose(resid.numpy(), [[np.log(0.75) + 2.0, 0.5]],
                               rtol=RTOL)
    np.testing.assert_allclose(jac.numpy(), [[[-1.0 / 0.75, 0.0], [0.0, 1.0]]],
                               rtol=RTOL)


def test_g2o_round_trip_of_the_2d_tags():
    g = build_all_types_graph(TGraph)
    text = save_g2o(g)
    for tag in ("VERTEX_XY", "PARAMS_SE2OFFSET", "EDGE_SE2_XY",
                "EDGE_BEARING_SE2_XY", "EDGE_PRIOR_SE2", "EDGE_PRIOR_SE2_XY",
                "EDGE_SE2_XY_CALIB", "EDGE_SE2_OFFSET",
                "EDGE_SE2_POINTXY_OFFSET"):
        assert any(ln.startswith(tag + " ") for ln in text.splitlines()), tag
    g2 = loads_g2o(text)
    assert list(g2.vertices) == list(g.vertices)
    assert sorted(g2.parameters) == [0, 7]
    for pid in (0, 7):
        np.testing.assert_array_equal(g2.parameters[pid][1],
                                      g.parameters[pid][1])
    assert [v for v in g2.vertices if g2.vertices[v].fixed] == [0, 5, 102]
    assert len(g2.edges) == len(g.edges)
    for a, b in zip(g2.edges, g.edges):
        assert a.etype is b.etype and a.vertex_ids == b.vertex_ids
        assert a.param_ids == b.param_ids
        np.testing.assert_array_equal(a.measurement, b.measurement)
        np.testing.assert_allclose(a.information, b.information, rtol=1e-15)
    # the format carries neither robust kernels nor levels: the reloaded
    # graph equals the original with both stripped
    for e in g.edges:
        e.kernel, e.level = "None", 0
    p1 = g.compile(device="cpu")
    p2 = g2.compile(device="cpu")
    assert float(tproblem.robust_chi2(p1)) == float(tproblem.robust_chi2(p2))


def test_jax_saved_2d_graph_loads_in_port():
    text = j_save_g2o(build_all_types_graph(JGraph))
    tg = loads_g2o(text)
    ref = build_all_types_graph(TGraph)
    assert tg.num_vertices() == ref.num_vertices()
    assert tg.num_edges() == ref.num_edges()
    assert [e.etype.name for e in tg.edges] == [e.etype.name
                                                for e in ref.edges]
    for a, b in zip(tg.edges, ref.edges):
        np.testing.assert_array_equal(a.measurement, b.measurement)
        assert a.param_ids == b.param_ids
