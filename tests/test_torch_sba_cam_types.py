"""The SBACam family and the anchored inverse-depth edge of the port
against the JAX package, float64 on the CPU.

* registry records and tags of VERTEX_CAM, VERTEX_INTRINSICS and the six
  edge types;
* every new error function (vmapped in JAX, batched in the port), the two
  retractions and invert_depth / depth_to_psi on random inputs from a
  numpy seed: rtol 1e-12 with an absolute floor of 1e-12 of the largest
  entry;
* one graph holding every new type (a shared intrinsics vertex, VERTEX_CAM
  cameras with one fixed, expmap cameras for the anchored edge, points with
  one fixed): residuals and the port's forward-mode Jacobians against JAX's
  jacfwd `linearize`, and the retraction through apply_update, same
  tolerance;
* the .g2o round trip of the new tags, VERTEX_CAM carrying camera-to-world
  in the file as in the graph, against JAX's save_g2o and loads_g2o.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core import registry as jregistry
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.io.g2o_format import loads_g2o as j_loads_g2o
from openslam_g2o_tpu.io.g2o_format import save_g2o as j_save_g2o
from openslam_g2o_tpu.models import sba as jsba
from openslam_g2o_tpu.utils import np_lie

from openslam_g2o_torch import loads_g2o, save_g2o
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core import registry as tregistry
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.models import sba as tsba

torch.set_num_threads(1)

RTOL = 1e-12
VERTEX_TYPES = ("cam", "intrinsics")
EDGE_TYPES = ("edge_project_psi2uv", "edge_project_p2mc",
              "edge_project_p2mc_intrinsics", "edge_project_p2sc",
              "edge_sba_cam", "edge_sba_scale")
K = np.array([510.0, 495.0, 318.0, 243.0, 0.09])    # fx, fy, cx, cy, b
CAMP = np.array([460.0, 300.0, 250.0, 0.1])          # focal, cx, cy, b


def _close(t, j):
    j = np.asarray(j)
    scale = max(float(np.abs(j).max()), 1.0)
    np.testing.assert_allclose(np.asarray(t), j, rtol=RTOL,
                               atol=1e-12 * scale)


def _quat(rng, scale, n=None):
    v = rng.normal(0, scale, (3,) if n is None else (n, 3))
    q = np.concatenate([v, np.ones_like(v[..., :1])], axis=-1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def build_sba_cam_graph(Graph, seed=4, n_cams=5, n_points=24):
    """Every new type in one graph, through either package's Graph API:
    VERTEX_INTRINSICS (added first), VERTEX_CAM cameras on a line looking
    down +z (camera 0 fixed), expmap cameras for the anchored edge, points
    (one fixed), P2MC / P2MC_INTRINSICS / P2SC observations, PSI2UV
    observations anchored at the point's first camera, EDGE_CAM and
    EDGE_SCALE between neighbouring cameras."""
    rng = np.random.default_rng(seed)
    g = Graph()
    g.add_parameter(0, "camera_parameters", CAMP)
    g.add_vertex(500, "intrinsics", K + rng.normal(0, 2.0, 5) * [1, 1, 1, 1, 0])
    cams, w2cs = [], []
    for i in range(n_cams):
        t = np.array([0.3 * i - 0.6, 0.05 * i, 0.0]) + rng.normal(0, 0.02, 3)
        c2w = np.concatenate([t, _quat(rng, 0.03)])
        cams.append(c2w)
        g.add_vertex(i, "cam", np.concatenate([c2w, K]), fixed=(i == 0))
        w2c = np_lie.se3_inverse(c2w)
        w2cs.append(w2c)
        g.add_vertex(100 + i, "se3_expmap", w2c, fixed=(i == 0))
    pts = rng.uniform(-1.5, 1.5, (n_points, 3)) + np.array([0, 0, 7.0])
    for j, p in enumerate(pts):
        g.add_vertex(1000 + j, "sba_point_xyz", p + rng.normal(0, 0.1, 3),
                     fixed=(j == 3), marginalized=True)
        pa = np_lie.se3_apply(w2cs[j % n_cams], p)
        g.add_vertex(2000 + j, "sba_point_xyz", np.array([pa[0], pa[1], 1.0])
                     / pa[2] + rng.normal(0, 0.01, 3), marginalized=True)
    eye2, eye3 = np.eye(2), np.eye(3)
    for j, p in enumerate(pts):
        for i in range(n_cams):
            noise = rng.normal(0, 0.5, 3)
            kind = (i + j) % 3
            if kind == 0:
                g.add_edge("edge_project_p2mc", (1000 + j, i),
                           rng.uniform(0, 640, 2), eye2 * 1.3)
            elif kind == 1:
                g.add_edge("edge_project_p2mc_intrinsics", (1000 + j, i, 500),
                           rng.uniform(0, 640, 2) + noise[:2], eye2)
            else:
                g.add_edge("edge_project_p2sc", (1000 + j, i),
                           rng.uniform(0, 640, 3), eye3 * 0.7)
            g.add_edge("edge_project_psi2uv",
                       (2000 + j, 100 + i, 100 + j % n_cams),
                       rng.uniform(0, 480, 2), eye2, param_ids=[0])
    for i in range(n_cams - 1):
        rel = np_lie.se3_compose(np_lie.se3_inverse(cams[i]), cams[i + 1])
        rel = np_lie.se3_compose(rel, np.concatenate(
            [rng.normal(0, 0.01, 3), _quat(rng, 0.01)]))
        info = np.diag(rng.uniform(1.0, 3.0, 6))
        g.add_edge("edge_sba_cam", (i, i + 1), rel, info)
        g.add_edge("edge_sba_scale", (i, i + 1),
                   [np.linalg.norm(cams[i][:3] - cams[i + 1][:3]) + 0.01],
                   np.eye(1) * 4.0)
    return g


@pytest.fixture(scope="module")
def pair():
    jprob = build_sba_cam_graph(JGraph).compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    return jprob, tprob


@pytest.mark.parametrize("name", VERTEX_TYPES)
def test_vertex_type_records_match(name):
    jt, tt = jregistry.vertex_type(name), tregistry.vertex_type(name)
    for f in ("tag", "ambient_dim", "tangent_dim", "marginalizable", "io_dim"):
        assert getattr(jt, f) == getattr(tt, f), f
    np.testing.assert_array_equal(np.asarray(jt.origin(jnp.float64)),
                                  tt.origin(torch.float64).numpy())
    assert tregistry.vertex_type_by_tag(jt.tag) is tt
    assert jt.from_file is None and tt.from_file is None


@pytest.mark.parametrize("name", EDGE_TYPES)
def test_edge_type_records_match(name):
    je, te = jregistry.edge_type(name), tregistry.edge_type(name)
    for f in ("tag", "vertex_types", "error_dim", "measurement_dim",
              "param_types", "io_meas_dim"):
        assert getattr(je, f) == getattr(te, f), f
    assert je.jacobian is None and te.jacobian is None   # forward mode
    assert tregistry.edge_type_by_tag(je.tag) is te


def _random_inputs(name, rng, n=64):
    """Per slot of `name`, n random vertex estimates; a measurement and
    the camera parameters."""
    pts = rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, 6.0])
    cam = np.concatenate([rng.normal(0, 0.3, (n, 3)), _quat(rng, 0.1, n),
                          np.tile(K, (n, 1)) + rng.normal(0, 3, (n, 5))], 1)
    w2c = np.concatenate([rng.normal(0, 0.3, (n, 3)), _quat(rng, 0.1, n)], 1)
    psi = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)),
                          rng.uniform(0.1, 0.3, (n, 1))], 1)
    intr = np.tile(K, (n, 1)) + rng.normal(0, 3, (n, 5))
    slots = {"edge_project_psi2uv": (psi, w2c, w2c[::-1].copy()),
             "edge_project_p2mc": (pts, cam),
             "edge_project_p2mc_intrinsics": (pts, cam, intr),
             "edge_project_p2sc": (pts, cam),
             "edge_sba_cam": (cam, cam[::-1].copy()),
             "edge_sba_scale": (cam, cam[::-1].copy())}[name]
    m = tregistry.edge_type(name).measurement_dim
    meas = rng.normal(0, 50, (n, m))
    if name == "edge_sba_cam":
        meas = np.concatenate([rng.normal(0, 0.3, (n, 3)),
                               _quat(rng, 0.1, n)], 1)
    pdata = ((np.tile(CAMP, (n, 1)),) if tregistry.edge_type(name).param_types
             else ())
    return slots, meas, pdata


@pytest.mark.parametrize("name", EDGE_TYPES)
def test_error_functions_match_jax(name):
    rng = np.random.default_rng(11)
    slots, meas, pdata = _random_inputs(name, rng)
    jerr = jax.vmap(lambda vp, m, pd: jregistry.edge_type(name).error(
        vp, m, pd))(tuple(jnp.asarray(s) for s in slots), jnp.asarray(meas),
                    tuple(jnp.asarray(p) for p in pdata))
    terr = tregistry.edge_type(name).error(
        tuple(torch.as_tensor(s) for s in slots), torch.as_tensor(meas),
        tuple(torch.as_tensor(p) for p in pdata))
    _close(terr.numpy(), jerr)


@pytest.mark.parametrize("name", VERTEX_TYPES)
def test_retractions_match_jax(name):
    rng = np.random.default_rng(2)
    n = 50
    if name == "cam":
        p = np.concatenate([rng.normal(0, 1, (n, 3)), _quat(rng, 0.3, n),
                            np.tile(K, (n, 1))], 1)
        d = rng.normal(0, 0.05, (n, 6))
    else:
        p = np.tile(K, (n, 1)) + rng.normal(0, 3, (n, 5))
        d = rng.normal(0, 2, (n, 4))
    jout = jax.vmap(jregistry.vertex_type(name).retract)(jnp.asarray(p),
                                                         jnp.asarray(d))
    tout = tregistry.vertex_type(name).retract(torch.as_tensor(p),
                                               torch.as_tensor(d))
    _close(tout.numpy(), jout)
    if name == "intrinsics":
        np.testing.assert_array_equal(tout[:, 4].numpy(), p[:, 4])


def test_inverse_depth_maps_match_jax():
    rng = np.random.default_rng(8)
    pa = rng.uniform(-1, 1, (40, 3)) + np.array([0, 0, 4.0])
    psi_j = jax.vmap(jsba.depth_to_psi)(jnp.asarray(pa))
    psi_t = tsba.depth_to_psi(torch.as_tensor(pa))
    _close(psi_t.numpy(), psi_j)
    _close(tsba.invert_depth(psi_t).numpy(), jax.vmap(jsba.invert_depth)(psi_j))
    _close(tsba.invert_depth(psi_t).numpy(), pa)


def test_build_problem_matches_jax():
    jprob = build_sba_cam_graph(JGraph).compile(dtype=jnp.float64)
    tprob = build_sba_cam_graph(TGraph).compile(device="cpu")
    layout = [(g.name, g.count, g.offset) for g in tprob.static.vgroups]
    assert layout == [(g.name, g.count, g.offset)
                      for g in jprob.static.vgroups]
    assert layout[0] == ("intrinsics", 1, 0)
    assert tprob.static.pose_dim == jprob.static.pose_dim == 4 + 5 * 6 * 2
    ja, ta = problem_arrays(jprob), problem_arrays(tprob)
    assert list(ta["edges"]) == list(ja["edges"])
    for k in ja["params"]:
        np.testing.assert_array_equal(ta["params"][k], ja["params"][k])
    np.testing.assert_allclose(float(tproblem.robust_chi2(tprob)),
                               float(jproblem.robust_chi2(jprob)), rtol=RTOL)


def test_residuals_and_forward_jacobians_match_jax(pair):
    jprob, tprob = pair
    jlin, tlin = jproblem.linearize(jprob), tproblem.linearize(tprob)
    assert set(jlin) == set(tlin) == set(EDGE_TYPES)
    for key in jlin:
        jr, jjacs, jw = jlin[key]
        tr, tjacs, tw = tlin[key]
        _close(tr.numpy(), jr)
        _close(tw.numpy(), jw)
        for tj, jj in zip(tjacs, jjacs, strict=True):
            _close(tj.numpy(), jj)


def test_retraction_through_apply_update_matches_jax(pair):
    jprob, tprob = pair
    rng = np.random.default_rng(3)
    dx = rng.normal(scale=0.05, size=jprob.static.total_dim)
    jnew = jproblem.apply_update(jprob, jnp.asarray(dx))
    tnew = tproblem.apply_update(tprob, torch.as_tensor(dx))
    for k in jnew:
        _close(tnew[k].numpy(), jnew[k])
    np.testing.assert_array_equal(tnew["cam"][0].numpy(),
                                  tprob.params["cam"][0].numpy())   # fixed
    np.testing.assert_allclose(float(tproblem.robust_chi2(tprob, tnew)),
                               float(jproblem.robust_chi2(jprob, jnew)),
                               rtol=RTOL)


def test_g2o_round_trip_of_the_new_tags():
    g = build_sba_cam_graph(TGraph)
    text = save_g2o(g)
    jtext = j_save_g2o(build_sba_cam_graph(JGraph))
    for tag in ("VERTEX_CAM", "VERTEX_INTRINSICS", "EDGE_PROJECT_P2MC",
                "EDGE_PROJECT_P2MC_INTRINSICS", "EDGE_PROJECT_P2SC",
                "EDGE_CAM", "EDGE_SCALE", "EDGE_PROJECT_PSI2UV:EXPMAP"):
        assert any(ln.startswith(tag + " ") for ln in text.splitlines()), tag
    assert text == jtext
    # VERTEX_CAM carries camera-to-world (t, q) and K in the file, as held
    line = next(ln for ln in text.splitlines() if ln.startswith("VERTEX_CAM 2 "))
    np.testing.assert_allclose([float(v) for v in line.split()[2:]],
                               g.vertices[2].params, rtol=1e-15)
    g2, g3 = loads_g2o(text), loads_g2o(jtext)
    jg = j_loads_g2o(text)
    for vid, rec in g.vertices.items():
        for other in (g2.vertices[vid].params, g3.vertices[vid].params,
                      np.asarray(jg.vertices[vid].params)):
            np.testing.assert_allclose(other, rec.params, rtol=1e-14,
                                       atol=1e-15)
    assert [e.etype.name for e in g2.edges] == [e.etype.name for e in g.edges]
    c = float(tproblem.robust_chi2(g.compile(device="cpu")))
    np.testing.assert_allclose(
        float(tproblem.robust_chi2(g2.compile(device="cpu"))), c, rtol=1e-12)
    np.testing.assert_allclose(
        float(jproblem.robust_chi2(jg.compile(dtype=jnp.float64))), c,
        rtol=1e-12)
