"""Host graph, .g2o I/O and the synthetic generator of the port, against
the JAX package: parse semantics on the 2D lines of tests/test_io.py, a
save/load round trip, a graph saved by the JAX writer and loaded by the
port, and identical synthetic arrays from one seed (exact equality: both
run the same numpy code)."""
import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.apps.simulator import (
    synthetic_pose_graph_2d as j_synthetic)
from openslam_g2o_tpu.io.g2o_format import loads_g2o as j_loads_g2o
from openslam_g2o_tpu.io.g2o_format import save_g2o as j_save_g2o

from openslam_g2o_torch import Graph, load_g2o, loads_g2o, save_g2o
from openslam_g2o_torch.apps.simulator import (
    synthetic_pose_graph_2d as t_synthetic)
from openslam_g2o_torch.core import registry
from openslam_g2o_torch.interop import problem_arrays
from tests.test_torch_assembly import make_jax_graph

torch.set_num_threads(1)

SAMPLE = """
# a comment line
VERTEX_SE2 0 0.1 0.2 0.3
VERTEX_SE2 1 1.0 0.0 0.0
VERTEX_XY 5 2.5 -1.5
FIX 0
EDGE_SE2 0 1 0.9 0.05 -0.1 500 0 0 500 0 5000
EDGE_SE2_XY 1 5 1.5 -1.5 1000 0 1000
VERTEX_TRACKXYZ 9 1.0 2.0 3.0
VERTEX_SIM3:EXPMAP 12 0 0 0 0 0 0 1 1
"""


def test_parse_basic_and_unknown_tags_skipped(capsys):
    g = loads_g2o(SAMPLE)
    # the 2D tags and VERTEX_TRACKXYZ (a 3D type) load; VERTEX_SIM3:EXPMAP
    # is not ported and is skipped like any unknown tag
    assert g.num_vertices() == 4 and g.num_edges() == 2
    err = capsys.readouterr().err
    assert "skipped unknown tags" in err and "VERTEX_SIM3:EXPMAP" in err
    assert "VERTEX_XY" not in err and "EDGE_SE2_XY" not in err
    assert "VERTEX_TRACKXYZ" not in err
    assert g.vertices[9].vtype.name == "point_xyz"
    np.testing.assert_allclose(g.vertices[9].params, [1.0, 2.0, 3.0])
    assert g.vertices[5].vtype.name == "point_xy"
    np.testing.assert_allclose(g.vertices[5].params, [2.5, -1.5])
    assert g.edges[1].etype.name == "edge_se2_xy"
    np.testing.assert_allclose(g.edges[1].information,
                               [[1000, 0], [0, 1000]])
    assert g.vertices[0].fixed and not g.vertices[1].fixed
    np.testing.assert_allclose(g.vertices[0].params, [0.1, 0.2, 0.3])
    e = g.edges[0]
    np.testing.assert_allclose(e.measurement, [0.9, 0.05, -0.1])
    np.testing.assert_allclose(
        e.information, [[500, 0, 0], [0, 500, 0], [0, 0, 5000]])


def test_information_upper_triangle_symmetrized():
    g = loads_g2o("VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 0 0 0\n"
                  "EDGE_SE2 0 1 0 0 0 1 2 3 4 5 6\n")
    np.testing.assert_allclose(g.edges[0].information,
                               [[1, 2, 3], [2, 4, 5], [3, 5, 6]])


def test_auto_create_missing_vertices():
    g = loads_g2o("VERTEX_SE2 0 1 2 3\nEDGE_SE2 0 7 0 0 0 1 0 0 1 0 1\n")
    assert 7 in g.vertices
    np.testing.assert_allclose(g.vertices[7].params, [0, 0, 0])


def test_roundtrip():
    g = loads_g2o(SAMPLE)
    g2 = loads_g2o(save_g2o(g))
    assert g2.num_vertices() == g.num_vertices()
    assert g2.num_edges() == g.num_edges()
    assert g2.vertices[0].fixed
    for vid in g.vertices:
        np.testing.assert_array_equal(g2.vertices[vid].params,
                                      g.vertices[vid].params)
    np.testing.assert_array_equal(g2.edges[0].measurement,
                                  g.edges[0].measurement)
    np.testing.assert_array_equal(g2.edges[0].information,
                                  g.edges[0].information)
    buf = io.StringIO(save_g2o(g))
    assert load_g2o(buf).num_edges() == 2


def test_jax_saved_graph_loads_in_port():
    """A graph written by the JAX writer loads in the port, and compiles to
    the arrays the JAX loader gives for the same text (the .g2o format
    carries no robust kernel, so both see plain EDGE_SE2 edges)."""
    jg = make_jax_graph()
    text = j_save_g2o(jg)
    tg = loads_g2o(text)
    assert tg.num_vertices() == jg.num_vertices()
    assert tg.num_edges() == jg.num_edges()
    assert [v for v in tg.vertices if tg.vertices[v].fixed] == [0, 17]
    ja = problem_arrays(j_loads_g2o(text).compile(dtype=jnp.float64))
    ta = problem_arrays(tg.compile(dtype=torch.float64, device="cpu"))
    np.testing.assert_array_equal(ta["params"]["se2"], ja["params"]["se2"])
    np.testing.assert_array_equal(ta["free"]["se2"], ja["free"]["se2"])
    assert list(ta["edges"]) == list(ja["edges"])
    for key, e in ja["edges"].items():
        for f in ("measurement", "information", "delta"):
            np.testing.assert_array_equal(ta["edges"][key][f], e[f])
        for a, b in zip(ta["edges"][key]["indices"], e["indices"]):
            np.testing.assert_array_equal(a, b)


def test_synthetic_pose_graph_matches_jax():
    jprob, jinfo = j_synthetic(n_poses=2000, grid=20)
    tprob, tinfo = t_synthetic(n_poses=2000, grid=20, device="cpu")
    assert tinfo["n_edges"] == jinfo["n_edges"]
    assert tinfo["noise_floor_chi2"] == jinfo["noise_floor_chi2"]
    np.testing.assert_array_equal(tinfo["gt"], jinfo["gt"])
    ja, ta = problem_arrays(jprob), problem_arrays(tprob)
    np.testing.assert_array_equal(ta["params"]["se2"], ja["params"]["se2"])
    np.testing.assert_array_equal(ta["free"]["se2"], ja["free"]["se2"])
    for f in ("measurement", "information", "delta", "kernel_id"):
        np.testing.assert_array_equal(ta["edges"]["edge_se2"][f],
                                      ja["edges"]["edge_se2"][f])
    for a, b in zip(ta["edges"]["edge_se2"]["indices"],
                    ja["edges"]["edge_se2"]["indices"]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32
    assert tprob.dtype == torch.float64 and tprob.device.type == "cpu"


def test_gauge_and_compile_dtype():
    g = loads_g2o("VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 1 0 0\n"
                  "VERTEX_SE2 2 2 0 0\n"
                  "EDGE_SE2 0 1 1 0 0 1 0 0 1 0 1\n"
                  "EDGE_SE2 1 2 1 0 0 1 0 0 1 0 1\n")
    assert g.gauge_freedom()
    assert g.find_gauge() == 1
    g.set_fixed(g.find_gauge(), True)
    assert not g.gauge_freedom()
    prob = g.compile(dtype=torch.float32, device="cpu")
    assert prob.params["se2"].dtype == torch.float32
    assert prob.free["se2"].tolist() == [1.0, 0.0, 1.0]


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: compile(device='cuda') is valid here")
    g = loads_g2o("VERTEX_SE2 0 0 0 0\n")
    with pytest.raises(RuntimeError, match="cuda"):
        g.compile(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        t_synthetic(n_poses=10, grid=3, device="cuda")


def test_default_device_is_the_card_and_never_falls_back():
    """compile(), build_problem() and the generator default to "cuda": with
    no GPU they raise RuntimeError instead of building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from openslam_g2o_torch.core.problem import build_problem, resolve_device
    g = loads_g2o("VERTEX_SE2 0 0 0 0\n")
    with pytest.raises(RuntimeError, match="cuda"):
        g.compile()
    with pytest.raises(RuntimeError, match="cuda"):
        g.compile(dtype=torch.float32, device=None)
    with pytest.raises(RuntimeError, match="cuda"):
        build_problem(g)
    with pytest.raises(RuntimeError, match="cuda"):
        t_synthetic(n_poses=10, grid=3)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    assert g.compile(device="cpu").device == torch.device("cpu")


def test_unported_type_raises_not_implemented():
    name = "point_xy_not_ported"
    if name not in registry.registered_vertex_types():
        registry.register_vertex_type(registry.VertexType(
            name=name, tag="VERTEX_XY_NOT_PORTED", ambient_dim=2,
            tangent_dim=2, retract=lambda p, d: p + d,
            origin=lambda dtype: torch.zeros(2, dtype=dtype)))
    g = Graph()
    g.add_vertex(0, name, [0.0, 0.0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        g.compile(device="cpu")
