"""Simulator2D of the port against the JAX package's: the same seed gives
the same graph to the bit (vertices, fixed flags, edges in order with their
types, endpoints, measurements and information; ground truth), for
landmark, bearing-only and pose-only worlds. Both run the same numpy code on
one random stream; the port only narrows the loop-closure search with
numpy before the reference's own scalar test decides a pair."""
import numpy as np
import pytest
import torch

from openslam_g2o_tpu.apps.simulator import Simulator2D as JSimulator2D

from openslam_g2o_torch.apps.simulator import Simulator2D, _info_from_sigmas
from openslam_g2o_torch.core.algorithms import optimize
from openslam_g2o_torch.core.problem import robust_chi2

torch.set_num_threads(1)

CASES = {
    "landmarks_seed0": (dict(n_landmarks=20, seed=0), dict(n_poses=40)),
    "landmarks_seed7": (dict(n_landmarks=60, seed=7, world_size=12.0),
                        dict(n_poses=150)),
    "bearing_only": (dict(n_landmarks=30, seed=3, world_size=10.0),
                     dict(n_poses=80, bearing_only=True)),
    "poses_only": (dict(n_landmarks=5, seed=1, world_size=6.0,
                        trans_noise=(0.02, 0.02), rot_noise=0.005),
                   dict(n_poses=120, landmark_obs=False)),
    "no_closures": (dict(n_landmarks=10, seed=2),
                    dict(n_poses=50, loop_closures=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_simulator2d_graph_equals_jax(case):
    init, sim = CASES[case]
    jg, jgt = JSimulator2D(**init).simulate(**sim)
    tg, tgt = Simulator2D(**init).simulate(**sim)
    np.testing.assert_array_equal(tgt, jgt)
    assert list(tg.vertices) == list(jg.vertices)
    for vid, jv in jg.vertices.items():
        tv = tg.vertices[vid]
        assert tv.vtype.name == jv.vtype.name and tv.fixed == jv.fixed
        np.testing.assert_array_equal(tv.params, jv.params)
    assert len(tg.edges) == len(jg.edges)
    for te, je in zip(tg.edges, jg.edges):
        assert te.etype.name == je.etype.name
        assert te.vertex_ids == je.vertex_ids
        np.testing.assert_array_equal(te.measurement, je.measurement)
        np.testing.assert_array_equal(te.information, je.information)
    kinds = {e.etype.name for e in tg.edges}
    if case == "bearing_only":
        assert "edge_se2_xy_bearing" in kinds and "edge_se2_xy" not in kinds
    if case == "poses_only":
        assert kinds == {"edge_se2"} and len(tg.edges) > sim["n_poses"] - 1
    if case == "no_closures":
        n_odo = sum(e.etype.name == "edge_se2" for e in tg.edges)
        assert n_odo == sim["n_poses"] - 1


def test_info_from_sigmas():
    np.testing.assert_allclose(_info_from_sigmas([0.5, 0.1]),
                               np.diag([4.0, 100.0]))


def test_simulated_world_optimizes():
    g, gt = Simulator2D(n_landmarks=20, seed=0).simulate(40)
    prob = g.compile(device="cpu")
    chi0 = float(robust_chi2(prob))
    out, stats = optimize(prob, iterations=6)
    assert stats[-1]["chi2"] < 0.1 * chi0
    err = out.params["se2"].numpy()[:, :2] - gt[:, :2]
    assert np.sqrt((err ** 2).sum(axis=1).mean()) < 0.3
