"""K17's slice as a whole on phase 4o's worlds (chip_smoke.py
`world2d_all_graph`, `world3d_all_graph`, `sba_all_graph`), and two branches
of its error functions, float64 on the CPU against the JAX package:

* the dense LM on each world, small, against JAX's chi2 trajectory to rtol
  1e-7 (the dense route's float64 precedent: factorizations and sums in
  another order): every edge type without a scene of another phase goes
  through `linearize_group` in one run;
* a bearing whose angle crosses +-pi (the floor wrap, derivative 1), and an
  EDGE_SE3:EXPMAP edge at its measurement (theta^2 = 0: the Taylor branches
  of so3_log and se3_log): the plain version's residual, Jacobians and
  rho' against JAX's `linearize` to rtol 1e-12, floor 1e-12 of the largest
  entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scenes
from openslam_g2o_tpu.core import algorithms as jalg
from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.utils import np_lie

from openslam_g2o_torch.core import algorithms as talg
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy

torch.set_num_threads(1)

RTOL = 1e-12
RTOL_DENSE = 1e-7


def _small_quat(rng, scale):
    v = rng.normal(0, scale, 3)
    return np.array([*v, np.sqrt(1 - v @ v)])


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=RTOL,
                               atol=1e-12 * max(float(np.abs(j).max()), 1.0))


@pytest.mark.parametrize("world", ["2d", "3d", "sba"])
def test_dense_lm_on_phase_4o_worlds_matches_jax(world):
    """The dense LM on phase 4o's three worlds of chip_smoke.py, small, under
    their own kernels (none), against JAX's trajectory: every type of the
    slice through `linearize_group` in one run."""
    make, size = {"2d": (scenes.world2d_all_graph, (60, 45)),
                  "3d": (scenes.world3d_all_graph, (40, 30)),
                  "sba": (scenes.sba_all_graph, (24, 50))}[world]
    jprob = make(JGraph, *size, seed=1).compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    _, jst = jalg.optimize(jprob, jalg.LevenbergMarquardt(), iterations=8)
    _, tst = talg.optimize(tprob, talg.LevenbergMarquardt(), iterations=8)
    jchi, tchi = [s["chi2"] for s in jst], [s["chi2"] for s in tst]
    np.testing.assert_allclose(tchi, jchi, rtol=RTOL_DENSE)
    chi0 = float(tproblem.robust_chi2(tprob))
    assert tchi[-1] < 0.05 * chi0 and np.all(np.diff([chi0] + tchi) <= 0)


def _linearize_both(jg, key):
    """The plain version's and JAX's linearization of group `key`."""
    jprob = jg.compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    eg = next(e for e in tprob.static.egroups if e.key == key)
    return (tproblem.linearize_group(tprob, eg),
            jproblem.linearize(jprob)[key])


def test_bearing_across_pi_matches_jax():
    """Landmarks behind the robot, bearings within 0.05 rad of +-pi, half
    the measurements on the other side of the cut: the wrapped residual
    and its derivative (1 through the floor) against JAX."""
    g = JGraph()
    poses = (np.array([1.0, -2.0, 0.4]), np.array([1.01, -1.98, 0.401]))
    for i, pose in enumerate(poses):
        g.add_vertex(i, "se2", pose, fixed=(i == 0))
    for k, dy in enumerate((-0.2, -0.05, 0.05, 0.2)):
        g.add_vertex(10 + k, "point_xy",
                     np_lie.se2_apply(poses[0], np.array([-5.0, dy])))
        bearing = np.arctan2(dy, -5.0)
        for i in range(2):
            g.add_edge("edge_se2_xy_bearing", (i, 10 + k),
                       [-bearing if k % 2 else bearing], np.eye(1) * 4.0)
    (resid, jacs, rho1), (jr, jj, jw) = _linearize_both(
        g, "edge_se2_xy_bearing")
    assert float(resid.abs().max()) > 0.05            # across the cut
    assert float(resid.abs().max()) < 0.5
    _close(resid, jr)
    _close(rho1, jw)
    for t_, j_ in zip(jacs, jj):
        _close(t_, j_)
    assert float(jacs[1].abs().max()) > 0.1


def test_se3_expmap_at_its_measurement_matches_jax():
    """An EDGE_SE3:EXPMAP edge whose measurement is exactly T2 T1^-1:
    the error is the identity's logarithm (theta^2 = 0, the Taylor
    branches of so3_log and se3_log), and its Jacobian against JAX's."""
    rng = np.random.default_rng(4)
    g = JGraph()
    poses = [np.concatenate([rng.normal(0, 0.5, 3), _small_quat(rng, 0.2)])
             for _ in range(3)]
    for i, p in enumerate(poses):
        g.add_vertex(i, "se3_expmap", p, fixed=(i == 0))
    for i, j in ((0, 1), (1, 2), (0, 2)):
        z = np_lie.se3_compose(poses[j], np_lie.se3_inverse(poses[i]))
        g.add_edge("edge_se3_expmap", (i, j), z, np.eye(6))
    (resid, jacs, rho1), (jr, jj, jw) = _linearize_both(g, "edge_se3_expmap")
    assert float(resid.abs().max()) < 1e-7
    _close(resid, jr)
    _close(rho1, jw)
    for t_, j_ in zip(jacs, jj):
        _close(t_, j_)
    assert float(jacs[1].abs().max()) > 0.5
