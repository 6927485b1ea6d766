"""Synthetic SE2 pose graph at 100k-pose scale: counterpart of
`synthetic_pose_graph_2d` in openslam_g2o_tpu/apps/simulator.py:274-392.

The graph is drawn with numpy's `default_rng(seed)` in exactly the JAX
package's order, so both packages build identical arrays from one seed; it
is built directly into the Problem (vertex 0 fixed, one information matrix
tiled over the edges), bypassing Graph as the JAX generator does.
"""
from __future__ import annotations

import numpy as np
import torch

from openslam_g2o_torch.core import registry, robust
from openslam_g2o_torch.core import problem as P
from openslam_g2o_torch.utils import np_lie


def synthetic_pose_graph_2d(n_poses: int = 100000, grid: int = 100,
                            trans_noise: float = 0.05,
                            rot_noise: float = 0.01,
                            closure_prob: float = 0.5, seed: int = 0,
                            dtype: torch.dtype = torch.float64,
                            device=None):
    """Serpentine sweeps over a grid x grid lattice, repeated until n_poses,
    with loop closures to the pose one sweep earlier in the same cell.
    Noise is drawn with the sigmas the information matrix encodes, so the
    converged chi2 has the computable noise floor 3E - 3(N-1).

    The Problem is built on `device`; None means "cuda" and raises where
    there is no GPU (pass device="cpu" for the CPU).

    Returns (Problem, {"gt", "n_edges", "noise_floor_chi2"})."""
    device = P.resolve_device(device)
    rng = np.random.default_rng(seed)
    N = n_poses
    sweep = grid * grid

    i = np.arange(N)
    cell = i % sweep
    row = cell // grid
    col_in = cell % grid
    col = np.where(row % 2 == 0, col_in, grid - 1 - col_in)
    srow = np.where((i // sweep) % 2 == 0, row, grid - 1 - row)
    x = col.astype(np.float64)
    y = srow.astype(np.float64)

    dx = np.diff(x, append=x[-1])
    dy = np.diff(y, append=y[-1])
    dx[-1], dy[-1] = dx[-2], dy[-2]
    theta = np.arctan2(dy, dx)
    gt = np.stack([x, y, theta], axis=1)

    ii_o = np.arange(N - 1)
    jj_o = ii_o + 1
    c, s = np.cos(theta[ii_o]), np.sin(theta[ii_o])
    rdx = x[jj_o] - x[ii_o]
    rdy = y[jj_o] - y[ii_o]
    z_odo = np.stack([c * rdx + s * rdy, -s * rdx + c * rdy,
                      np_lie.normalize_angle(theta[jj_o] - theta[ii_o])],
                     axis=1)
    z_odo[:, :2] += rng.normal(0, trans_noise, (N - 1, 2))
    z_odo[:, 2] = np_lie.normalize_angle(
        z_odo[:, 2] + rng.normal(0, rot_noise, N - 1))

    cand = np.arange(sweep, N)
    cand = cand[rng.random(len(cand)) < closure_prob]
    ii_c = cand - sweep
    jj_c = cand
    c, s = np.cos(theta[ii_c]), np.sin(theta[ii_c])
    rdx = x[jj_c] - x[ii_c]
    rdy = y[jj_c] - y[ii_c]
    z_clo = np.stack([c * rdx + s * rdy, -s * rdx + c * rdy,
                      np_lie.normalize_angle(theta[jj_c] - theta[ii_c])],
                     axis=1)
    z_clo[:, :2] += rng.normal(0, trans_noise, (len(cand), 2))
    z_clo[:, 2] = np_lie.normalize_angle(
        z_clo[:, 2] + rng.normal(0, rot_noise, len(cand)))

    ii = np.concatenate([ii_o, ii_c]).astype(np.int32)
    jj = np.concatenate([jj_o, jj_c]).astype(np.int32)
    meas = np.concatenate([z_odo, z_clo])
    E = len(meas)
    info = np.diag([1.0 / trans_noise ** 2, 1.0 / trans_noise ** 2,
                    1.0 / rot_noise ** 2])

    # noisy init: integrate the noisy odometry chain
    th0 = theta[0] + np.concatenate([[0.0], np.cumsum(z_odo[:, 2])])
    cth, sth = np.cos(th0[:-1]), np.sin(th0[:-1])
    step = np.stack([cth * z_odo[:, 0] - sth * z_odo[:, 1],
                     sth * z_odo[:, 0] + cth * z_odo[:, 1]], axis=1)
    pos0 = np.concatenate([[gt[0, :2]], gt[0, :2] + np.cumsum(step, axis=0)])
    init = np.stack([pos0[:, 0], pos0[:, 1], np_lie.normalize_angle(th0)],
                    axis=1)

    vt = registry.vertex_type("se2")
    et = registry.edge_type("edge_se2")
    free = np.ones(N)
    free[0] = 0.0
    init[0] = gt[0]
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    static = P.ProblemStatic((P.VGroup("se2", vt, N, 0),),
                             (P.EGroup(et.name, et, robust.NONE_ID, E),),
                             3 * N, 3 * N)
    edges = {et.name: P.EdgeArrays(
        (torch.as_tensor(ii, device=device), torch.as_tensor(jj, device=device)),
        as_t(meas), as_t(np.broadcast_to(info, (E, 3, 3)).copy()),
        torch.ones((E,), dtype=dtype, device=device))}
    prob = P.Problem(params={"se2": as_t(init)}, free={"se2": as_t(free)},
                     edges=edges, static=static)
    return prob, {"gt": gt, "n_edges": E,
                  "noise_floor_chi2": 3.0 * E - 3.0 * (N - 1)}
