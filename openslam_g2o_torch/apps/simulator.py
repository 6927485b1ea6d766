"""Synthetic dataset generators: counterpart of `Simulator2D`
(openslam_g2o_tpu/apps/simulator.py:31-126, the g2o_simulator2d equivalent:
a robot on a Manhattan walk among XY landmarks, emitting a Graph), of
`Simulator3D` (:129-207, a 3D random walk among XYZ landmarks seen through
an offset sensor), of `create_sphere` (:210-271, the sphere benchmark's pose
spiral) and of `synthetic_pose_graph_2d` (:274-392, the SE2 pose graph at
100k-pose scale, built directly into a Problem).

All draw from numpy's `default_rng(seed)` in exactly the JAX package's
order, so the two packages build identical graphs from one seed.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from openslam_g2o_torch.core import registry, robust
from openslam_g2o_torch.core import problem as P
from openslam_g2o_torch.core.graph import Graph
from openslam_g2o_torch.utils import np_lie

__all__ = ["Simulator2D", "Simulator3D", "create_sphere",
           "synthetic_pose_graph_2d"]


def _info_from_sigmas(sigmas):
    return np.diag(1.0 / np.asarray(sigmas) ** 2)


class Simulator2D:
    """2D robot in a planar world with landmarks (test_simulator2d.cpp).
    Sensors: odometry and pose loop closures (EDGE_SE2), landmark position
    (EDGE_SE2_XY) or bearing (EDGE_BEARING_SE2_XY). Noise is Gaussian on the
    measurement in its own space; information = inverse covariance."""

    def __init__(self, world_size: float = 25.0, n_landmarks: int = 100,
                 trans_noise=(0.05, 0.01), rot_noise=0.02,
                 landmark_noise=(0.05, 0.05), sensor_range: float = 3.0,
                 seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.world_size = world_size
        self.landmarks = self.rng.uniform(0, world_size, size=(n_landmarks, 2))
        self.trans_noise = trans_noise
        self.rot_noise = rot_noise
        self.landmark_noise = landmark_noise
        self.sensor_range = sensor_range

    def _motion(self, step: int):
        """Manhattan-style grid walk: mostly straight, occasional +-90
        degree turns."""
        if self.rng.random() < 0.25:
            turn = self.rng.choice([-1.0, 1.0]) * math.pi / 2
        else:
            turn = 0.0
        return np.array([1.0, 0.0, turn])

    def simulate(self, n_poses: int = 300, landmark_obs: bool = True,
                 bearing_only: bool = False, loop_closures: bool = True):
        """Returns (Graph, ground-truth poses [n_poses, 3]); vertex 0 is
        fixed, landmark ids start at 10000."""
        g = Graph()
        odo_sigmas = [*self.trans_noise, self.rot_noise]
        odo_info = _info_from_sigmas(odo_sigmas)
        lm_info = _info_from_sigmas(self.landmark_noise)
        bearing_info = _info_from_sigmas([self.rot_noise])

        gt = np.zeros((n_poses, 3))
        pose = np.array([self.world_size / 2, self.world_size / 2, 0.0])
        for i in range(n_poses):
            gt[i] = pose
            if i + 1 < n_poses:
                motion = self._motion(i)
                nxt = np_lie.se2_compose(pose, motion)
                # keep the robot in the world: turn around at the border
                if not (0 <= nxt[0] <= self.world_size
                        and 0 <= nxt[1] <= self.world_size):
                    motion = np.array([0.0, 0.0, math.pi / 2])
                    nxt = np_lie.se2_compose(pose, motion)
                pose = nxt

        def noisy_relative(i, j):
            z = np_lie.se2_compose(np_lie.se2_inverse(gt[i]), gt[j])
            zn = z + self.rng.normal(0, odo_sigmas)
            zn[2] = np_lie.normalize_angle(zn[2])
            return zn

        noisy = gt.copy()
        g.add_vertex(0, "se2", gt[0], fixed=True)
        for i in range(1, n_poses):
            zn = noisy_relative(i - 1, i)
            noisy[i] = np_lie.se2_compose(noisy[i - 1], zn)
            noisy[i][2] = np_lie.normalize_angle(noisy[i][2])
            g.add_vertex(i, "se2", noisy[i])
            g.add_edge("edge_se2", (i - 1, i), zn, odo_info)

        if loop_closures:
            # pose sensor: relative constraints to revisited poses. The
            # reference tests every pair (i, j >= i + 5) in a Python loop;
            # here numpy narrows each row to the pairs near the 1.0
            # threshold, and those are decided by the reference's own scalar
            # expression, so the random stream (one draw per close pair, in
            # (i, j) order) stays the same.
            for i in range(n_poses - 5):
                d = np.linalg.norm(gt[i + 5:, :2] - gt[i, :2], axis=1)
                for j in np.nonzero(d < 1.0 + 1e-6)[0] + i + 5:
                    if np.linalg.norm(gt[i][:2] - gt[j][:2]) < 1.0 \
                            and self.rng.random() < 0.3:
                        g.add_edge("edge_se2", (i, int(j)),
                                   noisy_relative(i, j), odo_info)

        lm_seen = set()
        if landmark_obs:
            for i in range(n_poses):
                d = np.linalg.norm(self.landmarks - gt[i][:2], axis=1)
                for li in np.nonzero(d < self.sensor_range)[0]:
                    vid = 10000 + int(li)
                    obs = np_lie.se2_apply(np_lie.se2_inverse(gt[i]),
                                           self.landmarks[li])
                    if vid not in lm_seen:
                        lm_seen.add(vid)
                        g.add_vertex(vid, "point_xy",
                                     np_lie.se2_apply(noisy[i], obs))
                    if bearing_only:
                        z = np.array([math.atan2(obs[1], obs[0])
                                      + self.rng.normal(0, self.rot_noise)])
                        g.add_edge("edge_se2_xy_bearing", (i, vid), z,
                                   bearing_info)
                    else:
                        zn = obs + self.rng.normal(0, self.landmark_noise)
                        g.add_edge("edge_se2_xy", (i, vid), zn, lm_info)

        return g, gt


class Simulator3D:
    """3D robot on a random walk with XYZ landmarks (test_simulator3d.cpp):
    odometry and pose closures (EDGE_SE3) and landmark observations through
    the offset parameter 0 (EDGE_SE3_TRACKXYZ)."""

    def __init__(self, world_size: float = 20.0, n_landmarks: int = 200,
                 trans_noise=(0.05, 0.05, 0.05), rot_noise=0.01,
                 landmark_noise=(0.05, 0.05, 0.05), sensor_range: float = 4.0,
                 seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.world_size = world_size
        self.landmarks = self.rng.uniform(0, world_size, size=(n_landmarks, 3))
        self.trans_noise = np.asarray(trans_noise)
        self.rot_noise = rot_noise
        self.landmark_noise = np.asarray(landmark_noise)
        self.sensor_range = sensor_range

    def _rand_quat(self, scale):
        v = self.rng.normal(0, scale, 3)
        w = math.sqrt(max(0.0, 1 - np.dot(v, v)))
        q = np.array([*v, w])
        return q / np.linalg.norm(q)

    def simulate(self, n_poses: int = 200, landmark_obs: bool = True,
                 loop_closures: bool = True):
        """Returns (Graph, ground-truth poses [n_poses, 7]); vertex 0 is
        fixed, landmark ids start at 10000."""
        g = Graph()
        g.add_parameter(0, "se3_offset", [0, 0, 0, 0, 0, 0, 1])
        odo_info = _info_from_sigmas([*self.trans_noise] + [self.rot_noise] * 3)
        lm_info = _info_from_sigmas(self.landmark_noise)

        gt = np.zeros((n_poses, 7))
        pose = np.array([self.world_size / 2, self.world_size / 2,
                         self.world_size / 2, 0, 0, 0, 1.0])
        for i in range(n_poses):
            gt[i] = pose
            if i + 1 < n_poses:
                motion = np.concatenate([[1.0, 0, 0], self._rand_quat(0.15)])
                nxt = np_lie.se3_compose(pose, motion)
                if not np.all((0 <= nxt[:3]) & (nxt[:3] <= self.world_size)):
                    # bounce: turn ~90 degrees about z
                    motion = np.concatenate(
                        [[0, 0, 0], [0, 0, math.sin(0.8), math.cos(0.8)]])
                    nxt = np_lie.se3_compose(pose, motion)
                pose = nxt

        noisy = gt.copy()
        g.add_vertex(0, "se3", gt[0], fixed=True)
        for i in range(1, n_poses):
            z = np_lie.se3_compose(np_lie.se3_inverse(gt[i - 1]), gt[i])
            dq = self._rand_quat(self.rot_noise)
            zn = np_lie.se3_compose(
                np.concatenate([self.rng.normal(0, self.trans_noise),
                                dq]), z)
            noisy[i] = np_lie.se3_compose(noisy[i - 1], zn)
            g.add_vertex(i, "se3", noisy[i])
            g.add_edge("edge_se3", (i - 1, i), zn, odo_info)

        if loop_closures:
            # every pair (i, j >= i + 5) in the reference's order; numpy
            # narrows each row to the pairs near the 1.5 threshold and the
            # reference's own scalar expression decides those, so the random
            # stream (one draw per close pair) stays the same
            for i in range(n_poses - 5):
                d = np.linalg.norm(gt[i + 5:, :3] - gt[i, :3], axis=1)
                for j in np.nonzero(d < 1.5 + 1e-6)[0] + i + 5:
                    if np.linalg.norm(gt[i][:3] - gt[j][:3]) < 1.5 \
                            and self.rng.random() < 0.3:
                        z = np_lie.se3_compose(np_lie.se3_inverse(gt[i]),
                                               gt[j])
                        g.add_edge("edge_se3", (i, int(j)), z, odo_info)

        if landmark_obs:
            seen = set()
            for i in range(n_poses):
                d = np.linalg.norm(self.landmarks - gt[i][:3], axis=1)
                for li in np.nonzero(d < self.sensor_range)[0]:
                    vid = 10000 + int(li)
                    obs = np_lie.se3_apply(np_lie.se3_inverse(gt[i]),
                                           self.landmarks[li])
                    if vid not in seen:
                        seen.add(vid)
                        g.add_vertex(vid, "point_xyz",
                                     np_lie.se3_apply(noisy[i], obs))
                    zn = obs + self.rng.normal(0, self.landmark_noise)
                    g.add_edge("edge_se3_xyz", (i, vid), zn, lm_info,
                               param_ids=[0])
        return g, gt


def create_sphere(n_laps: int = 50, n_per_lap: int = 50, radius: float = 100.0,
                  trans_noise=(0.1, 0.1, 0.1), rot_noise: float = 0.02,
                  seed: int = 0):
    """The sphere benchmark generator (examples/sphere/create_sphere.cpp):
    a pose spiral over a sphere with odometry and inter-lap closures.
    Returns (Graph, ground-truth poses [n_laps * n_per_lap, 7]); vertex 0 is
    fixed. The noise is drawn with the sigmas the information matrix
    encodes."""
    rng = np.random.default_rng(seed)
    g = Graph()
    info = _info_from_sigmas([*trans_noise] + [rot_noise] * 3)

    gt = []
    for i in range(n_laps * n_per_lap):
        phi = 2 * math.pi * (i % n_per_lap) / n_per_lap
        theta = math.pi * (i / (n_laps * n_per_lap))
        p = radius * np.array([math.sin(theta) * math.cos(phi),
                               math.sin(theta) * math.sin(phi),
                               math.cos(theta)])
        # orientation: z along -radial, x along direction of travel
        zax = -p / max(np.linalg.norm(p), 1e-9)
        xax = np.array([-math.sin(phi), math.cos(phi), 0.0])
        yax = np_lie.cross3(zax, xax)
        R = np.stack([xax, yax, zax], axis=1)
        # rotation matrix -> quaternion (Shepperd)
        t = np.trace(R)
        if t > 0:
            s = math.sqrt(t + 1.0) * 2
            q = np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                          (R[1, 0] - R[0, 1]) / s, 0.25 * s])
        else:
            k = int(np.argmax(np.diag(R)))
            i1, i2 = (k + 1) % 3, (k + 2) % 3
            s = math.sqrt(R[k, k] - R[i1, i1] - R[i2, i2] + 1.0) * 2
            q = np.zeros(4)
            q[k] = 0.25 * s
            q[i1] = (R[i1, k] + R[k, i1]) / s
            q[i2] = (R[i2, k] + R[k, i2]) / s
            q[3] = (R[i2, i1] - R[i1, i2]) / s
        q /= np.linalg.norm(q)
        gt.append(np.concatenate([p, q]))
    gt = np.stack(gt)

    def noisy_rel(a, b):
        z = np_lie.se3_compose(np_lie.se3_inverse(a), b)
        v = rng.normal(0, rot_noise, 3)
        w = math.sqrt(max(0.0, 1 - np.dot(v, v)))
        dq = np.array([*v, w])
        return np_lie.se3_compose(
            np.concatenate([rng.normal(0, trans_noise),
                            dq / np.linalg.norm(dq)]), z)

    n = len(gt)
    noisy = gt.copy()
    g.add_vertex(0, "se3", gt[0], fixed=True)
    for i in range(1, n):
        zn = noisy_rel(gt[i - 1], gt[i])
        noisy[i] = np_lie.se3_compose(noisy[i - 1], zn)
        g.add_vertex(i, "se3", noisy[i])
        g.add_edge("edge_se3", (i - 1, i), zn, info)
    # inter-lap closures: connect to the pose one lap earlier
    for i in range(n_per_lap, n):
        j = i - n_per_lap
        if rng.random() < 0.5:
            g.add_edge("edge_se3", (j, i), noisy_rel(gt[j], gt[i]), info)
    return g, gt


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
