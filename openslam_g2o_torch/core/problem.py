"""The compiled, device-resident optimization problem.

Counterpart of openslam_g2o_tpu/core/problem.py:50-329, 350-407 and
557-565. Vertices are grouped by type into ``[N, P]`` parameter tables,
edges by (type, robust kernel) into index/measurement/information tables;
fixed vertices keep their slots and are masked (their Jacobian columns are
zeroed, the damped diagonal gets a 1). The JAX pytree becomes plain dicts
keyed by group name, holding torch tensors on one device in one dtype.

Only VERTEX_SE2 / EDGE_SE2 are ported; build_problem raises
NotImplementedError for any other type.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from openslam_g2o_torch.core import registry, robust

__all__ = [
    "Problem", "EdgeArrays", "VGroup", "EGroup", "ProblemStatic",
    "build_problem", "compute_errors", "edge_chi2", "chi2", "robust_chi2",
    "linearize", "apply_update_parts", "tangent_masks", "write_back",
    "resolve_device", "check_supported",
]

SUPPORTED_VERTEX_TYPES = ("se2",)
SUPPORTED_EDGE_TYPES = ("edge_se2",)


@dataclass(frozen=True)
class VGroup:
    """One vertex type's table: N vertices, tangent block at [offset,
    offset + N*D) in the global tangent vector."""
    name: str
    vtype: registry.VertexType
    count: int
    offset: int

    @property
    def tangent_dim(self):
        return self.vtype.tangent_dim

    @property
    def tangent_size(self):
        return self.count * self.vtype.tangent_dim


@dataclass(frozen=True)
class EGroup:
    """One (edge type, robust kernel) group's static info."""
    key: str
    etype: registry.EdgeType
    kernel_id: int
    count: int

    @property
    def slots(self):
        return self.etype.vertex_types


@dataclass(frozen=True)
class ProblemStatic:
    vgroups: tuple
    egroups: tuple
    total_dim: int
    pose_dim: int = -1

    def __post_init__(self):
        if self.pose_dim < 0:
            object.__setattr__(self, "pose_dim", self.total_dim)


@dataclass
class EdgeArrays:
    indices: tuple            # per slot: [E] int32 local vertex indices
    measurement: torch.Tensor  # [E, M]
    information: torch.Tensor  # [E, D, D]
    delta: torch.Tensor        # [E] robust kernel width
    pdata: tuple = ()          # per parameter slot (none for EDGE_SE2)


@dataclass
class Problem:
    params: dict            # group name -> [N, P]
    free: dict              # group name -> [N] (1.0 = free, 0.0 = fixed)
    edges: dict             # egroup key -> EdgeArrays
    static: ProblemStatic

    @property
    def total_dim(self):
        return self.static.total_dim

    @property
    def dtype(self):
        return next(iter(self.params.values())).dtype

    @property
    def device(self):
        return next(iter(self.params.values())).device

    def with_params(self, params: dict) -> "Problem":
        return dataclasses.replace(self, params=params)


def resolve_device(device=None) -> torch.device:
    """torch.device(device), with None meaning "cuda": the port runs on the
    card unless the caller asks for the CPU. It refuses "cuda" where there
    is no GPU and never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           "torch.cuda.is_available() is False")
    return device


def check_supported(vtype_names, etype_names):
    """Raise NotImplementedError for types outside the ported slice."""
    for kind, names, ok in (("vertex", vtype_names, SUPPORTED_VERTEX_TYPES),
                            ("edge", etype_names, SUPPORTED_EDGE_TYPES)):
        bad = sorted(set(names) - set(ok))
        if bad:
            raise NotImplementedError(
                f"{kind} type(s) {bad} are not ported to openslam_g2o_torch "
                "yet: only VERTEX_SE2/EDGE_SE2 are (ROADMAP.md, 'Modules "
                "still to port', item 'Other 2D types' and the SE3 item)")


def build_problem(graph, dtype: torch.dtype = torch.float64, device=None,
                  level: int = 0) -> Problem:
    """Lower the host graph to a Problem on `device` (None: "cuda") in
    `dtype` (openslam_g2o_tpu/core/problem.py:149-246 without pad_counts, which
    only the online engine uses)."""
    device = resolve_device(device)
    order: dict[str, list] = {}
    local_index: dict[int, tuple] = {}
    for rec in graph.vertices.values():
        order.setdefault(rec.vtype.name, []).append(rec)
    edges_here = [e for e in graph.edges if e.level == level]
    check_supported(order, {e.etype.name for e in edges_here})
    group_names = sorted(order,
                         key=lambda n: order[n][0].vtype.marginalizable)
    vgroups, params, free = [], {}, {}
    offset = 0
    for name in group_names:
        recs = order[name]
        vt = recs[0].vtype
        for i, rec in enumerate(recs):
            local_index[rec.vid] = i
        p = np.stack([r.params for r in recs]).astype(np.float64)
        f = np.array([0.0 if r.fixed else 1.0 for r in recs])
        params[name] = torch.as_tensor(p, dtype=dtype, device=device)
        free[name] = torch.as_tensor(f, dtype=dtype, device=device)
        vgroups.append(VGroup(name, vt, len(recs), offset))
        offset += len(recs) * vt.tangent_dim
    pose_dim = sum(g.tangent_size for g in vgroups
                   if not g.vtype.marginalizable)

    buckets: dict[tuple, list] = {}
    for e in edges_here:
        buckets.setdefault((e.etype.name, robust.kernel_id(e.kernel)),
                           []).append(e)
    egroups, edges = [], {}
    for (tname, kid), recs in buckets.items():
        et = recs[0].etype
        key = (tname if kid == robust.NONE_ID
               else f"{tname}#{robust.kernel_names()[kid]}")
        idx = tuple(
            torch.as_tensor(np.array([local_index[r.vertex_ids[s]]
                                      for r in recs], dtype=np.int32),
                            device=device)
            for s in range(et.num_vertices))
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                         dtype=dtype, device=device)
        edges[key] = EdgeArrays(
            idx,
            as_t(np.stack([r.measurement for r in recs])),
            as_t(np.stack([r.information for r in recs])),
            as_t([r.kernel_delta for r in recs]))
        egroups.append(EGroup(key, et, kid, len(recs)))
    static = ProblemStatic(tuple(vgroups), tuple(egroups), offset, pose_dim)
    return Problem(params, free, edges, static)


def write_back(problem: Problem, graph) -> None:
    """Copy optimized estimates back into the host graph records."""
    order: dict[str, list] = {}
    for rec in graph.vertices.values():
        order.setdefault(rec.vtype.name, []).append(rec)
    for name, recs in order.items():
        vals = problem.params[name].detach().cpu().to(torch.float64).numpy()
        for i, rec in enumerate(recs):
            rec.params = vals[i].copy()


# ---------------------------------------------------------------------------
# Errors / chi2
# ---------------------------------------------------------------------------

def _gather_vertex_params(eg: EGroup, ea: EdgeArrays, params: dict):
    return tuple(params[g][ea.indices[s]] for s, g in enumerate(eg.slots))


def compute_errors(problem: Problem, params: Optional[dict] = None) -> dict:
    """Residuals per edge group (SparseOptimizer::computeActiveErrors)."""
    params = problem.params if params is None else params
    return {eg.key: eg.etype.error(
                _gather_vertex_params(eg, problem.edges[eg.key], params),
                problem.edges[eg.key].measurement, problem.edges[eg.key].pdata)
            for eg in problem.static.egroups}


def _mahalanobis(r, info):
    """e^T Omega e per row, as elementwise products (no batched matmul)."""
    return (r[:, :, None] * info * r[:, None, :]).sum(dim=(1, 2))


def edge_chi2(problem: Problem, errors: Optional[dict] = None,
              params: Optional[dict] = None) -> dict:
    """Per-edge squared Mahalanobis error e^T Omega e (base_edge.h:58)."""
    if errors is None:
        errors = compute_errors(problem, params)
    return {eg.key: _mahalanobis(errors[eg.key],
                                 problem.edges[eg.key].information)
            for eg in problem.static.egroups}


def chi2(problem: Problem, params: Optional[dict] = None):
    """Non-robust chi2 (activeChi2, sparse_optimizer.cpp:90-98)."""
    total = torch.zeros((), dtype=problem.dtype, device=problem.device)
    for v in edge_chi2(problem, params=params).values():
        total = total + v.sum()
    return total


def robust_chi2(problem: Problem, params: Optional[dict] = None):
    """Sum of rho(e2) (activeRobustChi2, sparse_optimizer.cpp:100-114)."""
    e2 = edge_chi2(problem, params=params)
    total = torch.zeros((), dtype=problem.dtype, device=problem.device)
    for eg in problem.static.egroups:
        rho0, _, _ = robust.robustify(eg.kernel_id, e2[eg.key],
                                      problem.edges[eg.key].delta)
        total = total + rho0.sum()
    return total


# ---------------------------------------------------------------------------
# Linearization
# ---------------------------------------------------------------------------

def linearize(problem: Problem, params: Optional[dict] = None) -> dict:
    """Per edge group: residual [E, D], per-slot analytic Jacobians
    [E, D, Ds] with the columns of fixed vertices zeroed, and robust
    weights rho' [E] (openslam_g2o_tpu/core/problem.py:350-392). The LM-PCG
    path runs the fused CUDA kernel B instead on the card
    (kernels/edge_se2.py), whose plain version calls this math."""
    params = problem.params if params is None else params
    out = {}
    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        vp = _gather_vertex_params(eg, ea, params)
        resid = eg.etype.error(vp, ea.measurement, ea.pdata)
        jacs = eg.etype.jacobian(vp, ea.measurement, ea.pdata)
        _, rho1, _ = robust.robustify(
            eg.kernel_id, _mahalanobis(resid, ea.information), ea.delta)
        masked = tuple(
            jacs[s] * problem.free[g][ea.indices[s]][:, None, None]
            for s, g in enumerate(eg.slots))
        out[eg.key] = (resid, masked, rho1)
    return out


def tangent_masks(problem: Problem):
    """(free_t, fixed_t): per-tangent-slot masks as [total_dim] vectors."""
    free_t = torch.cat([problem.free[g.name].repeat_interleave(g.tangent_dim)
                        for g in problem.static.vgroups])
    return free_t, 1.0 - free_t


def apply_update_parts(problem: Problem, dx_parts: dict,
                       params: Optional[dict] = None) -> dict:
    """params <- retract(params, dx * free) per group, dx as [N, D] parts
    (SparseOptimizer::update, sparse_optimizer.cpp:421-434)."""
    params = problem.params if params is None else params
    return {g.name: g.vtype.retract(
                params[g.name], dx_parts[g.name] * problem.free[g.name][:, None])
            for g in problem.static.vgroups}
