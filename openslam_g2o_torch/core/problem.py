"""The compiled, device-resident optimization problem.

Counterpart of openslam_g2o_tpu/core/problem.py:50-458 and 557-585.
Vertices are grouped by type into ``[N, P]`` parameter tables (poses first,
marginalizable landmarks last), edges by (type, robust kernel) into
index/measurement/information/parameter tables; fixed vertices keep their
slots and are masked (their Jacobian columns are zeroed, the diagonal gets
a 1). The JAX pytree becomes plain dicts keyed by group name, holding torch
tensors on one device in one dtype.

Every type of models/slam2d.py, models/slam3d.py, models/sba.py and
models/bal.py is supported. An edge type without an analytic Jacobian
is differentiated in forward mode (`linearize`): by the CUDA kernel K17 of
kernels/edge_lin.py on the card for every built-in type, by
torch.func.jvp on the CPU and for a type registered at run time.
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
    "linearize", "build_dense_system", "apply_update", "apply_update_parts",
    "tangent_masks", "write_back", "resolve_device", "check_supported",
    "linearize_group", "linearize_edges", "robust_chi2_parts",
    "trial_candidate", "tangent_parts", "lm_trial_outcome",
]

SUPPORTED_VERTEX_TYPES = ("se2", "point_xy", "se3", "point_xyz",
                          "se3_expmap", "sba_point_xyz", "cam", "intrinsics",
                          "bal_camera")
SUPPORTED_EDGE_TYPES = (
    "edge_se2", "edge_se2_xy", "edge_se2_xy_bearing", "edge_se2_prior",
    "edge_se2_prior_xy", "edge_se2_xy_calib", "edge_se2_offset",
    "edge_se2_xy_offset",
    "edge_se3", "edge_se3_xyz", "edge_se3_depth", "edge_se3_disparity",
    "edge_se3_prior", "edge_se3_offset",
    "edge_se3_expmap", "edge_project_xyz2uv", "edge_project_xyz2uvu",
    "edge_project_psi2uv", "edge_project_p2mc",
    "edge_project_p2mc_intrinsics", "edge_project_p2sc", "edge_sba_cam",
    "edge_sba_scale", "edge_project_bal")


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

    def vgroup(self, name: str) -> VGroup:
        for g in self.vgroups:
            if g.name == name:
                return g
        raise KeyError(name)

    @property
    def marginalized_groups(self):
        """The vertex groups laid out after the pose block: the
        marginalizable landmarks (openslam_g2o_tpu/core/problem.py:
        102-104)."""
        return tuple(g for g in self.vgroups if g.offset >= self.pose_dim)


@dataclass
class EdgeArrays:
    indices: tuple            # per slot: [E] int32 local vertex indices
    measurement: torch.Tensor  # [E, M]
    information: torch.Tensor  # [E, D, D]
    delta: torch.Tensor        # [E] robust kernel width
    pdata: tuple = ()          # per parameter slot: [E, dim] values


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
    """Raise NotImplementedError for types that are not ported: all but the
    vertex and edge types of models/slam2d.py, models/slam3d.py,
    models/sba.py and models/bal.py, and any other registered edge type
    between those vertices (the forward-mode linearizer serves it)."""
    bad = sorted(set(vtype_names) - set(SUPPORTED_VERTEX_TYPES))
    bad += sorted(
        n for n in set(etype_names) - set(SUPPORTED_EDGE_TYPES)
        if set(registry.edge_type(n).vertex_types)
        - set(SUPPORTED_VERTEX_TYPES))
    if bad:
        raise NotImplementedError(
            f"type(s) {bad} are not ported to openslam_g2o_torch yet: the 2D "
            "and 3D SLAM types and the BA types are (ROADMAP.md, "
            "'Modules still to port')")


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
        pdata = tuple(
            as_t(np.stack([graph.parameters[r.param_ids[ps]][1]
                           for r in recs]))
            for ps in range(len(et.param_types)))
        edges[key] = EdgeArrays(
            idx,
            as_t(np.stack([r.measurement for r in recs])),
            as_t(np.stack([r.information for r in recs])),
            as_t([r.kernel_delta for r in recs]), pdata)
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


def robust_chi2_parts(problem: Problem, params: Optional[dict] = None):
    """Partial sums of rho(e^T Omega e) over every edge group at `params`
    (activeRobustChi2, sparse_optimizer.cpp:100-114), laid out group after
    group in one vector: what kernels/retract_chi2.py `lm_outcome` and
    kernels/trial.py `chi2_sum` sum.

    Every edge type that openslam_g2o_torch.models registers has a wrapper
    in kernels/trial.py `CHI2` (K7): on CUDA tensors it launches its kernel
    (its partials are a block's each) or raises, on CPU tensors it runs its
    plain version (one partial per group). A type a caller registers at run
    time runs the plain version on either device."""
    from openslam_g2o_torch.kernels import trial
    params = problem.params if params is None else params
    egroups = problem.static.egroups
    counts = [trial.partial_count(eg.count, problem.device) for eg in egroups]
    part = torch.empty(max(sum(counts), 1), dtype=problem.dtype,
                       device=problem.device)
    if not egroups:
        return part.zero_()
    offset = 0
    for eg, c in zip(egroups, counts):
        ea = problem.edges[eg.key]
        args = (tuple(params[g].contiguous() for g in eg.slots), ea.indices,
                ea.measurement, ea.information, ea.delta, ea.pdata,
                eg.kernel_id)
        out = part[offset:offset + c]
        fn = trial.chi2_of(eg.etype.name)
        if fn is None:
            trial.chi2_plain(eg.etype, eg.kernel_id, *args[:-1], out=out)
        else:
            fn(*args, out=out)
        offset += c
    return part


def robust_chi2(problem: Problem, params: Optional[dict] = None):
    """Sum of rho(e2) (activeRobustChi2, sparse_optimizer.cpp:100-114): the
    partials of `robust_chi2_parts` summed by kernels/trial.py `chi2_sum`,
    in the order `lm_outcome` sums a trial's, as a 0-dim tensor."""
    from openslam_g2o_torch.kernels import trial
    return trial.chi2_sum(robust_chi2_parts(problem, params))


# ---------------------------------------------------------------------------
# Linearization
# ---------------------------------------------------------------------------

def forward_jacobians(eg: EGroup, vparams, meas, pdata):
    """Per-slot Jacobians [E, D, Ds] of the residual with respect to the
    tangent increment at zero, in forward mode: the counterpart of
    vmap(jacfwd(fn)) over the tangent-residual function
    (openslam_g2o_tpu/core/problem.py:336-347, :373-379). The error
    functions are batched on the last axis, so all C = sum(Ds) columns come
    from ONE jvp: the inputs are repeated along a leading axis of length C
    and column c carries the one-hot tangent of its own dimension."""
    vtypes = tuple(registry.vertex_type(n) for n in eg.slots)
    dims = [vt.tangent_dim for vt in vtypes]
    C, E = sum(dims), meas.shape[0]
    rep = lambda a: a.unsqueeze(0).expand(C, *a.shape)
    vp_c, meas_c = tuple(rep(p) for p in vparams), rep(meas)
    pdata_c = tuple(rep(p) for p in pdata)
    zeros, tangents, c0 = [], [], 0
    for d in dims:
        zeros.append(meas.new_zeros((C, E, d)))
        t = meas.new_zeros((C, E, d))
        t[range(c0, c0 + d), :, range(d)] = 1.0
        tangents.append(t)
        c0 += d

    def fn(*deltas):
        vp = tuple(vt.retract(p, dl)
                   for vt, p, dl in zip(vtypes, vp_c, deltas))
        return eg.etype.error(vp, meas_c, pdata_c)

    _, cols = torch.func.jvp(fn, tuple(zeros), tuple(tangents))   # [C, E, D]
    starts = np.cumsum([0] + dims)
    return tuple(cols[starts[s]:starts[s + 1]].permute(1, 2, 0)
                 for s in range(len(dims)))


def linearize(problem: Problem, params: Optional[dict] = None) -> dict:
    """Per edge group: residual [E, D], per-slot Jacobians [E, D, Ds] with
    respect to the tangent increment, the columns of fixed vertices
    zeroed, and robust weights rho' [E]
    (openslam_g2o_tpu/core/problem.py:350-392), by `linearize_group`. The
    one-group LM-PCG path runs the fused CUDA kernels B and K16 instead on
    the card (kernels/edge_se2.py, kernels/edge_se3.py), whose plain
    versions call this math; LM-PCG over several vertex groups runs
    `linearize_group` per edge group (core/sparse.py `pair_sources`)."""
    params = problem.params if params is None else params
    return {eg.key: linearize_group(problem, eg, params)
            for eg in problem.static.egroups}


def linearize_edges(etype, kernel_id: int, params, free, indices, meas,
                    info, delta, pdata):
    """The generic linearization of one edge group: the error at the
    gathered slot parameters, the type's analytic Jacobian where it has
    one, else `forward_jacobians`, rho' of `robustify`, each slot's
    Jacobian times its vertex's free flag. `params`, `free`, `indices` are
    per slot: the slot's vertex table [N, P], its free flags [N] and the
    edges' vertex indices [E]."""
    vp = tuple(p[i] for p, i in zip(params, indices))
    resid = etype.error(vp, meas, pdata)
    if etype.jacobian is not None:
        jacs = etype.jacobian(vp, meas, pdata)
    else:
        jacs = forward_jacobians(EGroup(etype.name, etype, kernel_id,
                                        meas.shape[0]), vp, meas, pdata)
    _, rho1, _ = robust.robustify(kernel_id, _mahalanobis(resid, info),
                                  delta)
    masked = tuple(j * f[i][:, None, None]
                   for j, f, i in zip(jacs, free, indices))
    return resid, masked, rho1


def linearize_group(problem: Problem, eg: EGroup,
                    params: Optional[dict] = None):
    """`linearize` of one edge group: (residual, masked Jacobians, rho').

    Every edge type that openslam_g2o_torch.models registers has a wrapper
    in kernels/edge_lin.py `LINEARIZERS` (K17): on CUDA tensors it
    launches its kernel or raises, on CPU tensors it runs its plain
    version, `linearize_edges`. So no built-in type is linearized by
    plain PyTorch on the card. An edge type that a caller registers at
    run time, with an error function in Python, has no kernel and runs
    `linearize_edges` on either device: the type's analytic Jacobian if it
    has one, else torch.func.jvp (`forward_jacobians`), as the JAX package
    runs jacfwd on any registered type."""
    from openslam_g2o_torch.kernels import edge_lin
    params = problem.params if params is None else params
    ea = problem.edges[eg.key]
    slot_params = tuple(params[g].contiguous() for g in eg.slots)
    slot_free = tuple(problem.free[g] for g in eg.slots)
    fn = edge_lin.linearizer(eg.etype.name)
    if fn is None:
        return linearize_edges(eg.etype, eg.kernel_id, slot_params,
                               slot_free, ea.indices, ea.measurement,
                               ea.information, ea.delta, ea.pdata)
    return fn(slot_params, slot_free, ea.indices, ea.measurement,
              ea.information, ea.delta, ea.pdata, eg.kernel_id)


def tangent_masks(problem: Problem):
    """(free_t, fixed_t): per-tangent-slot masks as [total_dim] vectors."""
    free_t = torch.cat([problem.free[g.name].repeat_interleave(g.tangent_dim)
                        for g in problem.static.vgroups])
    return free_t, 1.0 - free_t


def _slot_tangent_indices(g: VGroup, idx):
    """Global tangent indices of each edge's slot: [E, D]."""
    base = g.offset + idx.to(torch.int32) * g.tangent_dim
    return base[:, None] + torch.arange(g.tangent_dim, dtype=torch.int32,
                                        device=idx.device)[None, :]


def build_dense_system(problem: Problem, params: Optional[dict] = None,
                       lin: Optional[dict] = None,
                       add_fixed_diag: bool = True, pattern=None):
    """Assemble the full dense H = J^T W J [T, T] and b = -J^T W r [T] over
    the global tangent vector (openslam_g2o_tpu/core/problem.py:415-458;
    BlockSolver::buildSystem, block_solver.hpp:502-560). Returns (H, b,
    raw_diag): raw_diag is the diagonal before the unit entries of fixed
    slots are added, which is what LM's lambda init scans.

    The per-edge products and their sum into H are the CUDA kernel of
    kernels/dense_assemble.py on the card and its plain version on the
    CPU. `pattern` is that kernel's destination-major table
    (`kernels.dense_assemble.build_dense_pattern`); it depends on the
    topology alone, so a caller that assembles repeatedly builds it once
    and passes it. Without it, it is built here on every call on the card
    (the CPU path does not need it)."""
    from openslam_g2o_torch.kernels import dense_assemble as K
    if lin is None:
        lin = linearize(problem, params)
    if pattern is None and problem.device.type == "cuda":
        pattern = K.build_dense_pattern(problem)
    groups = []
    for i, eg in enumerate(problem.static.egroups):
        ea = problem.edges[eg.key]
        resid, jacs, w = lin[eg.key]
        offsets = (pattern.offsets[i] if pattern is not None
                   else K.slot_offsets(problem.static, eg, ea))
        groups.append(K.EdgeBlocks(resid.contiguous(), tuple(jacs),
                                   w.contiguous(), ea.information, offsets))
    _, fixed_t = tangent_masks(problem)
    return K.dense_assemble(groups, problem.static.total_dim, fixed_t,
                            pattern, add_fixed_diag)


def trial_candidate(problem: Problem, dx_parts: dict,
                    b_parts: Optional[dict] = None, lam=None,
                    params: Optional[dict] = None):
    """One trial's candidate params <- retract(params, dx * free) per
    vertex group (SparseOptimizer::update, sparse_optimizer.cpp:421-434)
    and, with the gradient b_parts and lam given, the partial sums of
    dx . (lam dx + b) over every group in one vector (None without them).
    dx_parts and b_parts hold one [N, D] tensor of any strides per group.

    Every group of a vertex type that openslam_g2o_torch.models registers
    goes to kernels/trial.py `trial_retract_groups` (K7): one launch over
    all of them on CUDA tensors, each group's partials at its offset (a
    group's partial_count after the groups before it), the plain version
    (vtype.retract and torch.dot) on CPU tensors. A type registered at run
    time keeps `trial.retract_plain`."""
    from openslam_g2o_torch.kernels import trial
    params = problem.params if params is None else params
    vgroups = problem.static.vgroups
    part = None
    counts = [trial.partial_count(g.count, problem.device) for g in vgroups]
    if b_parts is not None:
        part = torch.empty(sum(counts), dtype=problem.dtype,
                           device=problem.device)
    cand, served, offset = {}, [], 0
    for g, c in zip(vgroups, counts):
        x, free = params[g.name].contiguous(), problem.free[g.name]
        b = None if b_parts is None else b_parts[g.name]
        if g.vtype.name in trial.RETRACT_IDS:
            served.append((g.name, trial.RetractGroup(
                g.vtype.name, x, dx_parts[g.name], free, b, offset)))
        else:
            args = (x, dx_parts[g.name], free)
            if b is not None:
                args += (b, lam, part[offset:offset + c])
            cand[g.name] = trial.retract_plain(g.vtype, *args)[0]
        offset += c
    if served:
        cands = trial.trial_retract_groups(
            [grp for _, grp in served], None if part is None else lam, part)
        cand.update((name, c) for (name, _), c in zip(served, cands))
    return {g.name: cand[g.name] for g in vgroups}, part


def tangent_parts(problem: Problem, vec) -> dict:
    """The global tangent vector [T] as one [N, D] part per vertex group
    (a view where the vector's strides allow one)."""
    return {g.name: vec[g.offset:g.offset + g.tangent_size].reshape(
                g.count, g.tangent_dim) for g in problem.static.vgroups}


def apply_update_parts(problem: Problem, dx_parts: dict,
                       params: Optional[dict] = None) -> dict:
    """params <- retract(params, dx * free) per group, dx as [N, D] parts
    (SparseOptimizer::update, sparse_optimizer.cpp:421-434), by
    `trial_candidate`."""
    return trial_candidate(problem, dx_parts, params=params)[0]


def apply_update(problem: Problem, dx, params: Optional[dict] = None) -> dict:
    """params <- retract(params, dx), dx the global tangent vector [T],
    masked on fixed vertices (openslam_g2o_tpu/core/problem.py:572-585)."""
    return apply_update_parts(problem, tangent_parts(problem, dx), params)


def lm_trial_outcome(problem: Problem, dx_parts: dict, b_parts: dict, ok,
                     lam, ni, chi_cur):
    """The candidate and the LM bookkeeping of one trial on the dense and
    Schur routes: `trial_candidate`'s candidate and dot partials and
    `robust_chi2_parts` at the candidate, handed to kernels/retract_chi2.py
    `lm_outcome` (optimization_algorithm_levenberg.cpp:57-147). Returns
    (cand, chi_new, accept, lam_new, ni_new, retry), all on the device."""
    from openslam_g2o_torch.kernels import retract_chi2
    cand, part_dot = trial_candidate(problem, dx_parts, b_parts, lam)
    chi_new, _, accept, lam, ni, retry = retract_chi2.lm_outcome(
        robust_chi2_parts(problem, cand), part_dot, ok, lam, ni, chi_cur)
    return cand, chi_new, accept, lam, ni, retry
