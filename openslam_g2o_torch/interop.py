"""Carry a problem's arrays across from numpy into the port.

`problem_from_numpy` builds the port's Problem from plain numpy arrays —
the arrays of a JAX `Problem` converted with np.asarray, or any other
source — on a given device and dtype, so that both packages compute on
identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from openslam_g2o_torch.core import registry
from openslam_g2o_torch.core import problem as P

__all__ = ["problem_from_numpy", "problem_arrays"]


def problem_arrays(problem) -> dict:
    """The keyword arguments of `problem_from_numpy` read from a Problem of
    either package (attributes params, free, edges, static.egroups), every
    array converted with np.asarray."""
    arr = lambda a: np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    edges = {}
    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        edges[eg.key] = {"indices": tuple(arr(i) for i in ea.indices),
                         "measurement": arr(ea.measurement),
                         "information": arr(ea.information),
                         "delta": arr(ea.delta), "kernel_id": eg.kernel_id,
                         "pdata": tuple(arr(p) for p in ea.pdata)}
    return {"params": {k: arr(v) for k, v in problem.params.items()},
            "free": {k: arr(v) for k, v in problem.free.items()},
            "edges": edges}


def problem_from_numpy(params: dict, free: dict, edges: dict,
                       dtype: torch.dtype = torch.float64,
                       device=None) -> P.Problem:
    """Build a Problem from numpy arrays on `device` (None: "cuda").

    params: {vertex group name: [N, P]} (the group name is the vertex type
        name, e.g. "se2", "point_xy"); free: {group name: [N]} with 1.0 =
        free.
    edges: {edge group key: {"indices": one [E] array per slot,
        "measurement": [E, M], "information": [E, D, D], "delta": [E],
        "kernel_id": int, "pdata": one [E, dim] array per parameter slot
        (may be left out for a type without parameters)}}; the key is
        "<edge type name>" or "<edge type name>#<kernel name>", as
        build_problem names the groups.
    Vertex groups keep the order of `params` (build_problem lays poses
    before marginalizable landmarks), edge groups that of `edges`.
    """
    device = P.resolve_device(device)
    as_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64),
                                  dtype=dtype, device=device)
    vgroups, offset = [], 0
    for name, p in params.items():
        vt = registry.vertex_type(name)
        n = int(np.shape(p)[0])
        vgroups.append(P.VGroup(name, vt, n, offset))
        offset += n * vt.tangent_dim
    egroups, edge_arrays = [], {}
    for key, e in edges.items():
        et = registry.edge_type(key.split("#")[0])
        idx = tuple(torch.tensor(np.asarray(ix, dtype=np.int32),
                                 device=device) for ix in e["indices"])
        edge_arrays[key] = P.EdgeArrays(idx, as_t(e["measurement"]),
                                        as_t(e["information"]),
                                        as_t(e["delta"]),
                                        tuple(as_t(p)
                                              for p in e.get("pdata", ())))
        egroups.append(P.EGroup(key, et, int(e["kernel_id"]), len(idx[0])))
    P.check_supported([g.name for g in vgroups],
                      [eg.etype.name for eg in egroups])
    pose_dim = sum(g.tangent_size for g in vgroups
                   if not g.vtype.marginalizable)
    static = P.ProblemStatic(tuple(vgroups), tuple(egroups), offset, pose_dim)
    return P.Problem({k: as_t(v) for k, v in params.items()},
                     {k: as_t(v) for k, v in free.items()},
                     edge_arrays, static)
