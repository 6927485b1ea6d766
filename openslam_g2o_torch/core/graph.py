"""Host-side graph container: counterpart of openslam_g2o_tpu/core/graph.py.

A plain Python record store for ids, types, fixed flags and parameters;
`compile()` lowers it to the struct-of-arrays `Problem` on a torch device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from openslam_g2o_torch.core import registry


@dataclass
class VertexRecord:
    vid: int
    vtype: registry.VertexType
    params: np.ndarray            # [ambient_dim]
    fixed: bool = False
    marginalized: bool = False
    data: list = field(default_factory=list)


@dataclass
class EdgeRecord:
    etype: registry.EdgeType
    vertex_ids: tuple
    measurement: np.ndarray       # [measurement_dim] (internal form)
    information: np.ndarray       # [error_dim, error_dim]
    kernel: str = "None"
    kernel_delta: float = 1.0
    param_ids: tuple = ()
    level: int = 0


class Graph:
    """Mutable optimization graph (host side); usage mirrors the reference's
    programmatic API (examples/tutorial_slam2d/tutorial_slam2d.cpp:23-120)."""

    def __init__(self):
        self.vertices: dict[int, VertexRecord] = {}
        self.edges: list[EdgeRecord] = []
        self.parameters: dict[int, tuple] = {}

    def add_vertex(self, vid: int, type_name: str, params,
                   fixed: bool = False, marginalized: bool = False):
        if vid in self.vertices:
            raise ValueError(f"vertex id {vid} already in graph")
        vt = registry.vertex_type(type_name)
        params = np.array(params, dtype=np.float64).reshape(vt.ambient_dim)
        self.vertices[vid] = VertexRecord(vid, vt, params, fixed, marginalized)
        return self.vertices[vid]

    def add_edge(self, type_name: str, vertex_ids: Sequence[int], measurement,
                 information, kernel: str = "None", kernel_delta: float = 1.0,
                 param_ids: Sequence[int] = (), level: int = 0):
        et = registry.edge_type(type_name)
        vertex_ids = tuple(int(v) for v in vertex_ids)
        if len(vertex_ids) != et.num_vertices:
            raise ValueError(f"edge {type_name} expects {et.num_vertices} "
                             f"vertices, got {len(vertex_ids)}")
        for s, vid in enumerate(vertex_ids):
            if vid not in self.vertices:
                raise ValueError(
                    f"edge {type_name} references unknown vertex {vid}")
            want = et.vertex_types[s]
            got = self.vertices[vid].vtype.name
            if got != want:
                raise ValueError(f"edge {type_name} slot {s} expects vertex "
                                 f"type {want!r}, got {got!r}")
        measurement = np.array(measurement, dtype=np.float64).reshape(
            et.measurement_dim)
        information = np.array(information, dtype=np.float64).reshape(
            et.error_dim, et.error_dim)
        rec = EdgeRecord(et, vertex_ids, measurement, information,
                         kernel, float(kernel_delta), tuple(param_ids), level)
        self.edges.append(rec)
        return rec

    def add_parameter(self, pid: int, type_name: str, value):
        pt = registry.parameter_type(type_name)
        self.parameters[int(pid)] = (
            pt, np.asarray(value, dtype=np.float64).reshape(pt.dim))

    def set_fixed(self, vid: int, fixed: bool = True):
        self.vertices[vid].fixed = fixed

    def num_vertices(self):
        return len(self.vertices)

    def num_edges(self):
        return len(self.edges)

    def any_fixed(self):
        return any(v.fixed for v in self.vertices.values())

    def gauge_freedom(self):
        """True if no fixed vertex and no unary edge grounds the graph
        (simplified SparseOptimizer::gaugeFreedom, sparse_optimizer.cpp:137)."""
        if self.any_fixed():
            return False
        return not any(e.etype.num_vertices == 1 for e in self.edges)

    def find_gauge(self):
        """The max-connectivity max-dimension vertex
        (SparseOptimizer::findGauge, sparse_optimizer.cpp:116-135)."""
        degree = {vid: 0 for vid in self.vertices}
        for e in self.edges:
            for vid in e.vertex_ids:
                degree[vid] += 1
        max_dim = max(v.vtype.tangent_dim for v in self.vertices.values())
        best, best_deg = None, -1
        for vid, v in self.vertices.items():
            if v.vtype.tangent_dim == max_dim and degree[vid] > best_deg:
                best, best_deg = vid, degree[vid]
        return best

    def compile(self, dtype: torch.dtype = torch.float64,
                device=None, level: int = 0):
        """Lower to the struct-of-arrays Problem on `device` in `dtype`
        (SparseOptimizer::initializeOptimization analogue). device=None
        means "cuda"; pass device="cpu" to run on the CPU. Without a GPU
        the default raises RuntimeError: there is no fallback to the
        CPU."""
        from openslam_g2o_torch.core.problem import build_problem
        return build_problem(self, dtype=dtype, device=device, level=level)
