"""Type registries: the counterpart of openslam_g2o_tpu/core/registry.py:29-200.

A *type* is a declarative record holding pure functions; elements never
exist individually — every vertex/edge lives in a struct-of-arrays table
keyed by its type, and the per-type functions run batched over the whole
table. In this package the functions take torch tensors with the element on
the last axis and any leading batch axes (openslam_g2o_torch/ops/lie.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

__all__ = [
    "VertexType", "EdgeType", "ParameterType",
    "register_vertex_type", "register_edge_type", "register_parameter_type",
    "vertex_type", "edge_type", "parameter_type",
    "vertex_type_by_tag", "edge_type_by_tag", "parameter_type_by_tag",
    "registered_vertex_types",
]


@dataclass(frozen=True)
class VertexType:
    """A vertex type on a manifold: `retract` is oplusImpl, `origin`
    setToOriginImpl (g2o/core/base_vertex.h:52)."""
    name: str                     # canonical registry key, e.g. "se2"
    tag: str                      # .g2o tag, e.g. "VERTEX_SE2"
    ambient_dim: int              # parameters stored per vertex
    tangent_dim: int              # minimal (local) dimension D
    retract: Callable             # (params[..., P], delta[..., D]) -> params
    origin: Callable              # (dtype) -> params[P] torch tensor
    file_dim: Optional[int] = None
    from_file: Optional[Callable] = None   # np [file_dim] -> np [P]
    to_file: Optional[Callable] = None     # np [P] -> np [file_dim]
    marginalizable: bool = False
    extra_tags: tuple = ()

    @property
    def io_dim(self):
        return self.file_dim if self.file_dim is not None else self.ambient_dim


@dataclass(frozen=True)
class EdgeType:
    """An error-term type between ``len(vertex_types)`` vertices
    (g2o/core/base_binary_edge.h:41). `error` and `jacobian` are batched."""
    name: str
    tag: str
    vertex_types: tuple           # names of VertexTypes per slot
    error_dim: int                # D of the residual (information is DxD)
    measurement_dim: int          # numbers stored per edge (internal)
    error: Callable               # (vparams tuple, meas[E, M], pdata) -> r[E, D]
    jacobian: Optional[Callable] = None   # same args -> tuple of [E, D, Ds]
    file_meas_dim: Optional[int] = None
    from_file: Optional[Callable] = None
    to_file: Optional[Callable] = None
    param_types: tuple = ()
    extra_tags: tuple = ()
    # host-side numpy rule for the spanning-tree initializer
    initial_estimate: Optional[Callable] = None

    @property
    def num_vertices(self):
        return len(self.vertex_types)

    @property
    def io_meas_dim(self):
        return (self.file_meas_dim if self.file_meas_dim is not None
                else self.measurement_dim)


@dataclass(frozen=True)
class ParameterType:
    """A graph-global shared parameter (g2o/core/parameter.h:36-53)."""
    name: str
    tag: str
    dim: int
    file_dim: Optional[int] = None
    from_file: Optional[Callable] = None
    to_file: Optional[Callable] = None

    @property
    def io_dim(self):
        return self.file_dim if self.file_dim is not None else self.dim


_VERTEX_TYPES: dict = {}
_EDGE_TYPES: dict = {}
_PARAMETER_TYPES: dict = {}
_VERTEX_BY_TAG: dict = {}
_EDGE_BY_TAG: dict = {}
_PARAMETER_BY_TAG: dict = {}


def register_vertex_type(vt: VertexType) -> VertexType:
    if vt.name in _VERTEX_TYPES and _VERTEX_TYPES[vt.name] is not vt:
        raise ValueError(f"vertex type {vt.name!r} already registered")
    _VERTEX_TYPES[vt.name] = vt
    for tag in (vt.tag, *vt.extra_tags):
        _VERTEX_BY_TAG[tag] = vt
    return vt


def register_edge_type(et: EdgeType) -> EdgeType:
    if et.name in _EDGE_TYPES and _EDGE_TYPES[et.name] is not et:
        raise ValueError(f"edge type {et.name!r} already registered")
    for v in et.vertex_types:
        if v not in _VERTEX_TYPES:
            raise ValueError(
                f"edge type {et.name!r} references unknown vertex type {v!r}")
    _EDGE_TYPES[et.name] = et
    for tag in (et.tag, *et.extra_tags):
        _EDGE_BY_TAG[tag] = et
    return et


def register_parameter_type(pt: ParameterType) -> ParameterType:
    _PARAMETER_TYPES[pt.name] = pt
    _PARAMETER_BY_TAG[pt.tag] = pt
    return pt


def vertex_type(name: str) -> VertexType:
    return _VERTEX_TYPES[name]


def edge_type(name: str) -> EdgeType:
    return _EDGE_TYPES[name]


def parameter_type(name: str) -> ParameterType:
    return _PARAMETER_TYPES[name]


def vertex_type_by_tag(tag: str) -> Optional[VertexType]:
    return _VERTEX_BY_TAG.get(tag)


def edge_type_by_tag(tag: str) -> Optional[EdgeType]:
    return _EDGE_BY_TAG.get(tag)


def parameter_type_by_tag(tag: str) -> Optional[ParameterType]:
    return _PARAMETER_BY_TAG.get(tag)


def registered_vertex_types():
    return dict(_VERTEX_TYPES)

