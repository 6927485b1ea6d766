""".g2o text format reader/writer: counterpart of
openslam_g2o_tpu/io/g2o_format.py:34-225 on its Python tokenizer path
(`_tokenize_python`). The native C++ tokenizer is not ported yet.

* ``PARAMS_*`` lines are read in a pre-pass (optimizable_graph.cpp:359);
* vertex lines ``TAG id <estimate...>``; edge lines ``TAG id1 ... idk
  [param ids...] <measurement...> <upper-triangular information...>``;
* ``FIX id...`` lines; ``#`` comments;
* the 2D tags of models/slam2d.py load, PARAMS_SE2OFFSET included;
  unknown tags (every type not registered in the port, data payload lines
  included) are counted, reported on stderr and skipped, not fatal;
* missing endpoints of edges are auto-created at the origin
  (optimizable_graph.cpp:460-478).
"""
from __future__ import annotations

import io as _io
import sys
from typing import Optional, TextIO, Union

import numpy as np
import torch

from openslam_g2o_torch.core import registry
from openslam_g2o_torch.core.graph import Graph


def _info_from_upper(values, d):
    m = np.zeros((d, d))
    m[np.triu_indices(d)] = values
    return m + m.T - np.diag(np.diag(m))


def _upper_from_info(m):
    return m[np.triu_indices(m.shape[0])]


def load_g2o(source: Union[str, TextIO], graph: Optional[Graph] = None,
             renamed_types: Optional[dict] = None) -> Graph:
    """Parse a .g2o file (path or file object) into a Graph."""
    if isinstance(source, str):
        with open(source, "r") as f:
            text = f.read()
    else:
        text = source.read()
    return loads_g2o(text, graph=graph, renamed_types=renamed_types)


def _tokenize_python(text: str):
    """Per line (tag, float values or None, raw line if not all numeric)."""
    out = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        toks = line.split()
        try:
            vals = np.array([float(t) for t in toks[1:]])
            out.append((toks[0], vals, None))
        except ValueError:
            out.append((toks[0], None, line))
    return out


def loads_g2o(text: str, graph: Optional[Graph] = None,
              renamed_types: Optional[dict] = None) -> Graph:
    graph = graph if graph is not None else Graph()
    renamed = renamed_types or {}
    unknown_tags: dict[str, int] = {}
    fixed_ids: list[int] = []
    lines = [(renamed.get(tag, tag), vals)
             for tag, vals, _ in _tokenize_python(text)]

    for tag, vals in lines:
        pt = registry.parameter_type_by_tag(tag)
        if pt is None or vals is None:
            continue
        pvals = vals[1:1 + pt.io_dim]
        if pt.from_file is not None:
            pvals = pt.from_file(pvals)
        graph.add_parameter(int(vals[0]), pt.name, pvals)

    for tag, vals in lines:
        if registry.parameter_type_by_tag(tag) is not None:
            continue
        if tag == "FIX" and vals is not None:
            fixed_ids.extend(int(v) for v in vals)
            continue
        vt = registry.vertex_type_by_tag(tag)
        if vt is not None and vals is not None:
            v = vals[1:1 + vt.io_dim]
            if vt.from_file is not None:
                v = vt.from_file(v)
            graph.add_vertex(int(vals[0]), vt.name, v)
            continue
        et = registry.edge_type_by_tag(tag)
        if et is not None and vals is not None:
            k = et.num_vertices
            vids = [int(v) for v in vals[:k]]
            pos = k
            nparams = len(et.param_types)
            pids = [int(v) for v in vals[pos:pos + nparams]]
            pos += nparams
            md = et.io_meas_dim
            meas = vals[pos:pos + md]
            pos += md
            if et.from_file is not None:
                meas = et.from_file(meas)
            d = et.error_dim
            ninfo = d * (d + 1) // 2
            tri = vals[pos:pos + ninfo]
            if len(tri) != ninfo:
                raise ValueError(f"edge {tag}: expected {ninfo} information "
                                 f"entries, got {len(tri)}")
            for s, vid in enumerate(vids):
                if vid not in graph.vertices:
                    svt = registry.vertex_type(et.vertex_types[s])
                    graph.add_vertex(vid, svt.name,
                                     svt.origin(torch.float64).numpy())
            graph.add_edge(et.name, vids, meas, _info_from_upper(tri, d),
                           param_ids=pids)
            continue
        unknown_tags[tag] = unknown_tags.get(tag, 0) + 1

    for vid in fixed_ids:
        if vid in graph.vertices:
            graph.set_fixed(vid, True)
    if unknown_tags:
        print(f"load_g2o: skipped unknown tags: {unknown_tags}",
              file=sys.stderr)
    return graph


def save_g2o(graph: Graph, dest: Union[str, TextIO, None] = None
             ) -> Optional[str]:
    """Serialize a Graph back to .g2o text (optimizable_graph.cpp:806+)."""
    buf = _io.StringIO()
    fmtv = lambda vals: " ".join(repr(float(v)) for v in vals)

    for pid, (pt, vals) in sorted(graph.parameters.items()):
        out_vals = pt.to_file(vals) if pt.to_file is not None else vals
        buf.write(f"{pt.tag} {pid} {fmtv(out_vals)}\n")
    fixed = []
    for vid, rec in graph.vertices.items():
        vals = rec.params
        if rec.vtype.to_file is not None:
            vals = rec.vtype.to_file(vals)
        buf.write(f"{rec.vtype.tag} {vid} {fmtv(vals)}\n")
        if rec.fixed:
            fixed.append(vid)
    for vid in fixed:
        buf.write(f"FIX {vid}\n")
    for e in graph.edges:
        meas = e.measurement
        if e.etype.to_file is not None:
            meas = e.etype.to_file(meas)
        parts = [e.etype.tag, *(str(v) for v in e.vertex_ids),
                 *(str(p) for p in e.param_ids), fmtv(meas),
                 fmtv(_upper_from_info(e.information))]
        buf.write(" ".join(parts) + "\n")

    text = buf.getvalue()
    if dest is None:
        return text
    if isinstance(dest, str):
        with open(dest, "w") as f:
            f.write(text)
        return None
    dest.write(text)
    return None
