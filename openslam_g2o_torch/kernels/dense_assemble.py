"""K15: deterministic assembly of the dense normal equations
(csrc/dense_assemble.cu).

Replaces `build_dense_system` (openslam_g2o_tpu/core/problem.py:415-458):
per edge group and slot pair (s, t >= s) the products J_s^T (rho' Omega) J_t
and -J_s^T (rho' Omega) e, summed into the dense H [T, T] (the block and, off
the diagonal, its transpose) and b [T], then raw_diag = diag(H) and the unit
diagonal of fixed slots. The kernel sums through a destination-major table
built here on the host once per topology (`build_dense_pattern`), one
launch per slot pair: a group of threads per chunk of at most DENSE_CHUNK
contributions, a lane per entry of the destination block, and the last
chunk of a destination to arrive adds the chunks' sums in chunk order, so
a run repeats bit for bit and a hub (one vertex seen by every edge) is
spread over the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)
from openslam_g2o_torch.kernels.edge_se2 import bmm_small, bmv_small

MAX_DIM = 9          # the widest instantiation of csrc/dense_assemble.cu
DENSE_CHUNK = 64     # contributions per chunk (a group of threads)
# values per chunk row of the kernel's scratch: the widest destination's
# 9 x 9 block and 9 of b, rounded up to 16 bytes (float32)
PART_STRIDE = 92


@dataclass
class EdgeBlocks:
    """One edge group's inputs: residual [E, D], masked Jacobians per slot
    [E, D, Ds], rho' [E], Omega [E, D, D] and, per slot, the global tangent
    offset [E] int32 of the vertex in that slot."""
    resid: torch.Tensor
    jacs: tuple
    rho1: torch.Tensor
    info: torch.Tensor
    offsets: tuple


@dataclass
class PairTable:
    """Destinations of one (edge group, slot pair): destination d is the
    block at rows dest_p[d] (slot s's width) and columns dest_q[d] (slot
    t's width); its contributors are edge[ptr[d]:ptr[d+1]] in edge order,
    each with a flag: 0 add the block, 1 add its transpose, 2 add both.
    The lists are cut into chunks of at most DENSE_CHUNK contributions:
    chunk c is contributions chunk_ptr[c]:chunk_ptr[c+1] of destination
    chunk_dest[c], destination d owns chunks dest_chunk[d]:dest_chunk[d+1].
    arrivals [n_dest] int32: the chunks that have reached each destination
    in one launch; the last to arrive finishes the destination and resets
    its counter, so a launch that runs to its end leaves every counter at
    zero, and the next launch relies on that. The tables (and so every
    DensePattern that holds them) serve one launch at a time, on one
    stream; a launch that fails leaves the counters unknown, and the
    pattern must then be built anew."""
    s: int
    t: int
    n_dest: int
    ptr: torch.Tensor
    dest_p: torch.Tensor
    dest_q: torch.Tensor
    edge: torch.Tensor
    flag: torch.Tensor
    chunk_ptr: torch.Tensor
    chunk_dest: torch.Tensor
    dest_chunk: torch.Tensor
    arrivals: torch.Tensor

    @property
    def n_chunks(self):
        return self.chunk_ptr.shape[0] - 1


@dataclass
class DensePattern:
    """Static-topology tables of the dense assembly: per edge group (in
    the order of static.egroups) the slot offsets and one PairTable per
    slot pair (s, t >= s), in the order the reference scatters them.
    Its tables' arrival counters make it serve one dense_assemble call at
    a time, on one stream (PairTable)."""
    total_dim: int
    offsets: list
    pairs: list


def slot_offsets(static, eg, ea):
    """Per slot, the global tangent offset [E] int32 of each edge's vertex
    (the first column of `_slot_tangent_indices`)."""
    out = []
    for s, name in enumerate(eg.slots):
        g = static.vgroup(name)
        out.append((g.offset + ea.indices[s].to(torch.int32)
                    * g.tangent_dim).to(torch.int32))
    return tuple(out)


def _pair_table(a, b, diag, total_dim):
    """CSR destination table of one slot pair from the slots' offsets a, b
    (numpy int64 [E]). A destination is an unordered pair of vertices; it
    takes the orientation (p, q) = (a, b) of its first contributor. A
    contribution is flagged 1 or 2 only where both slots reach one vertex
    group (a vertex seen in both, or a pair seen both ways round), so the
    two slots are of one width; slots of two widths (a rectangular block)
    are all flag 0."""
    if diag:
        key = a
    else:
        key = np.minimum(a, b) * (total_dim + 1) + np.maximum(a, b)
    _, first, inverse, counts = np.unique(key, return_index=True,
                                          return_inverse=True,
                                          return_counts=True)
    p, q = a[first], b[first]
    flag = np.where(a == b, 0 if diag else 2,
                    np.where(a == p[inverse], 0, 1))
    order = np.argsort(inverse, kind="stable")
    ptr = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    n_chunk = (counts + DENSE_CHUNK - 1) // DENSE_CHUNK
    dest_chunk = np.concatenate([[0], np.cumsum(n_chunk)])
    dest_of = np.repeat(np.arange(len(counts)), n_chunk)
    chunk_ptr = np.concatenate([
        ptr[dest_of] + (np.arange(len(dest_of)) - dest_chunk[dest_of])
        * DENSE_CHUNK, [ptr[-1]]])
    return p, q, ptr, order, flag[order], chunk_ptr, dest_of, dest_chunk


def build_dense_pattern(problem, egroups=None, total_dim=None,
                        slots=None) -> DensePattern:
    """Host-side symbolic phase of the dense assembly (the analogue of
    BlockSolver::buildStructure for the dense Hessian), vectorized numpy;
    depends on the topology alone. `egroups` (default: all) and
    `total_dim` (default: the tangent dimension) restrict it to some edge
    groups on a leading block of the tangent vector, as the Schur solvers
    assemble Hpp on the pose block; `slots` (one tuple of slot indices per
    edge group) restricts each group to some of its slots, the pose slots
    of a landmark edge for the general Schur path (core/ba.py), whose
    EdgeBlocks then carry those slots' Jacobians and offsets in that
    order."""
    static, dev = problem.static, problem.device
    total_dim = static.total_dim if total_dim is None else total_dim
    offsets, pairs = [], []
    egs = static.egroups if egroups is None else egroups
    for i, eg in enumerate(egs):
        offs = slot_offsets(static, eg, problem.edges[eg.key])
        if slots is not None:
            offs = tuple(offs[s] for s in slots[i])
        offsets.append(offs)
        pairs.append(pair_tables(offs, total_dim, dev))
    return DensePattern(total_dim, offsets, pairs)


def pair_tables(offsets, total_dim, device) -> list:
    """The PairTables of one edge group, slot pairs (s, t >= s) in order,
    from its slots' offsets (one int tensor [E] per slot)."""
    i32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                                    device=device)
    host = [o.cpu().numpy().astype(np.int64) for o in offsets]
    tables = []
    for s in range(len(host)):
        for t in range(s, len(host)):
            (p, q, ptr, edge, flag, chunk_ptr, chunk_dest,
             dest_chunk) = _pair_table(host[s], host[t], s == t, total_dim)
            tables.append(PairTable(
                s, t, len(p), i32(ptr), i32(p), i32(q), i32(edge), i32(flag),
                i32(chunk_ptr), i32(chunk_dest), i32(dest_chunk),
                torch.zeros(len(p), dtype=torch.int32, device=device)))
    return tables


def dense_assemble_plain(groups, total_dim, fixed_t, pattern=None,
                         add_fixed_diag=True):
    """Plain PyTorch version of K15, in the reference's order of
    operations: (H [T, T], b [T], raw_diag [T]). It scatters through the
    groups' slot offsets and does not read `pattern`."""
    like = fixed_t
    H = torch.zeros((total_dim, total_dim), dtype=like.dtype,
                    device=like.device)
    b = torch.zeros((total_dim,), dtype=like.dtype, device=like.device)
    for g in groups:
        w_omega = g.rho1[:, None, None] * g.info                # [E, D, D]
        idx = [off.long()[:, None]
               + torch.arange(j.shape[2], device=off.device)[None, :]
               for off, j in zip(g.offsets, g.jacs)]
        k = len(g.jacs)
        for s in range(k):
            js_w = bmm_small(g.jacs[s].transpose(1, 2), w_omega)  # [E, Ds, D]
            b.index_put_((idx[s],), -bmv_small(js_w, g.resid),
                         accumulate=True)
            for t in range(s, k):
                blk = bmm_small(js_w, g.jacs[t])                # [E, Ds, Dt]
                H.index_put_((idx[s][:, :, None], idx[t][:, None, :]), blk,
                             accumulate=True)
                if t != s:
                    H.index_put_((idx[t][:, :, None], idx[s][:, None, :]),
                                 blk.transpose(1, 2), accumulate=True)
    raw_diag = H.diagonal().clone()
    if add_fixed_diag:
        H.diagonal().add_(fixed_t)
    return H, b, raw_diag


def _check_group(i, g, device, dtype):
    E, D = g.resid.shape
    k = len(g.jacs)
    require(len(g.offsets) == k and 1 <= k,
            f"dense_assemble: group {i} needs one offset table per slot")
    require(g.rho1.shape == (E,) and g.info.shape == (E, D, D),
            f"dense_assemble: group {i}: rho1 must be [E] and info [E, D, D]")
    for s, j in enumerate(g.jacs):
        require(j.dim() == 3 and j.shape[:2] == (E, D)
                and g.offsets[s].shape == (E,),
                f"dense_assemble: group {i} slot {s}: Jacobian must be "
                "[E, D, Ds] and offsets [E]")
        require(j.dtype == dtype and j.device == device,
                f"dense_assemble: group {i} slot {s}: Jacobian must be "
                f"{dtype} on {device}")
        require(max(D, j.shape[2]) <= MAX_DIM,
                f"dense_assemble: block widths above {MAX_DIM} are not "
                "supported")
    check_tensors("dense_assemble", device, dtype,
                  {"resid": g.resid, "rho1": g.rho1, "info": g.info},
                  {f"offsets[{s}]": o for s, o in enumerate(g.offsets)})


def dense_assemble(groups, total_dim, fixed_t, pattern=None,
                   add_fixed_diag=True):
    """(H [T, T], b [T], raw_diag [T]) from the edge groups' linearization
    (a list of EdgeBlocks in the order of static.egroups); K15 on CUDA
    tensors, where `pattern` (build_dense_pattern) is required, the plain
    version on CPU tensors. One counted call launches the zero fill of H
    and of b, one kernel per edge group and slot pair (the slot pairs run
    in order and share one scratch table), and the finalize kernel."""
    require(fixed_t.shape == (total_dim,),
            "dense_assemble: fixed_t must be [total_dim]")
    dev, dt = fixed_t.device, fixed_t.dtype
    check_tensors("dense_assemble", dev, dt, {"fixed_t": fixed_t}, {})
    for i, g in enumerate(groups):
        _check_group(i, g, dev, dt)
    if not launch_device("dense_assemble", dev):
        return dense_assemble_plain(groups, total_dim, fixed_t, pattern,
                                    add_fixed_diag)
    require(pattern is not None and pattern.total_dim == total_dim
            and len(pattern.pairs) == len(groups),
            "dense_assemble: on the card a DensePattern of this problem is "
            "required (build_dense_pattern)")
    H = torch.empty((total_dim, total_dim), dtype=dt, device=dev)
    b = torch.empty((total_dim,), dtype=dt, device=dev)
    raw_diag = torch.empty((total_dim,), dtype=dt, device=dev)
    if total_dim == 0:
        return H, b, raw_diag
    build.launch("g2o_dense_zero", H, H.data_ptr(), H.numel())
    build.launch("g2o_dense_zero", b, b.data_ptr(), b.numel())
    n_part = PART_STRIDE * max(
        [tb.n_chunks for tables in pattern.pairs for tb in tables] + [1])
    part = torch.empty(n_part, dtype=dt, device=dev)
    for g, tables in zip(groups, pattern.pairs):
        jacs = [j.contiguous() for j in g.jacs]
        D = g.resid.shape[1]
        for tb in tables:
            if tb.n_dest == 0:
                continue
            build.launch(
                "g2o_dense_pair", H, jacs[tb.s].data_ptr(),
                jacs[tb.t].data_ptr(), g.rho1.data_ptr(), g.info.data_ptr(),
                g.resid.data_ptr(), tb.chunk_ptr.data_ptr(),
                tb.chunk_dest.data_ptr(), tb.dest_chunk.data_ptr(),
                tb.dest_p.data_ptr(), tb.dest_q.data_ptr(),
                tb.edge.data_ptr(), tb.flag.data_ptr(),
                tb.arrivals.data_ptr(), part.data_ptr(), H.data_ptr(),
                b.data_ptr(), total_dim, tb.n_chunks, D, jacs[tb.s].shape[2],
                jacs[tb.t].shape[2], int(tb.s == tb.t))
    build.launch("g2o_dense_finalize", H, H.data_ptr(), fixed_t.data_ptr(),
                 raw_diag.data_ptr(), total_dim, int(add_fixed_diag))
    dense_assemble.launches += 1
    return H, b, raw_diag


dense_assemble.launches = 0
