"""K2', K4', K5', K8': the block-ELL kernels of LM-PCG over several vertex
groups, for square and rectangular block pairs (csrc/pair_ell.cu).

A pair table (core/sparse.py `PairPattern`) holds the blocks of one (row
group, column group) pair: nb [K, Nr] int32, cnt [Nr] int32 (the used
slots of each row: slots cnt[n].. are padding, column 0 and zero blocks)
and values [K, Dr*Dc, Nr], entry Dc a + c of the block in slot k of row
n, Dr and Dc in PAIR_WIDTHS; a square pair's slot 0 is the row's own
diagonal block. Vectors are lane-major [D, N] per group. The kernels
read only the used slots; the plain versions read every slot, which
gives the same result on values whose padding is zero (every assembled
and scaled table).

    pair_assemble    (K2') `_edge_blocks` + `_assemble_pair` +
                     `_assemble_b` (openslam_g2o_tpu/core/sparse.py:620-728)
    pair_scale       (K4') `ell_add_diag` + `ell_scale_jacobi` (:731-784)
    pair_spmv,       (K5') `ell_matvec_lane` (:883-908); the second with
    pair_spmv_dot          the partial sums of p . H p of the CG step
    pair_gershgorin  (K8') `ell_gershgorin_bound` (:787-817)

The assembly sums each destination's contributions through a
destination-major table built on the host once per topology
(`assembly_table`): contributions in table order (the sources in the
order given, then their edges in order), cut into chunks of at most
PAIR_CHUNK; a destination of several chunks is finished by its last chunk
to arrive (an arrival counter per destination, reset by that chunk), so
a run repeats bit for bit. A table therefore serves one launch at a time,
on one stream, and must be built anew after a launch that failed.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    PAIR_WIDTHS, check_tensors, launch_device, pair_width, require)
from openslam_g2o_torch.kernels.cg_step import ROW_BLOCK
from openslam_g2o_torch.kernels.edge_se2 import bmm_small, bmv_small

# contributions per chunk of pair_assemble: 16 took the least device time
# of 2, 4, 8, 16 and 32 on chip_smoke.py phase 4s's world (its six tables,
# float32 and float64)
PAIR_CHUNK = 16
MAX_SOURCES = 32       # kPairMaxSources of csrc/pair_ell.cu
MAX_PAIRS = 8          # kPairMaxPairs: the pairs of one row group
MAX_RESIDUAL = 6       # kPairMaxResid: the widest residual of a source


@dataclass
class Source:
    """One source of a pair table: an edge group's slot pair (s, t), i.e.
    its residual [E, D], slot s's masked Jacobian js [E, D, Dr], slot t's
    jt [E, D, Dc] (None for b), rho' [E] and Omega [E, D, D]."""
    resid: torch.Tensor
    js: torch.Tensor
    jt: object
    rho1: torch.Tensor
    info: torch.Tensor


@dataclass
class AssemblyTable:
    """The destinations of one pair table (dc > 0: destination d is slot
    d // n_rows of row d % n_rows) or of one vertex group's b (dc == 0:
    destination d is vertex d). dest: per source, the [E] int64
    destination of each of its edges (what the plain version adds by).
    cnt: the pair table's used slots per row [n_rows] int32 (None for b):
    its padding slots get zeros, its used ones the chunks. Chunk c holds
    contributions chunk_ptr[c]:chunk_ptr[c+1] of destination
    chunk_dest[c]; destination d owns chunks dest_chunk[d]:dest_chunk[d+1]
    (one at least for a used destination: an empty chunk writes its
    zeros; none for padding); contribution m is edge cedge[m] of source
    csrc[m]. arrivals [n_dest] int32: zero between launches."""
    n_rows: int
    n_dest: int
    dr: int
    dc: int
    cnt: object
    dest: tuple
    chunk_ptr: torch.Tensor
    chunk_dest: torch.Tensor
    dest_chunk: torch.Tensor
    csrc: torch.Tensor
    cedge: torch.Tensor
    arrivals: torch.Tensor

    @property
    def n_chunks(self):
        return self.chunk_dest.shape[0]

    @property
    def entries(self):
        return self.dr * self.dc if self.dc else self.dr


def assembly_table(dests, n_rows, n_dest, dr, dc, device,
                   cnt=None) -> AssemblyTable:
    """The table of one pair (dc > 0, with its used slots per row `cnt`,
    numpy [n_rows]) or of b (dc == 0, cnt None) from each source's
    destinations (a list of numpy int64 [E_s], in source order)."""
    dests = [np.asarray(d, dtype=np.int64) for d in dests]
    dest = (np.concatenate(dests) if dests else np.zeros(0, np.int64))
    src = np.concatenate([np.full(len(d), s, np.int64)
                          for s, d in enumerate(dests)] or [np.zeros(0)])
    edge = np.concatenate([np.arange(len(d), dtype=np.int64)
                           for d in dests] or [np.zeros(0)])
    order = np.argsort(dest, kind="stable")
    counts = np.bincount(dest, minlength=n_dest)
    ptr = np.zeros(n_dest + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    n_chunk = np.maximum((counts + PAIR_CHUNK - 1) // PAIR_CHUNK, 1)
    if cnt is not None:              # padding destinations own no chunk
        slot = np.arange(n_dest, dtype=np.int64) // max(n_rows, 1)
        n_chunk[slot >= np.tile(np.asarray(cnt, np.int64),
                                n_dest // max(n_rows, 1))] = 0
    dest_chunk = np.zeros(n_dest + 1, dtype=np.int64)
    np.cumsum(n_chunk, out=dest_chunk[1:])
    chunk_dest = np.repeat(np.arange(n_dest, dtype=np.int64), n_chunk)
    first = ptr[chunk_dest] + (np.arange(len(chunk_dest))
                               - dest_chunk[chunk_dest]) * PAIR_CHUNK
    chunk_ptr = np.concatenate([np.minimum(first, ptr[chunk_dest + 1]),
                                [ptr[-1]]])
    i32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                                    device=device)
    return AssemblyTable(
        n_rows, n_dest, dr, dc, None if cnt is None else i32(cnt),
        tuple(torch.as_tensor(d, device=device) for d in dests),
        i32(chunk_ptr), i32(chunk_dest), i32(dest_chunk), i32(src[order]),
        i32(edge[order]), torch.zeros(n_dest, dtype=torch.int32,
                                      device=device))


def _check_sources(name, table, sources):
    require(len(sources) == len(table.dest),
            f"{name}: {len(sources)} sources for a table of "
            f"{len(table.dest)}")
    require(1 <= len(sources) <= MAX_SOURCES,
            f"{name}: 1 to {MAX_SOURCES} sources, got {len(sources)}")
    pair_width(name, table.dr)
    if table.dc:
        pair_width(name, table.dc)
    dev, dt = sources[0].resid.device, sources[0].resid.dtype
    for i, s in enumerate(sources):
        E, D = s.resid.shape
        require(1 <= D <= MAX_RESIDUAL,
                f"{name}: source {i}: residual width {D} outside 1.."
                f"{MAX_RESIDUAL}")
        require(s.js.shape == (E, D, table.dr)
                and (table.dc == 0 or s.jt.shape == (E, D, table.dc))
                and s.rho1.shape == (E,) and s.info.shape == (E, D, D)
                and table.dest[i].shape == (E,),
                f"{name}: source {i}: shapes do not fit [E, D] residuals, "
                f"[E, D, {table.dr}] / [E, D, {table.dc}] Jacobians, [E] "
                "rho' and [E, D, D] Omega")
        floats = {"resid": s.resid, "js": s.js, "rho1": s.rho1,
                  "info": s.info}
        if table.dc:
            floats["jt"] = s.jt
        check_tensors(name, dev, dt, floats, {})
    ints = {"chunk_ptr": table.chunk_ptr, "chunk_dest": table.chunk_dest,
            "dest_chunk": table.dest_chunk, "csrc": table.csrc,
            "cedge": table.cedge, "arrivals": table.arrivals}
    if table.dc:
        require(table.cnt is not None and table.cnt.shape == (table.n_rows,),
                f"{name}: a pair table needs its cnt [{table.n_rows}]")
        ints["cnt"] = table.cnt
    check_tensors(name, dev, dt, {}, ints)
    return dev, dt


# -- pair_assemble ------------------------------------------------------------

def pair_assemble_plain(sources, table):
    """Plain PyTorch version of K2': each source's blocks (or b parts) by
    elementwise batched products, added at their destinations."""
    dev, dt = sources[0].resid.device, sources[0].resid.dtype
    out = torch.zeros((table.n_dest, table.entries), dtype=dt, device=dev)
    for s, dest in zip(sources, table.dest):
        jw = bmm_small(s.js.transpose(1, 2),
                       s.rho1[:, None, None] * s.info)        # [E, Dr, D]
        blk = (bmm_small(jw, s.jt) if table.dc
               else -bmv_small(jw, s.resid))
        out.index_add_(0, dest, blk.reshape(dest.shape[0], -1))
    k = table.n_dest // table.n_rows
    out = out.view(k, table.n_rows, table.entries).permute(0, 2, 1)
    return out.contiguous() if table.dc else out[0].contiguous()


def pair_assemble(sources, table):
    """The values [K, Dr*Dc, Nr] of one pair table (table.dc > 0) or b
    [Dr, N] of one vertex group (table.dc == 0), summed over the sources'
    contributions; K2' on CUDA tensors, the plain version on CPU
    tensors."""
    dev, dt = _check_sources("pair_assemble", table, sources)
    if not launch_device("pair_assemble", dev):
        return pair_assemble_plain(sources, table)
    k = table.n_dest // table.n_rows
    shape = (k, table.entries, table.n_rows) if table.dc else (
        table.dr, table.n_rows)
    out = torch.empty(shape, dtype=dt, device=dev)
    if table.n_dest == 0:
        return out
    n = len(sources)
    ptrs = (ctypes.c_longlong * (5 * n))(
        *(s.js.data_ptr() for s in sources),
        *((s.jt.data_ptr() if table.dc else 0) for s in sources),
        *(s.info.data_ptr() for s in sources),
        *(s.rho1.data_ptr() for s in sources),
        *(s.resid.data_ptr() for s in sources))
    dims = (ctypes.c_int * n)(*(s.resid.shape[1] for s in sources))
    part = torch.empty(max(table.n_chunks * table.entries, 1), dtype=dt,
                       device=dev)
    build.launch("g2o_pair_assemble", out, ptrs, dims, n,
                 table.chunk_ptr.data_ptr(), table.chunk_dest.data_ptr(),
                 table.dest_chunk.data_ptr(), table.csrc.data_ptr(),
                 table.cedge.data_ptr(), table.arrivals.data_ptr(),
                 part.data_ptr(), out.data_ptr(),
                 table.cnt.data_ptr() if table.dc else 0, table.n_rows,
                 table.n_dest // max(table.n_rows, 1), table.dr, table.dc,
                 table.n_chunks)
    pair_assemble.launches += 1
    return out


pair_assemble.launches = 0


# -- pair_scale ---------------------------------------------------------------

def pair_scale_plain(nb, cnt, values, linv_r, linv_c, extra=None):
    """Plain PyTorch version of K4' (sparse.py:731-784 on one layout)."""
    K, N = nb.shape
    dr = int(round(linv_r.shape[0] ** 0.5))
    dc = int(round(linv_c.shape[0] ** 0.5))
    B = values.view(K, dr, dc, N)
    if extra is not None:
        B = B.clone()
        B[0] += extra[None, None] * torch.eye(dr, dtype=values.dtype,
                                              device=values.device)[:, :, None]
    Li = linv_r.view(dr, dr, N)
    # C[k, a, c, n] = sum_b Li[a, b, n] B[k, b, c, n]
    C = (Li[None, :, :, None, :] * B[:, None]).sum(dim=2)
    Lj = linv_c[:, nb.long()].view(dc, dc, K, N).permute(2, 0, 1, 3)
    # S[k, a, d, n] = sum_c C[k, a, c, n] Lj[k, d, c, n]
    S = (C[:, :, None] * Lj[:, None]).sum(dim=3).reshape(K, dr * dc, N)
    empty = (values == 0).all(dim=1, keepdim=True)        # [K, 1, N]
    if extra is not None:
        empty[0] = False
    return torch.where(empty, torch.zeros((), dtype=S.dtype, device=S.device),
                       S)


def pair_scale(nb, cnt, values, linv_r, linv_c, extra=None):
    """The Jacobi-scaled values [K, Dr*Dc, Nr] of one pair table (nb, cnt):
    row
    factors linv_r [Dr*Dr, Nr] (K3's, of the row group), column factors
    linv_c [Dc*Dc, Nc] gathered at nb; `extra` [Nr], given for a square
    pair only, is the damping folded into slot 0. K4' on CUDA tensors, the
    plain version on CPU tensors."""
    K, N = nb.shape
    require(linv_r.dim() == 2 and linv_r.shape[1] == N
            and linv_c.dim() == 2,
            f"pair_scale: linv_r must be [Dr*Dr, {N}] and linv_c "
            "[Dc*Dc, Nc]")
    dr = next((d for d in PAIR_WIDTHS if d * d == linv_r.shape[0]), 0)
    dc = next((d for d in PAIR_WIDTHS if d * d == linv_c.shape[0]), 0)
    require(dr and dc, f"pair_scale: factor tables of {linv_r.shape[0]} and "
            f"{linv_c.shape[0]} rows fit no block widths in {PAIR_WIDTHS}")
    require(values.shape == (K, dr * dc, N),
            f"pair_scale: values shape {tuple(values.shape)} != "
            f"{(K, dr * dc, N)}")
    require(extra is None or (dr == dc and extra.shape == (N,)),
            f"pair_scale: extra must be [{N}], and only on a square pair")
    require(cnt.shape == (N,), f"pair_scale: cnt must be [{N}]")
    floats = {"values": values, "linv_r": linv_r, "linv_c": linv_c}
    if extra is not None:
        floats["extra"] = extra
    check_tensors("pair_scale", values.device, values.dtype, floats,
                  {"nb": nb, "cnt": cnt})
    if not launch_device("pair_scale", values.device):
        return pair_scale_plain(nb, cnt, values, linv_r, linv_c, extra)
    out = torch.empty_like(values)
    if N == 0:
        return out
    build.launch("g2o_pair_scale", values, nb.data_ptr(), cnt.data_ptr(),
                 values.data_ptr(),
                 linv_r.data_ptr(), linv_c.data_ptr(),
                 0 if extra is None else extra.data_ptr(), out.data_ptr(), N,
                 linv_c.shape[1], K, dr, dc)
    pair_scale.launches += 1
    return out


pair_scale.launches = 0


# -- pair_spmv / pair_spmv_dot ------------------------------------------------

def pair_lanes(max_k: int) -> int:
    """Lanes of a warp per row of K5' for a row group whose widest pair
    table has max_k slots: enough that no lane walks more than about four
    slots (a landmark seen by a hundred poses spreads over 32 lanes, a
    pose's few neighbours stay on one or two)."""
    lanes = 1
    while lanes < 32 and lanes * 4 < max_k:
        lanes *= 2
    return lanes


def partial_count(n: int, max_k: int, device) -> int:
    """The p . H p partials `pair_spmv_dot` writes for a row group of n
    rows whose widest table has max_k slots: one per block of ROW_BLOCK
    threads (ROW_BLOCK / pair_lanes(max_k) rows) on the card, one on the
    CPU."""
    if device.type != "cuda" or n == 0:
        return 1
    return (n * pair_lanes(max_k) + ROW_BLOCK - 1) // ROW_BLOCK


class RowArgs:
    """One row group's pair tables, checked once and laid out as K5''s C
    arguments (`row_args`): pointers to nb, cnt, values and x per pair,
    the columns Nc, K and Dc per pair and the lanes per row. A call fills
    in only the x pointers (`_refresh`), so the CG loop does not check and
    lay out the tables again in every iteration. Valid while its tensors
    live unchanged."""
    __slots__ = ("n", "dr", "dcs", "device", "dtype", "q", "xshapes",
                 "ptrs", "ncol", "dims", "max_k", "lanes")


def row_args(nbs, cnts, vals, xs, dr, name="pair_spmv"):
    """The RowArgs of one row group's pairs (nb [K, Nr] and cnt [Nr] int32,
    values [K, dr*Dc, Nr], x of the pair's column group [Dc, Nc]), every
    argument checked."""
    pair_width(name, dr)
    q = len(nbs)
    require(1 <= q <= MAX_PAIRS and len(vals) == q and len(xs) == q
            and len(cnts) == q,
            f"{name}: 1 to {MAX_PAIRS} pairs with one nb, cnt, values and x "
            "each")
    N = nbs[0].shape[1]
    dev, dt = vals[0].device, vals[0].dtype
    dcs = []
    for i, (nb, v, x) in enumerate(zip(nbs, vals, xs)):
        dc = x.shape[0]
        if (x.dim() != 2 or dc not in PAIR_WIDTHS or nb.dim() != 2
                or nb.shape[1] != N or v.shape != (nb.shape[0], dr * dc, N)):
            raise ValueError(f"{name}: pair {i}: nb {tuple(nb.shape)}, "
                             f"values {tuple(v.shape)} and x "
                             f"{tuple(x.shape)} do not fit [K, {N}], "
                             f"[K, {dr}*Dc, {N}], [Dc, Nc] with Dc in "
                             f"{PAIR_WIDTHS}")
        require(cnts[i].shape == (N,), f"{name}: pair {i}: cnt must be [{N}]")
        check_tensors(name, dev, dt, {"values": v, "x": x},
                      {"nb": nb, "cnt": cnts[i]})
        dcs.append(dc)
    ra = RowArgs()
    ra.n, ra.dr, ra.dcs, ra.device, ra.dtype, ra.q = N, dr, dcs, dev, dt, q
    ra.xshapes = [x.shape for x in xs]
    ra.ptrs = (ctypes.c_longlong * (4 * q))(
        *(t.data_ptr() for t in nbs), *(t.data_ptr() for t in cnts),
        *(t.data_ptr() for t in vals), *(t.data_ptr() for t in xs))
    ra.ncol = (ctypes.c_longlong * q)(*(x.shape[1] for x in xs))
    ra.dims = (ctypes.c_int * (2 * q))(*(nb.shape[0] for nb in nbs), *dcs)
    ra.max_k = max(nb.shape[0] for nb in nbs)
    ra.lanes = pair_lanes(ra.max_k)
    return ra


def _refresh(name, ra, xs):
    """Point `ra` at this call's column vectors, each checked against the
    shape, dtype and device the tables were laid out for."""
    if len(xs) != ra.q:
        raise ValueError(f"{name}: {len(xs)} x for {ra.q} pairs")
    for i, x in enumerate(xs):
        if (x.shape != ra.xshapes[i] or x.dtype != ra.dtype
                or x.device != ra.device or not x.is_contiguous()):
            raise ValueError(f"{name}: x {i} must be a contiguous "
                             f"{tuple(ra.xshapes[i])} {ra.dtype} tensor on "
                             f"{ra.device}")
        ra.ptrs[3 * ra.q + i] = x.data_ptr()


def pair_spmv_plain(nbs, cnts, vals, xs, dr, args=None):
    """y = sum over the pairs, in order, of the block-ELL product."""
    N = nbs[0].shape[1]
    y = torch.zeros((dr, N), dtype=vals[0].dtype, device=vals[0].device)
    for nb, v, x in zip(nbs, vals, xs):
        K, dc = nb.shape[0], x.shape[0]
        xg = x[:, nb.long()]                                 # [Dc, K, N]
        V = v.view(K, dr, dc, N)
        y = y + (V * xg.permute(1, 0, 2)[:, None]).sum(dim=(0, 2))
    return y


def pair_spmv(nbs, cnts, vals, xs, dr, args=None):
    """y [dr, Nr] = sum over one row group's pairs (nb [K, Nr], cnt [Nr],
    values [K, dr*Dc, Nr], x of the pair's column group [Dc, Nc]) of V x;
    K5' on CUDA tensors, the plain version on CPU tensors. `args`, the
    group's RowArgs from an earlier call (`row_args`), skips checking and
    laying out the tables again."""
    if args is None:
        args = row_args(nbs, cnts, vals, xs, dr)
    else:
        _refresh("pair_spmv", args, xs)
    if not launch_device("pair_spmv", args.device):
        return pair_spmv_plain(nbs, cnts, vals, xs, dr)
    y = torch.empty((dr, args.n), dtype=args.dtype, device=args.device)
    if args.n == 0:
        return y
    build.launch("g2o_pair_spmv", y, args.ptrs, args.ncol, args.dims, args.q,
                 0, y.data_ptr(), 0, args.n, dr, args.lanes)
    pair_spmv.launches += 1
    return y


pair_spmv.launches = 0


def pair_spmv_dot_plain(nbs, cnts, vals, xs, p, partials, args=None):
    """y and p . y as partials[0] (the rest of the partials zeroed, so
    that their sum is the dot on a table sized for the card too)."""
    y = pair_spmv_plain(nbs, cnts, vals, xs, p.shape[0])
    partials.zero_()
    partials[:1].copy_(torch.dot(p.reshape(-1), y.reshape(-1)).reshape(1))
    return y, partials


def pair_spmv_dot(nbs, cnts, vals, xs, p, partials, args=None):
    """(y, partials): `pair_spmv` of the row group whose vector is p [dr,
    Nr], and partial sums of p . y written into `partials`, a 1-d tensor
    of `partial_count(Nr, K, device)` values, K the widest of the pairs'
    tables (a view of the CG step's shared partials table)."""
    dr = p.shape[0]
    if args is None:
        args = row_args(nbs, cnts, vals, xs, dr, "pair_spmv_dot")
    else:
        _refresh("pair_spmv_dot", args, xs)
    count = partial_count(args.n, args.max_k, args.device)
    if (p.shape != (args.dr, args.n) or partials.dim() != 1
            or partials.shape[0] != count):
        raise ValueError(f"pair_spmv_dot: p must be [{args.dr}, {args.n}] "
                         f"and partials [{count}]")
    check_tensors("pair_spmv_dot", args.device, args.dtype,
                  {"p": p, "partials": partials}, {})
    if not launch_device("pair_spmv_dot", args.device):
        return pair_spmv_dot_plain(nbs, cnts, vals, xs, p, partials)
    y = torch.empty((dr, args.n), dtype=args.dtype, device=args.device)
    if args.n == 0:
        partials.zero_()
        return y, partials
    build.launch("g2o_pair_spmv", y, args.ptrs, args.ncol, args.dims, args.q,
                 p.data_ptr(), y.data_ptr(), partials.data_ptr(), args.n, dr,
                 args.lanes)
    pair_spmv_dot.launches += 1
    return y, partials


pair_spmv_dot.launches = 0


# -- pair_gershgorin ----------------------------------------------------------

def pair_gershgorin_plain(rows):
    dt, dev = rows[0][1][0].dtype, rows[0][1][0].device
    hi = torch.zeros((), dtype=dt, device=dev)
    for dr, vals, _ in rows:
        rowsum = None
        for v in vals:
            K, _, N = v.shape
            s = v.abs().view(K, dr, -1, N).sum(dim=(0, 2))      # [dr, N]
            rowsum = s if rowsum is None else rowsum + s
        if rowsum.numel():
            hi = torch.maximum(hi, rowsum.max())
    return torch.clamp_min(hi, 1e-3)


def pair_gershgorin(rows):
    """max(max over row groups and their rows of sum |S|, 1e-3) as a 0-dim
    tensor on the device: `rows` holds per row group (dr, [values of its
    pairs [K, dr*Dc, Nr], in pattern order], [their cnt [Nr]])
    (PairPattern.bound_rows). One counted call launches a row-sum pass per
    row group (each writing its blocks' maxima into one partials table) and
    the final maximum. A NaN entry gives NaN."""
    require(len(rows) >= 1, "pair_gershgorin: no row groups")
    dev, dt = rows[0][1][0].device, rows[0][1][0].dtype
    blocks = []
    for dr, vals, cnts in rows:
        pair_width("pair_gershgorin", dr)
        require(1 <= len(vals) <= MAX_PAIRS and len(cnts) == len(vals),
                f"pair_gershgorin: 1 to {MAX_PAIRS} pairs a row group, "
                "each with its cnt")
        N = vals[0].shape[2]
        for v, c in zip(vals, cnts):
            require(v.dim() == 3 and v.shape[2] == N
                    and v.shape[1] // dr in PAIR_WIDTHS
                    and v.shape[1] % dr == 0,
                    f"pair_gershgorin: values {tuple(v.shape)} are not "
                    f"[K, {dr}*Dc, {N}]")
            require(c.shape == (N,), f"pair_gershgorin: cnt must be [{N}]")
            check_tensors("pair_gershgorin", dev, dt, {"values": v},
                          {"cnt": c})
        lanes = pair_lanes(max(v.shape[0] for v in vals))
        blocks.append((N * lanes + ROW_BLOCK - 1) // ROW_BLOCK)
    if not launch_device("pair_gershgorin", dev):
        return pair_gershgorin_plain(rows)
    # every block of every row group writes its maximum; without rows the
    # final pass reads one zero
    partials = (torch.empty(sum(blocks), dtype=dt, device=dev) if sum(blocks)
                else torch.zeros(1, dtype=dt, device=dev))
    hi = torch.empty((), dtype=dt, device=dev)
    off = 0
    for (dr, vals, cnts), nblk in zip(rows, blocks):
        N = vals[0].shape[2]
        if N:
            q = len(vals)
            ptrs = (ctypes.c_longlong * (4 * q))(
                *([0] * q), *(c.data_ptr() for c in cnts),
                *(v.data_ptr() for v in vals), *([0] * q))
            ncol = (ctypes.c_longlong * q)(*([0] * q))
            dims = (ctypes.c_int * (2 * q))(
                *(v.shape[0] for v in vals), *(v.shape[1] // dr
                                               for v in vals))
            build.launch("g2o_pair_gershgorin", hi, ptrs, ncol, dims, q,
                         partials.data_ptr() + off * partials.element_size(),
                         N, dr, pair_lanes(max(v.shape[0] for v in vals)))
        off += nblk
    build.launch("g2o_pair_gershgorin_final", hi, partials.data_ptr(),
                 partials.shape[0], hi.data_ptr())
    pair_gershgorin.launches += 1
    return hi


pair_gershgorin.launches = 0
