"""K2', K4', K5', K8': the block-ELL kernels of LM-PCG over several vertex
groups, for square and rectangular block pairs (csrc/pair_ell.cu).

A pair table (core/sparse.py `PairPattern`) holds the blocks of one (row
group, column group) pair, Dr and Dc in PAIR_WIDTHS. Assembled (K2', read
by K3 and K4'): nb [K, Nr] int32, cnt [Nr] int32 (the used slots of each
row: slots cnt[n].. are padding, column 0 and zero blocks) and values
[K, Dr*Dc, Nr], entry Dc a + c of the block in slot k of row n; a square
pair's slot 0 is the row's own diagonal block. Scaled (K4', read by K5'
and K8'), the used-slot layout: rowptr [Nr + 1] int32 (row n's used slots
are u = rowptr[n] .. rowptr[n + 1] - 1, in slot order), cols [U] int32
(their columns) and values [Dr*Dc, U]. The CG vectors of all vertex
groups are one flat vector, each group's part vertex-major [N, D] at its
offset (`FlatLayout`): the Dc values of a column that a slot gathers are
adjacent.

    pair_stream      (K2', pass 1) `_edge_blocks`
                     (openslam_g2o_tpu/core/sparse.py:620-644), edge-major,
                     into a destination-major stream
    pair_assemble    (K2', pass 2) `_assemble_pair` + `_assemble_b`
                     (:646-728): every table and b from the stream
    pair_scale       (K4') `ell_add_diag` + `ell_scale_jacobi` (:731-784)
    pair_spmv,       (K5') `ell_matvec_lane` (:883-908) over every row
    pair_spmv_dot,         group in one launch (one more a further
                           MAX_GROUPS row groups); the second with the
    pair_spmv_dot_p        partial sums of p . H p of the CG step, the
                           third with the next direction p = beta p + r
                           folded in
    pair_gershgorin  (K8') `ell_gershgorin_bound` (:787-817)

The assembly's tables are built on the host once per topology
(`assembly_table`, `assembly_plan`): each table's contributions in
destination-major order (the sources in the order given, then their
edges in order), each contribution's place in that order and each
destination's run of it. Pass 1 writes every contribution's block there;
pass 2 sums each destination's run in order, cut into chunks of at most
PAIR_CHUNK, the chunk sums added in order: no atomics, so every output
repeats its bits.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    PAIR_WIDTHS, check_tensors, launch_device, pair_width, require)
from openslam_g2o_torch.kernels.cg_step import BETA, N_SCALARS
from openslam_g2o_torch.kernels.edge_se2 import bmm_small, bmv_small

# contributions per chunk of a destination's sum: 16 took the least device
# time of 2, 4, 8, 16 and 32 for the one-pass assembly on chip_smoke.py
# phase 4s's world; kept so that the two passes give its bits
PAIR_CHUNK = 16
MAX_PAIRS = 8          # the pair tables of one row group
MAX_RESIDUAL = 6       # kPairMaxResid: the widest residual of a source
MAX_SLOTS = 3          # kPairMaxSlots: the vertices of an edge
MAX_UNITS = 12         # kPairMaxUnits: edge group slots of one pass-1 launch
MAX_OUTS = 24          # kPairMaxOuts: tables and b of one pass-2 launch
MAX_GROUPS = 4         # kPairMaxGroups: row groups of one K5' / K8' launch
MAX_TABLES = 16        # kPairMaxTables: their pair tables (FlatLayout
                       # launches again for more)
THREADS = 256          # kThreads of csrc/common.cuh


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
    destination of each of its edges. Contributions in destination-major
    order (per destination: source order, then edge order): pos, per
    source, the [E] int32 place of each edge's contribution in that order;
    ptr [n_dest + 1] int32, destination d's run ptr[d]:ptr[d + 1] (empty
    for a padding slot and for a used slot without contributions, which
    get zeros). n_contrib: the contributions."""
    n_rows: int
    n_dest: int
    dr: int
    dc: int
    dest: tuple
    pos: tuple
    ptr: torch.Tensor
    n_contrib: int

    @property
    def entries(self):
        return self.dr * self.dc if self.dc else self.dr

    @property
    def stride(self):
        """A record's values in the stream: `entries` rounded up to a
        multiple of 4 (whole 16-byte pieces; the rest zeros)."""
        return (self.entries + 3) // 4 * 4

    @property
    def k(self):
        return self.n_dest // max(self.n_rows, 1)


def assembly_table(dests, n_rows, n_dest, dr, dc, device) -> AssemblyTable:
    """The table of one pair (dc > 0) or of b (dc == 0) from each source's
    destinations (a list of numpy int64 [E_s], in source order)."""
    dests = [np.asarray(d, dtype=np.int64) for d in dests]
    dest = (np.concatenate(dests) if dests else np.zeros(0, np.int64))
    order = np.argsort(dest, kind="stable")
    pos = np.empty(len(dest), dtype=np.int64)
    pos[order] = np.arange(len(dest))
    ptr = np.zeros(n_dest + 1, dtype=np.int64)
    np.cumsum(np.bincount(dest, minlength=n_dest), out=ptr[1:])
    cuts = np.cumsum([0] + [len(d) for d in dests])
    i32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                                    device=device)
    return AssemblyTable(
        n_rows, n_dest, dr, dc,
        tuple(torch.as_tensor(d, device=device) for d in dests),
        tuple(i32(pos[cuts[i]:cuts[i + 1]]) for i in range(len(dests))),
        i32(ptr), len(dest))


@dataclass
class Unit:
    """Slot s of edge group `group`: its blocks (s, t) go to table
    targets[t] = (table index, source index in that table), its b part to
    b = (table index, source index)."""
    group: int
    slot: int
    targets: tuple
    b: tuple


@dataclass
class AssemblyPlan:
    """Every table K2' writes, pair tables then each group's b (`tables`),
    the units of pass 1 (`units`, edge group by edge group, slot by slot)
    and each table's offset in the one stream (values, a multiple of 4;
    `offsets`, `stream_len`): a table's contributions in order, a record of
    `stride` values each."""
    tables: tuple
    units: tuple
    offsets: tuple
    stream_len: int


def assembly_plan(tables, units) -> AssemblyPlan:
    offsets, off = [], 0
    for tb in tables:
        offsets.append(off)
        off += tb.n_contrib * tb.stride
    for u in units:
        require(1 <= len(u.targets) <= MAX_SLOTS,
                f"pair_assemble: an edge of {len(u.targets)} vertices "
                f"(at most {MAX_SLOTS})")
    return AssemblyPlan(tuple(tables), tuple(units), tuple(offsets), off)


# -- pair_stream (pass 1) ------------------------------------------------------

def _check_lin(name, plan, lin):
    """lin: per edge group (resid [E, D], [J_s [E, D, D_s] per slot],
    rho' [E], Omega [E, D, D]), as the plan's units read them."""
    dev, dt = lin[0][0].device, lin[0][0].dtype
    for u in plan.units:
        resid, jacs, rho1, info = lin[u.group]
        E, D = resid.shape
        require(1 <= D <= MAX_RESIDUAL,
                f"{name}: edge group {u.group}: residual width {D} outside "
                f"1..{MAX_RESIDUAL}")
        require(len(jacs) == len(u.targets),
                f"{name}: edge group {u.group}: {len(jacs)} Jacobians for "
                f"{len(u.targets)} slots")
        for t, (ti, si) in enumerate(u.targets):
            tb = plan.tables[ti]
            require(jacs[u.slot].shape == (E, D, tb.dr)
                    and jacs[t].shape == (E, D, tb.dc)
                    and tb.pos[si].shape == (E,),
                    f"{name}: edge group {u.group}: the Jacobians of slots "
                    f"{u.slot}, {t} do not fit [E, D, {tb.dr}] / "
                    f"[E, D, {tb.dc}]")
        require(rho1.shape == (E,) and info.shape == (E, D, D),
                f"{name}: edge group {u.group}: rho' must be [E] and Omega "
                "[E, D, D]")
        check_tensors(name, dev, dt, {"resid": resid, "rho1": rho1,
                                      "info": info,
                                      **{f"J{t}": j for t, j in
                                         enumerate(jacs)}}, {})
    return dev, dt


def pair_stream_plain(plan, lin):
    """Plain PyTorch version of pass 1: each unit's blocks and b parts by
    batched products, scattered to their places in the stream."""
    dev, dt = lin[0][0].device, lin[0][0].dtype
    stream = torch.zeros(plan.stream_len, dtype=dt, device=dev)
    for u in plan.units:
        resid, jacs, rho1, info = lin[u.group]
        jw = bmm_small(jacs[u.slot].transpose(1, 2),
                       rho1[:, None, None] * info)             # [E, Dr, D]
        parts = [(bmm_small(jw, jacs[t]), ti, si)
                 for t, (ti, si) in enumerate(u.targets)]
        parts.append((-bmv_small(jw, resid), *u.b))
        for blk, ti, si in parts:
            tb = plan.tables[ti]
            rec = stream[plan.offsets[ti]:plan.offsets[ti] + tb.n_contrib
                         * tb.stride].view(tb.n_contrib, tb.stride)
            rec[tb.pos[si].long(), :tb.entries] = blk.reshape(blk.shape[0],
                                                              -1)
    return stream


def pair_stream(plan, lin):
    """The stream of every table of `plan` (1-d, plan.stream_len values):
    each contribution's block J_s^T (rho' Omega) J_t, or -J_s^T (rho'
    Omega) e for b, as a record of the table's `stride` values (Dr*Dc, or
    Dr, then zeros) at its place. K2''s
    first pass on CUDA tensors (one launch per MAX_UNITS units), the plain
    version on CPU tensors."""
    dev, dt = _check_lin("pair_stream", plan, lin)
    if not launch_device("pair_stream", dev):
        return pair_stream_plain(plan, lin)
    stream = torch.empty(max(plan.stream_len, 1), dtype=dt, device=dev)
    s = stream.element_size()
    base = stream.data_ptr()
    units = list(plan.units)
    for first in range(0, len(units), MAX_UNITS):
        words, block0 = [], 0
        chunk = units[first:first + MAX_UNITS]
        for u in chunk:
            resid, jacs, rho1, info = lin[u.group]
            E, D = resid.shape
            n_t = len(u.targets)
            pad = [0] * (MAX_SLOTS - n_t)
            tabs = [plan.tables[ti] for ti, _ in u.targets]
            bt = plan.tables[u.b[0]]
            words += [jacs[u.slot].data_ptr(), resid.data_ptr(),
                      rho1.data_ptr(), info.data_ptr(),
                      *(jacs[t].data_ptr() for t in range(n_t)), *pad,
                      *(tb.pos[si].data_ptr()
                        for tb, (_, si) in zip(tabs, u.targets)), *pad,
                      *(base + s * plan.offsets[ti] for ti, _ in u.targets),
                      *pad, *(tb.dc for tb in tabs), *pad,
                      bt.pos[u.b[1]].data_ptr(),
                      base + s * plan.offsets[u.b[0]], n_t, E, D,
                      plan.tables[u.targets[0][0]].dr, block0]
            block0 += (E + THREADS - 1) // THREADS
        desc = (ctypes.c_longlong * len(words))(*words)
        build.launch("g2o_pair_stream", stream, desc, len(chunk), block0)
        pair_stream.launches += 1
    return stream


pair_stream.launches = 0


# -- pair_assemble (pass 2) ----------------------------------------------------

def _outputs(plan, dt, dev):
    return [torch.empty((tb.k, tb.entries, tb.n_rows) if tb.dc
                        else (tb.dr, tb.n_rows), dtype=dt, device=dev)
            for tb in plan.tables]


def pair_assemble_plain(plan, stream):
    """Plain PyTorch version of pass 2: each table's records added at
    their destinations (the destination of place m from ptr)."""
    outs = []
    for tb, off in zip(plan.tables, plan.offsets):
        rec = stream[off:off + tb.n_contrib * tb.stride].view(
            tb.n_contrib, tb.stride)[:, :tb.entries]
        counts = torch.diff(tb.ptr.long())
        dest = torch.repeat_interleave(
            torch.arange(tb.n_dest, device=stream.device), counts)
        out = torch.zeros((tb.n_dest, tb.entries), dtype=stream.dtype,
                          device=stream.device).index_add_(0, dest, rec)
        out = out.view(tb.k, tb.n_rows, tb.entries).permute(0, 2, 1)
        outs.append(out.contiguous() if tb.dc else out[0].contiguous())
    return outs


def pair_assemble(plan, stream):
    """Every table of `plan` from pass 1's stream, in plan order: the values
    [K, Dr*Dc, Nr] of each pair table, then b [Dr, N] of each group (a
    destination without contributions, and every padding slot, zeros).
    K2''s second pass on CUDA tensors (one launch per MAX_OUTS tables),
    the plain version on CPU tensors."""
    require(stream.dim() == 1 and stream.numel() >= plan.stream_len,
            f"pair_assemble: the stream must hold {plan.stream_len} values")
    dev, dt = stream.device, stream.dtype
    check_tensors("pair_assemble", dev, dt, {"stream": stream},
                  {f"ptr{i}": tb.ptr for i, tb in enumerate(plan.tables)})
    if not launch_device("pair_assemble", dev):
        return pair_assemble_plain(plan, stream)
    outs = _outputs(plan, dt, dev)
    s, base = stream.element_size(), stream.data_ptr()
    items = list(zip(plan.tables, plan.offsets, outs))
    for first in range(0, len(items), MAX_OUTS):
        words, block0 = [], 0
        chunk = items[first:first + MAX_OUTS]
        for tb, off, out in chunk:
            require(out.numel() < 2 ** 31,
                    "pair_assemble: a table of 2^31 values")
            words += [base + s * off, tb.ptr.data_ptr(), out.data_ptr(),
                      tb.n_rows, tb.n_dest, tb.entries, block0]
            block0 += (tb.n_dest + THREADS - 1) // THREADS
        desc = (ctypes.c_longlong * len(words))(*words)
        build.launch("g2o_pair_sum", stream, desc, len(chunk), block0)
        pair_assemble.launches += 1
    return outs


pair_assemble.launches = 0


# -- pair_scale ---------------------------------------------------------------

def used_slots(rowptr):
    """(row, slot) of every used slot u of the used-slot layout, int64."""
    cnt = torch.diff(rowptr.long())
    rows = torch.repeat_interleave(
        torch.arange(cnt.shape[0], device=rowptr.device), cnt)
    return rows, torch.arange(rows.shape[0], device=rowptr.device) \
        - rowptr.long()[rows]


def padded(svals, rowptr, k):
    """The used-slot values [Dr*Dc, U] of a table as [K, Dr*Dc, Nr], zero
    at the padding slots (plain PyTorch, for comparisons)."""
    rows, slots = used_slots(rowptr)
    out = torch.zeros((k, svals.shape[0], rowptr.shape[0] - 1),
                      dtype=svals.dtype, device=svals.device)
    out[slots, :, rows] = svals.T
    return out


def pair_scale_plain(nb, rowptr, values, linv_r, linv_c, extra=None,
                     used=None):
    """Plain PyTorch version of K4' (sparse.py:731-784 on one layout); U
    from rowptr, `used` ignored."""
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
    S = torch.where(empty, torch.zeros((), dtype=S.dtype, device=S.device), S)
    rows, slots = used_slots(rowptr)
    return S[slots, :, rows].T.contiguous()


def pair_scale(nb, rowptr, values, linv_r, linv_c, extra=None, used=None):
    """The Jacobi-scaled values of one pair table (nb [K, Nr], rowptr
    [Nr + 1], assembled values [K, Dr*Dc, Nr]) in the used-slot layout,
    [Dr*Dc, U] with U = `used` = rowptr[-1]: row factors linv_r
    [Dr*Dr, Nr] (K3's, of the row group), column factors linv_c
    [Dc*Dc, Nc] gathered at nb; `extra` [Nr], given for a square pair only,
    is the damping folded into slot 0. K4' on CUDA tensors, the plain
    version on CPU tensors."""
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
    require(rowptr.shape == (N + 1,), f"pair_scale: rowptr must be [{N + 1}]")
    floats = {"values": values, "linv_r": linv_r, "linv_c": linv_c}
    if extra is not None:
        floats["extra"] = extra
    check_tensors("pair_scale", values.device, values.dtype, floats,
                  {"nb": nb, "rowptr": rowptr})
    if not launch_device("pair_scale", values.device):
        return pair_scale_plain(nb, rowptr, values, linv_r, linv_c, extra)
    require(used is not None and used >= 0,
            "pair_scale: the used slots U (rowptr[-1]) must be given on the "
            "card")
    out = torch.empty((dr * dc, used), dtype=values.dtype,
                      device=values.device)
    if N == 0 or used == 0:
        return out
    build.launch("g2o_pair_scale", values, nb.data_ptr(), rowptr.data_ptr(),
                 values.data_ptr(), linv_r.data_ptr(), linv_c.data_ptr(),
                 0 if extra is None else extra.data_ptr(), out.data_ptr(), N,
                 linv_c.shape[1], K, used, dr, dc)
    pair_scale.launches += 1
    return out


pair_scale.launches = 0


# -- K5' and K8' over every row group: the flat layout -------------------------

@dataclass
class FlatTable:
    """One pair table of a row group in the used-slot layout: rowptr
    [Nr + 1], cols [U], values [Dr*Dc, U]; dc, the column group's offset
    in the flat vectors and its vertices."""
    rowptr: torch.Tensor
    cols: torch.Tensor
    values: torch.Tensor
    dc: int
    col_off: int
    ncol: int

    @property
    def used(self):
        return self.cols.shape[0]


@dataclass
class FlatGroup:
    """One row group: width dr, n rows, its offset in the flat vectors and
    its tables (FlatTable, in pattern order)."""
    dr: int
    n: int
    off: int
    tables: tuple


# Threads a row of csrc/pair_ell.cu pair_flat (`lanes`, which walk a row's
# used slots table by table), chosen from the sweep of K5''s shapes on the
# card (kernel_times.py --only pairs, phase 4s's and 4f's worlds): a row
# group of fewer than BIG_GROUP rows takes 32 lanes a row (threads enough
# to keep the card busy at small shapes; a landmark row seen by 27 poses on
# average fills them), a larger one the power of two nearest its rows'
# average used slots in their fullest table over SLOTS_PER_LANE (each lane
# walks a few slots; 4 lanes for phase 4s's poses).
SLOTS_PER_LANE = 2.5
BIG_GROUP = 4096


def flat_shape(groups):
    """The lanes a row of each row group."""
    lanes = []
    for g in groups:
        if g.n < BIG_GROUP:
            lanes.append(32)
            continue
        avg = max(t.used for t in g.tables) / g.n / SLOTS_PER_LANE
        lanes.append(int(min(max(2 ** round(np.log2(max(avg, 1.0))), 1),
                             32)))
    return lanes


@dataclass
class FlatLaunch:
    """One launch of K5' or K8' over consecutive row groups (at most
    MAX_GROUPS of them with at most MAX_TABLES tables): its C descriptor,
    its row groups, its first block among all launches' and its blocks."""
    desc: object
    n_groups: int
    block0: int
    blocks: int


class FlatLayout:
    """Every row group's tables and the flat vectors' shape, checked once
    and laid out as K5''s and K8''s C descriptors: `n` values in all,
    `blocks` blocks of THREADS threads over its launches (the partial sums
    K5''s dot writes on the card; one on the CPU). Valid while its tensors
    live unchanged. The vectors, the CG scalars and the partials a call
    gets are checked at their first use only."""

    def __init__(self, groups, name="pair_spmv"):
        require(len(groups) >= 1, f"{name}: no row group")
        first = groups[0].tables[0].values
        self.device, self.dtype = first.device, first.dtype
        self.groups = tuple(groups)
        self.n = sum(g.dr * g.n for g in groups)
        for g in groups:
            pair_width(name, g.dr)
            require(1 <= len(g.tables) <= MAX_PAIRS,
                    f"{name}: 1 to {MAX_PAIRS} pair tables a row group")
            for t in g.tables:
                pair_width(name, t.dc)
                require(t.rowptr.shape == (g.n + 1,)
                        and t.values.shape == (g.dr * t.dc, t.used)
                        and t.cols.dim() == 1
                        and t.col_off + t.dc * t.ncol <= self.n,
                        f"{name}: a table does not fit rowptr [{g.n + 1}], "
                        f"values [{g.dr}*Dc, U] and its column group")
                check_tensors(name, self.device, self.dtype,
                              {"values": t.values},
                              {"rowptr": t.rowptr, "cols": t.cols})
        self.lanes = flat_shape(groups)
        self.on_card = launch_device(name, self.device)
        self.launches, cur = [], []
        for g, lanes in zip(groups, self.lanes):
            if cur and (len(cur) == MAX_GROUPS or sum(
                    len(h.tables) for h, _ in cur) + len(g.tables)
                    > MAX_TABLES):
                self._lay_out(cur)
                cur = []
            cur.append((g, lanes))
        self._lay_out(cur)
        self.blocks = (sum(c.blocks for c in self.launches) if self.on_card
                       else 1)
        self._seen = set()
        self._rows = None

    def _lay_out(self, groups):
        words, tab_words, block0, tab0 = [], [], 0, 0
        for g, lanes in groups:
            words += [g.off, g.n, g.dr, lanes, block0, tab0, len(g.tables)]
            rows = THREADS // lanes
            block0 += (g.n + rows - 1) // rows
            tab0 += len(g.tables)
            for t in g.tables:
                tab_words += [t.rowptr.data_ptr(), t.cols.data_ptr(),
                              t.values.data_ptr(), t.used, t.col_off,
                              t.ncol, t.dc]
        self.launches.append(FlatLaunch(
            (ctypes.c_longlong * (len(words) + len(tab_words)))(
                *words, *tab_words), len(groups),
            sum(c.blocks for c in self.launches), block0))

    def _once(self, name, arg, t, shape, what="a"):
        if t.shape != shape:
            raise ValueError(f"{name}: {arg} must be {what} {list(shape)} "
                             "tensor")
        key = (arg, t.data_ptr())
        if key not in self._seen:
            check_tensors(name, self.device, self.dtype, {arg: t}, {})
            if len(self._seen) > 64:
                self._seen.clear()
            self._seen.add(key)

    def check(self, name, **vectors):
        """Each vector flat [n], contiguous, of the layout's dtype and
        device: checked in full the first time its storage is seen."""
        for arg, v in vectors.items():
            self._once(name, arg, v, (self.n,), "a flat")

    def check_step(self, name, scal=None, partials=None):
        """The CG step's scalar buffer (kernels/cg_step.py, N_SCALARS
        values) and the partials table ([blocks]) as `check` checks a
        vector."""
        if scal is not None:
            self._once(name, "scal", scal, (N_SCALARS,))
        if partials is not None:
            self._once(name, "partials", partials, (self.blocks,))

    def parts(self, flat):
        """Per row group its [N, Dr] part of a flat vector (a view)."""
        return [flat[g.off:g.off + g.dr * g.n].view(g.n, g.dr)
                for g in self.groups]

    def rows(self):
        """Per group and table its used slots' (rows, columns, values
        [Dr*Dc, U]) (the plain versions)."""
        if self._rows is None:
            self._rows = [[(used_slots(t.rowptr)[0], t.cols, t.values)
                           for t in g.tables] for g in self.groups]
        return self._rows


def pair_spmv_plain(layout, x):
    """y = H x over the flat vectors: per row group, the sum over its
    tables, in order, of each used slot's block times its column's x."""
    y = torch.empty_like(x)
    for g, yg, rows in zip(layout.groups, layout.parts(y), layout.rows()):
        acc = torch.zeros((g.dr, g.n), dtype=x.dtype, device=x.device)
        for t, (row_u, cols, vals) in zip(g.tables, rows):
            xc = x[t.col_off:t.col_off + t.dc * t.ncol].view(t.ncol, t.dc)
            xg = xc[cols.long()].T                              # [Dc, U]
            V = vals.reshape(g.dr, t.dc, -1)
            acc.index_add_(1, row_u, (V * xg[None]).sum(dim=1))
        yg.copy_(acc.T)
    return y


def _launch_flat(layout, mode, scal, x, r, x_new, y, partials):
    """Every launch of `layout`, each writing its blocks' partials."""
    ptr = lambda t: 0 if t is None else t.data_ptr()
    s = x.element_size()
    for c in layout.launches:
        build.launch("g2o_pair_flat", x, c.desc, c.n_groups, c.blocks, mode,
                     ptr(scal), x.data_ptr(), ptr(r), ptr(x_new),
                     y.data_ptr(),
                     0 if partials is None
                     else partials.data_ptr() + s * c.block0)
    return len(layout.launches)


def pair_spmv(layout, x):
    """y = H x, flat [n] over every row group (`layout`, a FlatLayout);
    K5' on CUDA tensors (one launch per layout.launches), the plain
    version on CPU tensors."""
    layout.check("pair_spmv", x=x)
    if not layout.on_card:
        return pair_spmv_plain(layout, x)
    y = torch.empty_like(x)
    pair_spmv.launches += _launch_flat(layout, 0, None, x, None, None, y,
                                       None)
    return y


pair_spmv.launches = 0


def _partials(name, layout, partials):
    if partials is None:
        return torch.empty(layout.blocks, dtype=layout.dtype,
                           device=layout.device)
    layout.check_step(name, partials=partials)
    return partials


def pair_spmv_dot_plain(layout, p, partials=None):
    y = pair_spmv_plain(layout, p)
    partials = _partials("pair_spmv_dot", layout, partials)
    partials.zero_()
    partials[:1].copy_(torch.dot(p, y).reshape(1))
    return y, partials


def pair_spmv_dot(layout, p, partials=None):
    """(y, partials): y = H p and the partial sums of p . y, one per block
    (`layout.blocks`; into `partials` when given, the CG step's reused
    table). K5' on CUDA tensors, the plain version on CPU tensors (its
    first partial the dot, the rest zeros)."""
    layout.check("pair_spmv_dot", p=p)
    if not layout.on_card:
        return pair_spmv_dot_plain(layout, p, partials)
    partials = _partials("pair_spmv_dot", layout, partials)
    y = torch.empty_like(p)
    pair_spmv_dot.launches += _launch_flat(layout, 1, None, p, None, None, y,
                                           partials)
    return y, partials


pair_spmv_dot.launches = 0


def pair_spmv_dot_p_plain(layout, scal, p, r, p_new, partials=None):
    p_new.copy_(scal[BETA] * p + r)
    return pair_spmv_dot_plain(layout, p_new, partials)


def pair_spmv_dot_p(layout, scal, p, r, p_new, partials=None):
    """(y, partials) for the next direction p_new = beta p + r (beta from
    the CG step's scalars `scal`, kernels/cg_step.py), written into p_new
    (another buffer than p: the product gathers p at the columns): y = H
    p_new and the partial sums of p_new . y. K5' on CUDA tensors, the
    plain version on CPU tensors."""
    layout.check("pair_spmv_dot_p", p=p, r=r, p_new=p_new)
    layout.check_step("pair_spmv_dot_p", scal=scal)
    if p_new.data_ptr() == p.data_ptr():
        raise ValueError("pair_spmv_dot_p: p_new must be another buffer "
                         "than p")
    if not layout.on_card:
        return pair_spmv_dot_p_plain(layout, scal, p, r, p_new, partials)
    partials = _partials("pair_spmv_dot_p", layout, partials)
    y = torch.empty_like(p)
    pair_spmv_dot_p.launches += _launch_flat(layout, 2, scal, p, r, p_new, y,
                                             partials)
    return y, partials


pair_spmv_dot_p.launches = 0


# -- pair_gershgorin ----------------------------------------------------------

def pair_gershgorin_plain(layout):
    hi = torch.zeros((), dtype=layout.dtype, device=layout.device)
    for g, rows in zip(layout.groups, layout.rows()):
        rowsum = torch.zeros((g.dr, g.n), dtype=layout.dtype,
                             device=layout.device)
        for t, (row_u, _, vals) in zip(g.tables, rows):
            rowsum.index_add_(1, row_u, vals.abs().reshape(
                g.dr, t.dc, -1).sum(dim=1))
        if rowsum.numel():
            hi = torch.maximum(hi, rowsum.max())
    return torch.clamp_min(hi, 1e-3)


def pair_gershgorin(layout):
    """max(max over every row group's rows of sum |S|, 1e-3) as a 0-dim
    tensor on the device, over the scaled tables of `layout` (a
    FlatLayout). One counted call launches the row-sum pass over every
    row group (one per layout.launches) and the final maximum after the
    last. A NaN entry gives NaN."""
    if not layout.on_card:
        return pair_gershgorin_plain(layout)
    partials = torch.empty(max(layout.blocks, 1), dtype=layout.dtype,
                           device=layout.device)
    hi = torch.empty((), dtype=layout.dtype, device=layout.device)
    s = partials.element_size()
    last = layout.launches[-1]
    for c in layout.launches:
        build.launch("g2o_pair_bound", hi, c.desc, c.n_groups, c.blocks,
                     partials.data_ptr() + s * c.block0, partials.data_ptr(),
                     layout.blocks, hi.data_ptr() if c is last else 0)
    pair_gershgorin.launches += 1
    return hi


pair_gershgorin.launches = 0
