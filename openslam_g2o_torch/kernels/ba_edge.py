"""K10: the per-linearization pass of the Schur BA solver
(csrc/ba_edge_blocks.cu).

Replaces the per-edge products and owner sums of `_build`
(openslam_g2o_tpu/core/ba_ell.py:537-619: `_reduce_k_lane`:445,
`_gather_w_lane`:464) and, in the fused entry, the linearization of
EDGE_PROJECT_XYZ2UV (models/sba.py:147-185).

Per observation (an edge between landmark l and camera c, residual r,
Jacobians Jl [r, dl] and Jc [r, Dp], robust weight w, information Omega):

    Hll_e = Jl^T w Omega Jl    b_l,e = -Jl^T w Omega r    W_e = Jc^T w Omega Jl
    Hcc_e = Jc^T w Omega Jc    b_p,e = -Jc^T w Omega r

written into `EdgeStreams` (one column or record per observation of every
projection group, group after group): the landmark half and W lane-major in
observation order, the camera half (W too) as one record per observation at
its place in its camera's CSR list (`cam_pos`), so that each camera's
records lie in order. `ba_lm_sums` sums Hll and b_l per landmark over the slot
table [K, L] and lays W out landmark-major [Dp*dl, K, L]; `ba_cam_sums`
sums Hcc and b_p per camera over the records, chunk by chunk (K13's
`PoseRows`), and lays W out camera-major [Dp*dl, E] in CSR order.
(Dp, dl) is (6, 3), (3, 2) or (9, 3), the residual width 1 to 3.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from openslam_g2o_torch.core import registry, robust
from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)

# the (Dp, dl) instantiations; (9, 3): the BAL camera of models/bal.py
BLOCK_DIMS = ((6, 3), (3, 2), (9, 3))
MAX_RESIDUAL = 3


def record_size(dp, dl):
    """Values per camera record: Hcc_e, b_p,e and W_e, padded with zeros
    to a multiple of 8 (CamRecord of csrc/ba_blocks.cuh)."""
    return (dp * dp + dp + dp * dl + 7) // 8 * 8


def _records(hcc, bp, w, rs):
    """[n, rs] records from lane-major [rows, n] blocks."""
    n = hcc.shape[1]
    pad = hcc.new_zeros((n, rs - hcc.shape[0] - bp.shape[0] - w.shape[0]))
    return torch.cat([hcc.T, bp.T, w.T, pad], dim=1)


@dataclass
class EdgeStreams:
    """The per-observation blocks of one linearization. Lane-major in
    observation order, for the landmark sums: hll [dl*dl, E], bl [dl, E],
    w [Dp*dl, E]. Camera half: rec [E, RS], whose row cam_pos[e] ([E]
    int32: the observation's place in its camera's CSR list) holds
    observation e's record Hcc_e (Dp*Dp, row-major), b_p,e (Dp), W_e
    (Dp*dl, row-major) and zeros up to RS = record_size(Dp, dl)."""
    hll: torch.Tensor
    bl: torch.Tensor
    w: torch.Tensor
    rec: torch.Tensor
    cam_pos: torch.Tensor

    @classmethod
    def empty(cls, n_obs, dp, dl, dtype, device, cam_pos):
        new = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
        return cls(new(dl * dl, n_obs), new(dl, n_obs), new(dp * dl, n_obs),
                   new(n_obs, record_size(dp, dl)), cam_pos)

    @classmethod
    def from_lane_major(cls, hll, bl, w, hcc, bp, cam_pos):
        """The streams of lane-major [rows, E] blocks in observation
        order."""
        dp, dl = bp.shape[0], bl.shape[0]
        rec = hcc.new_empty((hcc.shape[1], record_size(dp, dl)))
        rec[cam_pos.long()] = _records(hcc, bp, w, rec.shape[1])
        return cls(hll, bl, w, rec, cam_pos)

    @property
    def dims(self):
        dl = self.bl.shape[0]
        return self.w.shape[0] // dl, dl

    @property
    def n_obs(self):
        return self.bl.shape[1]

    def lane_major(self):
        """(hll, bl, w, hcc, bp), each [rows, E] in observation order."""
        dp, dl = self.dims
        r = self.rec[self.cam_pos.long()].T
        nh, nb = dp * dp, dp * dp + dp
        return (self.hll, self.bl, r[nb:nb + dp * dl], r[:nh], r[nh:nb])

    def tensors(self):
        return (self.hll, self.bl, self.w, self.rec)


def _check_streams(name, out, device, dtype):
    dp, dl = out.dims
    require((dp, dl) in BLOCK_DIMS,
            f"{name}: (Dp, dl) = {(dp, dl)} not in {BLOCK_DIMS}")
    n = out.n_obs
    shapes = {"hll": (dl * dl, n), "bl": (dl, n), "w": (dp * dl, n),
              "rec": (n, record_size(dp, dl))}
    floats = {k: getattr(out, k) for k in shapes}
    for k, t in floats.items():
        require(t.shape == shapes[k], f"{name}: stream {k} shape "
                f"{tuple(t.shape)} != {shapes[k]}")
    require(out.cam_pos.shape == (n,), f"{name}: cam_pos must be [{n}]")
    check_tensors(name, device, dtype, floats, {"cam_pos": out.cam_pos})


def edge_products_plain(resid, jl, jc, rho1, info):
    """The per-edge products in the JAX order of operations
    (ba_ell.py:563-576), as lane-major [rows, E] tensors
    (hll, bl, w, hcc, bp)."""
    E = resid.shape[0]
    w_omega = rho1[:, None, None] * info                      # [E, R, R]
    jl_w = (jl[:, :, :, None] * w_omega[:, :, None, :]).sum(dim=1)
    jc_w = (jc[:, :, :, None] * w_omega[:, :, None, :]).sum(dim=1)
    hll = (jl_w[:, :, :, None] * jl[:, None]).sum(dim=2)      # [E, dl, dl]
    bl = -(jl_w * resid[:, None, :]).sum(dim=2)
    wb = (jc_w[:, :, :, None] * jl[:, None]).sum(dim=2)       # [E, Dp, dl]
    hcc = (jc_w[:, :, :, None] * jc[:, None]).sum(dim=2)
    bp = -(jc_w * resid[:, None, :]).sum(dim=2)
    return tuple(x.reshape(E, -1).T for x in (hll, bl, wb, hcc, bp))


def _write(out, offset, blocks):
    """Lane-major blocks of observations offset .. offset + n into the
    streams: the landmark half and W at their columns, the records at
    cam_pos."""
    hll, bl, w, hcc, bp = blocks
    cols = slice(offset, offset + hll.shape[1])
    out.hll[:, cols] = hll
    out.bl[:, cols] = bl
    out.w[:, cols] = w
    out.rec[out.cam_pos[cols].long()] = _records(hcc, bp, w,
                                                 out.rec.shape[1])


def _outputs(out):
    """The edge kernels' output pointers: hll, bl, rec, w."""
    return (out.hll.data_ptr(), out.bl.data_ptr(), out.rec.data_ptr(),
            out.w.data_ptr())


def ba_edge_blocks_plain(resid, jl, jc, rho1, info, out, offset):
    _write(out, offset, edge_products_plain(resid, jl, jc, rho1, info))


def ba_edge_blocks(resid, jl, jc, rho1, info, out: EdgeStreams, offset: int):
    """The generic entry: write the products of one edge group's
    observations (residual [E, R], masked Jacobians jl [E, R, dl] and
    jc [E, R, Dp], rho' [E], Omega [E, R, R], as `linearize` returns them)
    into observations offset .. offset + E of `out`. K10 on CUDA tensors,
    the plain version on CPU tensors."""
    E, R = resid.shape
    dp, dl = out.dims
    require(1 <= R <= MAX_RESIDUAL, f"ba_edge_blocks: residual width {R} "
            f"not in 1..{MAX_RESIDUAL}")
    require(jl.shape == (E, R, dl) and jc.shape == (E, R, dp)
            and rho1.shape == (E,) and info.shape == (E, R, R),
            f"ba_edge_blocks: jl {tuple(jl.shape)}, jc {tuple(jc.shape)}, "
            f"rho1 {tuple(rho1.shape)}, info {tuple(info.shape)} do not fit "
            f"E={E}, R={R}, (Dp, dl)={(dp, dl)}")
    require(0 <= offset and offset + E <= out.n_obs,
            "ba_edge_blocks: offset out of range")
    _check_streams("ba_edge_blocks", out, resid.device, resid.dtype)
    check_tensors("ba_edge_blocks", resid.device, resid.dtype,
                  {"resid": resid, "jl": jl, "jc": jc, "rho1": rho1,
                   "info": info}, {})
    if not launch_device("ba_edge_blocks", resid.device):
        return ba_edge_blocks_plain(resid, jl, jc, rho1, info, out, offset)
    if E == 0:
        return None
    build.launch("g2o_ba_generic", resid, resid.data_ptr(), jl.data_ptr(),
                 jc.data_ptr(), rho1.data_ptr(), info.data_ptr(),
                 out.cam_pos.data_ptr(), E, offset, out.n_obs, R, dp, dl,
                 *_outputs(out))
    ba_edge_blocks.launches += 1
    return None


ba_edge_blocks.launches = 0


def ba_xyz2uv_blocks_plain(points, cams, li, ci, meas, info, delta, camp,
                           free_l, free_c, kernel_id, out, offset):
    et = registry.edge_type("edge_project_xyz2uv")
    vp = (points[li.long()], cams[ci.long()])
    resid = et.error(vp, meas, (camp,))
    jl, jc = et.jacobian(vp, meas, (camp,))
    e2 = (resid[:, :, None] * info * resid[:, None, :]).sum(dim=(1, 2))
    _, rho1, _ = robust.robustify(kernel_id, e2, delta)
    jl = jl * free_l[li.long()][:, None, None]
    jc = jc * free_c[ci.long()][:, None, None]
    _write(out, offset, edge_products_plain(resid, jl, jc, rho1, info))


def ba_xyz2uv_blocks(points, cams, li, ci, meas, info, delta, camp, free_l,
                     free_c, kernel_id: int, out: EdgeStreams, offset: int):
    """The fused entry for EDGE_PROJECT_XYZ2UV: residual, analytic
    Jacobians, fixed-vertex masks and rho' of every edge (points [L, 3],
    world-to-camera cams [C, 7], li/ci [E] int32, meas [E, 2], info
    [E, 2, 2], delta [E], camera parameters camp [E, 4], free_l [L],
    free_c [C]) and their products into observations offset .. offset + E
    of `out` (Dp, dl = 6, 3). K10 on CUDA tensors, the plain version on CPU
    tensors."""
    E = li.shape[0]
    require(out.dims == (6, 3), "ba_xyz2uv_blocks: the streams must be "
            "(Dp, dl) = (6, 3)")
    require(points.dim() == 2 and points.shape[1] == 3
            and cams.dim() == 2 and cams.shape[1] == 7
            and ci.shape == (E,) and meas.shape == (E, 2)
            and info.shape == (E, 2, 2) and delta.shape == (E,)
            and camp.shape == (E, 4) and free_l.shape == (points.shape[0],)
            and free_c.shape == (cams.shape[0],),
            "ba_xyz2uv_blocks: argument shapes do not fit")
    require(0 <= offset and offset + E <= out.n_obs,
            "ba_xyz2uv_blocks: offset out of range")
    require(0 <= kernel_id < len(robust.kernel_names()),
            f"ba_xyz2uv_blocks: robust kernel id {kernel_id} unknown")
    _check_streams("ba_xyz2uv_blocks", out, points.device, points.dtype)
    check_tensors("ba_xyz2uv_blocks", points.device, points.dtype,
                  {"points": points, "cams": cams, "meas": meas,
                   "info": info, "delta": delta, "camp": camp,
                   "free_l": free_l, "free_c": free_c},
                  {"li": li, "ci": ci})
    if not launch_device("ba_xyz2uv_blocks", points.device):
        return ba_xyz2uv_blocks_plain(points, cams, li, ci, meas, info,
                                      delta, camp, free_l, free_c, kernel_id,
                                      out, offset)
    if E == 0:
        return None
    build.launch("g2o_ba_xyz2uv", points, points.data_ptr(), cams.data_ptr(),
                 li.data_ptr(), ci.data_ptr(), meas.data_ptr(),
                 info.data_ptr(), delta.data_ptr(), camp.data_ptr(),
                 free_l.data_ptr(), free_c.data_ptr(), out.cam_pos.data_ptr(),
                 kernel_id, E, offset, out.n_obs, *_outputs(out))
    ba_xyz2uv_blocks.launches += 1
    return None


ba_xyz2uv_blocks.launches = 0


@dataclass
class LandmarkStreams:
    """The landmark half of the per-edge blocks, lane-major: hll
    [dl*dl, E], bl [dl, E] (the general Schur path, core/ba.py, whose edge
    kernel writes W in place)."""
    hll: torch.Tensor
    bl: torch.Tensor


def ba_lm_sums_plain(streams, lm_edge, with_w=True):
    valid = lm_edge >= 0
    idx = lm_edge.clamp_min(0).long()
    zero = torch.zeros((), dtype=streams.bl.dtype, device=streams.bl.device)
    take = lambda s: torch.where(valid, s[:, idx], zero)     # [rows, K, L]
    return (take(streams.hll).sum(dim=1), take(streams.bl).sum(dim=1),
            take(streams.w) if with_w else None)


def ba_lm_sums(streams, lm_edge, with_w=True):
    """(Hll [dl*dl, L], b_l [dl, L], W_lm [Dp*dl, K, L]) from the streams
    and the landmark slot table lm_edge [K, L] (observation id, -1 on
    padding; W_lm is zero there). with_w=False sums Hll and b_l alone and
    returns None for W_lm; `streams` then only needs hll and bl (a
    LandmarkStreams). K10 on CUDA tensors, the plain version on CPU
    tensors."""
    require(lm_edge.dim() == 2, "ba_lm_sums: lm_edge must be [K, L]")
    K, L = lm_edge.shape
    dev, dt = streams.bl.device, streams.bl.dtype
    dl = streams.bl.shape[0]
    if with_w:
        dp, dl = streams.dims
        _check_streams("ba_lm_sums", streams, dev, dt)
    else:
        require(dl in (2, 3), f"ba_lm_sums: dl = {dl} not in (2, 3)")
        dp = 6 if dl == 3 else 3          # the instantiation; W untouched
        require(streams.hll.shape == (dl * dl, streams.bl.shape[1]),
                "ba_lm_sums: hll must be [dl*dl, E] beside bl [dl, E]")
        check_tensors("ba_lm_sums", dev, dt,
                      {"hll": streams.hll, "bl": streams.bl}, {})
    check_tensors("ba_lm_sums", dev, dt, {}, {"lm_edge": lm_edge})
    if not launch_device("ba_lm_sums", dev):
        return ba_lm_sums_plain(streams, lm_edge, with_w)
    hll = torch.empty((dl * dl, L), dtype=dt, device=dev)
    bl = torch.empty((dl, L), dtype=dt, device=dev)
    w_lm = (torch.empty((dp * dl, K, L), dtype=dt, device=dev) if with_w
            else None)
    if L == 0:
        return hll, bl, w_lm
    build.launch("g2o_ba_lm_sums", bl, streams.hll.data_ptr(),
                 streams.bl.data_ptr(),
                 streams.w.data_ptr() if with_w else None,
                 lm_edge.data_ptr(), L, K, streams.bl.shape[1], dp, dl,
                 hll.data_ptr(), bl.data_ptr(),
                 None if w_lm is None else w_lm.data_ptr())
    ba_lm_sums.launches += 1
    return hll, bl, w_lm


ba_lm_sums.launches = 0


def ba_cam_sums_plain(streams, rows):
    dp, dl = streams.dims
    nh, nb = dp * dp, dp * dp + dp
    counts = (rows.ptr[1:] - rows.ptr[:-1]).long()
    owner = torch.repeat_interleave(
        torch.arange(rows.n_rows, device=counts.device), counts)
    rec = streams.rec
    sums = torch.zeros((rows.n_rows, nb), dtype=rec.dtype,
                       device=rec.device).index_add_(0, owner, rec[:, :nb])
    return (sums[:, :nh].T.contiguous(), sums[:, nh:].T.contiguous(),
            rec[:, nb:nb + dp * dl].T.contiguous())


def ba_cam_sums(streams: EdgeStreams, rows):
    """(Hcc [Dp*Dp, C], b_p [Dp, C], W_cam [Dp*dl, E]) from the records and
    the camera lists `rows` (K13's PoseRows: the records of camera c are
    rows.ptr[c]:rows.ptr[c+1], cut into chunks; W_cam follows that CSR
    order). The kernel counts its chunks' arrivals in rows.arrivals and
    leaves them at zero (as `ba_wv` does: one PoseRows serves one launch
    at a time). K10 on CUDA tensors, the plain version on CPU tensors."""
    dp, dl = streams.dims
    E = streams.n_obs
    require(rows.n_entries == E, "ba_cam_sums: the camera lists must hold "
            f"the {E} observations")
    dev, dt = streams.bl.device, streams.bl.dtype
    _check_streams("ba_cam_sums", streams, dev, dt)
    check_tensors("ba_cam_sums", dev, dt, {},
                  {"ptr": rows.ptr, "chunk_ptr": rows.chunk_ptr,
                   "chunk_row": rows.chunk_row, "row_chunk": rows.row_chunk,
                   "arrivals": rows.arrivals})
    if not launch_device("ba_cam_sums", dev):
        return ba_cam_sums_plain(streams, rows)
    C, n_chunks = rows.n_rows, rows.n_chunks
    hcc = torch.empty((dp * dp, C), dtype=dt, device=dev)
    bp = torch.empty((dp, C), dtype=dt, device=dev)
    w_cam = torch.empty((dp * dl, E), dtype=dt, device=dev)
    if C == 0:
        return hcc, bp, w_cam
    part = torch.empty((dp * dp + dp, n_chunks), dtype=dt, device=dev)
    build.launch("g2o_ba_cam_sums", bp, streams.rec.data_ptr(),
                 rows.chunk_ptr.data_ptr(), rows.chunk_row.data_ptr(),
                 rows.row_chunk.data_ptr(), rows.arrivals.data_ptr(),
                 n_chunks, C, E, dp, dl, part.data_ptr(), hcc.data_ptr(),
                 bp.data_ptr(), w_cam.data_ptr())
    ba_cam_sums.launches += 1
    return hcc, bp, w_cam


ba_cam_sums.launches = 0
