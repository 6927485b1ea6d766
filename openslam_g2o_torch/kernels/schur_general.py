"""K14: the general Schur path's per-edge landmark blocks
(csrc/schur_general.cu).

Replaces the per-edge products and sorted segment sums of `schur_build`
(openslam_g2o_tpu/core/ba.py:81-168). A *W entry* is one (edge, pose slot)
pair of an edge with a landmark slot: W_e = J_t^T (rho' Omega) J_l
[Dp, dl]. An edge of the ternary EDGE_PROJECT_PSI2UV has two, in one pose
group; one of EDGE_PROJECT_P2MC_INTRINSICS has two, in two pose groups.
The entries of one pose group live twice, as K13's products read them
(kernels/ba_coupling.py):

* landmark-major W_lm [Dp*dl, K, L]: the entries of landmark l in slots
  k = 0.. in entry order, with the pose of each slot in lm_pose [K, L]
  (-1 on padding): read by `ba_wtx` (W^T x), one launch over the pose
  groups;
* pose-major W_pose [Dp*dl, M] in the CSR order of `ba_coupling.PoseRows`:
  read by `ba_wv` (W v) and `ba_sandwich` (the preconditioner blocks).

`schur_edge_blocks` writes W into both at host-built positions, and the
landmark blocks Hll_e, b_l,e into lane-major streams that K10's
`ba_lm_sums` sums per landmark. On the card each layout is written in its
own order, by host-built tables (`edge_orders`): the landmark-major one a
tile of EDGE_TILE edges at a time, in the order of the tile's slots; the
pose-major one a position at a time, in CSR order.
"""
from __future__ import annotations

import numpy as np

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)

# the (Dp, dl) instantiations of K14 (csrc/schur_general.cu): the general
# path's pose widths, (9, 3) the BAL camera of models/bal.py
DIMS = ((6, 3), (4, 3), (3, 2), (9, 3))

MAX_RESIDUAL = 3
# narrower residual limits of some instantiations: at (9, 3) a float64 tile
# of 3-wide residuals would stage 50,176 bytes, over the 48 KB of the tile
# kernel's static shared array; no built-in type has one on the BAL camera
MAX_RESIDUAL_AT = {(9, 3): 2}


def check_served(R, dp, dl, who="schur_edge_blocks"):
    """Raise NotImplementedError, naming `who`, unless K14 is instantiated
    for residual width R at (Dp, dl) (on either device, so that the CPU
    refuses what the card would)."""
    if (dp, dl) not in DIMS:
        raise NotImplementedError(
            f"{who}: (pose, landmark) tangent widths {(dp, dl)} are not "
            f"among the kernels' instantiations {DIMS}")
    limit = MAX_RESIDUAL_AT.get((dp, dl), MAX_RESIDUAL)
    if not 1 <= R <= limit:
        raise NotImplementedError(
            f"{who}: residual width {R} at (Dp, dl) = {(dp, dl)}; the "
            f"kernels take 1..{limit}")


# the edges a block of csrc/schur_general.cu's tile kernel stages (its
# kEdgeTile; the launch checks the two agree)
EDGE_TILE = 128


def edge_orders(lm_pos, pose_pos):
    """The two tables the kernel writes W by, for one (edge group, pose
    slot) with positions lm_pos, pose_pos [E] (numpy, distinct within
    each): lm_order, each tile of EDGE_TILE consecutive edges sorted by
    lm_pos, and pose_order, every edge sorted by pose_pos. Both are
    permutations of range(E)."""
    tile = np.arange(len(lm_pos)) // EDGE_TILE
    return (np.lexsort((lm_pos, tile)),
            np.argsort(pose_pos, kind="stable"))


def schur_edge_blocks_plain(resid, jl, jp, rho1, info, hll, bl, offset,
                            w_lm=None, lm_pos=None, w_pose=None,
                            pose_pos=None, lm_order=None, pose_order=None):
    """The wrapper's function in torch; it takes the wrapper's arguments
    (a caller may swap one for the other) and needs no write orders."""
    E = resid.shape[0]
    w_omega = rho1[:, None, None] * info                      # [E, R, R]
    if hll is not None:
        jl_w = (jl[:, :, :, None] * w_omega[:, :, None, :]).sum(dim=1)
        hll[:, offset:offset + E] = (jl_w[:, :, :, None] * jl[:, None]).sum(
            dim=2).reshape(E, -1).T
        bl[:, offset:offset + E] = -(jl_w * resid[:, None, :]).sum(dim=2).T
    if jp is not None:
        jp_w = (jp[:, :, :, None] * w_omega[:, :, None, :]).sum(dim=1)
        W = (jp_w[:, :, :, None] * jl[:, None]).sum(dim=2).reshape(E, -1).T
        w_lm.view(w_lm.shape[0], -1)[:, lm_pos.long()] = W
        w_pose[:, pose_pos.long()] = W


def schur_edge_blocks(resid, jl, jp, rho1, info, hll, bl, offset: int,
                      w_lm=None, lm_pos=None, w_pose=None, pose_pos=None,
                      lm_order=None, pose_order=None):
    """One edge group's landmark blocks for one of its pose slots: from the
    residual [E, R], the masked landmark Jacobian jl [E, R, dl], the pose
    slot's jp [E, R, Dp] (None for an edge without a pose slot), rho' [E]
    and Omega [E, R, R], write Hll_e and b_l,e into columns offset ..
    offset + E of the streams hll [dl*dl, E_all] and bl [dl, E_all] (both
    None for every pose slot but the first), and W_e into w_lm
    [Dp*dl, K, L] at flat slot lm_pos[e] (= k L + l) and into w_pose
    [Dp*dl, M] at position pose_pos[e]. lm_order and pose_order [E], given
    with W, are `edge_orders(lm_pos, pose_pos)` (core/ba.py builds them
    with the pattern). K14 on CUDA tensors, the plain version on CPU
    tensors, which does not read the tables."""
    E, R = resid.shape
    dl = jl.shape[2]
    require(jl.shape == (E, R, dl) and rho1.shape == (E,)
            and info.shape == (E, R, R),
            f"schur_edge_blocks: jl {tuple(jl.shape)}, rho1 "
            f"{tuple(rho1.shape)}, info {tuple(info.shape)} do not fit E={E}, "
            f"R={R}")
    require((hll is None) == (bl is None) and (hll is not None
                                              or jp is not None),
            "schur_edge_blocks: hll and bl go together, and a call writes "
            "them or W")
    floats = {"resid": resid, "jl": jl, "rho1": rho1, "info": info}
    ints = {}
    if hll is not None:
        require(hll.dim() == 2 and hll.shape[0] == dl * dl
                and bl.shape == (dl, hll.shape[1])
                and 0 <= offset and offset + E <= hll.shape[1],
                "schur_edge_blocks: hll must be [dl*dl, E_all] and bl "
                "[dl, E_all] with room for the group at offset")
        floats.update(hll=hll, bl=bl)
    if jp is not None:
        dp = jp.shape[2]
        require(jp.shape == (E, R, dp),
                f"schur_edge_blocks: jp {tuple(jp.shape)} does not fit E={E}, "
                f"R={R}")
        require(w_lm is not None and w_lm.dim() == 3
                and w_lm.shape[0] == dp * dl and w_pose is not None
                and w_pose.dim() == 2 and w_pose.shape[0] == dp * dl
                and lm_pos is not None and lm_pos.shape == (E,)
                and pose_pos is not None and pose_pos.shape == (E,)
                and lm_order is not None and lm_order.shape == (E,)
                and pose_order is not None and pose_order.shape == (E,),
                "schur_edge_blocks: W needs w_lm [Dp*dl, K, L], w_pose "
                "[Dp*dl, M], the positions lm_pos, pose_pos [E] and the "
                "write orders lm_order, pose_order [E]")
        floats.update(jp=jp, w_lm=w_lm, w_pose=w_pose)
        ints.update(lm_pos=lm_pos, pose_pos=pose_pos, lm_order=lm_order,
                    pose_order=pose_order)
    else:
        dp = 6 if dl == 3 else 3          # the instantiation; W untouched
    check_served(R, dp, dl)
    check_tensors("schur_edge_blocks", resid.device, resid.dtype, floats, ints)
    if not launch_device("schur_edge_blocks", resid.device):
        return schur_edge_blocks_plain(resid, jl, jp, rho1, info, hll, bl,
                                       offset, w_lm, lm_pos, w_pose, pose_pos)
    if E == 0:
        return None
    ptr = lambda t: None if t is None else t.data_ptr()
    build.launch("g2o_schur_edge", resid, resid.data_ptr(), jl.data_ptr(),
                 ptr(jp), rho1.data_ptr(), info.data_ptr(), E, offset,
                 0 if hll is None else hll.shape[1], R, dp, dl, ptr(hll),
                 ptr(bl), ptr(lm_pos), ptr(lm_order),
                 0 if w_lm is None else w_lm.shape[1] * w_lm.shape[2],
                 ptr(w_lm), ptr(pose_pos), ptr(pose_order),
                 0 if w_pose is None else w_pose.shape[1], ptr(w_pose),
                 EDGE_TILE)
    schur_edge_blocks.launches += 1
    return None


schur_edge_blocks.launches = 0
