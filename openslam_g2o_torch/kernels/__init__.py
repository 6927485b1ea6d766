"""Hand-written CUDA kernels of the LM-PCG main path, of the dense GN/LM
path and of the Schur BA solver, with their wrappers.

Each wrapper takes torch tensors. On CPU tensors it runs the kernel's plain
PyTorch version, which sits beside it in the same module; on CUDA tensors it
launches the kernel (built from kernels/csrc on first use, kernels/build.py)
or raises. There is no fallback between the two and no switch: the device
of the arguments decides. Every wrapper counts the calls in which it
launched its kernel in a plain integer attribute, `wrapper.launches`
(`cg_finish` and `gershgorin_bound` are two-pass reductions: one counted
call launches two kernels per vector, respectively two; `pair_gershgorin`
the row-sum pass over every row group (a launch per range of
MAX_GROUPS of them) and the final maximum, and the K5' wrappers count
the launch per range each; `ba_schur_dense` launches the zero fill of S,
the copy of Hinv into records (counted by `ba_schur_records`, as is W's
copy) and its pair kernel; `ba_wv` and `ba_sandwich` are one launch
each).
`ba_block_inv`, `damp_chol`, `lane_block_mv` and `lane_block_mv_dot`,
which serve several block widths on one path, also count their launches
per width D in `wrapper.launches_by_width` (a Counter);
`trial_retract_groups` counts, per vertex type, the launches that served
a group of that type in `launches_by_type`.

The block-ELL kernels (A, C, K3, K4, `spmv_dot`, `spmv_dot_p`,
`gershgorin_bound`) are instantiated for 3x3 blocks (SE2 poses) and 6x6
blocks (SE3 poses); the shapes of the arguments pick the instantiation.

    A  spmv.block_ell_spmv       block-ELL SpMV            (ROADMAP K5)
    B  edge_se2.edge_se2_blocks  fused SE2 linearizer      (ROADMAP K1)
       edge_se3.edge_se3_blocks  fused SE3 linearizer      (ROADMAP K16)
    C  assemble.assemble_gather  contributor-gather H, b   (ROADMAP K2)
    damp_chol.damp_chol          damping, block Cholesky, b (ROADMAP K3)
    jacobi_scale.jacobi_scale    block-Jacobi scaling      (ROADMAP K4)
    jacobi_scale.lane_block_mv   per-row block apply       (ROADMAP K4)
    jacobi_scale.lane_block_mv_dot  z = M r and r . z partials (ROADMAP K4)
    cg_step.*                    the CG step               (ROADMAP K6)
    chebyshev.*                  Gershgorin + Chebyshev    (ROADMAP K8)
    retract_chi2.retract_chi2    SE2 trial candidate, chi2 (ROADMAP K7)
    retract_chi2.retract_se3     SE3 trial candidate       (ROADMAP K7)
    retract_chi2.se3_edge_chi2   SE3 trial chi2            (ROADMAP K7)
    retract_chi2.lm_outcome      LM trial bookkeeping      (ROADMAP K7)
    dense_assemble.dense_assemble  dense H, b, raw_diag    (ROADMAP K15)
    gather.lane_gather           the probe's lane gather
    ba_edge.ba_xyz2uv_blocks     fused XYZ2UV edge blocks   (ROADMAP K10)
    ba_edge.ba_edge_blocks       generic BA edge blocks     (ROADMAP K10)
    ba_edge.ba_lm_sums           landmark sums, W by lm     (ROADMAP K10)
    ba_edge.ba_cam_sums          camera sums, W by camera   (ROADMAP K10)
    ba_inv.ba_block_inv          damped block inverses     (ROADMAP K11)
    ba_schur.ba_schur_dense      dense reduced system S    (ROADMAP K12)
    ba_schur.ba_schur_records    K12's W and Hinv records  (ROADMAP K12)
    ba_coupling.ba_wtx           W^T x, landmark solve     (ROADMAP K13)
    ba_coupling.ba_wv            W v, S x, reduced rhs     (ROADMAP K13)
    ba_coupling.ba_sandwich      preconditioner blocks     (ROADMAP K13)
    schur_general.schur_edge_blocks  general Schur edge blocks (ROADMAP K14)
    edge_lin.edge_lin_*          edge linearizers          (ROADMAP K17)
    trial.trial_retract_groups   a trial's candidate, all groups (ROADMAP K7)
    trial.trial_chi2_*           trial chi2 per edge type  (ROADMAP K7)
    trial.chi2_sum               the chi2 partials' sum    (ROADMAP K7)
    pair_ell.pair_stream         pair blocks, edge-major   (ROADMAP K2')
    pair_ell.pair_assemble       pair tables' values and b (ROADMAP K2')
    pair_ell.pair_scale          pair block-Jacobi scaling (ROADMAP K4')
    pair_ell.pair_spmv(_dot)(_p) pair SpMV, with the dot, with the p
                                 update folded in          (ROADMAP K5')
    pair_ell.pair_gershgorin     pair Gershgorin bound     (ROADMAP K8')

The `edge_lin` wrappers, one per edge type of openslam_g2o_torch.models
(`edge_lin.LINEARIZERS`: twenty-one in forward mode, EDGE_SE2 and the two
XYZ2UV projections in closed form), serve core/problem.py
`linearize_group` on the dense routes, the general Schur path and K10's
generic entry; a type registered at run time keeps the generic route.
The `trial` wrappers, `trial_retract_groups` over every vertex group
(`trial.RETRACT_IDS`) and one per edge type (`trial.CHI2`, from K17's
functors), serve every trial of
the dense GN / LM, the dual-ELL Schur and the general Schur routes and the
chi2 at their inits (core/problem.py `trial_candidate`,
`robust_chi2_parts`, `robust_chi2`, `lm_trial_outcome`).

The dual-ELL solver takes (Dp, dl) = (6, 3), (3, 2) and (9, 3), the last
the BAL camera of models/bal.py: K10's generic entry and owner sums, K12
and K13 at (9, 3), K11 and K4's `lane_block_mv_dot` at D = 9.

The general Schur path (core/ba.py) runs K14 `schur_edge_blocks` at (Dp,
dl) = (6, 3), (4, 3), (3, 2) and (9, 3) (the BAL camera: residual widths 1
and 2 only), K10's `ba_lm_sums` without its W layout, K13's products
(`ba_wtx` in one launch over all its pose groups, `ba_wv` and
`ba_sandwich` per pose group, all three at (Dp, dl) = (4, 3) too), K11
and K4's `lane_block_mv_dot` at D = 4 and 9, and K15 on the pose slots of its
edges. K15 takes block widths up to 9 (the BAL camera on the dense GN / LM
route and on the general path's pose slots).

LM-PCG over several vertex groups (core/sparse.py `PairPattern`: every
graph but one group of SE2 or SE3 poses with only EDGE_SE2 / EDGE_SE3
edges) runs the pair kernels at block widths (Dr, Dc) in {2, 3, 6}^2,
K3 `damp_chol` and K4's `lane_block_mv` per vertex group (D = 2 too), and
K6's vector kernels once over the flat vector of all groups (the
two-launch CG step) or on each group's part (a preconditioned solve).
"""
from __future__ import annotations

from openslam_g2o_torch.kernels import (
    assemble, ba_coupling, ba_edge, ba_inv, ba_schur, cg_step, chebyshev,
    damp_chol, dense_assemble, edge_lin, edge_se2, edge_se3, gather,
    jacobi_scale, pair_ell, retract_chi2, schur_general, spmv, trial)

# the wrapper functions, which own the launch counts (several share their
# module's name, so the modules are what this package exports)
WRAPPERS = (
    spmv.block_ell_spmv, edge_se2.edge_se2_blocks, edge_se3.edge_se3_blocks,
    assemble.assemble_gather,
    damp_chol.damp_chol, jacobi_scale.jacobi_scale,
    jacobi_scale.lane_block_mv, jacobi_scale.lane_block_mv_dot,
    cg_step.spmv_dot, cg_step.spmv_dot_p, cg_step.dot_partials,
    cg_step.cg_residual, cg_step.cg_start, cg_step.cg_update_xr,
    cg_step.cg_update_p, cg_step.cg_finish, chebyshev.gershgorin_bound,
    chebyshev.chebyshev_coeffs, chebyshev.chebyshev_init,
    chebyshev.chebyshev_update, gather.lane_gather,
    retract_chi2.retract_chi2, retract_chi2.retract_se3,
    retract_chi2.se3_edge_chi2, retract_chi2.lm_outcome,
    dense_assemble.dense_assemble, ba_edge.ba_xyz2uv_blocks,
    ba_edge.ba_edge_blocks, ba_edge.ba_lm_sums, ba_edge.ba_cam_sums,
    ba_inv.ba_block_inv, ba_schur.ba_schur_dense, ba_schur.ba_schur_records,
    ba_coupling.ba_wtx,
    ba_coupling.ba_wv, ba_coupling.ba_sandwich,
    schur_general.schur_edge_blocks, pair_ell.pair_stream,
    pair_ell.pair_assemble, pair_ell.pair_scale, pair_ell.pair_spmv,
    pair_ell.pair_spmv_dot, pair_ell.pair_spmv_dot_p,
    pair_ell.pair_gershgorin, *edge_lin.WRAPPERS, *trial.WRAPPERS)


def launch_counts() -> dict:
    """{wrapper name: calls that launched its kernel so far}."""
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts():
    for w in WRAPPERS:
        w.launches = 0
        for by in ("launches_by_width", "launches_by_type"):
            if hasattr(w, by):
                getattr(w, by).clear()
