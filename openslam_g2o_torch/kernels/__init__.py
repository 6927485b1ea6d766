"""Hand-written CUDA kernels of the LM-PCG main path and of the dense GN/LM
path, with their wrappers.

Each wrapper takes torch tensors. On CPU tensors it runs the kernel's plain
PyTorch version, which sits beside it in the same module; on CUDA tensors it
launches the kernel (built from kernels/csrc on first use, kernels/build.py)
or raises. There is no fallback between the two and no switch: the device
of the arguments decides. Every wrapper counts the calls in which it
launched its kernel in a plain integer attribute, `wrapper.launches`
(`cg_finish` and `gershgorin_bound` are two-pass reductions: one counted
call launches two kernels per vector, respectively two).

The block-ELL kernels (A, C, K3, K4, `spmv_dot`, `gershgorin_bound`) are
instantiated for 3x3 blocks (SE2 poses) and 6x6 blocks (SE3 poses); the
shapes of the arguments pick the instantiation.

    A  spmv.block_ell_spmv       block-ELL SpMV            (ROADMAP K5)
    B  edge_se2.edge_se2_blocks  fused SE2 linearizer      (ROADMAP K1)
       edge_se3.edge_se3_blocks  fused SE3 linearizer      (ROADMAP K16)
    C  assemble.assemble_gather  contributor-gather H, b   (ROADMAP K2)
    damp_chol.damp_chol          damping, block Cholesky, b (ROADMAP K3)
    jacobi_scale.jacobi_scale    block-Jacobi scaling      (ROADMAP K4)
    jacobi_scale.lane_block_mv   per-row block apply       (ROADMAP K4)
    cg_step.*                    the CG step               (ROADMAP K6)
    chebyshev.*                  Gershgorin + Chebyshev    (ROADMAP K8)
    retract_chi2.retract_chi2    SE2 trial candidate, chi2 (ROADMAP K7)
    retract_chi2.retract_se3     SE3 trial candidate       (ROADMAP K7)
    retract_chi2.se3_edge_chi2   SE3 trial chi2            (ROADMAP K7)
    retract_chi2.lm_outcome      LM trial bookkeeping      (ROADMAP K7)
    dense_assemble.dense_assemble  dense H, b, raw_diag    (ROADMAP K15)
    gather.lane_gather           the probe's lane gather
"""
from __future__ import annotations

from openslam_g2o_torch.kernels import (
    assemble, cg_step, chebyshev, damp_chol, dense_assemble, edge_se2,
    edge_se3, gather, jacobi_scale, retract_chi2, spmv)

# the wrapper functions, which own the launch counts (several share their
# module's name, so the modules are what this package exports)
WRAPPERS = (
    spmv.block_ell_spmv, edge_se2.edge_se2_blocks, edge_se3.edge_se3_blocks,
    assemble.assemble_gather,
    damp_chol.damp_chol, jacobi_scale.jacobi_scale,
    jacobi_scale.lane_block_mv, cg_step.spmv_dot, cg_step.dot_partials,
    cg_step.cg_residual, cg_step.cg_start, cg_step.cg_update_xr,
    cg_step.cg_update_p, cg_step.cg_finish, chebyshev.gershgorin_bound,
    chebyshev.chebyshev_coeffs, chebyshev.chebyshev_init,
    chebyshev.chebyshev_update, gather.lane_gather,
    retract_chi2.retract_chi2, retract_chi2.retract_se3,
    retract_chi2.se3_edge_chi2, retract_chi2.lm_outcome,
    dense_assemble.dense_assemble)


def launch_counts() -> dict:
    """{wrapper name: calls that launched its kernel so far}."""
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts():
    for w in WRAPPERS:
        w.launches = 0
