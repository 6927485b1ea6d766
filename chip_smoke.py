#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
 1. the card: torch's device name and `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`; TF32 off for matmul and cuDNN;
 2. build the CUDA kernels from openslam_g2o_torch/kernels/csrc with nvcc
    (one process per source);
 3. every kernel against its plain PyTorch version on the card, float32 and
    float64, with the time per call of both (CUDA events around 20 calls,
    median of 15), its
    bound (the larger of bytes / 3.35 TB/s and operations / 67 TFLOP/s)
    and, where one PyTorch call computes the same function, that call's
    time: kernels A-C and the trial-solve kernels on the 100k-pose graph,
    kernel A and the lane gather at the TPU probe's shape, and the
    NaN cases of the factor and scaling kernels: NaN in the same places,
    exact zeros in the upper factor entries and in every padding slot.
    K7 (retract_chi2, lm_outcome) on the same graph, with its NaN cases (a
    NaN dx and ok False both give chi2 inf, rho -1, no accept, lambda * nu,
    retry; flags compared exactly), and K15 (dense_assemble) on the
    landmark worlds of phases 4d and 4f and on the pose slots of the
    general Schur path's scenes (4j, 4k @psi2uv, 4l @intrinsics, 4n), by
    device time, twice for the same bits, beside one index_put_ per slot
    pair, and on the 2D world once more with its width-3 instantiation
    switched off (a second build of dense_assemble.cu), for what that
    instantiation saves. K17 (edge_lin_*, the linearizers of all 24
    edge types: twenty-one in forward mode, EDGE_SE2 and the XYZ2UV /
    XYZ2UVU projections in closed form) on the edge groups of their
    phase's scene (LIN_ROWS: the worlds of 4d and 4f, the 4j BAL problem,
    the 4k and 4l scenes, 4m's two-pose-group and stereo scenes, 4p's 80k
    BAL camera scene) and, for the types of
    phase 4o, on a seeded group of 50,000 edges each (lin_group), twice
    for the same bits and by device time. K7 on the dense and Schur
    routes (trial_retract_groups on each vertex type's seeded group of
    50,000 vertices, trial_chi2_* of every edge type on a seeded group of
    50,000 edges under Huber, chi2_sum on a 400,000-edge group's
    partials), float32 and float64, twice for the same bits and by device
    time. K17's closed forms and K7's chi2 also on their phases' own
    groups (PHASE_ROWS: XYZ2UV at 4n's 400,000 edges, XYZ2UVU at 4o's
    2,700, and each edge type's chi2 at a phase that runs it), float32
    and float64, twice for the same bits and by device time, their JSON
    rows with that phase's launches; a float32 chi2 row also against the
    plain version in float64 on the same values (chi2_witness).
    On the sphere of phase 4e: K16 (edge_se3_blocks, without and with a robust
    kernel, on streams of the main path's width; twice for the same bits and
    by device time), K7 for SE3 (retract_se3, se3_edge_chi2, a NaN dx) and the 6x6
    instantiations of kernels A and C, damp_chol (a non-SPD 6x6 block),
    jacobi_scale (a NaN factor), lane_block_mv, spmv_dot and
    gershgorin_bound, with torch.linalg.cholesky + solve_triangular (also
    beside damp_chol at D = 3), a BSR product of block size 6 and
    torch.bmm as the library yardsticks.
    The CG kernels' scalar buffer is held slot by slot, each scalar
    relative to its own plain value and the pd/continue flags exactly,
    also where they must be 0 (negative and NaN curvature, sticky pd,
    r2 <= thresh). The two-launch step (cg_update_xr with its finish,
    spmv_dot_p) equals the three-launch step bit for bit at D = 3 and 6,
    each repeats its bits, and twenty two-launch iterations give the bits
    of twenty three-launch iterations (cg_update_xr a programmatic
    dependent launch in both); timed on the device beside spmv_dot,
    spmv_dot + cg_update_p and spmv_dot + torch.addcmul; a whole CG
    iteration each way;
    dot_partials beside torch.dot. The Schur BA kernels K10-K13 on the BAL problems of
    phases 4g and 4h and on the landmark worlds of 4i (rows @400k, @2d,
    @3d: every instantiation a path runs), in the order the solver runs
    them, with index_add_, torch.linalg.inv, a CSR product and the JAX
    route's torch.matmul(B2, M2) as the library yardsticks (K12 with its
    record copies at 80k and at (3, 2) on the 2D world, also with W's
    records made beforehand); the camera and
    landmark sums, W^T x, W v and S twice for the same bits; W^T x over
    the general path's pose groups in one launch; ba_sandwich twice for the
    same bits. ba_lm_sums, ba_wv,
    ba_wtx and ba_sandwich (here and on the general path's scenes; ba_wtx
    beside its chained form there, ba_sandwich per pose group) also by
    device time, as are C, damp_chol, cg_update_p, lane_gather, the generic
    K10 entry, K11, K12 and K4 at D = 4 beside their library calls: CUDA
    events around 200 calls queued behind a spin kernel, beside the same
    time of index_add_ (Hll and b_l only), of index_add_ with the masked W
    gather (ba_lm_sums's whole function) and of the CSR products (W v,
    W^T x);
    the fused XYZ2UV entry and the chunked camera sums over the records
    likewise (beside index_add_ on the records, with W's copy, and from
    observation order with index_select);
 4. the main path: the 100,000-pose serpentine (noise 0.03 / 0.002, float32)
    through LevenbergMarquardtPCG's lambda init and lm_pcg_optimize_fused
    windows (pcg 100, tol 0.15) until chi2 <= 1.05 x the noise floor, then
    warm polish windows (pcg 600, tol 1e-6) until <= 1.02 x; the first 3
    iterations are held against the same run with every kernel replaced by
    its plain version, to rtol 2e-4 (float32 sums in another order);
    two launches per CG iteration and no cg_update_p (also in 4e's
    windows without Chebyshev);
    and the time and launches of one trial's retract + chi2 + outcome (K7);
 4b. the Chebyshev path: the same graph with pcg_cheby=4, three windows of
    10; finite, never increasing, below chi2_0, and the first 3 chi2 equal
    to the plain route to rtol 2e-4;
 4c. the probe path: a block-ELL SpMV composed of the lane gather and a
    multiply-sum on the TPU probe's data, against kernel A, and the device
    time of both kernels at that shape (torch.profiler);
 4d. the dense path at full size: a Simulator2D landmark world (3000 poses,
    1500 landmarks, tangent dimension T >= 8000, float64) through compile()
    -> optimize(prob), the default dense LevenbergMarquardt, for 10
    iterations and GaussNewton() for 5: chi2 never increases, every step
    that still gains is accepted, GN and LM end within 1e-6 of each other,
    the trajectory equals the same run with the dense-path kernels
    replaced by their plain versions to rtol 1e-9, and a second run gives
    the same bits; K17 launched for EDGE_SE2 and EDGE_SE2_XY; ms per
    iteration split into linearize / assemble / factor + solve / retract +
    chi2, and the device's busy time by kernel over 3 iterations
    (torch.profiler);
 4e. the SE3 main path at full width: create_sphere at 200 laps of 500 =
    100,000 poses (noise 0.03 / 0.002, float32, 6x6 blocks) through lambda
    init and lm_pcg_optimize_fused on the sphere benchmark's schedule (6
    windows of 10 at pcg 200 / tol 0.05, then 15 warm polish windows of 5
    at pcg 600 / tol 1e-6), after which chi2 <= 1.05 x its expectation
    6E - 6(N - 1); chi2 never increases; CG iterations and trials per
    window, and from the third window on every trial's CG ends at its cap;
    the first 3 iterations against the plain route (rtol 2e-4); ms per
    linearization (K16 + C) and per trial outcome (K7); one pcg_cheby=4
    window on the same graph; the same schedule in float64; and the
    benchmark's own shape (50 laps of 50, default noise) on the same
    schedule with 6 polish windows;
 4f. the dense route on 3D: a Simulator3D world (1500 poses, XYZ landmarks
    seen through an offset parameter, T >= 8000, float64) through
    optimize(prob) for 10 iterations and GaussNewton() for 5, with the
    checks of 4d (K15 at block width 6; the plain route replaces K17's
    linearizers too) and its profile of 3 iterations; K17 launched;
 4g. Schur bundle adjustment on the dense-Schur route:
    synthetic_bal_problem(100, 10000, 8) (80,000 observations, float32)
    through LevenbergMarquardtSchurELL's lambda init, 10 iterations of
    ba_ell_optimize_fused (pcg 30, tol 0.05) and the same 10 from the same
    start through ba_ell_step: chi2 never increases, ends at most 1.02 x
    (2E - 6(C - 1) - 3P), the first 3 equal the plain route to rtol 2e-4,
    ms per LM iteration for both entry points; the route is asserted;
    K12's kernels in one profiled linearization + trial solve;
 4h. the same on the implicit route at synthetic_bal_problem(900, 50000,
    8) (400,000 observations), with CG iterations per trial;
 4i. the landmark worlds of 4d and 4f through LevenbergMarquardtSchurELL
    (float64, 10 iterations), on the implicit route the predicate picks and
    on the dense-Schur route (routing constants raised): chi2 never
    increases, and the dense-Schur run ends within 1% of that phase's dense
    LM end (both margins printed);
 4j-4n. the general Schur path (LevenbergMarquardtSchur) on the ba_80k
    geometry as XYZ2UV, PSI2UV and P2MC_INTRINSICS, _SchurAuto's routes and
    the anchored demo scene, and ba_400k: the gates and the JAX package's
    trajectories, one ba_wtx launch per S x and per back-substitution
    (two pose groups at P2MC_INTRINSICS), and in one profiled trial solve
    the device time per CG iteration and the kernels per ba_wv call (one);
    one build split into linearize and the rest of schur_build; K17
    launched in 4j-4n (XYZ2UV in 4j, 4m and 4n, P2MC and P2SC in 4m's
    routes, with their linearize split);
 4d-4o: the K7 split of one trial at each phase's start (4i aside): the
    candidate and its chi2 (apply_update_parts + robust_chi2) and the
    whole outcome (lm_trial_outcome), by CUDA events, with the outcome's
    launches (one per vertex group, one per edge group, lm_outcome);
 4o. the dense LM over every type without a scene of another phase: three
    worlds built with Graph from a seed (world2d_all_graph: the SE2 types,
    priors, calibration and offset edges; world3d_all_graph: depth,
    disparity, SE3 prior and offset edges; sba_all_graph: VERTEX_CAM with
    P2MC, P2SC, EDGE_CAM, EDGE_SCALE, expmap cameras with XYZ2UV, XYZ2UVU,
    EDGE_SE3:EXPMAP) at T of 9,000-9,203 in float64, 10 iterations of
    optimize(prob): chi2 never increases, every gaining step accepted, the
    plain route equal to rtol 1e-9 with the same trials, a second run
    bit-identical, K17 launched for each type, a linearize / assemble
    split;
 4p. BAL bundle adjustment with the 9-wide Snavely camera (models/bal.py):
    the ba_80k and ba_400k geometries of synthetic_bal_problem turned into
    BAL scenes (bal_camera_scene: BAL's negative-z convention, f = 800,
    nonzero k1 and k2, pixel noise 1.0, the generator's perturbed poses
    and points as the start, every camera but camera 0 started at f = 808
    and k1 = k2 = 0), written as BAL text files in phase 3 and read by
    load_bal_problem: lambda init + 10 iterations through
    optimize(LevenbergMarquardtSchurELL(pcg 30, tol 0.05)) and, from the
    same init, 10 through ba_ell_optimize_fused with one trial per
    iteration and with ba_ell_step's trials; float32 at 80k (the
    dense-Schur route) and 400k (the implicit route, with CG iterations
    and device us per CG iteration of one trial's solve), float64 at 80k,
    whose trajectory must equal the JAX package's float64 CPU trajectory
    to the printed 5 digits (JAX_BAL_TRAJ); chi2 never increases and ends
    at most 1.02 x (2E - 9(C - 1) - 3P); _SchurAuto's route on the 80k
    graph (the dual-ELL solver); the float32 80k result written by
    save_bal_problem and read back with the final chi2. Phase 3 holds
    the instantiations this path adds at its shapes (rows @bal, @bal400k,
    lane_block_mv_dot@d9, edge_lin_bal and trial_chi2_bal@4p on the 80k
    scene): K17 and K7 for EDGE_PROJECT_BAL and VERTEX_CAMERA_BAL, K10's
    generic entry and owner sums at (9, 3), K11 and K4 at D = 9 (beside
    torch.linalg.inv_ex and torch.bmm), K12 (beside the JAX route's
    torch.matmul(B2, M2)) and K13;
 4q. the same BAL files through the general Schur path
    (LevenbergMarquardtSchur(), pcg 250, tol 1e-8, as 4j): lambda init +
    10 iterations, float32 at 80k and 400k and float64 at 80k, with 4j's
    checks and reports (one ba_wtx launch per S x, ms per LM iteration,
    wall and device us per CG iteration of one profiled trial solve, K14
    and K15 per schur_build); chi2 never increases and ends at most 1.02
    x (2E - 9(C - 1) - 3P); the float64 80k end within 1e-4 of 4p's
    dual-ELL float64 end (the gap printed). Phase 3 holds K14 at (9, 3)
    and K15 on the 9-wide camera slots at both shapes (rows @bal,
    @bal400k);
 4r. the dense GN / LM route at block width 9 on a BAL file of the dense
    worlds' size (bal_camera_scene(100, 3000): T = 9900, 24,000
    observations, float64): optimize(prob) (the default dense
    LevenbergMarquardt) for 10 iterations, chi2 never increasing and at
    most 1.02 x (2E - 9(C - 1) - 3P); GaussNewton() for 3 iterations from
    its end, and LM going on from its 10th iteration until it is within
    1e-6 of GN's end (at most 30 more, chi2 never increasing: its lambda
    falls slowly on this scene); LevenbergMarquardtSchurELL() on the same
    scene (the dense-Schur route) within 1% of the dense LM's end; ms per
    iteration, the split of one LM iteration (cuSOLVER's share) and K15
    per build (profiler). Phase 3 holds K15 on this scene (row
    dense_assemble@d9: the 3 x 3, 3 x 9 and 9 x 9 pairs, the zero fill,
    the unit diagonal of camera 0);
 4s. LM-PCG over several vertex groups (core/sparse.py PairPattern: one
    block-ELL table per (row group, column group) pair): lambda init + 10
    iterations of lm_pcg_optimize_fused (PAIR_PCG: pcg 2000, tol 1e-10),
    float32 and float64, on a 9000-pose Simulator2D landmark world
    (PAIR_WORLD: T = 34,108, the full-width run), on phase 4d's world and on
    phase 4f's; one more float32 run each on the 9000-pose world and on
    4f's world with pcg_cheby 4. Through K17, K2' (pair_stream, then
    pair_assemble), K3 per vertex group (D = 2 for the landmarks), K4'
    pair_scale, K5' over every row group in one launch (pair_spmv for the
    first residual, pair_spmv_dot, then pair_spmv_dot_p: the two-launch CG
    step, asserted in the profiled solve; the three-launch step with
    pcg_cheby 4), K4's lane_block_mv, K7 (core/problem.py
    lm_trial_outcome) and, with pcg_cheby 4, K8' pair_gershgorin. Chi2
    never increases; the first 3 float32 iterations equal the plain route's
    (every wrapper swapped for its plain version) to PLAIN_ROUTE_RTOL; the
    float64 trajectory on 4d's world equals the JAX package's float64 CPU
    trajectory at the same settings (JAX_PAIR_TRAJ) to rtol 1e-6 while an
    iteration gains; the ends on 4d's and 4f's worlds over the dense LM's
    end of phases 4d and 4f; ms per LM iteration, CG iterations per trial,
    the launches per run, and wall and device us per CG iteration of one
    profiled trial solve at 9000 poses; no plain call of a built-in type
    on the card. Phase 3 holds the pair kernels at the 9000-pose world's
    shapes and at 4f's (rows @3d: the (6, 6), (6, 3), (3, 6), (3, 3) pairs)
    (float32, float64; twice for the same bits, by device time):
    pair_stream (pass 1 alone), pair_assemble (both passes) beside
    torch.bmm + index_add_ (the same function) and index_add_ of the
    blocks formed beforehand, pair_spmv, pair_spmv_dot and pair_spmv_dot_p
    beside a torch.sparse CSR product of the same H, pair_scale with a NaN
    factor and its all-zero slots, pair_gershgorin, and K3 /
    lane_block_mv at D = 2 (damp_chol@d2,
    lane_block_mv@d2) beside cholesky_ex + solve_triangular and einsum;
 5. a small .g2o string through loads_g2o -> compile() (the default
    device) -> optimize(LevenbergMarquardtPCG()), chi2 decreasing and equal
    to the CPU run of the same graph; one with VERTEX_XY, EDGE_SE2_XY
    and a PARAMS_SE2OFFSET / EDGE_SE2_OFFSET pair through optimize(), the
    default algorithm, against its CPU run; and two with the 3D tags: a
    sphere (VERTEX_SE3:QUAT, EDGE_SE3:QUAT) through LM-PCG and a landmark
    world (PARAMS_SE3OFFSET, VERTEX_TRACKXYZ, EDGE_SE3_TRACKXYZ) through
    the dense LM; and a BA scene (PARAMS_CAMERAPARAMETERS, VERTEX_SE3:EXPMAP
    with camera-to-world in the file, VERTEX_XYZ, EDGE_PROJECT_XYZ2UV:EXPMAP,
    EDGE_SE3:EXPMAP) through LevenbergMarquardtSchurELL;
 6. every kernel's launch count in the paths of phases 4-4s, each > 0. A
    count is one per wrapper call that launched; cg_finish launches two
    kernels per vector and gershgorin_bound two per call. The 6x6
    instantiations are listed apart, with the launches of the SE3 and
    dense 3D paths, which their 3x3 rows then leave out. The BA kernels'
    rows count phases 4g-4i, their @-rows the phase of their shape; K14's
    and K15's 9-wide rows (WIDE_ROWS) count phases 4q and 4r; the pair
    kernels count phase 4s (pair_gershgorin and cg_update_p its
    pcg_cheby 4 runs, pair_spmv_dot_p the others), and
    damp_chol@d2 / lane_block_mv@d2 their launches at D = 2 there.
    spmv_dot_p runs on the unpreconditioned paths only, cg_update_p on the
    preconditioned ones (4b, 4e's Chebyshev window, 4h, 4i, 4j-4n).
    K17's rows count every phase (4d, 4f, 4i, 4j-4n, 4o, 4s), and each row's
    phase (LIN_ROWS) must launch it. K4's lane_block_mv_dot counts the
    preconditioned Schur phases (4h, 4i, 4j-4n, 4p, 4q) by width: there it
    takes the place of lane_block_mv + dot_partials, so dot_partials must
    not launch there, and lane_block_mv_dot launches once per pose group per
    CG iteration and per solve's start (two under the preconditioned norm).
    K7's trial_retract_groups launches once per trial on every route of
    lm_trial_outcome (4d-4s but 4e; trial_split asserts it), and its rows
    trial_retract_groups@<vertex type> count the launches that served a
    group of that type, read with each phase's counts (read_counts) and
    summed over the phases as the other rows are. From phase 4 on no built-in edge type
    reaches the generic linearization (linearize_edges, forward_jacobians)
    on the card outside the plain-route runs: each such call is counted and
    there must be none; nor does a built-in vertex or edge type reach the
    plain trial (kernels/trial.py retract_plain, chi2_plain). K7's rows
    (TRIAL_ROWS) count every phase, each row's phase must launch it, and its
    launches are printed per phase.
    Phase 3 also holds K4's lane_block_mv_dot at the shapes of the
    preconditioned Schur routes (D = 6, N = 900: 4h's cameras; @d9: 4p's 900
    BAL cameras; @d4: 4l's intrinsics hub; @4l its cameras, printed),
    against its plain version, its partials bit for bit against
    dot_partials of its z (and at D = 6, where lane_block_mv is built,
    against lane_block_mv + dot_partials, the parent's form, and by device
    time beside that pair and lane_block_mv alone), by device time beside
    torch.bmm; K7's trial_retract_groups on two or three seeded groups at
    4g's, 4p @400k's and 4l's sizes, bit for bit against one launch per
    group (as the parent's trial launched) and by device time beside them,
    and on each vertex type's seeded group of 50,000 (rows @<vertex
    type>); kernel_times.py --only precond and --only trial time the
    parent's forms (--tree).
The last two lines are the per-kernel JSON and {"ok": true, "device": ...}.
Exits non-zero without printing a result when no GPU is visible.
"""
from __future__ import annotations

import atexit
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

# Relative tolerances against the plain version (largest |difference| over
# the largest |plain| entry), per dtype. The default covers kernels that sum
# a few products in another order with FMA contraction. Kernel B's pose
# differences cancel (coordinates ~100 against residuals ~0.03), so a last
# ulp of a coordinate shows in the residual. damp_chol subtracts squares
# (a22 - l31^2 - l32^2) and divides by the result, so an FMA's last ulp is
# amplified by the condition number of the block (the noise-free rotation
# rows make it ~1e2); jacobi_scale and lane_block_mv multiply by those
# factors. The lane gather copies values: it must agree exactly.
TOL_DEFAULT = {"float32": 2e-5, "float64": 1e-12}
TOL = {"edge_se2_blocks": {"float32": 1e-4, "float64": 1e-11},
       "damp_chol": {"float32": 1e-4, "float64": 1e-11},
       "lane_gather": {"float32": 0.0, "float64": 0.0},
       # the trial chi2 cancels coordinates as kernel B's residual does
       "retract_chi2": {"float32": 1e-4, "float64": 1e-11},
       # the SE3 residual cancels coordinates ~100 m against ~0.03 m, and
       # the kernel and torch.func.jvp order the derivative's sums otherwise
       "edge_se3_blocks": {"float32": 2e-4, "float64": 1e-10},
       # with Huber, rho' = delta / sqrt(e^T Omega e) carries the float32
       # residual's cancellation error into every block
       "edge_se3_blocks@huber": {"float32": 2e-3, "float64": 1e-10},
       "se3_edge_chi2": {"float32": 1e-4, "float64": 1e-11},
       # K17: forward mode through the same error in another operation
       # order (FMA contraction); the SE3 and pixel residuals cancel
       # coordinates as K16's and K10's do
       "edge_lin_se3": {"float32": 2e-4, "float64": 1e-10},
       "edge_lin_se3_xyz": {"float32": 2e-4, "float64": 1e-10},
       "edge_lin_p2mc_intrinsics": {"float32": 2e-4, "float64": 1e-10},
       "edge_lin_psi2uv": {"float32": 2e-4, "float64": 1e-10},
       **{"edge_lin_" + n_: {"float32": 2e-4, "float64": 1e-10} for n_ in (
           "se2", "se2_xy", "se2_bearing", "se2_prior", "se2_prior_xy",
           "se2_xy_calib", "se2_offset", "se2_xy_offset", "se3_depth",
           "se3_disparity", "se3_prior", "se3_offset", "se3_expmap",
           "xyz2uv", "xyz2uvu", "p2mc", "p2sc", "sba_cam", "sba_scale",
           "bal")},
       # K7 on the dense and Schur routes: the candidate relative to its
       # largest entry, the summed chi2 and dot
       **{w_: {"float32": 1e-5, "float64": 1e-12} for w_ in (
           "chi2_sum", "trial_retract_groups",
           *("trial_chi2_" + n_ for n_ in (
               "se2", "se2_xy", "se2_bearing", "se2_prior", "se2_prior_xy",
               "se2_xy_calib", "se2_offset", "se2_xy_offset", "se3",
               "se3_xyz", "se3_depth", "se3_disparity", "se3_prior",
               "se3_offset", "se3_expmap", "xyz2uv", "xyz2uvu", "psi2uv",
               "p2mc", "p2mc_intrinsics", "p2sc", "sba_cam",
               "sba_scale", "bal")))},
       # the pixel residual cancels a projection of a few hundred pixels
       "ba_xyz2uv_blocks": {"float32": 1e-4, "float64": 1e-11},
       # downstream of a block inverse or of the Schur difference
       # Hcc - W Hinv W^T, which cancels most of Hcc; a block inverse's
       # rows raise this to the first-order bound cond x eps of their
       # worst-conditioned block (BLOCK_INV_TOL)
       "ba_block_inv": {"float32": 1e-4, "float64": 1e-10},
       "ba_schur_dense": {"float32": 1e-4, "float64": 1e-10},
       "ba_wtx": {"float32": 1e-4, "float64": 1e-10},
       "ba_sandwich": {"float32": 1e-4, "float64": 1e-10},
       # W v, per element: |kernel - plain| <= 64 u (|base| + |Hcc_d| |x|
       # + |extra| + |W| |v|), u the unit roundoff, and the dot likewise
       # with sum |x| (those magnitudes): a row of W v sums up to 80,000
       # products of both signs (the shared intrinsics vertex), so a bound
       # relative to the largest result would be loose on the short rows
       # and tight on the long one (wv_error_scale)
       "ba_wv": {"float32": 64 * 2.0 ** -23, "float64": 64 * 2.0 ** -52}}
DENSE_ROUTE_RTOL = 1e-9
# The dense path's world: odometry noise below Simulator2D's default, so that
# 10 LM and 5 GN iterations reach the same minimum (at the default noise LM's
# lambda, which falls by at most 3x per iteration, leaves it 2e-3 above GN's)
DENSE_WORLD = dict(world_size=60, n_landmarks=1500, trans_noise=(0.02, 0.01),
                   rot_noise=0.002, seed=0)
DENSE_POSES = 3000
PLAIN_ROUTE_RTOL = 2e-4
N_POSES, GRID = 100000, 100
# The SE3 main path's graph: the sphere generator at 200 laps of 500 poses
# (100,000 poses), with the noise lowered from the benchmark's (0.1, 0.02) so
# that 100,000 steps of integrated odometry stay in LM's basin; the converged
# chi2 is held against 6E - 6(N - 1), its expectation under that noise.
SPHERE = dict(n_laps=200, n_per_lap=500, radius=100.0,
              trans_noise=(0.03, 0.03, 0.03), rot_noise=0.002, seed=0)
# CG runs into its cap in every trial on this 200 x 500 mesh from the third
# window on (200 iterations in the windows, 600 in the polish; phase 4e
# checks it from the launch counts), so each LM step is a truncated solve and
# the tail is slow, in float32 and float64 alike (phase 4e runs both). The
# schedule is fixed: six windows, then SPHERE_POLISH_WINDOWS polish windows,
# and chi2 is held against SPHERE_GATE x its expectation after the last.
SPHERE_GATE = 1.05
SPHERE_POLISH_WINDOWS = 15
# the benchmark's own shape (2500 poses, default noise), same schedule
SPHERE_BENCH = dict(n_laps=50, n_per_lap=50, radius=100.0, seed=0)
# The dense 3D world: poses, XYZ landmarks seen through offset parameter 0;
# noise below Simulator3D's default so that 10 LM and 5 GN iterations reach
# the same minimum
DENSE3_WORLD = dict(world_size=40.0, n_landmarks=1200,
                    trans_noise=(0.02, 0.02, 0.02), rot_noise=0.002,
                    landmark_noise=(0.02, 0.02, 0.02), seed=0)
DENSE3_POSES = 1500
# Schur bundle adjustment: the JAX bench's two synthetic BAL shapes
# (bench.py:1166-1170), 8 observations per point, float32, pcg 30 / tol
# 0.05; chi2 is held against 1.02 x (2E - 6(C - 1) - 3P) (bench.py:386-395)
BA_80K = (100, 10000)            # dense-Schur route
BA_400K = (900, 50000)           # implicit route
BA_OBS = 8
BA_PCG = dict(pcg_iters=30, pcg_tol=0.05)
BA_GATE = 1.02
# phase 4i: the Schur LM on the landmark worlds of 4d and 4f against the
# dense LM's end. Their pose blocks (Tp = 9000) put them on the implicit
# route, whose reduced camera systems are long pose chains: block-Jacobi PCG
# with the default 100 iterations truncates every step there, in the JAX
# package as in the port (tests/test_torch_ba_lm.py holds the two packages'
# ends together on smaller worlds), so that run's margin is printed, and the
# gate holds the same worlds on the dense-Schur route (the routing constants
# raised, as the tests lower them), whose exact solve must follow the dense
# LM.
BA_WORLD_GATE = 0.01
# phase 4s: LM-PCG over several vertex groups at full width, on a
# 9000-pose Simulator2D landmark world (9000 SE2 poses, 3554 XY landmarks,
# 10,751 EDGE_SE2, 96,100 EDGE_SE2_XY: T = 34,108; a dense float64 H would
# take 9.3 GB), and on the worlds of phases 4d and 4f
PAIR_WORLD = dict(world_size=100, n_landmarks=4000,
                  trans_noise=(0.02, 0.01), rot_noise=0.002, seed=0)
PAIR_POSES = 9000
# its CG budget: run to a tight tolerance, so that the float64 trajectory
# on 4d's world follows the JAX package's to rtol 1e-6 (truncated CG would
# amplify the packages' rounding differences: tests/test_torch_ba_lm.py)
PAIR_PCG = dict(pcg_iters=2000, pcg_tol=1e-10)
# the JAX package's float64 CPU trajectory of lambda init + 10 iterations
# of lm_pcg_optimize_fused at PAIR_PCG on phase 4d's world
# (Simulator2D(**DENSE_WORLD).simulate(DENSE_POSES)), computed once
JAX_PAIR_TRAJ = (451646.1768174232, 75601.51449942714, 68540.00784878874,
                 66148.74846235478, 65158.258014290994, 64965.38423999106,
                 64943.054974905666, 64931.1283784606, 64928.29952445466,
                 64928.16276410687)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOPS = 67e12               # float32 outside the tensor cores

# wrapper name -> (source under kernels/csrc, the JAX or Pallas code it
# replaces)
KERNELS = {
    "block_ell_spmv": ("block_ell_spmv.cu",
                       "scripts/probe_pallas_gather.py:90"),
    "edge_se2_blocks": ("edge_se2_blocks.cu",
                        "openslam_g2o_tpu/core/sparse.py:620"),
    "assemble_gather": ("assemble_gather.cu",
                        "openslam_g2o_tpu/core/sparse.py:1045"),
    "damp_chol": ("damp_chol.cu", "openslam_g2o_tpu/core/solvers.py:63"),
    "jacobi_scale": ("jacobi_scale.cu",
                     "openslam_g2o_tpu/core/sparse.py:1204"),
    "lane_block_mv": ("jacobi_scale.cu",
                      "openslam_g2o_tpu/core/sparse.py:871"),
    # the preconditioner step z = M r and r . z of the Schur routes' PCG
    # (its row: D = 6, N = 900, the ba_400k cameras of phase 4h)
    "lane_block_mv_dot": ("jacobi_scale.cu",
                          "openslam_g2o_tpu/core/solvers.py:246"),
    "spmv_dot": ("cg_step.cu", "openslam_g2o_tpu/core/solvers.py:263"),
    "spmv_dot_p": ("cg_step.cu", "openslam_g2o_tpu/core/solvers.py:275"),
    "dot_partials": ("cg_step.cu", "openslam_g2o_tpu/core/solvers.py:157"),
    "cg_residual": ("cg_step.cu", "openslam_g2o_tpu/core/solvers.py:245"),
    "cg_start": ("cg_step.cu", "openslam_g2o_tpu/core/solvers.py:248"),
    "cg_update_xr": ("cg_step.cu", "openslam_g2o_tpu/core/solvers.py:270"),
    "cg_update_p": ("cg_step.cu", "openslam_g2o_tpu/core/solvers.py:275"),
    "cg_finish": ("cg_step.cu", "openslam_g2o_tpu/core/solvers.py:288"),
    "gershgorin_bound": ("chebyshev.cu",
                         "openslam_g2o_tpu/core/sparse.py:1270"),
    "chebyshev_coeffs": ("chebyshev.cu",
                         "openslam_g2o_tpu/core/solvers.py:192"),
    "chebyshev_init": ("chebyshev.cu",
                       "openslam_g2o_tpu/core/solvers.py:198"),
    "chebyshev_update": ("chebyshev.cu",
                         "openslam_g2o_tpu/core/solvers.py:203"),
    "lane_gather": ("lane_gather.cu", "scripts/probe_pallas_gather.py:53"),
    "retract_chi2": ("retract_chi2.cu",
                     "openslam_g2o_tpu/core/problem.py:557"),
    "lm_outcome": ("retract_chi2.cu",
                   "openslam_g2o_tpu/core/algorithms.py:306"),
    "dense_assemble": ("dense_assemble.cu",
                       "openslam_g2o_tpu/core/problem.py:415"),
    "edge_se3_blocks": ("edge_se3_blocks.cu",
                        "openslam_g2o_tpu/models/slam3d.py:70"),
    "retract_se3": ("retract_chi2_se3.cu",
                    "openslam_g2o_tpu/ops/lie.py:256"),
    "se3_edge_chi2": ("retract_chi2_se3.cu",
                      "openslam_g2o_tpu/core/problem.py:302"),
    "ba_xyz2uv_blocks": ("ba_edge_blocks.cu",
                         "openslam_g2o_tpu/core/ba_ell.py:556"),
    "ba_edge_blocks": ("ba_edge_blocks.cu",
                       "openslam_g2o_tpu/core/ba_ell.py:563"),
    "ba_lm_sums": ("ba_edge_blocks.cu", "openslam_g2o_tpu/core/ba_ell.py:445"),
    "ba_cam_sums": ("ba_edge_blocks.cu",
                    "openslam_g2o_tpu/core/ba_ell.py:597"),
    "ba_block_inv": ("ba_inv.cu", "openslam_g2o_tpu/core/ba_ell.py:376"),
    "ba_schur_dense": ("ba_schur.cu", "openslam_g2o_tpu/core/ba_ell.py:745"),
    "ba_schur_records": ("ba_schur.cu",
                         "openslam_g2o_tpu/core/ba_ell.py:647"),
    "ba_wtx": ("ba_coupling.cu", "openslam_g2o_tpu/core/ba_ell.py:482"),
    "ba_wv": ("ba_coupling.cu", "openslam_g2o_tpu/core/ba_ell.py:774"),
    "ba_sandwich": ("ba_coupling.cu", "openslam_g2o_tpu/core/ba_ell.py:513"),
    "schur_edge_blocks": ("schur_general.cu",
                          "openslam_g2o_tpu/core/ba.py:147"),
    "edge_lin_se3": ("edge_lin.cu", "openslam_g2o_tpu/core/problem.py:378"),
    "edge_lin_se3_xyz": ("edge_lin.cu",
                         "openslam_g2o_tpu/core/problem.py:378"),
    "edge_lin_p2mc_intrinsics": ("edge_lin.cu",
                                 "openslam_g2o_tpu/core/problem.py:378"),
    "edge_lin_psi2uv": ("edge_lin.cu",
                        "openslam_g2o_tpu/core/problem.py:378"),
    # the slice's nineteen: sixteen in forward mode (:378), EDGE_SE2 and
    # the two XYZ2UV projections in closed form (the analytic branch, :367)
    **{"edge_lin_" + n_: ("edge_lin.cu",
                          "openslam_g2o_tpu/core/problem.py:"
                          + ("367" if n_ in ("se2", "xyz2uv", "xyz2uvu")
                             else "378"))
       for n_ in ("se2", "se2_xy", "se2_bearing", "se2_prior",
                  "se2_prior_xy", "se2_xy_calib", "se2_offset",
                  "se2_xy_offset", "se3_depth", "se3_disparity",
                  "se3_prior", "se3_offset", "se3_expmap", "xyz2uv",
                  "xyz2uvu", "p2mc", "p2sc", "sba_cam", "sba_scale")},
    # the BAL camera's projection (models/bal.py), in forward mode
    "edge_lin_bal": ("edge_lin.cu", "openslam_g2o_tpu/core/problem.py:378"),
    # K7 on the dense, dual-ELL and general Schur routes: the candidate of
    # every vertex group (apply_update_parts) in one launch (its row: 4g's
    # two groups), each edge type's robust chi2 (robust_chi2
    # over edge_chi2) and the sum of its partials
    "trial_retract_groups": ("trial.cu",
                             "openslam_g2o_tpu/core/problem.py:557"),
    **{"trial_chi2_" + n_: ("trial.cu",
                            "openslam_g2o_tpu/core/problem.py:321")
       for n_ in ("se2", "se2_xy", "se2_bearing", "se2_prior",
                  "se2_prior_xy", "se2_xy_calib", "se2_offset",
                  "se2_xy_offset", "se3", "se3_xyz", "se3_depth",
                  "se3_disparity", "se3_prior", "se3_offset", "se3_expmap",
                  "xyz2uv", "xyz2uvu", "psi2uv", "p2mc", "p2mc_intrinsics",
                  "p2sc", "sba_cam", "sba_scale", "bal")},
    "chi2_sum": ("trial.cu", "openslam_g2o_tpu/core/problem.py:327"),
    # LM-PCG over several vertex groups (phase 4s): K2' (its first pass;
    # "pair_assemble" both passes), K4', K5' (without and with the dot: the
    # rectangular form of the probe's spmv_kernel; with the next direction
    # folded in), K8'
    "pair_stream": ("pair_ell.cu", "openslam_g2o_tpu/core/sparse.py:620"),
    "pair_assemble": ("pair_ell.cu", "openslam_g2o_tpu/core/sparse.py:646"),
    "pair_scale": ("pair_ell.cu", "openslam_g2o_tpu/core/sparse.py:754"),
    "pair_spmv": ("pair_ell.cu", "openslam_g2o_tpu/core/sparse.py:883"),
    "pair_spmv_dot": ("pair_ell.cu", "scripts/probe_pallas_gather.py:90"),
    "pair_spmv_dot_p": ("pair_ell.cu",
                        "openslam_g2o_tpu/core/solvers.py:275"),
    "pair_gershgorin": ("pair_ell.cu",
                        "openslam_g2o_tpu/core/sparse.py:787"),
}
# K17's rows: wrapper -> the phase whose scene its phase-3 row is taken
# on, which must launch it; its launches are those of every phase. The
# types of phase 4o, whose groups there are small, are taken on a seeded
# group of LIN_GROUP_EDGES edges each (lin_group) instead.
LIN_ROWS = {"edge_lin_se3": "4f", "edge_lin_se3_xyz": "4f",
            "edge_lin_psi2uv": "4k", "edge_lin_p2mc_intrinsics": "4l",
            "edge_lin_se2": "4d", "edge_lin_se2_xy": "4d",
            "edge_lin_xyz2uv": "4j", "edge_lin_p2mc": "4m",
            "edge_lin_p2sc": "4m", "edge_lin_bal": "4p",
            **{"edge_lin_" + n_: "4o" for n_ in (
                "se2_bearing", "se2_prior", "se2_prior_xy", "se2_xy_calib",
                "se2_offset", "se2_xy_offset", "se3_depth", "se3_disparity",
                "se3_prior", "se3_offset", "se3_expmap", "xyz2uvu",
                "sba_cam", "sba_scale")}}
LIN_GROUP_EDGES = 50000
# K17's operations per edge: scalar operations of one evaluation of the
# error (through the retractions, in forward mode; with the closed form,
# for the analytic three), counted from csrc/edge_lin.cu and the headers
# it includes (sin, cos, sqrt, atan2 and tan as one each), plus two per
# Jacobian entry (a lower bound on the forward mode's work)
LIN_VALUE_OPS = {"edge_se3": 390, "edge_se3_xyz": 225,
                 "edge_project_p2mc_intrinsics": 95,
                 "edge_project_psi2uv": 500,
                 "edge_se2": 110, "edge_se2_xy": 40,
                 "edge_se2_xy_bearing": 45, "edge_se2_prior": 45,
                 "edge_se2_prior_xy": 8, "edge_se2_xy_calib": 60,
                 "edge_se2_offset": 95, "edge_se2_xy_offset": 60,
                 "edge_se3_depth": 240, "edge_se3_disparity": 240,
                 "edge_se3_prior": 230, "edge_se3_offset": 420,
                 "edge_se3_expmap": 470, "edge_project_xyz2uv": 150,
                 "edge_project_xyz2uvu": 190, "edge_project_p2mc": 90,
                 "edge_project_p2sc": 105, "edge_sba_cam": 330,
                 "edge_sba_scale": 16, "edge_project_bal": 75}
# K7's rows on the dense and Schur routes: wrapper -> a phase that must
# launch it (its launches are those of every phase). Its phase-3 row is
# taken on a seeded group of TRIAL_GROUP vertices (trial_vertex_group) or
# edges (lin_group) each.
TRIAL_ROWS = {**{"trial_chi2_" + w_[len("edge_lin_"):]: ph_
                 for w_, ph_ in LIN_ROWS.items()},
              "chi2_sum": "4d"}
TRIAL_GROUP = 50000
# K7's trial_retract_groups on the groups of a phase's trial: row label ->
# (the phase whose launches it reports, its groups as (vertex type, count)
# in the scene's order), each group seeded (trial_vertex_group)
GROUP_ROWS = {
    "trial_retract_groups": ("4g", (("se3_expmap", BA_80K[0]),
                                    ("sba_point_xyz", BA_80K[1]))),
    "trial_retract_groups@bal400k": ("4p 400k", (
        ("bal_camera", BA_400K[0]), ("sba_point_xyz", BA_400K[1]))),
    "trial_retract_groups@4l": ("4l", (("intrinsics", 1),
                                       ("cam", BA_80K[0]),
                                       ("sba_point_xyz", BA_80K[1])))}
# K17's closed forms and K7's chi2 at their phases' own group sizes: row
# label (wrapper@phase) -> the phase whose scene the row's group is taken
# from and whose launches it reports (4n: the ba_400k scene, 400,000
# XYZ2UV edges; 4o: the three worlds of phase 4o). Every edge type has a
# K7 row at a phase that runs it.
PHASE_ROWS = {"edge_lin_xyz2uv@4n": "4n", "edge_lin_xyz2uvu@4o": "4o",
              "trial_chi2_se2@4d": "4d", "trial_chi2_se2_xy@4d": "4d",
              "trial_chi2_se3@4f": "4f", "trial_chi2_se3_xyz@4f": "4f",
              "trial_chi2_xyz2uv@4j": "4j", "trial_chi2_xyz2uv@4n": "4n",
              "trial_chi2_psi2uv@4k": "4k",
              "trial_chi2_p2mc_intrinsics@4l": "4l",
              "trial_chi2_bal@4p": "4p",
              **{f"trial_chi2_{n_}@4o": "4o" for n_ in (
                  "se2_bearing", "se2_prior", "se2_prior_xy",
                  "se2_xy_calib", "se2_offset", "se2_xy_offset",
                  "se3_depth", "se3_disparity", "se3_prior", "se3_offset",
                  "se3_expmap", "xyz2uvu", "p2mc", "p2sc", "sba_cam",
                  "sba_scale")}}
# A float32 chi2 row's distance from the plain version in float64 on the
# same values (chi2_witness), where its kernel and float32 plain version
# disagree beyond K7's float32 tolerance: the float32 tolerance of the
# LM-PCG trial chi2 (TOL["retract_chi2"]), whose residuals cancel
# coordinates in the same way
CHI2_WITNESS_TOL = 1e-4
# The phases whose paths run float64: their PHASE_ROWS JSON rows take the
# float64 figures, the others the float32 ones
FLOAT64_PHASES = ("4d", "4f", "4o")
# K7's operations per vertex of a retraction (csrc/trial.cu and the
# headers it includes: sqrt, sin, cos as one each) beside three per tangent
# value of the dot product; a chi2 row's are the edge's LIN_VALUE_OPS (the
# error through zero-step retractions: an upper estimate of the error
# alone) and 2 D^2 of e^T Omega e
RETRACT_OPS = {"se2": 6, "point_xy": 2, "se3": 75, "point_xyz": 3,
               "se3_expmap": 140, "sba_point_xyz": 3, "cam": 45,
               "intrinsics": 4, "bal_camera": 9}
# the general Schur path's rows at the instantiations it adds: suffix -> its
# phase, and what each kernel replaces there (openslam_g2o_tpu/core/ba.py)
GENERAL_SUFFIXES = {"@psi2uv": "4k", "@intrinsics": "4l", "@d4": "4l",
                    "@4j": "4j", "@4n": "4n"}
GENERAL_REPLACES = {
    "ba_lm_sums": "openslam_g2o_tpu/core/ba.py:148",
    "ba_wtx": "openslam_g2o_tpu/core/ba.py:233",
    "ba_block_inv": "openslam_g2o_tpu/core/ba.py:262",
    "lane_block_mv": "openslam_g2o_tpu/core/ba.py:264",
    "lane_block_mv_dot": "openslam_g2o_tpu/core/ba.py:264",
    "dense_assemble": "openslam_g2o_tpu/core/ba.py:118",
    "schur_edge_blocks": "openslam_g2o_tpu/core/ba.py:147",
    "ba_wv": "openslam_g2o_tpu/core/ba.py:229",
    "ba_sandwich": "openslam_g2o_tpu/core/ba.py:246"}
# K14 at (9, 3) and K15 at block width 9 on the BAL camera: row -> the
# phases whose launches it reports (4q: the general Schur path on 4p's
# files, float32 and float64 at 80k; 4r: the dense route)
WIDE_ROWS = {"schur_edge_blocks@bal": ("4q 80k float32", "4q 80k float64"),
             "schur_edge_blocks@bal400k": ("4q 400k float32",),
             "dense_assemble@bal": ("4q 80k float32", "4q 80k float64"),
             "dense_assemble@bal400k": ("4q 400k float32",),
             "dense_assemble@d9": ("4r",)}
# the BA kernels' rows at the other shapes and instantiations of their
# paths: suffix -> the phase whose launches the row reports (@400k: the
# implicit route's shape; @2d: the 4d world, (Dp, dl) = (3, 2); @3d: the 4f
# world, 3-wide residuals; @bal and @bal400k: phase 4p's BAL camera scenes,
# (9, 3), on the dense-Schur and the implicit route)
BA_SUFFIXES = {"@400k": "4h", "@2d": "4i 2D", "@3d": "4i 3D",
               "@bal": "4p 80k", "@bal400k": "4p 400k"}
# the 6x6 instantiations: report name -> (wrapper, source, replaces); their
# launches are the wrapper's counts in the SE3 paths (phases 4e and 4f)
KERNELS_D6 = {
    "block_ell_spmv@d6": ("block_ell_spmv", "block_ell_spmv.cu",
                          "openslam_g2o_tpu/core/sparse.py:883"),
    "assemble_gather@d6": ("assemble_gather", "assemble_gather.cu",
                           "openslam_g2o_tpu/core/sparse.py:646"),
    "damp_chol@d6": ("damp_chol", "damp_chol.cu",
                     "openslam_g2o_tpu/core/solvers.py:105"),
    "jacobi_scale@d6": ("jacobi_scale", "jacobi_scale.cu",
                        "openslam_g2o_tpu/core/sparse.py:1204"),
    "lane_block_mv@d6": ("lane_block_mv", "jacobi_scale.cu",
                         "openslam_g2o_tpu/core/sparse.py:871"),
    "spmv_dot@d6": ("spmv_dot", "cg_step.cu",
                    "openslam_g2o_tpu/core/sparse.py:1309"),
    "spmv_dot_p@d6": ("spmv_dot_p", "cg_step.cu",
                      "openslam_g2o_tpu/core/solvers.py:275"),
    "gershgorin_bound@d6": ("gershgorin_bound", "chebyshev.cu",
                            "openslam_g2o_tpu/core/sparse.py:1270"),
    "dense_assemble@d6": ("dense_assemble", "dense_assemble.cu",
                          "openslam_g2o_tpu/core/problem.py:415"),
}


# -- the general Schur path's scenes -------------------------------------
# Three edge families on the geometry of synthetic_bal_problem(100, 10000,
# 8), the JAX bench's ba_80k: its cameras, points, observations and noisy
# initial values. Each scene function takes the Graph class, so that the tests
# build the same graph in both packages (tests/test_torch_schur_general.py
# and tests/test_torch_kernels.py import them from here).
# the JAX package's float64 CPU trajectories of LevenbergMarquardtSchur()
# on the 80k scenes (chi2 / expected per iteration after lambda init)
JAX_SCHUR_TRAJ = {
    "bal": (5.06546, 1.43313, 1.06291, 1.00768, 1.00456, 1.00446, 1.00446,
            1.00446, 1.00446, 1.00446),
    "psi2uv": (1.22959, 1.00472, 1.00449, 1.00447, 1.00447, 1.00446,
               1.00446, 1.00446, 1.00446, 1.00446),
    "p2mc_intrinsics": (17.08854, 3.70802, 1.54350, 1.11637, 1.01977,
                        1.00753, 1.00572, 1.00517, 1.00492, 1.00471),
}
# the JAX package's float64 CPU trajectory of optimize(prob,
# LevenbergMarquardtSchurELL(pcg_iters=30, pcg_tol=0.05), iterations=10) on
# phase 4p's 80k BAL camera scene (bal_camera_scene(path, 100, 10000)):
# chi2 / expected per iteration after lambda init
JAX_BAL_TRAJ = (1.99362, 1.03167, 1.00315, 1.00231, 1.00224, 1.00211,
                1.00189, 1.00164, 1.00146, 1.00131)
# LevenbergMarquardtSchur(), 30 iterations, on the scene of
# examples/ba_anchored_inverse_depth_demo.py: the JAX package's final chi2,
# float64 on the CPU (its make_scene, pixel noise 1.0, rng 11)
JAX_DEMO_CHI2 = 17886464.67048266
SBA_CAMERA = (800.0, 0.0, 0.0, 0.1)   # focal, cx, cy, baseline of the BAL
INTRINSICS_START = (808.0, 808.0, 0.0, 0.0, 0.1)   # 1% off


def bal_geometry(n_cams, n_points):
    """The geometry of the port's synthetic_bal_problem(n_cams, n_points,
    8) as float64 numpy arrays: initial world-to-camera poses
    cams_w2c [C, 7] (camera 0 is exact), initial points [P, 3], and per
    observation (point-major, the generator's order) pt [E], cam [E] and
    obs [E, 2]."""
    import numpy as np
    import torch
    from openslam_g2o_torch.apps.simulator import synthetic_bal_problem
    prob, _ = synthetic_bal_problem(n_cams, n_points, 8,
                                    dtype=torch.float64, device="cpu")
    ea = prob.edges["edge_project_xyz2uv"]
    arr = lambda t: t.numpy().astype(np.float64)
    return {"cams_w2c": arr(prob.params["se3_expmap"]),
            "points": arr(prob.params["sba_point_xyz"]),
            "pt": ea.indices[0].numpy().astype(np.int64),
            "cam": ea.indices[1].numpy().astype(np.int64),
            "obs": arr(ea.measurement)}


def _se3_inverse(w2c):
    """Batched inverse of (t, q) rows, the formula of utils/np_lie.py."""
    import numpy as np
    from openslam_g2o_torch.utils import np_lie
    return np.stack([np_lie.se3_inverse(p) for p in w2c])


def psi2uv_graph(Graph, geo):
    """The observations as ternary EDGE_PROJECT_PSI2UV:EXPMAP (psi,
    observing camera, anchor): the anchor is the point's first observing
    camera in edge order, psi the initial point in the anchor's initial
    frame, (u, v, 1) / z; camera parameters SBA_CAMERA; only camera 0 (the
    generator's gauge) fixed. Vertex ids: cameras 0..C-1, points C + j."""
    import numpy as np
    from openslam_g2o_torch.utils import np_lie
    C, P = len(geo["cams_w2c"]), len(geo["points"])
    g = Graph()
    g.add_parameter(0, "camera_parameters", list(SBA_CAMERA))
    for i in range(C):
        g.add_vertex(i, "se3_expmap", geo["cams_w2c"][i], fixed=(i == 0))
    first = np.full(P, -1, dtype=np.int64)
    for e in range(len(geo["pt"]) - 1, -1, -1):
        first[geo["pt"][e]] = geo["cam"][e]
    for j in range(P):
        if first[j] < 0:
            continue
        pa = np_lie.se3_apply(geo["cams_w2c"][first[j]], geo["points"][j])
        g.add_vertex(C + j, "sba_point_xyz",
                     np.array([pa[0], pa[1], 1.0]) / pa[2], marginalized=True)
    eye = np.eye(2)
    for e in range(len(geo["pt"])):
        j = geo["pt"][e]
        g.add_edge("edge_project_psi2uv", (C + j, geo["cam"][e], first[j]),
                   geo["obs"][e], eye, param_ids=[0])
    return g


def p2mc_intrinsics_graph(Graph, geo):
    """The observations as ternary EDGE_PROJECT_P2MC_INTRINSICS (point,
    VERTEX_CAM, one VERTEX_INTRINSICS): each VERTEX_CAM carries the
    camera-to-world inverse of the initial pose and (800, 800, 0, 0, 0.1);
    the shared intrinsics start at INTRINSICS_START and are added first, so
    they sit at tangent offset 0 (Tp = 4 + 6C); only camera 0 fixed.
    Vertex ids: intrinsics C + P, cameras 0..C-1, points C + j."""
    import numpy as np
    C, P = len(geo["cams_w2c"]), len(geo["points"])
    k = np.array([SBA_CAMERA[0], SBA_CAMERA[0], SBA_CAMERA[1], SBA_CAMERA[2],
                  SBA_CAMERA[3]])
    g = Graph()
    g.add_vertex(C + P, "intrinsics", np.array(INTRINSICS_START))
    c2w = _se3_inverse(geo["cams_w2c"])
    for i in range(C):
        g.add_vertex(i, "cam", np.concatenate([c2w[i], k]), fixed=(i == 0))
    for j in range(P):
        g.add_vertex(C + j, "sba_point_xyz", geo["points"][j],
                     marginalized=True)
    eye = np.eye(2)
    for e in range(len(geo["pt"])):
        g.add_edge("edge_project_p2mc_intrinsics",
                   (C + geo["pt"][e], geo["cam"][e], C + P), geo["obs"][e],
                   eye)
    return g


def two_pose_group_graph(Graph, geo):
    """A binary graph with two pose groups: the cameras alternate between
    VERTEX_SE3:EXPMAP seen through EDGE_PROJECT_XYZ2UV:EXPMAP and
    VERTEX_CAM (camera-to-world, SBA_CAMERA's focal) seen through
    EDGE_PROJECT_P2MC; camera 0 fixed. The port's dual-ELL pattern refuses
    it (one pose group), the JAX package's takes it."""
    import numpy as np
    C, P = len(geo["cams_w2c"]), len(geo["points"])
    f, cx, cy, b = SBA_CAMERA
    c2w = _se3_inverse(geo["cams_w2c"])
    g = Graph()
    g.add_parameter(0, "camera_parameters", list(SBA_CAMERA))
    for i in range(C):
        if i % 2 == 0:
            g.add_vertex(i, "se3_expmap", geo["cams_w2c"][i], fixed=(i == 0))
        else:
            g.add_vertex(i, "cam", np.concatenate([c2w[i], [f, f, cx, cy, b]]))
    for j in range(P):
        g.add_vertex(C + j, "sba_point_xyz", geo["points"][j],
                     marginalized=True)
    eye = np.eye(2)
    for e in range(len(geo["pt"])):
        c = geo["cam"][e]
        if c % 2 == 0:
            g.add_edge("edge_project_xyz2uv", (C + geo["pt"][e], c),
                       geo["obs"][e], eye, param_ids=[0])
        else:
            g.add_edge("edge_project_p2mc", (C + geo["pt"][e], c),
                       geo["obs"][e], eye)
    return g


def stereo_sba_graph(Graph):
    """examples/sba_demo.py `make_scene` with --stereo (rng 17, 8 cameras,
    300 points, pixel noise 0.5): VERTEX_CAM cameras with intrinsics (500,
    500, 320, 240, 0.075) on a line, the first two fixed,
    EDGE_PROJECT_P2SC observations."""
    import numpy as np
    fx, fy, cx, cy, base = 500.0, 500.0, 320.0, 240.0, 0.075
    n_cams, n_points, pixel_noise = 8, 300, 0.5
    rng = np.random.default_rng(17)
    g = Graph()
    pts = rng.uniform(-2, 2, (n_points, 3)) + np.array([0, 0, 10.0])
    cam_ts = []
    for i in range(n_cams):
        t = np.array([i * 0.25 - n_cams * 0.125, 0, 0])
        cam_ts.append(t)
        g.add_vertex(i, "cam", np.concatenate([t, [0, 0, 0, 1],
                                               [fx, fy, cx, cy, base]]),
                     fixed=(i < 2))
    for j, pt in enumerate(pts):
        obs = []
        for i, t in enumerate(cam_ts):
            pc = pt - t
            u, v = fx * pc[0] / pc[2] + cx, fy * pc[1] / pc[2] + cy
            ur = fx * (pc[0] - base) / pc[2] + cx
            if pc[2] <= 0.1 or not (0 <= u < 640 and 0 <= v < 480):
                continue
            obs.append((i, np.array([u, v, ur])))
        if len(obs) < 2:
            continue
        g.add_vertex(1000 + j, "sba_point_xyz", pt + rng.normal(0, 0.5, 3),
                     marginalized=True)
        for i, uvu in obs:
            g.add_edge("edge_project_p2sc", (1000 + j, i),
                       uvu + rng.normal(0, pixel_noise, 3), np.eye(3))
    return g


def anchored_demo_graph(Graph):
    """examples/ba_anchored_inverse_depth_demo.py `make_scene` (rng 11,
    pixel noise 1.0): 500 points in a shallow box, 15 cameras translating
    along x (the first two fixed), anchored inverse-depth initialization,
    ternary EDGE_PROJECT_PSI2UV observations, camera (1000, 320, 240,
    0.1)."""
    import numpy as np
    from openslam_g2o_torch.utils import np_lie
    focal, cx, cy, pixel_noise = 1000.0, 320.0, 240.0, 1.0
    rng = np.random.default_rng(11)
    g = Graph()
    g.add_parameter(0, "camera_parameters", [focal, cx, cy, 0.1])
    true_points = np.stack([(rng.uniform(size=500) - 0.5) * 3,
                            rng.uniform(size=500) - 0.5,
                            rng.uniform(size=500) + 3], axis=1)
    poses = []
    for i in range(15):
        w2c = np_lie.se3_inverse(np.array([i * 0.04 - 1.0, 0, 0, 0, 0, 0,
                                           1.0]))
        poses.append(w2c)
        g.add_vertex(i, "se3_expmap", w2c, fixed=(i < 2))
    for j, pt in enumerate(true_points):
        vid = 1000 + j
        obs = []
        for i, w2c in enumerate(poses):
            pc = np_lie.se3_apply(w2c, pt)
            if pc[2] < 0.1:
                continue
            uv = pc[:2] / pc[2] * focal + np.array([cx, cy])
            if not (0 <= uv[0] < 640 and 0 <= uv[1] < 480):
                continue
            obs.append((i, uv + rng.normal(0, pixel_noise, 2)))
        if len(obs) < 2:
            continue
        anchor = obs[0][0]
        pa = np_lie.se3_apply(poses[anchor], pt + rng.normal(0, 1.0, 3))
        g.add_vertex(vid, "sba_point_xyz",
                     np.array([pa[0], pa[1], 1.0]) / pa[2], marginalized=True)
        for i, z in obs:
            g.add_edge("edge_project_psi2uv", (vid, i, anchor), z,
                       np.eye(2), param_ids=[0])
    return g


# -- phase 4p's BAL scenes ------------------------------------------------
# The geometry of synthetic_bal_problem(C, P, 8) (ba_80k and ba_400k) seen
# through the 9-wide Snavely camera of models/bal.py: its ground-truth
# poses turned into BAL's convention (the points at negative z), focal
# BAL_FOCAL and distortion BAL_DISTORTION, its observation lists projected
# anew with pixel noise 1.0, and its perturbed initial poses and points as
# the start, every camera but camera 0 (the gauge, exact) with intrinsics
# BAL_START. Written as a BAL text file that both packages read.
BAL_FOCAL = 800.0
BAL_DISTORTION = (-0.05, 0.01)       # k1, k2 of every camera's truth
BAL_START = (808.0, 0.0, 0.0)        # f (1% off), k1, k2 of the start
BAL_PIXEL_NOISE = 1.0
# phase 4q: the general Schur path's float64 end at 80k against phase 4p's
# dual-ELL float64 end on the same file (relative)
BAL_GENERAL_GAP = 1e-4
# phase 4r's scene: the dense GN / LM route on a BAL file of the size of the
# other dense worlds (T = 9 x 100 + 3 x 3000 = 9900, 24,000 observations;
# at 4p's 80k shape the dense H alone would be 11.6 GB in float64)
BAL_DENSE = (100, 3000)


def _bal_cameras(w2c, intrinsics):
    """World-to-camera (t, q) rows -> BAL cameras [C, 9]: the rotation and
    translation turned by diag(1, -1, -1), the rotation as its Rodrigues
    vector, then the intrinsics rows [C, 3]."""
    import numpy as np
    from openslam_g2o_torch.utils import np_lie
    out = np.zeros((len(w2c), 9))
    flip = np.array([1.0, 0.0, 0.0, 0.0])      # pi about x: diag(1, -1, -1)
    for i, p in enumerate(w2c):
        q = np_lie.quat_mul(flip, p[3:7])
        q = -q if q[3] < 0 else q
        n = np.linalg.norm(q[:3])
        out[i, :3] = (2.0 * np.arctan2(n, q[3]) / n * q[:3] if n > 0
                      else 2.0 * q[:3])
        out[i, 3:6] = p[:3] * np.array([1.0, -1.0, -1.0])
    out[:, 6:9] = intrinsics
    return out


def bal_camera_scene(path, n_cams, n_points, seed=0):
    """Write the BAL scene of synthetic_bal_problem(n_cams, n_points, 8)
    to `path` (observations point-major, as the generator lists them).
    Returns {"n_obs": E, "expected": 2E - 9(C - 1) - 3P}, the gate's
    expectation (bench.py:386-395 with the 9-wide camera)."""
    import numpy as np
    import torch
    from openslam_g2o_torch.apps.simulator import synthetic_bal_problem
    from openslam_g2o_torch.models.bal import snavely_project
    prob, meta = synthetic_bal_problem(n_cams, n_points, BA_OBS, seed=seed,
                                       dtype=torch.float64, device="cpu")
    ea = prob.edges["edge_project_xyz2uv"]
    pt = ea.indices[0].numpy().astype(np.int64)
    cam = ea.indices[1].numpy().astype(np.int64)
    truth = np.array([BAL_FOCAL, *BAL_DISTORTION])
    cams_gt = _bal_cameras(meta["cams_w2c"], truth)
    with torch.no_grad():
        uv = snavely_project(torch.as_tensor(cams_gt[cam]),
                             torch.as_tensor(meta["points"][pt])).numpy()
    rng = np.random.default_rng(seed + 1)
    uv = uv + rng.normal(0, BAL_PIXEL_NOISE, uv.shape)
    start = np.tile(np.array(BAL_START), (n_cams, 1))
    start[0] = truth
    cams0 = _bal_cameras(prob.params["se3_expmap"].numpy(), start)
    points0 = prob.params["sba_point_xyz"].numpy()
    E = len(pt)
    lines = [f"{n_cams} {n_points} {E}"]
    lines += [f"{c} {p} {u!r} {v!r}" for c, p, (u, v) in
              zip(cam.tolist(), pt.tolist(), uv.tolist())]
    lines += [repr(v) for v in cams0.reshape(-1).tolist()]
    lines += [repr(v) for v in points0.reshape(-1).tolist()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"n_obs": E, "expected": 2 * E - 9 * (n_cams - 1) - 3 * n_points}


def bal_camera_graph(Graph, n_cams=6, n_points=40, seed=4):
    """A small BAL graph built with either package's Graph (the tests'
    scene of the 9-wide camera): cameras in BAL's convention on a line at
    z = 8 over a point cloud (tests/test_bal.py make_bal_file's layout),
    every third at omega = 0 exactly, camera 1 at theta^2 = 1.13e-12 (just
    above so3_exp's Taylor branch), the others turned by up to 0.3 rad;
    focal 800 and seeded distortion; every camera sees every point with
    pixel noise 0.5; the start perturbed (0.02 on the pose, 1% on f, the
    distortion zeroed; points by 0.2), camera 0 (the gauge) fixed.
    Vertex ids: cameras 0..C-1, points C + j."""
    import numpy as np
    import torch
    from openslam_g2o_torch.models.bal import snavely_project
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (n_points, 3))
    cams = np.zeros((n_cams, 9))
    for i in range(n_cams):
        if i == 1:
            cams[i, :3] = (8e-7, 7e-7, 0.0)
        elif i % 3:
            cams[i, :3] = rng.uniform(-0.3, 0.3, 3)
        cams[i, 3:6] = (i * 0.4 - n_cams * 0.2, 0.0, 8.0)
        cams[i, 6:9] = (800.0, rng.uniform(-0.1, 0.1),
                        rng.uniform(-0.02, 0.02))
    with torch.no_grad():
        uv = snavely_project(torch.as_tensor(cams)[:, None],
                             torch.as_tensor(pts)[None]).numpy()
    uv = uv + rng.normal(0, 0.5, uv.shape)
    g = Graph()
    for i in range(n_cams):
        c0 = cams[i].copy()
        if i:
            c0[:6] += rng.normal(0, 0.02, 6)
            c0[6:9] = (c0[6] * 1.01, 0.0, 0.0)
        if i % 3 == 0:
            c0[:3] = 0.0
        g.add_vertex(i, "bal_camera", c0, fixed=(i == 0))
    for j in range(n_points):
        g.add_vertex(n_cams + j, "sba_point_xyz",
                     pts[j] + rng.normal(0, 0.2, 3), marginalized=True)
    for j in range(n_points):
        for i in range(n_cams):
            g.add_edge("edge_project_bal", (n_cams + j, i), uv[i, j],
                       np.eye(2))
    return g


# -- phase 4o's worlds ----------------------------------------------------
# Three graphs that hold every edge type without a scene of another phase,
# built with the Graph API from a seed around a ground truth with small
# noise (so that the dense LM converges), at T = 9003, 9000 and 9000 in
# phase 4o; the tests build them small in both packages.
ALL2D = (2000, 1600)        # poses, landmarks: T = 6000 + 3200 + 3
ALL3D = (1000, 1000)        # poses, landmarks: T = 6000 + 3000
ALLSBA = (600, 1800)        # cameras (half VERTEX_CAM), points: T = 3600
#                             + 5400


def _noisy_quat(rng, scale):
    import numpy as np
    v = rng.normal(0, scale, 3)
    return np.array([*v, np.sqrt(1.0 - v @ v)])


def fix_one_per_slot(g):
    """Fix, in every slot of every edge type of graph `g` that names more
    than one vertex and none fixed yet, the vertex of its middle edge (the
    tests' fixed vertices)."""
    slots = {}
    for e in g.edges:
        for s, vid in enumerate(e.vertex_ids):
            slots.setdefault((e.etype.name, s), []).append(vid)
    for vids in slots.values():
        if len(set(vids)) > 1 and not any(g.vertices[v].fixed for v in vids):
            g.set_fixed(vids[len(vids) // 2])
    return g


def world2d_all_graph(Graph, n_poses, n_landmarks, seed=0, prior_every=50):
    """A Simulator2D-style world with every SE2 edge type: a random walk of
    SE2 poses, odometry alternating EDGE_SE2 and EDGE_SE2_OFFSET (offset
    parameters 1 and 2), EDGE_PRIOR_SE2_XY on every `prior_every`-th pose
    and EDGE_PRIOR_SE2 on every fourth of those; XY landmarks each seen from four
    consecutive poses by EDGE_SE2_XY, EDGE_SE2_XY_CALIB (one calibration
    vertex, id 10**6), EDGE_SE2_POINTXY_OFFSET (offset parameter 3) and
    EDGE_BEARING_SE2_XY. Measurement noise 0.01 m / 0.002 rad, initial
    values 0.05 m / 0.01 rad off; no vertex fixed (the priors hold the
    gauge). Vertex ids: poses 0.., landmarks 100000..."""
    import numpy as np
    from openslam_g2o_torch.utils import np_lie
    rng = np.random.default_rng(seed)
    sig_t, sig_r = 0.01, 0.002
    offs = {1: np.array([0.2, 0.0, 0.1]), 2: np.array([-0.1, 0.1, 0.0]),
            3: np.array([0.05, -0.15, -0.2])}
    calib = np.array([0.1, -0.05, 0.02])
    g = Graph()
    for pid, off in offs.items():
        g.add_parameter(pid, "se2_offset", off)
    gt = [np.zeros(3)]
    for _ in range(n_poses - 1):
        gt.append(np_lie.se2_compose(gt[-1], np.array(
            [1.0, 0.0, rng.normal(0, 0.2)])))
    for i, p in enumerate(gt):
        g.add_vertex(i, "se2", p + rng.normal(0, [0.05, 0.05, 0.01]))
    g.add_vertex(10 ** 6, "se2", calib + rng.normal(0, [0.01, 0.01, 0.005]))
    odo = np.diag([1 / sig_t ** 2, 1 / sig_t ** 2, 1 / sig_r ** 2])
    pos = np.eye(2) / sig_t ** 2
    for i in range(n_poses - 1):
        if i % 2 == 0:
            z = np_lie.se2_compose(np_lie.se2_inverse(gt[i]), gt[i + 1])
            g.add_edge("edge_se2", (i, i + 1), z + rng.normal(
                0, [sig_t, sig_t, sig_r]), odo)
        else:
            z = np_lie.se2_compose(
                np_lie.se2_inverse(np_lie.se2_compose(gt[i], offs[1])),
                np_lie.se2_compose(gt[i + 1], offs[2]))
            g.add_edge("edge_se2_offset", (i, i + 1), z + rng.normal(
                0, [sig_t, sig_t, sig_r]), odo, param_ids=[1, 2])
    for i in range(0, n_poses, prior_every):
        if i % (4 * prior_every) == 0:
            g.add_edge("edge_se2_prior", (i,), gt[i] + rng.normal(
                0, [sig_t, sig_t, sig_r]), odo)
        g.add_edge("edge_se2_prior_xy", (i,), gt[i][:2] + rng.normal(
            0, sig_t, 2), pos)
    for k in range(n_landmarks):
        i0 = int(k * (n_poses - 4) / n_landmarks)
        lm = np_lie.se2_apply(gt[i0], np.array(
            [rng.uniform(1.0, 4.0), rng.uniform(-2.0, 2.0)]))
        lid = 100000 + k
        g.add_vertex(lid, "point_xy", lm + rng.normal(0, 0.05, 2))
        x = gt[i0]
        g.add_edge("edge_se2_xy", (i0, lid), np_lie.se2_apply(
            np_lie.se2_inverse(x), lm) + rng.normal(0, sig_t, 2), pos)
        x = np_lie.se2_compose(gt[i0 + 1], calib)
        g.add_edge("edge_se2_xy_calib", (i0 + 1, lid, 10 ** 6),
                   np_lie.se2_apply(np_lie.se2_inverse(x), lm)
                   + rng.normal(0, sig_t, 2), pos)
        x = np_lie.se2_compose(gt[i0 + 2], offs[3])
        g.add_edge("edge_se2_xy_offset", (i0 + 2, lid),
                   np_lie.se2_apply(np_lie.se2_inverse(x), lm)
                   + rng.normal(0, sig_t, 2), pos, param_ids=[3])
        d = np_lie.se2_apply(np_lie.se2_inverse(gt[i0 + 3]), lm)
        g.add_edge("edge_se2_xy_bearing", (i0 + 3, lid),
                   [np.arctan2(d[1], d[0]) + rng.normal(0, sig_r)],
                   np.eye(1) / sig_r ** 2)
    return g


def world3d_all_graph(Graph, n_poses, n_landmarks, seed=0):
    """A Simulator3D-style world with the 3D types that no other phase
    runs: a random walk of SE3 poses, odometry EDGE_SE3_OFFSET (offset
    parameters 1 and 2), EDGE_SE3_PRIOR (offset 1) on every 100th pose, and
    XYZ landmarks each seen through the camera_calib parameter 0 (looking
    along the robot's x axis, fx = fy = 500, c = (320, 240)) from four
    consecutive poses, alternately by EDGE_PROJECT_DEPTH and
    EDGE_PROJECT_DISPARITY. Noise 0.5 px, 0.01 m of depth, 1e-4 of
    disparity, 0.01 m / 0.002 rad of odometry; initial values 0.05 m /
    0.01 rad off; no vertex fixed. Vertex ids: poses 0.., landmarks
    100000..."""
    import numpy as np
    from openslam_g2o_torch.utils import np_lie
    rng = np.random.default_rng(seed)
    h = np.sqrt(0.5)
    cam = np.array([0.1, 0.0, 0.2, 0.0, h, 0.0, h, 500.0, 500.0, 320.0,
                    240.0])
    offs = {1: np.concatenate([[0.2, 0.0, 0.05], _noisy_quat(rng, 0.05)]),
            2: np.concatenate([[-0.1, 0.1, 0.0], _noisy_quat(rng, 0.05)])}
    g = Graph()
    g.add_parameter(0, "camera_calib", cam)
    for pid, off in offs.items():
        g.add_parameter(pid, "se3_offset", off)
    gt = [np.array([0, 0, 0, 0, 0, 0, 1.0])]
    for _ in range(n_poses - 1):
        q = _noisy_quat(rng, 0.01)
        q[2] += rng.normal(0, 0.03)
        q /= np.linalg.norm(q)
        gt.append(np_lie.se3_compose(gt[-1], np.concatenate(
            [[0.5, 0.0, 0.0], q])))

    def noisy_pose(p, st, sr):
        return np_lie.se3_compose(p, np.concatenate(
            [rng.normal(0, st, 3), _noisy_quat(rng, sr)]))

    for i, p in enumerate(gt):
        g.add_vertex(i, "se3", noisy_pose(p, 0.05, 0.005))
    info6 = np.diag([1e4, 1e4, 1e4, 2.5e5, 2.5e5, 2.5e5])
    for i in range(n_poses - 1):
        z = np_lie.se3_compose(
            np_lie.se3_inverse(np_lie.se3_compose(gt[i], offs[1])),
            np_lie.se3_compose(gt[i + 1], offs[2]))
        g.add_edge("edge_se3_offset", (i, i + 1), noisy_pose(z, 0.01, 0.002),
                   info6, param_ids=[1, 2])
    for i in range(0, n_poses, 100):
        g.add_edge("edge_se3_prior", (i,), noisy_pose(
            np_lie.se3_compose(gt[i], offs[1]), 0.01, 0.002), info6,
            param_ids=[1])
    for k in range(n_landmarks):
        i0 = int(k * (n_poses - 4) / n_landmarks)
        c2w = np_lie.se3_compose(gt[i0], cam[:7])
        lm = np_lie.se3_apply(c2w, np.array(
            [rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(4, 7)]))
        lid = 100000 + k
        g.add_vertex(lid, "point_xyz", lm + rng.normal(0, 0.05, 3))
        for j in range(4):
            pc = np_lie.se3_apply(np_lie.se3_inverse(
                np_lie.se3_compose(gt[i0 + j], cam[:7])), lm)
            uv = cam[7:9] * pc[:2] / pc[2] + cam[9:11]
            if j % 2 == 0:
                z = np.array([*uv, pc[2]]) + rng.normal(0, [0.5, 0.5, 0.01])
                g.add_edge("edge_se3_depth", (i0 + j, lid), z,
                           np.diag([4.0, 4.0, 1e4]), param_ids=[0])
            else:
                z = np.array([*uv, 1 / pc[2]]) + rng.normal(
                    0, [0.5, 0.5, 1e-4])
                g.add_edge("edge_se3_disparity", (i0 + j, lid), z,
                           np.diag([4.0, 4.0, 1e8]), param_ids=[0])
    return g


def sba_all_graph(Graph, n_cams, n_points, seed=0):
    """An SBA world with every SBA type but PSI2UV: cameras on a line
    along x looking down +z, the even ones VERTEX_CAM (camera-to-world,
    intrinsics (500, 500, 320, 240, 0.1)) joined by EDGE_CAM and EDGE_SCALE
    to the next even one, the odd ones VERTEX_SE3:EXPMAP (world-to-camera)
    joined by EDGE_SE3:EXPMAP to the next odd one; points 4-7 m in front,
    each seen by six consecutive cameras: through P2MC or P2SC (by the
    point's parity) from the VERTEX_CAMs, through XYZ2UV or XYZ2UVU
    (camera parameters 0: 500, 320, 240, 0.1) from the expmap cameras.
    Cameras 0-3 fixed; noise 0.5 px and 0.005 m / 0.001 rad between
    cameras, initial values 0.02 m / 0.002 rad (cameras) and 0.05 m
    (points) off. Vertex ids: cameras 0.., points 100000..."""
    import numpy as np
    from openslam_g2o_torch.utils import np_lie
    rng = np.random.default_rng(seed)
    f, cx, cy, b = 500.0, 320.0, 240.0, 0.1
    g = Graph()
    g.add_parameter(0, "camera_parameters", [f, cx, cy, b])
    c2w = [np.concatenate([[0.1 * i, rng.normal(0, 0.02), 0.0],
                           _noisy_quat(rng, 0.02)]) for i in range(n_cams)]

    def perturb(p, st, sr):
        return np_lie.se3_compose(p, np.concatenate(
            [rng.normal(0, st, 3), _noisy_quat(rng, sr)]))

    for i in range(n_cams):
        fixed = i < 4
        start = c2w[i] if fixed else perturb(c2w[i], 0.02, 0.002)
        if i % 2 == 0:
            g.add_vertex(i, "cam", np.concatenate([start, [f, f, cx, cy, b]]),
                         fixed=fixed)
        else:
            g.add_vertex(i, "se3_expmap", np_lie.se3_inverse(start),
                         fixed=fixed)
    info6 = np.diag([4e4, 4e4, 4e4, 1e6, 1e6, 1e6])
    for i in range(n_cams - 2):
        if i % 2 == 0:
            z = np_lie.se3_compose(np_lie.se3_inverse(c2w[i]), c2w[i + 2])
            g.add_edge("edge_sba_cam", (i, i + 2), perturb(z, 0.005, 0.001),
                       info6)
            g.add_edge("edge_sba_scale", (i, i + 2),
                       [np.linalg.norm(c2w[i][:3] - c2w[i + 2][:3])
                        + rng.normal(0, 0.005)], np.eye(1) * 4e4)
        else:
            w2c1, w2c2 = (np_lie.se3_inverse(c2w[i]),
                          np_lie.se3_inverse(c2w[i + 2]))
            z = np_lie.se3_compose(w2c2, np_lie.se3_inverse(w2c1))
            g.add_edge("edge_se3_expmap", (i, i + 2),
                       perturb(z, 0.005, 0.001), info6)
    for j in range(n_points):
        k0 = int(j * (n_cams - 6) / n_points)
        x0 = 0.1 * (k0 + 2.5)
        pt = np.array([x0 + rng.uniform(-1.0, 1.0), rng.uniform(-1.5, 1.5),
                       rng.uniform(4.0, 7.0)])
        pid = 100000 + j
        g.add_vertex(pid, "sba_point_xyz", pt + rng.normal(0, 0.05, 3),
                     marginalized=True)
        for i in range(k0, k0 + 6):
            pc = np_lie.se3_apply(np_lie.se3_inverse(c2w[i]), pt)
            uv = f * pc[:2] / pc[2] + np.array([cx, cy])
            ur = f * (pc[0] - b) / pc[2] + cx
            stereo = j % 2 == 1
            z = (np.array([*uv, ur]) if stereo else uv) + rng.normal(
                0, 0.5, 3 if stereo else 2)
            info = np.eye(len(z)) * 4.0
            if i % 2 == 0:
                g.add_edge("edge_project_p2sc" if stereo
                           else "edge_project_p2mc", (pid, i), z, info)
            else:
                g.add_edge("edge_project_xyz2uvu" if stereo
                           else "edge_project_xyz2uv", (pid, i), z, info,
                           param_ids=[0])
    return g


def pose_slot_dargs(torch, dense_assemble, gprob, pat, lin):
    """dense_assemble's arguments as schur_build (core/ba.py) passes them
    on the general Schur path: the pose slots' EdgeBlocks of every edge
    group with a pose slot (from the linearization `lin`), Tp, zeros [Tp],
    the pattern's Tp-wide table (on the card), no fixed diagonal."""
    hp = pat.hpp_pattern or dense_assemble.build_dense_pattern(
        gprob, egroups=[next(e for e in gprob.static.egroups if e.key == k)
                        for k, _ in pat.hpp_keys],
        total_dim=pat.pose_dim, slots=[ps for _, ps in pat.hpp_keys])
    groups = []
    for i, (key, ps) in enumerate(pat.hpp_keys):
        resid, jacs, rho1 = lin[key]
        groups.append(dense_assemble.EdgeBlocks(
            resid.contiguous(), tuple(jacs[s].contiguous() for s in ps),
            rho1.contiguous(), gprob.edges[key].information, hp.offsets[i]))
    return (groups, pat.pose_dim, torch.zeros(
        pat.pose_dim, dtype=gprob.dtype, device=gprob.device), hp, False)


def dense_world_dargs(dense_assemble, problem_mod, dprob):
    """dense_assemble's arguments as the dense routes pass them: every
    edge group's EdgeBlocks from one linearization of `dprob`, T, the
    fixed-slot mask, the problem's DensePattern, the fixed diagonal."""
    pattern = dense_assemble.build_dense_pattern(dprob)
    lin = problem_mod.linearize(dprob)
    groups = [dense_assemble.EdgeBlocks(
        lin[eg.key][0].contiguous(),
        tuple(j.contiguous() for j in lin[eg.key][1]), lin[eg.key][2],
        dprob.edges[eg.key].information, pattern.offsets[i])
        for i, eg in enumerate(dprob.static.egroups)]
    return (groups, dprob.static.total_dim,
            problem_mod.tangent_masks(dprob)[1], pattern, True)


def k14_operands(torch, ba_edge, gprob, pat, lin):
    """K14's calls as schur_build makes them on the general Schur path:
    (new_out() -> zeroed outputs (landmark streams, W landmark-major and
    pose-major per pose group), run(fn, out) -> every
    schur_edge_blocks-shaped call of the linearization `lin` into out, the
    bytes (each input read once, each output written once: residual, the
    Jacobians, rho', Omega, two positions per W entry; Hll_e, b_l,e and
    each W block in both layouts), the operations, a shape string)."""
    dt, dev, dl = gprob.dtype, gprob.device, pat.dl
    new_out = lambda: (
        ba_edge.LandmarkStreams(
            torch.zeros((dl * dl, pat.n_lm_edges), dtype=dt, device=dev),
            torch.zeros((dl, pat.n_lm_edges), dtype=dt, device=dev)),
        {pg.name: torch.zeros((pg.dim * dl,) + tuple(pg.lm_pose.shape),
                              dtype=dt, device=dev)
         for pg in pat.pose_groups},
        {pg.name: torch.zeros((pg.dim * dl, pg.n_entries), dtype=dt,
                              device=dev) for pg in pat.pose_groups})

    def run(fn, out):
        st, wl, wp = out
        for le in pat.lm_edges:
            resid, jacs, rho1 = lin[le.egkey]
            first = True
            for ce in (c for c in pat.cross if c.egkey == le.egkey):
                # the pattern's write orders (a tree without them: none)
                orders = ((ce.lm_order, ce.pose_order)
                          if hasattr(ce, "lm_order") else ())
                fn(resid.contiguous(), jacs[le.lm_slot].contiguous(),
                   jacs[ce.slot].contiguous(), rho1.contiguous(),
                   gprob.edges[le.egkey].information,
                   st.hll if first else None, st.bl if first else None,
                   le.offset, wl[ce.group], ce.lm_pos, wp[ce.group],
                   ce.pose_pos, *orders)
                first = False
        return (st.hll, st.bl, *wl.values(), *wp.values())

    E, s = pat.n_lm_edges, torch.empty((), dtype=dt).element_size()
    R = gprob.edges[pat.lm_edges[0].egkey].measurement.shape[1]
    slot_dims = [next(pg.dim for pg in pat.pose_groups
                      if pg.name == ce.group) for ce in pat.cross]
    nbytes = (s * E * (R + R * dl + 1 + R * R + dl * dl + dl
                       + sum(R * d + 2 * d * dl for d in slot_dims))
              + 8 * E * len(slot_dims))
    flops = E * (2 * dl * R * R + 2 * dl * dl * R + 2 * dl * R
                 + sum(2 * d * R * R + 2 * d * dl * R for d in slot_dims))
    return (new_out, run, nbytes, flops,
            f"E={E} R={R} pose slots of widths {slot_dims}, dl={dl}")


def k12_operands(ba_ell, ba_inv, bprob):
    """K12's operands as the dense-Schur route's _solve takes them, from
    one _build of `bprob` and the block inverses at lambda = 1e-4
    max|Hll|: (pairs, W_lm, Hinv, Hcc_d)."""
    bpat = ba_ell.build_ba_ell_pattern(bprob)
    sys_ = ba_ell._build(bprob, bpat)
    lam = 1e-4 * sys_["Hll"][0].abs().max()
    _, hinv, _ = ba_inv.ba_block_inv(
        sys_["Hll"], ba_inv.LANDMARK, bprob.free[bpat.lm_name], lam,
        b=sys_["b_l"])
    hcc_d = ba_inv.ba_block_inv(sys_["Hcc"], ba_inv.CAMERA,
                                bprob.free[bpat.cam_name], lam,
                                want_inv=False)[0]
    return bpat.schur_pairs(), sys_["W_lm"], hinv, hcc_d


def k15_bytes_flops(groups, pattern):
    """What one dense_assemble call must move and compute beyond H, b,
    raw_diag and fixed_t: each group's residuals, Jacobians, rho' and Omega
    and the tables once (bytes), and the products J_s^T (rho' Omega) J_t
    of every slot pair (operations)."""
    nbytes = flops = 0
    for gi, g in enumerate(groups):
        E, D = g.resid.shape
        s = g.resid.element_size()
        widths = [j.shape[2] for j in g.jacs]
        nbytes += s * E * (D + D * sum(widths) + 1 + D * D)
        nbytes += 4 * sum(tb.chunk_ptr.numel() + tb.dest_chunk.numel()
                          + 2 * tb.n_dest + 2 * tb.edge.numel()
                          for tb in pattern.pairs[gi])
        flops += sum(2 * E * widths[a] * D * (D + widths[b])
                     for a in range(len(widths))
                     for b in range(a, len(widths)))
    return nbytes, flops


def lin_args(prob, eg):
    """K17's arguments for edge group `eg` of `prob`, as core/problem.py
    `linearize_group` passes them."""
    ea = prob.edges[eg.key]
    return (tuple(prob.params[g] for g in eg.slots),
            tuple(prob.free[g] for g in eg.slots), ea.indices,
            ea.measurement, ea.information, ea.delta, ea.pdata, eg.kernel_id)


def lin_bytes_flops(type_name, args):
    """What one K17 call with the wrapper arguments `args` must move and do:
    each slot's vertex table and free flags once (a table two slots share
    once), the indices, measurements, Omega, delta and parameter data, the
    residual, Jacobians and rho' written once (bytes); LIN_VALUE_OPS per
    edge and two per Jacobian entry (operations)."""
    from openslam_g2o_torch.core import registry
    params, free, indices, meas, info, delta, pdata, _ = args
    s = meas.element_size()
    E, D = meas.shape[0], info.shape[1]
    tables = {p.data_ptr(): p for p in params}.values()
    dims = [registry.vertex_type(n).tangent_dim
            for n in registry.edge_type(type_name).vertex_types]
    nbytes = (s * (sum(p.shape[0] * (p.shape[1] + 1) for p in tables)
                   + E * (meas.shape[1] + D * D + 1
                          + sum(p.shape[1] for p in pdata))
                   + E * (D + D * sum(dims) + 1)) + 4 * E * len(params))
    return nbytes, E * (LIN_VALUE_OPS[type_name] + 2 * D * sum(dims))


def lin_group(torch, type_name, n_edges, dtype, device, kernel_id=0,
              seed=0):
    """K17's arguments for one edge group of `type_name` with `n_edges`
    edges, built straight from seeded tensors: n_edges / 4 vertices per
    vertex group (every 7th fixed), random incidences (two slots of one
    vertex type never name one vertex), measurements, Omega = A A^T + I,
    delta in [0.5, 2] and parameter data. Poses sit near the identity (a
    translation within 0.5, a rotation within 0.3 rad) and points 4-8 in
    front of them, so every projection has positive depth; SE2 poses and
    XY points spread over 40 m, angles over [-pi, pi)."""
    import math
    from openslam_g2o_torch.core import registry
    et = registry.edge_type(type_name)
    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64

    def U(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, dtype=f64)

    def quat(n, scale):
        v = U(n, 3, lo=-scale, hi=scale)
        return torch.cat([v, torch.sqrt(1 - (v * v).sum(1, keepdim=True))],
                         1)

    def pose(n):
        return torch.cat([U(n, 3, lo=-0.5, hi=0.5), quat(n, 0.15)], 1)

    def point(n):
        return torch.cat([U(n, 2, lo=-2, hi=2), U(n, 1, lo=4, hi=8)], 1)

    def intr(n, w):
        return torch.cat([U(n, 2, lo=480, hi=520), U(n, 1, lo=300, hi=340),
                          U(n, 1, lo=220, hi=260), U(n, 1, lo=0.05,
                                                        hi=0.15)], 1)[:, :w]

    def bal(n):
        """BAL cameras (omega, t, f, k1, k2), every fifth at omega = 0 (the
        Taylor branch of so3_exp)"""
        om = U(n, 3, lo=-0.3, hi=0.3)
        om[::5] = 0.0
        return torch.cat([om, U(n, 3, lo=-0.5, hi=0.5),
                          U(n, 1, lo=480, hi=520), U(n, 1, lo=-0.1, hi=0.1),
                          U(n, 1, lo=-0.02, hi=0.02)], 1)

    n = max(n_edges // 4, 16)
    if type_name == "edge_project_psi2uv":   # inverse depth in the anchor
        point = lambda n_: torch.cat([U(n_, 2, lo=-0.4, hi=0.4),
                                      U(n_, 1, lo=0.125, hi=0.25)], 1)
    vertex = {
        "se2": lambda: torch.cat([U(n, 2, lo=-20, hi=20),
                                  U(n, 1, lo=-math.pi, hi=math.pi)], 1),
        "point_xy": lambda: U(n, 2, lo=-20, hi=20),
        "se3": lambda: pose(n), "se3_expmap": lambda: pose(n),
        "point_xyz": lambda: point(n), "sba_point_xyz": lambda: point(n),
        "cam": lambda: torch.cat([pose(n), intr(n, 5)], 1),
        "intrinsics": lambda: intr(4, 5), "bal_camera": lambda: bal(n)}
    tables = {vt: vertex[vt]() for vt in dict.fromkeys(et.vertex_types)}
    E = n_edges
    indices, first = [], {}
    for vt in et.vertex_types:
        N = tables[vt].shape[0]
        if vt in first:                       # another vertex of the group
            idx = (first[vt] + 1 + torch.randint(N - 1, (E,), generator=gen)
                   ) % N
        else:
            idx = first[vt] = torch.randint(N, (E,), generator=gen)
        indices.append(idx)
    M, D = et.measurement_dim, et.error_dim
    if type_name in ("edge_se3", "edge_se3_prior", "edge_se3_offset",
                     "edge_se3_expmap", "edge_sba_cam"):
        meas = pose(E)
    elif type_name in ("edge_se3_depth", "edge_se3_disparity"):
        z = U(E, 1, lo=4, hi=8)
        meas = torch.cat([U(E, 2, lo=200, hi=400),
                          z if type_name == "edge_se3_depth" else 1 / z], 1)
    elif type_name.startswith("edge_project") and type_name not in (
            "edge_project_psi2uv",):
        meas = U(E, M, lo=200, hi=400)
    elif type_name in ("edge_se2", "edge_se2_prior", "edge_se2_offset"):
        meas = torch.cat([U(E, 2, lo=-2, hi=2),
                          U(E, 1, lo=-math.pi, hi=math.pi)], 1)
    elif type_name == "edge_se2_xy_bearing":
        meas = U(E, 1, lo=-math.pi, hi=math.pi)
    elif type_name == "edge_sba_scale":
        meas = U(E, 1, lo=0.5, hi=1.5)
    else:                                      # positions, pixels of PSI2UV
        meas = U(E, M, lo=-5, hi=5)
    A = U(E, D, D, lo=-0.5, hi=0.5)
    info = A @ A.transpose(1, 2) + torch.eye(D, dtype=f64)
    pmake = {"se2_offset": lambda: torch.cat([U(E, 2, lo=-0.3, hi=0.3),
                                              U(E, 1, lo=-0.5, hi=0.5)], 1),
             "se3_offset": lambda: pose(E),
             "camera_calib": lambda: torch.cat([pose(E), intr(E, 4)], 1),
             "camera_parameters": lambda: torch.cat(
                 [U(E, 1, lo=480, hi=520), U(E, 1, lo=300, hi=340),
                  U(E, 1, lo=220, hi=260), U(E, 1, lo=0.05, hi=0.15)], 1)}
    pdata = tuple(pmake[pt]() for pt in et.param_types)
    to = lambda t: t.to(device=device, dtype=dtype).contiguous()
    free = {vt: (torch.arange(t.shape[0]) % 7 != 3).to(f64)
            for vt, t in tables.items()}
    return (tuple(to(tables[vt]) for vt in et.vertex_types),
            tuple(to(free[vt]) for vt in et.vertex_types),
            tuple(i.to(device=device, dtype=torch.int32) for i in indices),
            to(meas), to(info), to(U(E, lo=0.5, hi=2.0)),
            tuple(to(p) for p in pdata), kernel_id)


def trial_vertex_group(torch, vname, n, dtype, device, seed=0):
    """K7's retraction arguments for one seeded group of `n` vertices of
    `vname`: (x [n, P], dx [n, D] and b [n, D] as transposed views of
    lane-major [D, n] tables, as the Schur routes pass them, free [n]
    (every 7th fixed), lam). Poses near the identity (a translation within
    0.5, a rotation within 0.3 rad) with every third quaternion stored 3%
    off unit norm, SE2 poses over 40 m and [-pi, pi) with every fourth
    angle within 0.01 of +-pi stepped across it, points and intrinsics as
    lin_group's; steps of 0.05, b of the step's sign (no cancellation in
    the dot)."""
    import math
    from openslam_g2o_torch.core import registry
    vt = registry.vertex_type(vname)
    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64

    def U(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, dtype=f64)

    def pose():
        v = U(n, 3, lo=-0.15, hi=0.15)
        q = torch.cat([v, torch.sqrt(1 - (v * v).sum(1, keepdim=True))], 1)
        q[1::3] *= 1.03
        return torch.cat([U(n, 3, lo=-0.5, hi=0.5), q], 1)

    intr = lambda: torch.cat([U(n, 2, lo=480, hi=520),
                              U(n, 1, lo=300, hi=340),
                              U(n, 1, lo=220, hi=260),
                              U(n, 1, lo=0.05, hi=0.15)], 1)
    make = {"se2": lambda: torch.cat([U(n, 2, lo=-20, hi=20),
                                      U(n, 1, lo=-math.pi, hi=math.pi)], 1),
            "point_xy": lambda: U(n, 2, lo=-20, hi=20),
            "se3": pose, "se3_expmap": pose,
            "point_xyz": lambda: U(n, 3, lo=-2, hi=8),
            "sba_point_xyz": lambda: U(n, 3, lo=-2, hi=8),
            "cam": lambda: torch.cat([pose(), intr()], 1),
            "intrinsics": intr,
            "bal_camera": lambda: torch.cat([
                U(n, 3, lo=-0.3, hi=0.3), U(n, 3, lo=-0.5, hi=0.5),
                U(n, 1, lo=480, hi=520), U(n, 2, lo=-0.05, hi=0.05)], 1)}
    x = make[vname]()
    D = vt.tangent_dim
    dxT = 0.05 * (2 * torch.rand(D, n, generator=gen, dtype=f64) - 1)
    if vname == "se2":
        x[1::4, 2], dxT[2, 1::4] = math.pi - 0.01, 0.05
        x[2::4, 2], dxT[2, 2::4] = -math.pi + 0.01, -0.05
    bT = dxT.sign() * torch.rand(D, n, generator=gen, dtype=f64)
    free = (torch.arange(n) % 7 != 3).to(f64)
    to = lambda t: t.to(device=device, dtype=dtype).contiguous()
    return (to(x), to(dxT).T, to(bT).T, to(free),
            torch.tensor(0.7, dtype=dtype, device=device))


def trial_bytes_flops(vname, x, dx):
    """What one K7 retraction must move and do: x, dx, b and free read once,
    the candidate written once, a partial per block (bytes);
    RETRACT_OPS per vertex and three per tangent value (operations)."""
    s = x.element_size()
    N, P = x.shape
    D = dx.shape[1]
    return (s * (N * (2 * P + 2 * D + 1) + (N + 255) // 256),
            N * (RETRACT_OPS[vname] + 3 * D))


def chi2_bytes_flops(type_name, args):
    """What one K7 chi2 call with lin_group's arguments `args` must move and
    do: each slot's vertex table once (a table two slots share once), the
    indices, measurements, Omega, delta and parameter data, a partial per
    block (bytes); LIN_VALUE_OPS and 2 D^2 per edge (operations)."""
    params, _, indices, meas, info, delta, pdata, _ = args
    s = meas.element_size()
    E, D = meas.shape[0], info.shape[1]
    tables = {p.data_ptr(): p for p in params}.values()
    nbytes = (s * (sum(p.numel() for p in tables)
                   + E * (meas.shape[1] + D * D + 1
                          + sum(p.shape[1] for p in pdata))
                   + (E + 255) // 256) + 4 * E * len(params))
    return nbytes, E * (LIN_VALUE_OPS[type_name] + 2 * D * D)


def _pair_blocks(torch, so, dc):
    """The per-edge blocks J_s^T (rho' Omega) J_t [E, Dr*Dc] (dc > 0) or
    b parts -J_s^T (rho' Omega) e [E, Dr] of one K2' source, formed as the
    plain version forms them: what the index_add_ yardstick sums."""
    from openslam_g2o_torch.kernels.edge_se2 import bmm_small, bmv_small
    jw = bmm_small(so.js.transpose(1, 2), so.rho1[:, None, None] * so.info)
    blk = bmm_small(jw, so.jt) if dc else -bmv_small(jw, so.resid)
    return blk.reshape(blk.shape[0], -1)


def pair_work(pattern, srcs, bsrcs, s, blocks):
    """{kernel: (bytes, operations)} that each pair kernel's call over a
    whole PairPattern must move and do, for `bound_ms`; the assembly's
    sources `srcs` / `bsrcs` as core/sparse.py `pair_sources` gives them,
    s the float size, `blocks` the blocks of K5''s launch (its partials).
    Each input once: K17's residuals, Jacobians, rho' and Omega once per
    edge group (the six tables share them), each group's factors and
    vector once. Only the used slots of the assembled tables are read, and
    K4''s scaled tables hold only those; every slot of an assembled table
    is written, the padding's zeros too, since the layout holds them.

    pair_stream     the inputs above and an int32 place per contribution;
                    the stream (a record per contribution) written;
                    J_s^T (rho' Omega) formed once per edge and slot, then
                    one product per contribution
    pair_assemble   both passes, the whole function: the inputs above, an
                    int32 place per contribution and a run bound per
                    destination; every table and b written once (the
                    stream between the passes stays in L2 and is not
                    counted); pair_stream's operations
    pair_scale      used values, nb and rowptr, each group's L^-1 and
                    damping; the used values written; two block products
                    a used slot
    pair_spmv       used values, cols, rowptr, x; y written
    pair_spmv_dot   the same and its partials written
    pair_spmv_dot_p the same, p and r read, p_new and y written
    pair_gershgorin used values and rowptr; the bound written"""
    inputs, n_dest, flops_asm, formed = {}, 0, 0, set()
    for src in [*srcs, *(bsrcs[g] for g in pattern.groups)]:
        for so in src:
            for t in (so.resid, so.js, so.jt, so.rho1, so.info):
                if t is not None:
                    inputs[t.data_ptr()] = t.numel()
            E, D = so.resid.shape
            n_dest += E
            # rho' Omega once per edge group, J_s^T (rho' Omega) once per
            # slot, then the contribution's own product
            for key, ops in ((so.info.data_ptr(), D * D),
                             (so.js.data_ptr(), 2 * D * D * so.js.shape[2])):
                if key not in formed:
                    formed.add(key)
                    flops_asm += E * ops
            flops_asm += 2 * E * D * so.js.shape[2] * (
                1 if so.jt is None else so.jt.shape[2])
    tab_out = sum(pt.k * pt.dr * pt.dc * pt.n for pt in pattern.pairs)
    runs = (sum(pt.k * pt.n + 1 for pt in pattern.pairs)
            + sum(pattern.counts[g] + 1 for g in pattern.groups))
    stream_len = (sum(so.resid.shape[0] * pt.dr * pt.dc
                      for pt, src in zip(pattern.pairs, srcs) for so in src)
                  + sum(so.resid.shape[0] * pattern.widths[g]
                        for g in pattern.groups for so in bsrcs[g]))
    used = [int(pt.cnt.sum()) for pt in pattern.pairs]
    ptrs = sum(pt.n + 1 for pt in pattern.pairs)
    vals_used = sum(u * pt.dr * pt.dc for u, pt in zip(used, pattern.pairs))
    mv_flops = 2 * vals_used
    fac = sum(pattern.widths[g] ** 2 * pattern.counts[g]
              for g in pattern.groups)
    vec = sum(pattern.widths[g] * pattern.counts[g] for g in pattern.groups)
    damping = sum(pattern.counts[g] for g in pattern.square)
    return {
        "pair_stream": (s * (sum(inputs.values()) + stream_len)
                        + 4 * n_dest, flops_asm),
        "pair_assemble": (s * (sum(inputs.values()) + tab_out + vec)
                          + 4 * (n_dest + runs), flops_asm),
        "pair_scale": (s * (2 * vals_used + fac + damping)
                       + 4 * (sum(used) + ptrs),
                       sum(2 * u * pt.dr * pt.dc * (pt.dr + pt.dc)
                           for u, pt in zip(used, pattern.pairs))),
        "pair_spmv": (s * (vals_used + 2 * vec) + 4 * (sum(used) + ptrs),
                      mv_flops),
        "pair_spmv_dot": (s * (vals_used + 2 * vec + blocks)
                          + 4 * (sum(used) + ptrs), mv_flops + 2 * vec),
        "pair_spmv_dot_p": (s * (vals_used + 4 * vec + blocks)
                            + 4 * (sum(used) + ptrs), mv_flops + 4 * vec),
        "pair_gershgorin": (s * (vals_used + 1) + 4 * ptrs, vals_used),
    }


def _median_ms(torch, fn, repeats=15, inner=20, warmup=3):
    """Median over `repeats` of the time per call in a run of `inner`
    back-to-back calls between two CUDA events: what a call costs in a
    loop, the wrapper's host work included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


_SPIN = {}


def _device_ms(torch, fn, calls=200, repeats=5):
    """Device time per call: CUDA events around back-to-back calls that the
    host queues while the stream is held by a spin kernel
    (torch.cuda._sleep), so that the events time the device's work and not
    the host's enqueue. `calls` calls, or half as many while the spin ends
    before the last call is queued (a call of several launches can fill
    the launch queue), down to 25. Returns (median of `repeats` in ms, the
    calls timed, whether every repeat was held: False means a host-bound
    time)."""
    if "hz" not in _SPIN:                  # spin cycles per second
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _SPIN["hz"] = 1e7 / (start.elapsed_time(end) / 1e3)

    def window(n, spin_s):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(_SPIN["hz"] * spin_s))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        return start.elapsed_time(end) / n, held

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_s = 2 * host_s + 2e-3
    while True:
        ms, held = window(calls, spin_s)
        if held or calls <= 25:
            break
        calls //= 2
    times, all_held = [ms], held
    for _ in range(repeats - 1):
        ms, held = window(calls, spin_s)
        times.append(ms)
        all_held &= held
    times.sort()
    return times[len(times) // 2], calls, all_held


def _errors(torch, got, want, same_nan=False, scale=None):
    """(max abs error, max error relative to the largest finite |entry| of
    its output) over the tensors a kernel and its plain version returned.
    With same_nan the two must be NaN in exactly the same places, and the
    errors are taken over the other entries. With scale (tensors shaped
    as the outputs) the second is max |got - want| / scale per element."""
    as_tuple = lambda o: o if isinstance(o, (tuple, list)) else (o,)
    abs_err = rel_err = 0.0
    if scale is not None:
        for g, w, m in zip(as_tuple(got), as_tuple(want), as_tuple(scale),
                           strict=True):
            d = (g.detach().double() - w.detach().double()).abs()
            abs_err = max(abs_err, float(d.max()))
            rel_err = max(rel_err, float(
                (d / m.double().clamp_min(1e-300)).max()))
        return abs_err, rel_err
    for g, w in zip(as_tuple(got), as_tuple(want), strict=True):
        g, w = g.detach().double().reshape(-1), w.detach().double().reshape(-1)
        if same_nan:
            differ = int((torch.isnan(g) != torch.isnan(w)).sum())
            if differ:
                raise AssertionError(f"{differ} entries are NaN in only one "
                                     "of kernel and plain version")
            keep = ~torch.isnan(w)
            g, w = g[keep], w[keep]
        same_inf = torch.isinf(w) & (g == w)     # inf - inf would be NaN
        g, w = g[~same_inf], w[~same_inf]
        if w.numel() == 0:
            continue
        err = float((g - w).abs().max())
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / max(float(w.abs().max()), 1e-300))
    return abs_err, rel_err


def _bound(nbytes, flops):
    """(bound in ms, what bounds it) from the bytes a call must move and
    the operations it does."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


UNIT_ROUNDOFF = {"float32": 2.0 ** -23, "float64": 2.0 ** -52}


def block_inv_tol(tag, cond):
    """Tolerance of a batched block inverse: the TOL table's, or the
    first-order perturbation bound cond x eps of the worst-conditioned
    block where that is larger."""
    return max(TOL["ba_block_inv"][tag], cond * UNIT_ROUNDOFF[tag])


def wv_error_scale(ba_coupling, w, rows, v, x, base=None, hcc_d=None,
                   extra=None):
    """The magnitudes the W v check takes its error relative to: per
    element of y = base + Hcc_d x + extra - W v, the sum of its terms'
    magnitudes |base| + |Hcc_d| |x| + |extra| + |W| |v|, and for the dot
    x . y, sum |x| times those: (magnitudes of y [Dp, N], of the dot)."""
    neg = lambda t: None if t is None else -t.abs()
    mag, part = ba_coupling.ba_wv_plain(
        w.abs(), rows, v.abs(), base=neg(base), hcc_d=neg(hcc_d),
        x=x.abs(), extra=neg(extra), want_dot=True)
    return mag.abs(), part.abs().sum()


def wrong_row_reading(y, mag, rows):
    """What the W v check reads for a kernel whose row n is 1% off (y[:, n]
    times 1.01): max_s 0.01 |y[s, n]| / mag[s, n], for the row with the most
    entries and for the row where the reading is smallest, as ((n, entries,
    reading), (n, entries, reading))."""
    reading = (0.01 * y.double().abs() / mag.double().clamp_min(1e-300)) \
        .max(dim=0).values
    deg = (rows.ptr[1:] - rows.ptr[:-1]).long()
    hub, low = int(deg.argmax()), int(reading.argmin())
    return ((hub, int(deg[hub]), float(reading[hub])),
            (low, int(deg[low]), float(reading[low])))


def main() -> int:
    t_main = time.monotonic()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import numpy as np
    from openslam_g2o_torch import kernels, loads_g2o, save_g2o
    from openslam_g2o_torch.apps.simulator import (
        Simulator2D, Simulator3D, create_sphere, synthetic_bal_problem,
        synthetic_pose_graph_2d)
    from openslam_g2o_torch.core import ba as ba_general
    from openslam_g2o_torch.core import ba_ell, factory
    from openslam_g2o_torch.core import problem as problem_mod
    from openslam_g2o_torch.core import sparse
    from openslam_g2o_torch.core.algorithms import (
        GaussNewton, LevenbergMarquardt, LevenbergMarquardtPCG,
        _lambda_init_pcg, _pcg_precomp, _pcg_trial, _trial_outcome,
        lm_pcg_optimize_fused, optimize)
    from openslam_g2o_torch.core.graph import Graph
    from openslam_g2o_torch.core.problem import robust_chi2
    from openslam_g2o_torch.core.solvers import solve_dense_cholesky
    from openslam_g2o_torch.kernels import (
        assemble, ba_coupling, ba_edge, ba_inv, ba_schur, build, cg_step,
        chebyshev, damp_chol, dense_assemble, edge_lin, edge_se2, edge_se3,
        gather, jacobi_scale, pair_ell, retract_chi2, schur_general, spmv,
        trial)
    from openslam_g2o_torch.core import registry as registry_mod
    from openslam_g2o_torch.models.bal import (
        load_bal_problem, save_bal_problem)
    from openslam_g2o_torch.utils import np_lie

    # -- 1. device --------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"phase 1 device: torch={name!r} count="
          f"{torch.cuda.device_count()} torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvidia-smi: {card}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.monotonic()
    build.load()
    built = build.last_build()
    # ptxas -v: registers of every kernel, and the kernels that spill
    regs, spilling, entry_name, by_kernel = [], [], "?", []
    for ln in built["log"].splitlines():
        if "Compiling entry function" in ln:
            entry_name = ln.split("'")[1]
        elif "bytes spill stores" in ln and \
                "0 bytes spill stores, 0 bytes spill loads" not in ln:
            spilling.append([entry_name, ln.strip()])
        elif "Used " in ln:
            regs.append(int(ln.split("Used ")[1].split()[0]))
            # _ZN9g2o_torch<len><name>I<f|d>[Li<D>E]E... -> name<f|d[,D]>
            m = re.match(r"_ZN9g2o_torch(\d+)", entry_name)
            short = entry_name
            if m:
                rest = entry_name[m.end():]
                short, rest = rest[:int(m.group(1))], rest[int(m.group(1)):]
                t = re.match(r"I([fd])(?:Li(\d+)E)?", rest)
                if t:
                    short += "<" + ",".join(x for x in t.groups() if x) + ">"
            by_kernel.append(f"{short}={regs[-1]}")
            if spilling and spilling[-1][0] == entry_name:
                spilling[-1].append(f"{regs[-1]} registers")
    print(f"phase 2 build: {time.monotonic() - t0:.2f} s "
          f"(nvcc {built['seconds']:.2f} s, "
          f"{len(list(build.CSRC.glob('*.cu')))} sources in parallel) -> "
          f"{built['path']}; ptxas: {len(regs)} kernels, registers "
          f"{min(regs, default=0)}-{max(regs, default=0)}, "
          f"{len(spilling)} with spills")
    print("phase 2 registers: " + " ".join(by_kernel))
    for entry in spilling:
        print("phase 2 spills: " + "; ".join(entry))

    # -- 3. kernels against their plain versions ---------------------------
    results = {}

    def case(kname, tag, shape, run, plain, nbytes, flops, library=None,
             same_nan=False, label=None, timed=True, post=None,
             slow_plain=False, tol=None, scale=None, library_what=None):
        """Compare one kernel with its plain version (`run` and `plain`
        return the tensors to compare; `post` first reduces partial sums
        and splits a scalar buffer, on both sides), time both (a plain
        version of tens of ms: median of 5 single calls), and record the
        row under (label or kname, tag); `tol` overrides the TOL table;
        `scale` returns per-element magnitudes that the error is taken
        relative to (_errors); `library_what` says what the library call
        leaves out of the kernel's function."""
        post = post or (lambda out: out)
        abs_e, rel_e = _errors(torch, post(run()), post(plain()), same_nan,
                               None if scale is None else scale())
        row = dict(abs=abs_e, rel=rel_e, shape=shape, kname=kname,
                   library_what=library_what)
        if tol is not None:
            row["tol"] = tol
        if timed:
            row.update(ms=_median_ms(torch, run),
                       plain_ms=(_median_ms(torch, plain, 5, 1, 1)
                                 if slow_plain else _median_ms(torch, plain)),
                       library_ms=(None if library is None
                                   else _median_ms(torch, library)))
            row["bound_ms"], row["bound_by"] = _bound(nbytes, flops)
        results[(label or kname, tag)] = row

    def chi2_witness(label, wname, args, part, plain32):
        """A float32 chi2 row's witness: the plain version in float64 on
        the same values (the float32 inputs widened, so it computes the
        answer both float32 versions round), and the distance of the
        kernel's partials and of the float32 plain version's sum from it,
        relative to it. On the worlds of 4d, 4f and 4o (pose chains of
        hundreds of metres, started noisy) a float32 chi2 cancels
        coordinates against centimetre residuals, as the LM-PCG trial's
        does, so both float32 versions may land further from the float64
        answer than K7's float32 tolerance between them: the check then
        lets a float32 row whose kernel and plain version disagree beyond
        that tolerance pass only where the kernel is within
        CHI2_WITNESS_TOL of the float64 answer (ROADMAP.md §3 lists the
        rows that need it)."""
        wide = lambda t: tuple(x.double() for x in t)
        params, idx, meas, info, delta, pdata, kid = args
        ref = float(getattr(trial, wname + "_plain")(
            wide(params), idx, meas.double(), info.double(),
            delta.double(), wide(pdata), kid).sum())
        scale = max(abs(ref), 1e-300)
        row = results[(label, "float32")]
        row["witness"] = (abs(float(part.double().sum()) - ref) / scale,
                          abs(float(plain32.double().sum()) - ref) / scale)
        print(f"phase 3 witness {label} float32: float64 plain version on "
              f"the same values {ref!r}; kernel {row['witness'][0]:.3e}, "
              f"float32 plain version {row['witness'][1]:.3e} from it "
              f"(relative); kernel against the float32 plain version "
              f"{row['rel']:.3e}")

    def device_rows(label, tag, fns):
        """Device time per call (_device_ms: CUDA events over 200 calls) of
        the kernel's wrapper and of its yardsticks (`fns`: description ->
        call, the kernel's first), printed beside the row's bound."""
        row = results[(label, tag)]
        timed = {k: _device_ms(torch, f) for k, f in fns.items()}
        kernel_ms = next(iter(timed.values()))[0]
        print(f"phase 3 device {label} {tag}: "
              + "; ".join(f"{k} {1e3 * ms:.2f} us"
                          + ("" if n == 200 else f" ({n} calls)")
                          + ("" if held else " (host-bound: the stream ran "
                             "dry)") for k, (ms, n, held) in timed.items())
              + f"; bound {1e3 * row['bound_ms']:.2f} us ({row['bound_by']}"
              f"), the kernel at {100 * row['bound_ms'] / kernel_ms:.0f}% of "
              f"it (CUDA events around 200 calls back to back, median of 5) "
              f"[{card}]")

    def precond_rows(label, tag, mats, r, what):
        """K4's lane_block_mv_dot on one preconditioner table mats [D*D, N]
        and vector r [D, N]: against its plain version, its partials bit
        for bit against dot_partials of its z, twice for the same bits, and
        by device time beside torch.bmm (z alone, the yardstick); at a width
        lane_block_mv is built at (MV_WIDTHS), also bit for bit against the
        two launches it replaces (lane_block_mv, then dot_partials) and by
        device time beside that pair (the parent's form) and lane_block_mv
        alone."""
        D, N = r.shape
        run = lambda: jacobi_scale.lane_block_mv_dot(mats, r)
        m_b = mats.view(D, D, N).permute(2, 0, 1).contiguous()
        r_b = r.T.contiguous()[:, :, None]
        bmm = lambda: torch.bmm(m_b, r_b)
        chunks = -(-D * N // cg_step.CHUNK)
        case("lane_block_mv_dot", tag, f"D={D} N={N}, {what}", run,
             lambda: jacobi_scale.lane_block_mv_dot_plain(mats, r),
             nbytes=r.element_size() * ((D * D + 2 * D) * N + chunks),
             flops=2 * D * D * N + 2 * D * N, label=label, library=bmm,
             post=lambda o: (o[0], o[1].sum()),
             library_what="z = M r alone, without the r . z partials")
        z, part = run()
        pair = D in jacobi_scale.MV_WIDTHS
        z_row = jacobi_scale.lane_block_mv(mats, r) if pair else z
        if not (torch.equal(z, z_row) and torch.equal(
                part, cg_step.dot_partials(r, z_row))):
            raise AssertionError(f"{label} {tag}: not the bits of "
                                 + ("lane_block_mv + " if pair else "")
                                 + "dot_partials")
        z2, part2 = run()
        if not (torch.equal(z2, z) and torch.equal(part2, part)):
            raise AssertionError(f"{label} {tag} does not repeat its bits")
        rows = {"kernel": run}
        if pair:
            rows["the parent's pair, lane_block_mv + dot_partials"] = \
                lambda: cg_step.dot_partials(
                    r, jacobi_scale.lane_block_mv(mats, r))
            rows["lane_block_mv alone"] = \
                lambda: jacobi_scale.lane_block_mv(mats, r)
        rows[f"torch.bmm on [N, {D}, {D}] x [N, {D}, 1]"] = bmm
        device_rows(label, tag, rows)

    def two_launch_rows(pattern, svals, p0, r0, scal0, hp0, part_pap, x0,
                        tag, s, sfx, spmv_bytes, spmv_flops):
        """The two-launch CG step from the state after cg_start and one
        spmv_dot: cg_update_xr with an arrival counter (its last block
        stores cg_update_p's scalars) against the three-launch pair, then
        spmv_dot_p against cg_update_p + spmv_dot from the same state: the
        same scalars, x, r, p, H p and partials bit for bit; both against
        their plain versions; device times beside the three-launch
        kernels' and spmv_dot + torch.addcmul."""
        n = p0.numel()
        arrivals = torch.zeros(1, dtype=torch.int32, device=dev)
        st = {}
        for route in ("two", "three"):
            xx, rr_, pp, sc = x0.clone(), r0.clone(), p0.clone(), scal0.clone()
            part = cg_step.cg_update_xr(sc, part_pap, xx, rr_, pp, hp0,
                                        arrivals if route == "two" else None)
            if route == "three":
                cg_step.cg_update_p(sc, part, part, rr_, pp, True)
            st[route] = (xx, rr_, pp, sc)
        if int(arrivals.item()) != 0:
            raise AssertionError("cg_update_xr left its arrival counter set")
        if not all(torch.equal(a_, b_) for a_, b_ in zip(
                (st["two"][0], st["two"][1], st["two"][3]),
                (st["three"][0], st["three"][1], st["three"][3]))):
            raise AssertionError("cg_update_xr with the finish differs from "
                                 "cg_update_xr + cg_update_p")
        # the same bits again, both forms
        for route in ("two", "three"):
            xx, rr_, sc = x0.clone(), r0.clone(), scal0.clone()
            part = cg_step.cg_update_xr(sc, part_pap, xx, rr_, p0, hp0,
                                        arrivals if route == "two" else None)
            if route == "three":
                cg_step.cg_update_p(sc, part, part, rr_, p0.clone(), True)
            if not (torch.equal(xx, st[route][0])
                    and torch.equal(rr_, st[route][1])
                    and torch.equal(sc, st[route][3])):
                raise AssertionError(f"cg_update_xr ({route}-launch step) "
                                     "does not repeat its bits")
        xs = {r_: (x0.clone(), r0.clone(), scal0.clone())
              for r_ in ("k", "p")}
        if sfx:                  # the three-launch form at this width
            xs3 = {r_: (x0.clone(), r0.clone(), scal0.clone())
                   for r_ in ("k", "p")}
            case("cg_update_xr", tag, f"n={n}, three-launch form",
                 lambda: (xs3["k"][0], xs3["k"][1], cg_step.cg_update_xr(
                     xs3["k"][2], part_pap, xs3["k"][0], xs3["k"][1], p0,
                     hp0), xs3["k"][2]),
                 lambda: (xs3["p"][0], xs3["p"][1], cg_step.cg_update_xr_plain(
                     xs3["p"][2], part_pap, xs3["p"][0], xs3["p"][1], p0,
                     hp0), xs3["p"][2]),
                 nbytes=6 * s * n, flops=6 * n, post=sums(2, scal=True),
                 label="cg_update_xr" + sfx)

        def run_fin(fn, st_, route):
            out = fn(st_[2], part_pap, st_[0], st_[1], p0, hp0,
                     arrivals if route == "k" else
                     torch.zeros(1, dtype=torch.int32, device=dev))
            return st_[0], st_[1], out, st_[2]

        case("cg_update_xr", tag, f"n={n}, with the step's scalars",
             lambda: run_fin(cg_step.cg_update_xr, xs["k"], "k"),
             lambda: run_fin(cg_step.cg_update_xr_plain, xs["p"], "p"),
             nbytes=6 * s * n, flops=6 * n, post=sums(2, scal=True),
             label="cg_update_xr@finish" + sfx)
        xk, rk, pk, sck = st["two"]
        p_new = torch.full_like(pk, float("nan"))
        hp_f, part_f = cg_step.spmv_dot_p(pattern.nb, svals, sck, pk, rk,
                                          p_new)
        hp_t, part_t = cg_step.spmv_dot(pattern.nb, svals, st["three"][2])
        if not (torch.equal(p_new, st["three"][2]) and torch.equal(hp_f, hp_t)
                and torch.equal(part_f, part_t)):
            raise AssertionError("spmv_dot_p differs from cg_update_p + "
                                 "spmv_dot")
        again = torch.empty_like(pk)
        if not (all(torch.equal(a_, b_) for a_, b_ in zip(
                cg_step.spmv_dot_p(pattern.nb, svals, sck, pk, rk, again),
                (hp_f, part_f))) and torch.equal(again, p_new)):
            raise AssertionError("spmv_dot_p does not repeat its bits")
        pn_k, pn_p = torch.empty_like(pk), torch.empty_like(pk)
        D = pk.shape[0]
        case("spmv_dot_p", tag, f"D={D} N={pk.shape[1]}",
             lambda: (pn_k, *cg_step.spmv_dot_p(pattern.nb, svals, sck, pk,
                                                rk, pn_k)),
             lambda: (pn_p, *cg_step.spmv_dot_p_plain(pattern.nb, svals, sck,
                                                      pk, rk, pn_p)),
             nbytes=spmv_bytes + 2 * s * n, flops=spmv_flops + 4 * n,
             post=lambda out: (out[0], out[1], out[2].sum()),
             label="spmv_dot_p" + sfx)
        z_ = rk.clone()
        part_z = cg_step.dot_partials(z_, z_)
        p_, sc_ = pk.clone(), sck.clone()
        beta_ = sck[cg_step.BETA].clone()
        device_rows("spmv_dot_p" + sfx, tag, {
            "kernel": lambda: cg_step.spmv_dot_p(pattern.nb, svals, sck, pk,
                                                 rk, pn_k),
            "spmv_dot": lambda: cg_step.spmv_dot(pattern.nb, svals, pk),
            "block_ell_spmv (kernel A: H p alone)": lambda: (
                spmv.block_ell_spmv(pattern.nb, svals, pk)),
            "spmv_dot + cg_update_p (the three-launch step's pair)":
                lambda: (cg_step.cg_update_p(sc_, part_z, part_z, z_, p_,
                                             True),
                         cg_step.spmv_dot(pattern.nb, svals, p_)),
            "spmv_dot + torch.addcmul (one PyTorch call for p = z + beta p)":
                lambda: (torch.addcmul(z_, pk, beta_),
                         cg_step.spmv_dot(pattern.nb, svals, pk))})
        device_rows("cg_update_xr@finish" + sfx, tag, {
            "kernel": lambda: cg_step.cg_update_xr(
                xs["k"][2], part_pap, xs["k"][0], xs["k"][1], p0, hp0,
                arrivals),
            "cg_update_xr (three-launch step)": lambda: cg_step.cg_update_xr(
                xs["k"][2], part_pap, xs["k"][0], xs["k"][1], p0, hp0),
            "cg_update_p": lambda: cg_step.cg_update_p(
                sc_, part_z, part_z, z_, p_, True)})
        # one whole CG iteration each way, from copies of the same state: what
        # the fold buys on the device, the launch bounds being the same
        three = [x0.clone(), r0.clone(), p0.clone(), scal0.clone()]
        two = [x0.clone(), r0.clone(), p0.clone(), p0.clone(), sck.clone()]

        def step_three():
            x_, r_, p_, s_ = three
            hp_, pap_ = cg_step.spmv_dot(pattern.nb, svals, p_)
            rr_ = cg_step.cg_update_xr(s_, pap_, x_, r_, p_, hp_)
            cg_step.cg_update_p(s_, rr_, rr_, r_, p_, False)

        def step_two():
            x_, r_, p_, q_, s_ = two
            hp_, pap_ = cg_step.spmv_dot_p(pattern.nb, svals, s_, p_, r_, q_)
            cg_step.cg_update_xr(s_, pap_, x_, r_, q_, hp_, arrivals)
            two[2], two[3] = q_, p_

        t3, t2 = _device_ms(torch, step_three), _device_ms(torch, step_two)
        t2b = _device_ms(torch, step_two)
        # twenty CG iterations each way from the state after the first
        # step: the same bits (a read of p or hp that the product had not
        # yet written, under the programmatic dependent launch, would show)
        x_, r_, p_, s_ = (t_.clone() for t_ in st["two"])
        q_ = torch.empty_like(p_)
        for _ in range(20):
            hp_, pap_ = cg_step.spmv_dot_p(pattern.nb, svals, s_, p_, r_, q_)
            cg_step.cg_update_xr(s_, pap_, x_, r_, q_, hp_, arrivals)
            p_, q_ = q_, p_
        runs = [(x_, r_, s_)]
        x_, r_, p_, s_ = (t_.clone() for t_ in st["three"])
        for _ in range(20):
            hp_, pap_ = cg_step.spmv_dot(pattern.nb, svals, p_)
            rr_ = cg_step.cg_update_xr(s_, pap_, x_, r_, p_, hp_)
            cg_step.cg_update_p(s_, rr_, rr_, r_, p_, False)
        runs.append((x_, r_, s_))
        if not all(torch.equal(a_, b_) for a_, b_ in zip(*runs)):
            raise AssertionError(f"20 two-launch CG iterations{sfx} {tag} "
                                 "differ from 20 three-launch iterations")
        print(f"phase 3 device CG iteration{sfx} {tag}: three launches "
              f"(spmv_dot + cg_update_xr + cg_update_p) {1e3 * t3[0]:.2f} us"
              f" ({t3[1]} iterations); two launches (spmv_dot_p + "
              f"cg_update_xr with its finish) {1e3 * t2[0]:.2f}, "
              f"{1e3 * t2b[0]:.2f} us ({t2[1]} iterations); the fold saves "
              f"{1e3 * (t3[0] - t2[0]):.2f} us (CUDA events, median of 5) "
              f"[{card}]")

    def sums(*which, scal=False):
        """Reduce the partial-sum outputs at the given positions. With
        `scal` the last output is the scalar buffer and is split into its
        slots, one tensor each, so that every scalar is held relative to its
        own plain value and not to the largest of the ten (rz, r2 and b2
        are ~|b|^2; alpha, beta and the flags ~1)."""
        def post(out):
            out = [o.sum() if i in which else o for i, o in enumerate(out)]
            return (*out[:-1], *out[-1].unbind()) if scal else tuple(out)
        return post

    probs = {}
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
        s = torch.empty((), dtype=dt).element_size()
        prob, info = synthetic_pose_graph_2d(
            n_poses=N_POSES, grid=GRID, trans_noise=0.03, rot_noise=0.002,
            dtype=dt)
        if prob.device.type != "cuda":
            raise AssertionError("the default device is not the card")
        floor = info["noise_floor_chi2"]
        probs[tag] = prob
        pattern = sparse.build_ell_pattern(prob)
        N, K, E = pattern.n, pattern.k, pattern.e_total
        ea = prob.edges["edge_se2"]
        gen = torch.Generator(device=dev).manual_seed(0)
        randn = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                           dtype=dt)

        # B and C, on streams of the main path's width (pattern.e_cols:
        # E rounded up to whole lines; the padding columns stay zero)
        W = pattern.e_cols
        hk = torch.zeros((9, 4 * W), dtype=dt, device=dev)
        bk = torch.zeros((3, 2 * W), dtype=dt, device=dev)
        hp_, bp_ = torch.zeros_like(hk), torch.zeros_like(bk)
        args = (prob.params["se2"], prob.free["se2"], ea.indices[0],
                ea.indices[1], ea.measurement, ea.information, ea.delta, 0)

        def run_b():
            edge_se2.edge_se2_blocks(*args, hk, bk, 0)
            return hk, bk

        def plain_b():
            edge_se2.edge_se2_blocks_plain(*args, hp_, bp_, 0)
            return hp_, bp_

        case("edge_se2_blocks", tag, f"E={E}", run_b, plain_b,
             nbytes=s * (4 * N + 13 * E + 42 * E) + 8 * E, flops=400 * E)
        cargs = (hk, bk, pattern.hidx, pattern.bidx, K, N)
        hdest = torch.zeros(4 * W, dtype=torch.long, device=dev)
        bdest = torch.zeros(2 * W, dtype=torch.long, device=dev)
        for tbl, dest in ((pattern.hidx, hdest), (pattern.bidx, bdest)):
            cols = torch.arange(tbl.shape[1], device=dev).expand_as(tbl)
            dest[tbl[tbl >= 0].long()] = cols[tbl >= 0]
        lib_v = torch.zeros((9, K * N), dtype=dt, device=dev)
        lib_b = torch.zeros((3, N), dtype=dt, device=dev)

        def lib_c():                         # accumulates; timed only
            lib_v.index_add_(1, hdest, hk)
            lib_b.index_add_(1, bdest, bk)

        case("assemble_gather", tag,
             f"N={N} K={K} mh={pattern.hidx.shape[0]}",
             lambda: assemble.assemble_gather(*cargs),
             lambda: assemble.assemble_gather_plain(*cargs),
             nbytes=s * (42 * E + 9 * K * N + 3 * N)
             + 4 * (pattern.hidx.numel() + pattern.bidx.numel()),
             flops=36 * E, library=lib_c)
        device_rows("assemble_gather", tag, {
            "kernel": lambda: assemble.assemble_gather(*cargs),
            "two index_add_": lib_c})
        values, b = assemble.assemble_gather(*cargs)
        del hk, bk, hp_, bp_, lib_v, lib_b

        # A at the slice shape (library: a BSR product) and the probe's
        r = np.random.default_rng(0)
        probe_nb = torch.as_tensor(
            r.integers(0, 3500, (10, 3500)).astype(np.int32), device=dev)
        probe_vals = torch.as_tensor(r.normal(size=(10, 9, 3500)), dtype=dt,
                                     device=dev)
        x = randn(3, N)
        rows_ = torch.arange(N, device=dev).expand(K, N)
        real = (values != 0).any(dim=1)       # every slot but the padding
        real[0] = True
        order = torch.argsort(rows_[real] * N + pattern.nb[real].long())
        bsr = torch.sparse_bsr_tensor(
            torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                       torch.cumsum(real.sum(dim=0), 0)]),
            pattern.nb[real].long()[order],
            values.permute(0, 2, 1)[real][order].reshape(-1, 3, 3),
            size=(3 * N, 3 * N))
        x_col = x.t().reshape(3 * N, 1).contiguous()
        lib_y = (bsr @ x_col).reshape(N, 3).t()
        _, lib_rel = _errors(torch, lib_y,
                             spmv.block_ell_spmv_plain(pattern.nb, values, x))
        if lib_rel > TOL_DEFAULT[tag] * 10:
            raise AssertionError(f"the BSR yardstick disagrees: {lib_rel}")
        case("block_ell_spmv", tag, f"N={N} K={K}",
             lambda: spmv.block_ell_spmv(pattern.nb, values, x),
             lambda: spmv.block_ell_spmv_plain(pattern.nb, values, x),
             nbytes=s * (9 * K * N + 6 * N) + 4 * K * N, flops=18 * K * N,
             library=lambda: bsr @ x_col)
        xp = randn(3, 3500)
        # the probe's random columns repeat within a row: summed into a
        # dense matrix first, then cut into 3x3 blocks for the BSR product
        nine = torch.arange(9, device=dev)[None, :, None]
        dense_p = torch.zeros((3 * 3500, 3 * 3500), dtype=dt, device=dev)
        dense_p.index_put_(
            ((3 * torch.arange(3500, device=dev)[None, None, :]
              + nine // 3).expand(10, 9, 3500),
             3 * probe_nb[:, None, :].long() + nine % 3),
            probe_vals, accumulate=True)
        bsr_p = dense_p.to_sparse_bsr(blocksize=(3, 3))
        xp_col = xp.t().reshape(3 * 3500, 1).contiguous()
        _, lib_rel = _errors(
            torch, (bsr_p @ xp_col).reshape(3500, 3).t(),
            spmv.block_ell_spmv_plain(probe_nb, probe_vals, xp))
        if lib_rel > TOL_DEFAULT[tag] * 10:
            raise AssertionError(f"the probe's BSR yardstick disagrees: "
                                 f"{lib_rel}")
        case("block_ell_spmv", tag, "N=3500 K=10",
             lambda: spmv.block_ell_spmv(probe_nb, probe_vals, xp),
             lambda: spmv.block_ell_spmv_plain(probe_nb, probe_vals, xp),
             nbytes=s * (90 * 3500 + 6 * 3500) + 40 * 3500,
             flops=180 * 3500, label="block_ell_spmv@probe",
             library=lambda: bsr_p @ xp_col)
        del bsr, bsr_p, dense_p

        # K3 and K4 at lambda0, and their NaN cases
        free = prob.free["se2"]
        lam = _lambda_init_pcg(prob, pattern, prob.params,
                               torch.tensor(1e-5, dtype=dt, device=dev))
        eye3 = torch.eye(3, dtype=dt, device=dev)

        def lib_chol3(ex=False):
            """The library yardstick, as for D = 6: torch.linalg.cholesky
            and solve_triangular on the damped [N, 3, 3] blocks."""
            blocks = (values[0].view(3, 3, N).permute(2, 0, 1)
                      + (lam * free + (1 - free))[:, None, None] * eye3)
            L = (torch.linalg.cholesky_ex(blocks)[0] if ex
                 else torch.linalg.cholesky(blocks))
            return torch.linalg.solve_triangular(L, eye3.expand(N, 3, 3),
                                                 upper=False)

        case("damp_chol", tag, f"N={N}",
             lambda: damp_chol.damp_chol(values, free, b, lam),
             lambda: damp_chol.damp_chol_plain(values, free, b, lam),
             nbytes=s * (9 + 1 + 3 + 9 + 9 + 3 + 1) * N, flops=60 * N,
             library=lib_chol3)
        device_rows("damp_chol", tag, {
            "kernel": lambda: damp_chol.damp_chol(values, free, b, lam),
            "torch.linalg.cholesky + solve_triangular": lib_chol3,
            "the same with cholesky_ex (no error check, no host read)":
                lambda: lib_chol3(ex=True)})
        bad_values = values.clone()
        bad_values[0, 0, 7] = -1.0e6          # block 7 is not SPD
        case("damp_chol", tag, f"N={N}, block 7 not SPD",
             lambda: damp_chol.damp_chol(bad_values, free, b, lam),
             lambda: damp_chol.damp_chol_plain(bad_values, free, b, lam),
             0, 0, same_nan=True, label="damp_chol@nan", timed=False)
        for fn in (damp_chol.damp_chol, damp_chol.damp_chol_plain):
            f_inv, f_chol = fn(bad_values, free, b, lam)[:2]
            if not (torch.isnan(f_inv[:, 7]).any()
                    and torch.isnan(f_chol[:, 7]).any()):
                raise AssertionError("a non-SPD block did not give NaN "
                                     "factors")
            if (f_inv[[1, 2, 5]] != 0).any() or (f_chol[[1, 2, 5]] != 0).any():
                raise AssertionError("an upper entry of a factor is not 0")
        del bad_values
        linv, lchol, bhat, extra = damp_chol.damp_chol(values, free, b, lam)
        case("jacobi_scale", tag, f"N={N} K={K}",
             lambda: jacobi_scale.jacobi_scale(pattern.nb, values, linv,
                                               extra),
             lambda: jacobi_scale.jacobi_scale_plain(pattern.nb, values,
                                                     linv, extra),
             nbytes=s * (18 * K * N + 10 * N) + 4 * K * N,
             flops=108 * K * N)
        bad_linv = linv.clone()
        bad_linv[:, 0] = float("nan")         # row 0's factor
        pad = (values == 0).all(dim=1)          # [K, N] empty slots
        pad[0] = False
        n_pad = int(pad.sum())
        case("jacobi_scale", tag,
             f"N={N} K={K}, NaN factor in row 0, {n_pad} padding slots",
             lambda: jacobi_scale.jacobi_scale(pattern.nb, values, bad_linv,
                                               extra),
             lambda: jacobi_scale.jacobi_scale_plain(pattern.nb, values,
                                                     bad_linv, extra),
             0, 0, same_nan=True, label="jacobi_scale@nan", timed=False)
        if n_pad == 0:
            raise AssertionError("the NaN case has no padding slot")
        for fn in (jacobi_scale.jacobi_scale, jacobi_scale.jacobi_scale_plain):
            scaled = fn(pattern.nb, values, bad_linv, extra)
            if (scaled.permute(0, 2, 1)[pad] != 0).any():
                raise AssertionError("a padding slot is not exactly zero")
            if not torch.isnan(scaled[0, :, 0]).all():
                raise AssertionError("row 0's NaN factor did not show")
        del bad_linv
        lchol3 = lchol.view(3, 3, N)
        case("lane_block_mv", tag, f"N={N} (and its transpose)",
             lambda: (jacobi_scale.lane_block_mv(lchol, x, True),
                      jacobi_scale.lane_block_mv(linv, x, False)),
             lambda: (jacobi_scale.lane_block_mv_plain(lchol, x, True),
                      jacobi_scale.lane_block_mv_plain(linv, x, False)),
             nbytes=2 * s * 15 * N, flops=2 * 18 * N,
             library=lambda: (torch.einsum("ban,bn->an", lchol3, x),
                              torch.einsum("abn,bn->an", linv.view(3, 3, N),
                                           x)))
        svals = jacobi_scale.jacobi_scale(pattern.nb, values, linv, extra)

        # K6 on the scaled system
        n = 3 * N
        p = randn(3, N)
        spmv_bytes = s * (9 * K * N + 6 * N) + 4 * K * N

        flags = [cg_step.PD, cg_step.CONT, cg_step.PD_NEXT]

        def check_flags(what, scal_kernel, scal_plain, **expect):
            """The 0/1 slots agree exactly, and hold the expected values
            (slot name -> 0.0 or 1.0) in kernel and plain version alike."""
            if not torch.equal(scal_kernel[flags], scal_plain[flags]):
                raise AssertionError(
                    f"{what}: the pd/continue flags differ: kernel "
                    f"{scal_kernel[flags].tolist()} plain "
                    f"{scal_plain[flags].tolist()}")
            for slot, value in expect.items():
                for route, sc in (("kernel", scal_kernel),
                                  ("plain", scal_plain)):
                    if float(sc[getattr(cg_step, slot)]) != value:
                        raise AssertionError(
                            f"{what}: {route} {slot} is not {value}: "
                            f"{sc.tolist()}")

        case("spmv_dot", tag, f"N={N} K={K}",
             lambda: cg_step.spmv_dot(pattern.nb, svals, p),
             lambda: cg_step.spmv_dot_plain(pattern.nb, svals, p),
             nbytes=spmv_bytes, flops=18 * K * N + 6 * N, post=sums(1))
        a_vec = randn(3, N)
        b_vec = a_vec + 0.1 * randn(3, N)
        case("dot_partials", tag, f"n={n}",
             lambda: cg_step.dot_partials(a_vec, b_vec),
             lambda: cg_step.dot_partials_plain(a_vec, b_vec),
             nbytes=2 * s * n, flops=2 * n, post=torch.sum,
             library=lambda: torch.dot(a_vec.view(-1), b_vec.view(-1)))
        device_rows("dot_partials", tag, {
            "kernel": lambda: cg_step.dot_partials(a_vec, b_vec),
            "torch.dot": lambda: torch.dot(a_vec.view(-1), b_vec.view(-1))})
        hx = spmv.block_ell_spmv(pattern.nb, svals, x)
        case("cg_residual", tag, f"n={n}",
             lambda: cg_step.cg_residual(bhat, hx),
             lambda: cg_step.cg_residual_plain(bhat, hx),
             nbytes=4 * s * n, flops=5 * n, post=sums(2, 3))
        r0, p0, part_rr, part_bb = cg_step.cg_residual(bhat, hx)
        scal_k, scal_p = cg_step.new_scalars(r0), cg_step.new_scalars(r0)

        def run_start(fn, scal, part_rz=part_rr, tol=0.15):
            fn(scal, part_rz, part_rr, part_bb, tol, True)
            return (scal,)

        case("cg_start", tag, f"{part_rr.numel()} partials",
             lambda: run_start(cg_step.cg_start, scal_k),
             lambda: run_start(cg_step.cg_start_plain, scal_p),
             nbytes=s * (3 * part_rr.numel() + cg_step.N_SCALARS),
             flops=3 * part_rr.numel(), post=sums(scal=True))
        check_flags("cg_start", scal_k, scal_p, PD=1.0, CONT=1.0,
                    PD_NEXT=1.0, ALPHA=0.0, BETA=0.0)
        # r2 = b2 <= thresh = 4 b2: the solve must not start
        stop_k, stop_p = cg_step.new_scalars(r0), cg_step.new_scalars(r0)
        case("cg_start", tag, "r2 <= thresh",
             lambda: run_start(cg_step.cg_start, stop_k, part_bb, 2.0),
             lambda: run_start(cg_step.cg_start_plain, stop_p, part_bb, 2.0),
             0, 0, post=sums(scal=True), label="cg_start@stop", timed=False)
        check_flags("cg_start, r2 <= thresh", stop_k, stop_p, PD=1.0,
                    CONT=0.0)
        hp0, part_pap = cg_step.spmv_dot(pattern.nb, svals, p0)

        def cg_state():
            """Two equal copies of a CG state after cg_start, for the
            kernel and the plain version to step in place."""
            return {route: dict(x=x.clone(), r=r0.clone(), p=p0.clone(),
                                scal=scal_k.clone()) for route in ("k", "p")}

        def run_xr(fn, st, part=part_pap):
            out = fn(st["scal"], part, st["x"], st["r"], st["p"], hp0)
            return st["x"], st["r"], out, st["scal"]

        z0 = r0.clone()
        part_rz = cg_step.dot_partials(z0, z0)

        def run_p(fn, st):
            fn(st["scal"], part_rz, part_rz, z0, st["p"], True)
            return st["p"], st["scal"]

        state = cg_state()
        case("cg_update_xr", tag, f"n={n}",
             lambda: run_xr(cg_step.cg_update_xr, state["k"]),
             lambda: run_xr(cg_step.cg_update_xr_plain, state["p"]),
             nbytes=6 * s * n, flops=6 * n, post=sums(2, scal=True))
        check_flags("cg_update_xr", state["k"]["scal"], state["p"]["scal"],
                    PD=1.0, PD_NEXT=1.0)
        for st in state.values():             # the timing runs moved r
            st["r"].copy_(r0)
        beta_t = state["k"]["scal"][cg_step.BETA].clone()
        case("cg_update_p", tag, f"n={n}",
             lambda: run_p(cg_step.cg_update_p, state["k"]),
             lambda: run_p(cg_step.cg_update_p_plain, state["p"]),
             nbytes=3 * s * n, flops=2 * n, post=sums(scal=True),
             library=lambda: torch.addcmul(z0, state["k"]["p"], beta_t),
             library_what="p = z + beta p only")
        device_rows("cg_update_p", tag, {
            "kernel": lambda: run_p(cg_step.cg_update_p, state["k"]),
            "torch.addcmul (p = z + beta p only)":
                lambda: torch.addcmul(z0, state["k"]["p"], beta_t)})
        check_flags("cg_update_p", state["k"]["scal"], state["p"]["scal"],
                    PD=1.0, PD_NEXT=1.0, CONT=1.0)
        # a direction of negative curvature (p . hp < 0) and one with a
        # NaN: pd goes off and stays off, alpha is 0, x and r stay, and
        # the next cg_update_p clears the continue flag
        nan_pap = part_pap.clone()
        nan_pap[0] = float("nan")
        for what, part in (("p.Hp < 0", -part_pap), ("p.Hp NaN", nan_pap)):
            state = cg_state()
            case("cg_update_xr", tag, f"n={n}, {what}",
                 lambda: run_xr(cg_step.cg_update_xr, state["k"], part),
                 lambda: run_xr(cg_step.cg_update_xr_plain, state["p"],
                                part),
                 0, 0, post=sums(2, scal=True),
                 label=f"cg_update_xr@{what}", timed=False)
            check_flags(f"cg_update_xr, {what}", state["k"]["scal"],
                        state["p"]["scal"], PD=1.0, PD_NEXT=0.0, ALPHA=0.0)
            for st in state.values():
                if not (torch.equal(st["x"], x) and torch.equal(st["r"], r0)):
                    raise AssertionError(f"cg_update_xr, {what}: alpha 0 "
                                         "moved x or r")
            case("cg_update_p", tag, f"n={n}, after {what}",
                 lambda: run_p(cg_step.cg_update_p, state["k"]),
                 lambda: run_p(cg_step.cg_update_p_plain, state["p"]),
                 0, 0, post=sums(scal=True),
                 label=f"cg_update_p@{what}", timed=False)
            check_flags(f"cg_update_p after {what}", state["k"]["scal"],
                        state["p"]["scal"], PD=0.0, PD_NEXT=0.0, CONT=0.0)
            # once off, pd stays off whatever the next curvature is
            for fn, st in ((cg_step.cg_update_xr, state["k"]),
                           (cg_step.cg_update_xr_plain, state["p"])):
                run_xr(fn, st)
            check_flags(f"cg_update_xr, sticky pd after {what}",
                        state["k"]["scal"], state["p"]["scal"], PD=0.0,
                        PD_NEXT=0.0, ALPHA=0.0)
        # converged (r2 <= thresh) with pd on: the continue flag goes off
        state = cg_state()
        for st in state.values():
            st["scal"][cg_step.THRESH] = 1e30
        case("cg_update_p", tag, f"n={n}, r2 <= thresh",
             lambda: run_p(cg_step.cg_update_p, state["k"]),
             lambda: run_p(cg_step.cg_update_p_plain, state["p"]),
             0, 0, post=sums(scal=True), label="cg_update_p@stop",
             timed=False)
        check_flags("cg_update_p, r2 <= thresh", state["k"]["scal"],
                    state["p"]["scal"], PD=1.0, CONT=0.0)
        two_launch_rows(pattern, svals, p0, r0, scal_k, hp0, part_pap, x,
                        tag, s, "", spmv_bytes, 18 * K * N)
        for bad in (False, True):
            xs = {r_: x.clone() for r_ in ("k", "p")}
            if bad:
                for v in xs.values():
                    v[1, 5] = float("nan")
            if bool(cg_step.cg_finish(scal_k, [xs["k"].clone()])) == bad:
                raise AssertionError("cg_finish: wrong ok flag")
            case("cg_finish", tag, f"n={n}" + (", one NaN in x" if bad
                                               else ""),
                 lambda: (cg_step.cg_finish(scal_k, [xs["k"]]), xs["k"]),
                 lambda: (cg_step.cg_finish_plain(scal_k, [xs["p"]]),
                          xs["p"]),
                 nbytes=s * n, flops=n, same_nan=bad,
                 label="cg_finish@nan" if bad else None, timed=not bad)

        # K8
        case("gershgorin_bound", tag, f"N={N} K={K}",
             lambda: chebyshev.gershgorin_bound(svals),
             lambda: chebyshev.gershgorin_bound_plain(svals),
             nbytes=9 * s * K * N, flops=18 * K * N)
        hi = chebyshev.gershgorin_bound(svals)
        lo = hi * 0.02
        case("chebyshev_coeffs", tag, "degree 4",
             lambda: chebyshev.chebyshev_coeffs(lo, hi, 4),
             lambda: chebyshev.chebyshev_coeffs_plain(lo, hi, 4),
             nbytes=9 * s, flops=30)
        coef = chebyshev.chebyshev_coeffs(lo, hi, 4)
        case("chebyshev_init", tag, f"n={n}",
             lambda: chebyshev.chebyshev_init(coef, r0),
             lambda: chebyshev.chebyshev_init_plain(coef, r0),
             nbytes=3 * s * n, flops=n)
        d0, zc0 = chebyshev.chebyshev_init(coef, r0)
        sz = spmv.block_ell_spmv(pattern.nb, svals, zc0)
        dz = {r_: (d0.clone(), zc0.clone()) for r_ in ("k", "p")}

        def run_cu(fn, pair):
            fn(coef, 1, r0, sz, *pair)
            return pair

        case("chebyshev_update", tag, f"n={n}",
             lambda: run_cu(chebyshev.chebyshev_update, dz["k"]),
             lambda: run_cu(chebyshev.chebyshev_update_plain, dz["p"]),
             nbytes=6 * s * n, flops=5 * n)

        # the lane gather at the probe's shape
        gx = torch.as_tensor(r.normal(size=(8, 3500)), dtype=dt, device=dev)
        gidx = torch.as_tensor(
            r.integers(0, 3500, (8, 35000)).astype(np.int32), device=dev)
        gidx_long = gidx.long()
        case("lane_gather", tag, "R=8 N=3500 M=35000",
             lambda: gather.lane_gather(gx, gidx),
             lambda: gather.lane_gather_plain(gx, gidx),
             nbytes=s * 8 * (3500 + 35000) + 4 * 8 * 35000, flops=0,
             library=lambda: torch.gather(gx, 1, gidx_long))
        device_rows("lane_gather", tag, {
            "kernel": lambda: gather.lane_gather(gx, gidx),
            "torch.gather (int64 indices made beforehand)":
                lambda: torch.gather(gx, 1, gidx_long)})

        # K7 on the same graph: a step of the size LM takes here, the
        # gradient b, lambda0
        dxT = 0.01 * randn(3, N)
        groups7 = [(ea.indices[0], ea.indices[1], ea.measurement,
                    ea.information, ea.delta, 0)]
        k7 = (prob.params["se2"], dxT, free, b, lam, groups7)
        case("retract_chi2", tag, f"N={N} E={E}",
             lambda: retract_chi2.retract_chi2(*k7),
             lambda: retract_chi2.retract_chi2_plain(*k7),
             nbytes=s * (13 * N + 13 * E) + 8 * E, flops=12 * N + 120 * E,
             post=sums(1, 2))
        first = retract_chi2.retract_chi2(*k7)
        if not all(torch.equal(a_, b_) for a_, b_ in
                   zip(first, retract_chi2.retract_chi2(*k7))):
            raise AssertionError("retract_chi2 does not repeat its bits")
        _, part_dot, part_chi = first
        on = torch.tensor(True, device=dev)
        two = torch.tensor(2.0, dtype=dt, device=dev)
        chi_cur = robust_chi2(prob)
        nan_dx = dxT.clone()
        nan_dx[2, 11] = float("nan")
        _, nan_dot, nan_chi = retract_chi2.retract_chi2(
            prob.params["se2"], nan_dx, free, b, lam, groups7)
        if bool(torch.isfinite(nan_chi.sum())):
            raise AssertionError("a NaN step gave a finite chi2")
        split = lambda out: tuple(o.to(dt) for o in out)
        outcome_cases = {
            None: (part_chi, part_dot, on, lam, two, chi_cur),
            "lm_outcome@ok_false": (part_chi, part_dot, ~on, lam, two,
                                    chi_cur),
            "lm_outcome@nan_dx": (nan_chi, nan_dot, on, lam, two, chi_cur),
            "lm_outcome@uphill": (part_chi, part_dot, on, lam, two,
                                  chi_cur * 0.5)}
        for label, oc in outcome_cases.items():
            case("lm_outcome", tag,
                 f"{part_chi.numel()}+{part_dot.numel()} partials"
                 + (f", {label.split('@')[1]}" if label else ""),
                 lambda: split(retract_chi2.lm_outcome(*oc)),
                 lambda: split(retract_chi2.lm_outcome_plain(*oc)),
                 nbytes=s * (part_chi.numel() + part_dot.numel() + 7) + 3,
                 flops=part_chi.numel() + part_dot.numel() + 20,
                 label=label, timed=label is None)
            got = retract_chi2.lm_outcome(*oc)
            want = retract_chi2.lm_outcome_plain(*oc)
            for i in (2, 5):                  # accept, retry: exactly
                if bool(got[i]) != bool(want[i]):
                    raise AssertionError(f"lm_outcome {label}: flag {i} "
                                         "differs from the plain version")
            if label in ("lm_outcome@ok_false", "lm_outcome@nan_dx"):
                if not (float(got[0]) == float("inf")
                        and float(got[1]) == -1.0 and not bool(got[2])
                        and bool(got[5])
                        and float(got[3]) == float(lam * two)
                        and float(got[4]) == 4.0):
                    raise AssertionError(
                        f"{label}: expected chi2 inf, rho -1, no accept, "
                        f"lambda * nu, retry; got {[float(g) for g in got]}")
        del values, svals, state, dz, linv, lchol
    # the SE3 kernels and the 6x6 instantiations on the sphere of phase 4e
    t_sphere = time.monotonic()
    sphere, _ = create_sphere(**SPHERE)
    t_sphere = time.monotonic() - t_sphere
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
        s = torch.empty((), dtype=dt).element_size()
        prob = sphere.compile(dtype=dt)
        if prob.device.type != "cuda":
            raise AssertionError("the default device is not the card")
        probs["se3_" + tag] = prob
        pattern = sparse.build_ell_pattern(prob)
        N, K, E = pattern.n, pattern.k, pattern.e_total
        if pattern.d != 6:
            raise AssertionError(f"the sphere's block width is {pattern.d}")
        ea = prob.edges["edge_se3"]
        x7, free = prob.params["se3"], prob.free["se3"]
        gen = torch.Generator(device=dev).manual_seed(1)
        randn = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                           dtype=dt)
        sum_at = lambda *which: (lambda out: tuple(
            o.sum() if i in which else o for i, o in enumerate(out)))

        # K16, for the plain (None) and one robust kernel (Huber)
        W = pattern.e_cols                   # as B and C above
        hk = torch.zeros((36, 4 * W), dtype=dt, device=dev)
        bk = torch.zeros((6, 2 * W), dtype=dt, device=dev)
        hp_, bp_ = torch.zeros_like(hk), torch.zeros_like(bk)
        for kid, klabel in ((1, "edge_se3_blocks@huber"), (0, None)):
            args = (x7, free, ea.indices[0], ea.indices[1], ea.measurement,
                    ea.information, ea.delta, kid)

            def run_16():
                edge_se3.edge_se3_blocks(*args, hk, bk, 0)
                return hk, bk

            def plain_16():
                edge_se3.edge_se3_blocks_plain(*args, hp_, bp_, 0)
                return hp_, bp_

            case("edge_se3_blocks", tag, f"E={E}", run_16, plain_16,
                 nbytes=s * (8 * N + 44 * E + 156 * E) + 8 * E,
                 flops=6000 * E, label=klabel, slow_plain=True)
            first = tuple(t_.clone() for t_ in run_16())
            if not all(torch.equal(a_, b_)
                       for a_, b_ in zip(first, run_16())):
                raise AssertionError(f"{klabel or 'edge_se3_blocks'} does "
                                     "not repeat its bits")
            del first
            device_rows(klabel or "edge_se3_blocks", tag, {"kernel": run_16})
            if kid == 1 and dt == torch.float32:
                # whose error the float32 Huber row shows: the kernel and the
                # float32 plain version, each against the plain version in
                # float64 on the same (float32) inputs
                args64 = tuple(a.double() if torch.is_tensor(a)
                               and a.is_floating_point() else a for a in args)
                h64, b64 = hk.double(), bk.double()
                edge_se3.edge_se3_blocks_plain(*args64, h64, b64, 0)
                _, rel_k64 = _errors(torch, run_16(), (h64, b64))
                _, rel_p64 = _errors(torch, plain_16(), (h64, b64))
                print(f"phase 3 kernel edge_se3_blocks@huber float32 "
                      f"against the float64 plain version: kernel "
                      f"max_rel_err {rel_k64:.3e}, float32 plain version "
                      f"{rel_p64:.3e}")
                del args64, h64, b64
        cargs = (hk, bk, pattern.hidx, pattern.bidx, K, N)
        hdest = torch.zeros(4 * W, dtype=torch.long, device=dev)
        bdest = torch.zeros(2 * W, dtype=torch.long, device=dev)
        for tbl, dest in ((pattern.hidx, hdest), (pattern.bidx, bdest)):
            cols = torch.arange(tbl.shape[1], device=dev).expand_as(tbl)
            dest[tbl[tbl >= 0].long()] = cols[tbl >= 0]
        lib_v = torch.zeros((36, K * N), dtype=dt, device=dev)
        lib_b = torch.zeros((6, N), dtype=dt, device=dev)

        def lib_c6():                        # accumulates; timed only
            lib_v.index_add_(1, hdest, hk)
            lib_b.index_add_(1, bdest, bk)

        case("assemble_gather", tag,
             f"D=6 N={N} K={K} mh={pattern.hidx.shape[0]}",
             lambda: assemble.assemble_gather(*cargs),
             lambda: assemble.assemble_gather_plain(*cargs),
             nbytes=s * (156 * E + 36 * K * N + 6 * N)
             + 4 * (pattern.hidx.numel() + pattern.bidx.numel()),
             flops=144 * E, library=lib_c6, label="assemble_gather@d6")
        device_rows("assemble_gather@d6", tag, {
            "kernel": lambda: assemble.assemble_gather(*cargs),
            "two index_add_": lib_c6})
        values, b = assemble.assemble_gather(*cargs)
        del hk, bk, hp_, bp_, lib_v, lib_b, hdest, bdest

        # A and spmv_dot at D = 6 (library: a BSR product, block size 6)
        x = randn(6, N)
        rows_ = torch.arange(N, device=dev).expand(K, N)
        real = (values != 0).any(dim=1)
        real[0] = True
        order = torch.argsort(rows_[real] * N + pattern.nb[real].long())
        bsr = torch.sparse_bsr_tensor(
            torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                       torch.cumsum(real.sum(dim=0), 0)]),
            pattern.nb[real].long()[order],
            values.permute(0, 2, 1)[real][order].reshape(-1, 6, 6),
            size=(6 * N, 6 * N))
        x_col = x.t().reshape(6 * N, 1).contiguous()
        _, lib_rel = _errors(torch, (bsr @ x_col).reshape(N, 6).t(),
                             spmv.block_ell_spmv_plain(pattern.nb, values, x))
        if lib_rel > TOL_DEFAULT[tag] * 10:
            raise AssertionError(f"the 6x6 BSR yardstick disagrees: {lib_rel}")
        spmv_bytes = s * (36 * K * N + 12 * N) + 4 * K * N
        case("block_ell_spmv", tag, f"D=6 N={N} K={K}",
             lambda: spmv.block_ell_spmv(pattern.nb, values, x),
             lambda: spmv.block_ell_spmv_plain(pattern.nb, values, x),
             nbytes=spmv_bytes, flops=72 * K * N,
             library=lambda: bsr @ x_col, label="block_ell_spmv@d6")
        del bsr

        # K3 and K4 at lambda0, and the non-SPD 6x6 block
        lam = _lambda_init_pcg(prob, pattern, prob.params,
                               torch.tensor(1e-5, dtype=dt, device=dev))
        eye6 = torch.eye(6, dtype=dt, device=dev)

        def lib_chol(ex=False):
            blocks = (values[0].view(6, 6, N).permute(2, 0, 1)
                      + (lam * free + (1 - free))[:, None, None] * eye6)
            L = (torch.linalg.cholesky_ex(blocks)[0] if ex
                 else torch.linalg.cholesky(blocks))
            return torch.linalg.solve_triangular(L, eye6.expand(N, 6, 6),
                                                 upper=False)

        case("damp_chol", tag, f"D=6 N={N}",
             lambda: damp_chol.damp_chol(values, free, b, lam),
             lambda: damp_chol.damp_chol_plain(values, free, b, lam),
             nbytes=s * (36 + 1 + 6 + 36 + 36 + 6 + 1) * N, flops=400 * N,
             library=lib_chol, label="damp_chol@d6", slow_plain=True)
        device_rows("damp_chol@d6", tag, {
            "kernel": lambda: damp_chol.damp_chol(values, free, b, lam),
            "torch.linalg.cholesky + solve_triangular": lib_chol,
            "the same with cholesky_ex (no error check, no host read)":
                lambda: lib_chol(ex=True)})
        bad_values = values.clone()
        bad_values[0, 14, 7] = -1.0e9         # entry (2, 2) of block 7
        case("damp_chol", tag, f"D=6 N={N}, block 7 not SPD",
             lambda: damp_chol.damp_chol(bad_values, free, b, lam),
             lambda: damp_chol.damp_chol_plain(bad_values, free, b, lam),
             0, 0, same_nan=True, label="damp_chol@d6 nan", timed=False)
        upper = [6 * a_ + c_ for a_ in range(6) for c_ in range(a_ + 1, 6)]
        for fn in (damp_chol.damp_chol, damp_chol.damp_chol_plain):
            f_inv, f_chol = fn(bad_values, free, b, lam)[:2]
            if not (torch.isnan(f_inv[:, 7]).any()
                    and torch.isnan(f_chol[:, 7]).any()):
                raise AssertionError("a non-SPD 6x6 block did not give NaN "
                                     "factors")
            if bool(torch.isnan(f_inv[:, :7]).any()) \
                    or bool(torch.isnan(f_inv[:, 8:]).any()):
                raise AssertionError("the NaN left its block")
            if (f_inv[upper] != 0).any() or (f_chol[upper] != 0).any():
                raise AssertionError("an upper entry of a 6x6 factor is not 0")
        del bad_values
        linv, lchol, bhat, extra = damp_chol.damp_chol(values, free, b, lam)
        case("jacobi_scale", tag, f"D=6 N={N} K={K}",
             lambda: jacobi_scale.jacobi_scale(pattern.nb, values, linv,
                                               extra),
             lambda: jacobi_scale.jacobi_scale_plain(pattern.nb, values,
                                                     linv, extra),
             nbytes=s * (72 * K * N + 37 * N) + 4 * K * N,
             flops=864 * K * N, label="jacobi_scale@d6", slow_plain=True)
        bad_linv = linv.clone()
        bad_linv[:, 0] = float("nan")
        pad = (values == 0).all(dim=1)
        pad[0] = False
        if int(pad.sum()) == 0:
            raise AssertionError("the 6x6 NaN case has no padding slot")
        case("jacobi_scale", tag,
             f"D=6 N={N} K={K}, NaN factor in row 0, {int(pad.sum())} "
             "padding slots",
             lambda: jacobi_scale.jacobi_scale(pattern.nb, values, bad_linv,
                                               extra),
             lambda: jacobi_scale.jacobi_scale_plain(pattern.nb, values,
                                                     bad_linv, extra),
             0, 0, same_nan=True, label="jacobi_scale@d6 nan", timed=False)
        scaled = jacobi_scale.jacobi_scale(pattern.nb, values, bad_linv, extra)
        if (scaled.permute(0, 2, 1)[pad] != 0).any() \
                or not torch.isnan(scaled[0, :, 0]).all():
            raise AssertionError("6x6 scaling: padding not exactly zero or "
                                 "row 0's NaN factor did not show")
        del bad_linv, scaled
        l_blocks = lchol.view(6, 6, N).permute(2, 0, 1).contiguous()
        m_blocks = linv.view(6, 6, N).permute(2, 0, 1).contiguous()
        x_rows = x.t().contiguous()[:, :, None]
        case("lane_block_mv", tag, f"D=6 N={N} (and its transpose)",
             lambda: (jacobi_scale.lane_block_mv(lchol, x, True),
                      jacobi_scale.lane_block_mv(linv, x, False)),
             lambda: (jacobi_scale.lane_block_mv_plain(lchol, x, True),
                      jacobi_scale.lane_block_mv_plain(linv, x, False)),
             nbytes=2 * s * 48 * N, flops=2 * 72 * N,
             library=lambda: (torch.bmm(l_blocks.transpose(1, 2), x_rows),
                              torch.bmm(m_blocks, x_rows)),
             label="lane_block_mv@d6")
        del l_blocks, m_blocks
        svals = jacobi_scale.jacobi_scale(pattern.nb, values, linv, extra)
        p = randn(6, N)
        case("spmv_dot", tag, f"D=6 N={N} K={K}",
             lambda: cg_step.spmv_dot(pattern.nb, svals, p),
             lambda: cg_step.spmv_dot_plain(pattern.nb, svals, p),
             nbytes=spmv_bytes, flops=72 * K * N + 12 * N, post=sum_at(1),
             label="spmv_dot@d6")
        # the two-launch CG step at D = 6, from a fresh solve's first
        # product
        r6, p6, rr6, bb6 = cg_step.cg_residual(bhat, torch.zeros_like(bhat))
        scal6 = cg_step.new_scalars(r6)
        cg_step.cg_start(scal6, rr6, rr6, bb6, 0.05, True)
        hp6, pap6 = cg_step.spmv_dot(pattern.nb, svals, p6)
        two_launch_rows(pattern, svals, p6, r6, scal6, hp6, pap6,
                        torch.zeros_like(bhat), tag, s, "@d6", spmv_bytes,
                        72 * K * N)
        del r6, p6, hp6
        case("gershgorin_bound", tag, f"D=6 N={N} K={K}",
             lambda: chebyshev.gershgorin_bound(svals),
             lambda: chebyshev.gershgorin_bound_plain(svals),
             nbytes=36 * s * K * N, flops=72 * K * N,
             label="gershgorin_bound@d6")

        # K7 for SE3: a step of the size LM takes, the gradient b, lambda0
        dxT = 0.01 * randn(6, N)
        r7 = (x7, dxT, free, b, lam)
        case("retract_se3", tag, f"N={N}",
             lambda: retract_chi2.retract_se3(*r7),
             lambda: retract_chi2.retract_se3_plain(*r7),
             nbytes=s * 27 * N, flops=150 * N, post=sum_at(1))
        cand, _ = retract_chi2.retract_se3(*r7)
        c7 = (cand, ea.indices[0], ea.indices[1], ea.measurement,
              ea.information, ea.delta, 0)
        case("se3_edge_chi2", tag, f"E={E}",
             lambda: (retract_chi2.se3_edge_chi2(*c7),),
             lambda: (retract_chi2.se3_edge_chi2_plain(*c7),),
             nbytes=s * (44 * E + 14 * E) + 8 * E, flops=400 * E,
             post=sum_at(0))
        if not all(torch.equal(a_, b_) for a_, b_ in
                   zip(retract_chi2.retract_se3(*r7),
                       retract_chi2.retract_se3(*r7))):
            raise AssertionError("retract_se3 does not repeat its bits")
        nan_dx = dxT.clone()
        nan_dx[4, 11] = float("nan")
        nan_cand, nan_dot = retract_chi2.retract_se3(x7, nan_dx, free, b, lam)
        nan_chi = retract_chi2.se3_edge_chi2(nan_cand, *c7[1:])
        got = retract_chi2.lm_outcome(
            nan_chi, nan_dot, torch.tensor(True, device=dev), lam,
            torch.tensor(2.0, dtype=dt, device=dev), robust_chi2(prob))
        if bool(torch.isfinite(nan_chi.sum())) or not (
                float(got[0]) == float("inf") and float(got[1]) == -1.0
                and not bool(got[2]) and bool(got[5])):
            raise AssertionError("a NaN SE3 step did not give chi2 inf, rho "
                                 "-1, no accept, retry")
        del values, svals, linv, lchol, cand, nan_cand
    del probs["se3_float64"]
    torch.cuda.empty_cache()

    # K15 on the landmark worlds of phases 4d and 4f
    def k15_row(label, tag, dargs, slow_plain=True):
        """K15 (dense_assemble(*dargs)) against its plain version, by
        device time beside its library yardstick, twice for the same bits.
        Bytes: H, b, raw_diag and fixed_t once, the groups' residuals,
        Jacobians, rho' and Omega, the tables; operations: the products.
        The yardstick: one index_put_(accumulate=True) per slot pair and
        mirror on the precomputed blocks (H only; the products are not
        timed)."""
        groups_, T_, _, pattern_, _ = dargs
        s_ = groups_[0].resid.element_size()
        lib_H = torch.zeros((T_, T_), dtype=groups_[0].resid.dtype,
                            device=dev)
        nbytes, flops = k15_bytes_flops(groups_, pattern_)
        nbytes += s_ * (T_ * T_ + 3 * T_)
        lib_ops = []
        for gblk in groups_:
            w_om = gblk.rho1[:, None, None] * gblk.info
            widths = [j.shape[2] for j in gblk.jacs]
            idx = [o.long()[:, None] + torch.arange(w_, device=dev)[None, :]
                   for o, w_ in zip(gblk.offsets, widths)]
            for s1 in range(len(widths)):
                jw = edge_se2.bmm_small(gblk.jacs[s1].transpose(1, 2), w_om)
                for t1 in range(s1, len(widths)):
                    blk = edge_se2.bmm_small(jw, gblk.jacs[t1])
                    lib_ops.append((idx[s1][:, :, None], idx[t1][:, None, :],
                                    blk))
                    if t1 != s1:
                        lib_ops.append((idx[t1][:, :, None],
                                        idx[s1][:, None, :],
                                        blk.transpose(1, 2).contiguous()))

        def lib_dense():                         # accumulates; timed only
            for rows_i, cols_i, blk in lib_ops:
                lib_H.index_put_((rows_i, cols_i), blk, accumulate=True)

        tables = [tb for tbs in pattern_.pairs for tb in tbs]
        run = lambda: dense_assemble.dense_assemble(*dargs)
        case("dense_assemble", tag,
             f"T={T_} E=" + "+".join(str(g_.resid.shape[0]) for g_ in groups_)
             + f", {len(tables)} slot pairs, "
             f"{sum(tb.n_dest for tb in tables)} destinations, "
             f"{sum(tb.edge.numel() for tb in tables)} contributions, "
             f"{sum(tb.n_chunks for tb in tables)} chunks "
             f"({nbytes / 1e6:.1f} MB)", run,
             lambda: dense_assemble.dense_assemble_plain(*dargs),
             nbytes=nbytes, flops=flops, library=lib_dense, label=label,
             slow_plain=slow_plain)
        device_rows(label, tag, {"kernel": run})
        once = run()
        if not all(torch.equal(a_, b_) for a_, b_ in zip(once, run())):
            raise AssertionError(f"{label} does not repeat its bits")
        if any(bool(tb.arrivals.any()) for tb in tables):
            raise AssertionError(f"{label} left an arrival counter set")
        del lib_H, lib_ops, once

    t_sim = time.monotonic()
    world, _ = Simulator2D(**DENSE_WORLD).simulate(n_poses=DENSE_POSES)
    t_sim = time.monotonic() - t_sim
    t_sim3 = time.monotonic()
    world3, _ = Simulator3D(**DENSE3_WORLD).simulate(n_poses=DENSE3_POSES)
    t_sim3 = time.monotonic() - t_sim3
    # dense_assemble.cu built a second time with its width-3 instantiation
    # switched off, for the comparison below
    wide_path = build.BUILD_DIR / "dense_assemble_wide_only.so"
    wide_build = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-DG2O_DENSE_NARROW_WIDTH=0",
         "-shared", str(build.CSRC / "dense_assemble.cu"), "-o",
         str(wide_path)], capture_output=True, text=True)
    if wide_build.returncode != 0:
        raise AssertionError("nvcc failed on the wide-only dense_assemble:\n"
                             + wide_build.stdout + wide_build.stderr)
    wide_only = ctypes.CDLL(str(wide_path))
    # (graph, label of the row, widest diagonal block)
    for world_g, k15_label, k15_width in ((world, None, 3),
                                          (world3, "dense_assemble@d6", 6)):
        for dt in (torch.float32, torch.float64):
            tag = str(dt).split(".")[-1]
            s = torch.empty((), dtype=dt).element_size()
            dprob = world_g.compile(dtype=dt)
            dargs = dense_world_dargs(dense_assemble, problem_mod, dprob)
            T = dargs[1]
            k15_row(k15_label or "dense_assemble", tag, dargs,
                    slow_plain=k15_label is not None)
            once = dense_assemble.dense_assemble(*dargs)
            if k15_width == 3:
                # what the width-3 instantiation saves the 2D types: the
                # same call with every pair launch on dense_pair<T, 6>
                saved = build.entry("g2o_dense_pair", dt)
                wide = getattr(wide_only, "g2o_dense_pair_"
                               + {"float32": "f32", "float64": "f64"}[tag])
                wide.argtypes, wide.restype = saved.argtypes, saved.restype
                build._entries[("g2o_dense_pair", dt)] = wide
                try:
                    once_wide = dense_assemble.dense_assemble(*dargs)
                    wide_ms = _median_ms(
                        torch, lambda: dense_assemble.dense_assemble(*dargs))
                finally:
                    build._entries[("g2o_dense_pair", dt)] = saved
                narrow_ms = _median_ms(
                    torch, lambda: dense_assemble.dense_assemble(*dargs))
                same = all(torch.equal(a_, b_)
                           for a_, b_ in zip(once, once_wide))
                print(f"phase 3 dense_assemble {tag} T={T} (2D types) with "
                      f"every pair launch forced to dense_pair<T, 6>: "
                      f"{wide_ms:.4f} ms per call against {narrow_ms:.4f} ms "
                      f"with dense_pair<T, 3>; same bits: {same} [{card}]")
                del once_wide
            # the mirrored writes make H symmetric to the bit outside the
            # diagonal blocks, which are at most k15_width wide
            skew = (once[0] - once[0].T).abs_()
            scale = float(once[0].abs().max())
            if float(skew.max()) > TOL_DEFAULT[tag] * scale \
                    or bool(skew.triu(k15_width).any()):
                raise AssertionError("dense_assemble: H is not symmetric")
            del skew
            del dargs, once, dprob

    # phase 4p's BAL camera scenes, written once as BAL text files (removed
    # when the script exits)
    bal_dir = tempfile.mkdtemp(prefix="chip_smoke_bal_")
    atexit.register(shutil.rmtree, bal_dir, True)
    bal_scenes = {}
    for key_b, (nc_b, np_b) in (("80k", BA_80K), ("400k", BA_400K),
                                ("dense", BAL_DENSE)):
        path_b = os.path.join(bal_dir, f"bal_{key_b}.txt")
        t_b = time.monotonic()
        bal_scenes[key_b] = dict(bal_camera_scene(path_b, nc_b, np_b),
                                 path=path_b, shape=(nc_b, np_b))
        print(f"phase 3 BAL scene {key_b}: bal_camera_scene({nc_b}, {np_b})"
              f" -> {bal_scenes[key_b]['n_obs']} observations in "
              f"{time.monotonic() - t_b:.2f} s on the host")
    bal80_path = bal_scenes["80k"]["path"]

    # K10-K13 on the BAL problems of phases 4g and 4h, on the landmark
    # worlds of 4i (the generic entry and the (3, 2) instantiations) and on
    # phase 4p's BAL camera scenes ((9, 3))
    def ba_rows(bprob, sfx, tag, s, with_schur):
        """Every Schur BA kernel against its plain version on one problem,
        in the order _build and _solve run them; rows labelled kernel +
        sfx. Library yardsticks: index_add_ for the owner sums,
        torch.linalg.inv for the block inverses, a CSR product for W v and
        W^T x, torch.matmul(B2, M2) of the JAX route for S."""
        dt = bprob.dtype
        bpat = ba_ell.build_ba_ell_pattern(bprob)
        E, L, C = bpat.n_obs, bpat.n_lm, bpat.n_cam
        K, dp, dl = bpat.lm_edge.shape[0], bpat.dp, bpat.dl
        Tp = C * dp
        fl, fc = bprob.free[bpat.lm_name], bprob.free[bpat.cam_name]
        streams = lambda: ba_edge.EdgeStreams.empty(E, dp, dl, dt, dev,
                                                    bpat.cam_pos)
        got, want = streams(), streams()
        rs = ba_edge.record_size(dp, dl)
        # values written per edge: the landmark half and W lane-major, the
        # padded record
        n_out = dl * dl + dl + dp * dl + rs
        edge_runs = []                         # (label, launch)
        for pg in bpat.proj:
            eg = next(e_ for e_ in bprob.static.egroups if e_.key == pg.egkey)
            ea = bprob.edges[pg.egkey]
            Eg = pg.count
            if pg.fused:
                # each point (3 values and its free mask) and each camera
                # (7 and its mask) is read once, however many edges see it
                n_points = int(torch.unique(ea.indices[pg.lm_slot]).numel())
                n_cams = int(torch.unique(ea.indices[pg.cam_slot]).numel())
                fargs = (bprob.params[bpat.lm_name],
                         bprob.params[bpat.cam_name], ea.indices[pg.lm_slot],
                         ea.indices[pg.cam_slot], ea.measurement,
                         ea.information, ea.delta, ea.pdata[0], fl, fc,
                         eg.kernel_id)
                case("ba_xyz2uv_blocks", tag, f"E={Eg} L={L} C={C}",
                     lambda a=fargs, o=pg.offset: (
                         ba_edge.ba_xyz2uv_blocks(*a, got, o),
                         got.tensors())[1],
                     lambda a=fargs, o=pg.offset: (
                         ba_edge.ba_xyz2uv_blocks_plain(*a, want, o),
                         want.tensors())[1],
                     nbytes=s * ((2 + 4 + 1 + 4 + n_out) * Eg
                                 + 4 * n_points + 8 * n_cams) + 12 * Eg,
                     flops=500 * Eg, label="ba_xyz2uv_blocks" + sfx,
                     slow_plain=True)
                edge_runs.append((
                    "ba_xyz2uv_blocks" + sfx,
                    lambda a=fargs, o=pg.offset: ba_edge.ba_xyz2uv_blocks(
                        *a, got, o)))
            else:
                resid, jacs, rho1 = problem_mod.linearize_group(bprob, eg)
                gargs = (resid.contiguous(), jacs[pg.lm_slot].contiguous(),
                         jacs[pg.cam_slot].contiguous(), rho1.contiguous(),
                         ea.information)
                R = resid.shape[1]
                case("ba_edge_blocks", tag,
                     f"E={Eg} R={R} (Dp, dl)=({dp}, {dl})",
                     lambda a=gargs, o=pg.offset: (
                         ba_edge.ba_edge_blocks(*a, got, o),
                         got.tensors())[1],
                     lambda a=gargs, o=pg.offset: (
                         ba_edge.ba_edge_blocks_plain(*a, want, o),
                         want.tensors())[1],
                     nbytes=s * (R + R * (dl + dp) + 1 + R * R + n_out) * Eg
                     + 4 * Eg,
                     flops=2 * R * (dl + dp) * (R + dl + dp + 1) * Eg,
                     label="ba_edge_blocks" + sfx, slow_plain=True)
                if dp == 9:
                    first = [t_.clone() for t_ in got.tensors()]
                    ba_edge.ba_edge_blocks(*gargs, got, pg.offset)
                    if not all(torch.equal(a_, b_) for a_, b_ in
                               zip(first, got.tensors())):
                        raise AssertionError(f"ba_edge_blocks{sfx} does not "
                                             "repeat its bits")
                    del first
                device_rows("ba_edge_blocks" + sfx, tag, {
                    "kernel": lambda a=gargs, o=pg.offset:
                        ba_edge.ba_edge_blocks(*a, got, o)})
                edge_runs.append((
                    "ba_edge_blocks" + sfx,
                    lambda a=gargs, o=pg.offset: ba_edge.ba_edge_blocks(
                        *a, got, o)))
        # the owner of every observation, for the index_add_ yardsticks
        owner_l = torch.empty(E, dtype=torch.long, device=dev)
        owner_l[bpat.cam_edge.long()] = bpat.cam_lm.long()
        counts_c = (bpat.cam_ptr[1:] - bpat.cam_ptr[:-1]).long()
        owner_pos = torch.repeat_interleave(torch.arange(C, device=dev),
                                            counts_c)   # of each record
        owner_c = torch.empty(E, dtype=torch.long, device=dev)
        owner_c[bpat.cam_edge.long()] = owner_pos
        lm_stack = torch.cat([got.hll, got.bl])
        nb_ = dp * dp + dp                     # the values summed per camera
        rows_c = bpat.cam_rows
        case("ba_lm_sums", tag, f"L={L} K={K}",
             lambda: ba_edge.ba_lm_sums(got, bpat.lm_edge),
             lambda: ba_edge.ba_lm_sums_plain(got, bpat.lm_edge),
             nbytes=s * ((dl * dl + dl + dp * dl) * E + (dl * dl + dl) * L
                         + dp * dl * K * L) + 4 * K * L,
             flops=(dl * dl + dl) * E, label="ba_lm_sums" + sfx,
             library=lambda: torch.zeros(
                 (dl * dl + dl, L), dtype=dt, device=dev).index_add_(
                 1, owner_l, lm_stack), slow_plain=True)
        case("ba_cam_sums", tag, f"C={C} E={E} chunks={rows_c.n_chunks}, "
             f"records of {rs} values",
             lambda: ba_edge.ba_cam_sums(got, rows_c),
             lambda: ba_edge.ba_cam_sums_plain(got, rows_c),
             nbytes=s * (rs * E + nb_ * C + dp * dl * E)
             + 4 * (2 * rows_c.n_chunks + C + 2),
             flops=nb_ * E, label="ba_cam_sums" + sfx,
             library=lambda: torch.zeros(
                 (C, nb_), dtype=dt, device=dev).index_add_(
                 0, owner_pos, got.rec[:, :nb_]),
             slow_plain=True, library_what="Hcc and b_p only")
        again = ba_edge.ba_cam_sums(got, rows_c)
        Hll, b_l, W_lm = ba_edge.ba_lm_sums(got, bpat.lm_edge)
        Hcc, b_p, W_cam = ba_edge.ba_cam_sums(got, rows_c)
        if not all(torch.equal(a_, b_) for a_, b_ in zip(again,
                                                         (Hcc, b_p, W_cam))):
            raise AssertionError("ba_cam_sums does not repeat its bits")
        if not all(torch.equal(a_, b_) for a_, b_ in zip(
                ba_edge.ba_lm_sums(got, bpat.lm_edge), (Hll, b_l, W_lm))):
            raise AssertionError("ba_lm_sums does not repeat its bits")
        if bool(rows_c.arrivals.any()):
            raise AssertionError("ba_cam_sums left an arrival counter set")
        # the same function by PyTorch calls: on the records, index_add_
        # for Hcc and b_p and W_cam as a transposed copy; and, from the
        # per-observation streams in observation order (the layout before
        # the records), index_add_ and index_select of W in CSR order
        lanes = [t.contiguous() for t in got.lane_major()]
        cam_stack = torch.cat([lanes[3], lanes[4]])
        cam_edge_l = bpat.cam_edge.long()

        def cam_same_function():
            sums_ = torch.zeros((C, nb_), dtype=dt, device=dev).index_add_(
                0, owner_pos, got.rec[:, :nb_])
            return sums_, got.rec[:, nb_:nb_ + dp * dl].T.contiguous()

        def cam_same_function_lanes():
            sums_ = torch.zeros((nb_, C), dtype=dt, device=dev).index_add_(
                1, owner_c, cam_stack)
            return sums_, torch.index_select(lanes[2], 1, cam_edge_l)

        for what, fn, sums_of in (
                ("records", cam_same_function, lambda t: t.T),
                ("observation order", cam_same_function_lanes, lambda t: t)):
            sums_, w_ = fn()
            sums_ = sums_of(sums_)
            if not torch.equal(w_, W_cam) or _errors(
                    torch, (sums_[:dp * dp], sums_[dp * dp:]),
                    (Hcc, b_p))[1] > TOL_DEFAULT[tag]:
                raise AssertionError(f"the ba_cam_sums yardstick ({what}) "
                                     "computes another function")
        del sums_, w_
        device_rows("ba_cam_sums" + sfx, tag, {
            "kernel": lambda: ba_edge.ba_cam_sums(got, rows_c),
            "index_add_ on the records (Hcc, b_p only)": lambda: torch.zeros(
                (C, nb_), dtype=dt, device=dev).index_add_(
                0, owner_pos, got.rec[:, :nb_]),
            "index_add_ + W's transposed copy (the same function)":
                cam_same_function,
            "index_add_ + index_select from observation order":
                cam_same_function_lanes})
        del lanes, cam_stack
        for label_, run_ in edge_runs:
            if label_ in ("ba_xyz2uv_blocks", "ba_xyz2uv_blocks@400k"):
                device_rows(label_, tag, {"kernel": run_})
        # the yardstick that computes the same function: Hll and b_l by
        # index_add_, W_lm by a masked gather of the lane-major W
        valid_l = bpat.lm_edge >= 0
        idx_l = bpat.lm_edge.clamp_min(0).long()
        zero = torch.zeros((), dtype=dt, device=dev)

        def lm_same_function():
            new_ = lambda r: torch.zeros((r, L), dtype=dt, device=dev)
            return (new_(dl * dl).index_add_(1, owner_l, got.hll),
                    new_(dl).index_add_(1, owner_l, got.bl),
                    torch.where(valid_l, got.w[:, idx_l], zero))

        same = lm_same_function()
        if not torch.equal(same[2], W_lm) or _errors(
                torch, same[:2], (Hll, b_l))[1] > TOL_DEFAULT[tag]:
            raise AssertionError("the ba_lm_sums yardstick computes another "
                                 "function")
        del same
        device_rows("ba_lm_sums" + sfx, tag, {
            "kernel": lambda: ba_edge.ba_lm_sums(got, bpat.lm_edge),
            "index_add_ (Hll, b_l only)": lambda: torch.zeros(
                (dl * dl + dl, L), dtype=dt, device=dev).index_add_(
                1, owner_l, lm_stack),
            "index_add_ + masked W gather (the same function)":
                lm_same_function})
        lam = 1e-4 * Hll[0].abs().max()
        iargs = (Hll, ba_inv.LANDMARK, fl, lam, b_l)
        eye_l = torch.eye(dl, dtype=dt, device=dev)
        Hll_d = (Hll.view(dl, dl, L).permute(2, 0, 1)
                 + eye_l * (lam * fl + (1.0 - fl))[:, None, None])
        cond = float(torch.linalg.cond(Hll_d.double()).max())
        case("ba_block_inv", tag, f"D={dl} N={L}, landmark damping and "
             f"Hinv b_l, condition number up to {cond:.2e}",
             lambda: ba_inv.ba_block_inv(*iargs)[1:],
             lambda: ba_inv.ba_block_inv_plain(*iargs)[1:],
             nbytes=s * (2 * dl * dl + 1 + 2 * dl) * L,
             flops=(60 if dl == 3 else 12) * L, label="ba_block_inv" + sfx,
             library=lambda: torch.linalg.inv(Hll_d), slow_plain=True,
             tol=block_inv_tol(tag, cond))
        device_rows("ba_block_inv" + sfx, tag, {
            "kernel": lambda: ba_inv.ba_block_inv(*iargs),
            "torch.linalg.inv (the inverse alone)":
                lambda: torch.linalg.inv(Hll_d),
            "torch.linalg.inv_ex (no error check, no host read)":
                lambda: torch.linalg.inv_ex(Hll_d)[0]})
        _, Hinv, hib = ba_inv.ba_block_inv(*iargs)
        Hcc_d = ba_inv.ba_block_inv(Hcc, ba_inv.CAMERA, fc, lam,
                                    want_inv=False)[0]
        gen = torch.Generator(device=dev).manual_seed(7)
        x = torch.randn((dp, C), generator=gen, dtype=dt, device=dev)
        # W as a sparse [Tp, dl L] matrix: the yardstick of W v and W^T x
        obs = torch.arange(E, device=dev)
        rows_w = ((owner_c[:, None, None] * dp
                   + torch.arange(dp, device=dev)[None, :, None])
                  .expand(E, dp, dl))
        cols_w = ((torch.arange(dl, device=dev)[None, None, :] * L
                   + owner_l[:, None, None]).expand(E, dp, dl))
        w_obs = torch.empty((dp * dl, E), dtype=dt, device=dev)
        w_obs[:, bpat.cam_edge.long()] = W_cam
        vals_w = w_obs.T.reshape(E, dp, dl)
        coo = torch.sparse_coo_tensor(
            torch.stack([rows_w.reshape(-1), cols_w.reshape(-1)]),
            vals_w.reshape(-1), (Tp, dl * L)).coalesce()
        W_csr = coo.to_sparse_csr()
        WT_csr = coo.t().coalesce().to_sparse_csr()
        del obs, rows_w, cols_w, vals_w, coo
        x_col = x.T.reshape(-1, 1).contiguous()
        case("ba_wtx", tag, f"L={L} K={K} C={C}, Hinv applied",
             lambda: ba_coupling.ba_wtx(W_lm, bpat.lm_cam, x, hinv=Hinv),
             lambda: ba_coupling.ba_wtx_plain(W_lm, bpat.lm_cam, x,
                                              hinv=Hinv),
             nbytes=s * (dp * dl * K * L + dp * C + dl * dl * L + dl * L)
             + 4 * K * L, flops=2 * dp * dl * E + 2 * dl * dl * L,
             label="ba_wtx" + sfx, library=lambda: WT_csr @ x_col,
             slow_plain=True)
        v = ba_coupling.ba_wtx(W_lm, bpat.lm_cam, x, hinv=Hinv)
        if not torch.equal(v, ba_coupling.ba_wtx(W_lm, bpat.lm_cam, x,
                                                 hinv=Hinv)):
            raise AssertionError(f"ba_wtx{sfx} does not repeat its bits")
        if sfx in ("", "@400k", "@bal", "@bal400k"):
            device_rows("ba_wtx" + sfx, tag, {
                "kernel": lambda: ba_coupling.ba_wtx(W_lm, bpat.lm_cam, x,
                                                     hinv=Hinv),
                "CSR product W^T x (W^T alone)": lambda: WT_csr @ x_col})
        v_col = v.reshape(-1, 1).contiguous()
        rows_c = bpat.cam_rows
        case("ba_wv", tag, f"C={C} E={E} chunks={rows_c.n_chunks}, S x with "
             "the dot (error per element over the sum of its terms' "
             "magnitudes)",
             lambda: ba_coupling.ba_wv(W_cam, rows_c, v, hcc_d=Hcc_d, x=x,
                                       want_dot=True),
             lambda: ba_coupling.ba_wv_plain(W_cam, rows_c, v, hcc_d=Hcc_d,
                                             x=x, want_dot=True),
             nbytes=s * (dp * dl * E + dl * L + dp * dp * C + 2 * dp * C + C)
             + 4 * (E + rows_c.n_chunks + C + 2),
             flops=2 * dp * dl * E + 2 * dp * dp * C,
             label="ba_wv" + sfx, library=lambda: W_csr @ v_col,
             post=lambda out: (out[0], out[1].sum()), slow_plain=True,
             scale=lambda: wv_error_scale(ba_coupling, W_cam, rows_c, v, x,
                                          hcc_d=Hcc_d),
             library_what="W·v only")
        wv_call = lambda: ba_coupling.ba_wv(W_cam, rows_c, v, hcc_d=Hcc_d,
                                            x=x, want_dot=True)
        wv1, wv2 = wv_call(), wv_call()
        if not all(torch.equal(a_, b_) for a_, b_ in zip(wv1, wv2)):
            raise AssertionError("ba_wv does not repeat its bits")
        del wv1, wv2
        device_rows("ba_wv" + sfx, tag, {
            "kernel": wv_call,
            "CSR product, W·v only": lambda: W_csr @ v_col})
        # the preconditioner blocks, their 9-wide inverse and K4: not on the
        # BAL camera's dense-Schur route, which forms none (phase 3 holds
        # them at 400k, where the implicit route runs them)
        if not (dp == 9 and with_schur):
            case("ba_sandwich", tag, f"C={C} E={E} chunks={rows_c.n_chunks}",
                 lambda: ba_coupling.ba_sandwich(W_cam, rows_c, Hinv, Hcc_d),
                 lambda: ba_coupling.ba_sandwich_plain(W_cam, rows_c, Hinv,
                                                       Hcc_d),
                 nbytes=s * (dp * dl * E + dl * dl * L + 2 * dp * dp * C)
                 + 4 * (E + rows_c.n_chunks + C + 1),
                 flops=2 * (dp * dl * dl + dp * dp * dl) * E,
                 label="ba_sandwich" + sfx, slow_plain=True)
            sand_call = lambda: ba_coupling.ba_sandwich(W_cam, rows_c, Hinv,
                                                        Hcc_d)
            if not torch.equal(sand_call(), sand_call()):
                raise AssertionError(f"ba_sandwich{sfx} does not repeat its "
                                     "bits")
            device_rows("ba_sandwich" + sfx, tag, {"kernel": sand_call})
            s_blocks = ba_coupling.ba_sandwich(W_cam, rows_c, Hinv, Hcc_d)
            cond = float(torch.linalg.cond(
                s_blocks.view(dp, dp, C).permute(2, 0, 1).double()).max())
            case("ba_block_inv", tag, f"D={dp} N={C}, the preconditioner "
                 f"blocks, condition number up to {cond:.2e}",
                 lambda: ba_inv.ba_block_inv(s_blocks)[1],
                 lambda: ba_inv.ba_block_inv_plain(s_blocks)[1],
                 nbytes=s * 2 * dp * dp * C,
                 flops={3: 60, 6: 500, 9: 1500}[dp] * C,
                 label="ba_block_inv@cam" + sfx,
                 library=lambda: torch.linalg.inv(
                     s_blocks.view(dp, dp, C).permute(2, 0, 1)),
                 slow_plain=True, tol=block_inv_tol(tag, cond))
            if dp == 6 and sfx == "@400k":
                precond_rows("lane_block_mv_dot", tag,
                             ba_inv.ba_block_inv(s_blocks)[1], x,
                             "the ba_400k cameras' preconditioner (4h)")
            if dp == 9:
                # K11 and K4 at D = 9: the implicit route's preconditioner
                # on the BAL camera, beside torch.linalg.inv_ex and
                # torch.bmm
                batch = lambda t: t.view(dp, dp, C).permute(2, 0, 1) \
                    .contiguous()
                s_batch = batch(s_blocks)
                device_rows("ba_block_inv@cam" + sfx, tag, {
                    "kernel": lambda: ba_inv.ba_block_inv(s_blocks),
                    "torch.linalg.inv_ex on [N, 9, 9]":
                        lambda: torch.linalg.inv_ex(s_batch)[0]})
                s_binv = ba_inv.ba_block_inv(s_blocks)[1]
                if not torch.equal(s_binv, ba_inv.ba_block_inv(s_blocks)[1]):
                    raise AssertionError(f"ba_block_inv@cam{sfx} does not "
                                         "repeat its bits")
                precond_rows("lane_block_mv_dot@d9", tag, s_binv, x,
                             "the BAL cameras' preconditioner (4p @400k)")
                del s_batch, s_binv
        if with_schur:
            # the JAX route's operands: B2 [Tp, dl L], M2 = [HB2^T | hib]
            B2 = W_csr.to_dense()
            HB2 = torch.einsum("utl,ctl->cul", Hinv.view(dl, dl, L),
                               B2.view(Tp, dl, L)).reshape(Tp, dl * L)
            M2 = torch.cat([HB2.T, hib.reshape(-1, 1)], dim=1).contiguous()
            del HB2
            # K12's own operands, as kernel_times.py makes them
            pairs, w_k, hinv_k, hcc_k = k12_operands(ba_ell, ba_inv, bprob)
            M = pairs.n_contrib
            # W's records, made once per linearization on this route
            w_flat = w_k.view(dp * dl, -1)
            rec_w = ba_schur.record_width(dp * dl, dt)
            case("ba_schur_records", tag,
                 f"W [{dp * dl}, {K * L}] -> [{K * L}, {rec_w}]",
                 lambda: ba_schur.ba_schur_records(w_flat),
                 lambda: ba_schur.ba_schur_records_plain(w_flat),
                 nbytes=s * (dp * dl + rec_w) * K * L, flops=0,
                 label="ba_schur_records" + sfx,
                 library=lambda: torch.nn.functional.pad(
                     w_flat.T, (0, rec_w - dp * dl)),
                 tol={"float32": 0.0, "float64": 0.0}[tag])
            device_rows("ba_schur_records" + sfx, tag, {
                "kernel": lambda: ba_schur.ba_schur_records(w_flat),
                "torch.nn.functional.pad of the transpose":
                    lambda: torch.nn.functional.pad(
                        w_flat.T, (0, rec_w - dp * dl))})
            W_rec = ba_schur.ba_schur_records(w_flat)
            schur_call = lambda: ba_schur.ba_schur_dense(
                pairs, w_k, hinv_k, hcc_k, w_rec=W_rec)
            both_copies = lambda: ba_schur.ba_schur_dense(
                pairs, w_k, hinv_k, hcc_k,
                w_rec=ba_schur.ba_schur_records(w_flat))
            case("ba_schur_dense", tag,
                 f"Tp={Tp} {pairs.n_dest} destinations {M} contributions, "
                 "both record copies in each call",
                 both_copies,
                 lambda: ba_schur.ba_schur_dense_plain(pairs, w_k, hinv_k,
                                                       hcc_k),
                 nbytes=s * (dp * dl * K * L + dl * dl * L + dp * dp * C
                             + Tp * Tp) + 4 * (3 * M + 3 * pairs.n_dest),
                 flops=2 * (dp * dl * dl + dp * dp * dl) * M,
                 label="ba_schur_dense" + sfx, library=lambda: B2 @ M2,
                 slow_plain=True)
            device_rows("ba_schur_dense" + sfx, tag, {
                "kernel, both record copies": both_copies,
                "kernel, W's records made once per linearization (as "
                "_solve calls it)": schur_call,
                **({} if sfx not in ("", "@bal") else {
                    "torch.matmul(B2, M2) of the JAX route":
                        lambda: B2 @ M2})})
            if not torch.equal(schur_call(), schur_call()):
                raise AssertionError("ba_schur_dense does not repeat its "
                                     "bits")
            del B2, M2, W_rec, w_k, hinv_k, hcc_k
        del got, want, W_csr, WT_csr

    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
        s = torch.empty((), dtype=dt).element_size()
        for (nc, npts), sfx, with_schur in ((BA_80K, "", True),
                                            (BA_400K, "@400k", False)):
            ba_rows(synthetic_bal_problem(nc, npts, BA_OBS, dtype=dt)[0],
                    sfx, tag, s, with_schur)
        # (9, 3): the BAL camera scenes of phase 4p, the generic entry over
        # K17's linearization of EDGE_PROJECT_BAL
        for key_b, sfx, with_schur in (("80k", "@bal", True),
                                       ("400k", "@bal400k", False)):
            ba_rows(load_bal_problem(bal_scenes[key_b]["path"],
                                     dtype=dt)[0], sfx, tag, s, with_schur)
        # K12 at (3, 2) on the 2D world (4i's dense-Schur run)
        for world_g, sfx in ((world, "@2d"), (world3, "@3d")):
            ba_rows(world_g.compile(dtype=dt), sfx, tag, s, sfx == "@2d")
        # the generic entry's own row is its 3-wide (6, 3) instantiation on
        # the 3D world (the BAL problems run the fused entry only)
        results[("ba_edge_blocks", tag)] = results.pop(
            ("ba_edge_blocks@3d", tag))
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()

    # K14 and what the general Schur path runs of K10, K11, K13, K4 and K15,
    # on the anchored (k) and shared-intrinsics (l) scenes at ba_80k, in the
    # order schur_build and _solve run them. The K14 rows of (k) carry the
    # kernel's own name, every other row a suffix naming its scene. The
    # library yardsticks: index_add_ for the landmark sums, CSR products
    # for W^T x and W v (as in the K13 rows), torch.linalg.inv and
    # torch.einsum for the 4x4 blocks.
    geo80 = bal_geometry(*BA_80K)
    general_graphs = {"@psi2uv": psi2uv_graph(Graph, geo80),
                      "@intrinsics": p2mc_intrinsics_graph(Graph, geo80)}

    def general_rows(gprob, sfx, tag, s):
        dt = gprob.dtype
        pat = ba_general.build_schur_pattern(gprob)
        lin = problem_mod.linearize(gprob)
        dl, L, Tp = pat.dl, pat.n_lm, pat.pose_dim
        name = lambda k: k if (sfx == "@psi2uv" and k.startswith("schur_")) \
            else k + sfx
        new_w, edge_run, k14_bytes, k14_flops, k14_shape = k14_operands(
            torch, ba_edge, gprob, pat, lin)
        got_w, want_w = new_w(), new_w()
        E = pat.n_lm_edges
        case("schur_edge_blocks", tag, k14_shape,
             lambda: edge_run(schur_general.schur_edge_blocks, got_w),
             lambda: edge_run(schur_general.schur_edge_blocks_plain, want_w),
             nbytes=k14_bytes, flops=k14_flops,
             label=name("schur_edge_blocks"), slow_plain=True)
        st = got_w[0]
        K = pat.lm_edge.shape[0]
        owner_l = torch.full((E,), -1, dtype=torch.long, device=dev)
        valid = pat.lm_edge >= 0
        owner_l[pat.lm_edge[valid].long()] = torch.arange(
            L, device=dev)[None].expand(K, L)[valid]
        lm_stack = torch.cat([st.hll, st.bl])
        case("ba_lm_sums", tag, f"L={L} K={K} E={E}, without W",
             lambda: ba_edge.ba_lm_sums(st, pat.lm_edge, with_w=False)[:2],
             lambda: ba_edge.ba_lm_sums_plain(st, pat.lm_edge, False)[:2],
             nbytes=s * (dl * dl + dl) * (E + L) + 4 * K * L,
             flops=(dl * dl + dl) * E, label=name("ba_lm_sums"),
             library=lambda: torch.zeros(
                 (dl * dl + dl, L), dtype=dt, device=dev).index_add_(
                 1, owner_l, lm_stack), slow_plain=True)
        lm_call = lambda: ba_edge.ba_lm_sums(st, pat.lm_edge, with_w=False)
        if not all(torch.equal(a_, b_) for a_, b_ in
                   zip(lm_call()[:2], lm_call()[:2])):
            raise AssertionError("ba_lm_sums does not repeat its bits")
        # without W, one index_add_ computes the same function
        device_rows(name("ba_lm_sums"), tag, {
            "kernel": lm_call,
            "index_add_ (the same function)": lambda: torch.zeros(
                (dl * dl + dl, L), dtype=dt, device=dev).index_add_(
                1, owner_l, lm_stack)})
        sys_ = ba_general.schur_build(gprob, lin=lin, pattern=pat)
        fl = gprob.free[pat.lm_name]
        lam = 1e-4 * sys_["Hll"][0].abs().max()
        _, hinv, hib = ba_inv.ba_block_inv(sys_["Hll"], ba_inv.LANDMARK, fl,
                                           lam, b=sys_["b_l"])
        free_p = torch.cat([gprob.free[pg.name][None].expand(
            pg.dim, pg.count).reshape(-1) for pg in pat.pose_groups])
        hpp_d = sys_["Hpp"][pat.perm[:, None], pat.perm[None, :]]
        hpp_d.diagonal().add_(lam * free_p + (1.0 - free_p))
        gen = torch.Generator(device=dev).manual_seed(9)
        xs = {pg.name: torch.randn((pg.dim, pg.count), generator=gen,
                                   dtype=dt, device=dev)
              for pg in pat.pose_groups}
        # W as one sparse [Tp, dl L] matrix over every pose group, rows in
        # the lane order: the yardstick of W v and W^T x
        rows_l, cols_l, vals_l = [], [], []
        for pg in pat.pose_groups:
            M = pg.n_entries
            own = torch.repeat_interleave(
                torch.arange(pg.count, device=dev),
                (pg.rows.ptr[1:] - pg.rows.ptr[:-1]).long())
            r_ = (pg.offset + torch.arange(pg.dim, device=dev)[:, None, None]
                  * pg.count + own[None, None, :]).expand(pg.dim, dl, M)
            c_ = (torch.arange(dl, device=dev)[None, :, None] * L
                  + pg.rows.lm.long()[None, None, :]).expand(pg.dim, dl, M)
            rows_l.append(r_.reshape(-1))
            cols_l.append(c_.reshape(-1))
            vals_l.append(sys_["W_pose"][pg.name].reshape(-1))
        coo = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows_l), torch.cat(cols_l)]),
            torch.cat(vals_l), (Tp, dl * L)).coalesce()
        W_csr, WT_csr = coo.to_sparse_csr(), coo.t().coalesce().to_sparse_csr()
        del coo, rows_l, cols_l, vals_l
        x_col = torch.cat([xs[pg.name].reshape(-1)
                           for pg in pat.pose_groups])[:, None].contiguous()
        n_w = sum(pg.dim * dl * pg.n_entries for pg in pat.pose_groups)
        n_slots = sum(pg.lm_pose.numel() for pg in pat.pose_groups)

        def wtx(fn):
            """W^T x over the pose groups in one call, Hinv applied."""
            gs = pat.pose_groups
            return fn([sys_["W_lm"][pg.name] for pg in gs],
                      [pg.lm_pose for pg in gs], [xs[pg.name] for pg in gs],
                      hinv=hinv)

        def wtx_chained():
            """The form it replaces: one launch per pose group, each later
            group starting from the earlier groups' u."""
            u = None
            for i, pg in enumerate(pat.pose_groups):
                kw = (dict(hinv=hinv) if i == len(pat.pose_groups) - 1
                      else {})
                u = ba_coupling.ba_wtx(sys_["W_lm"][pg.name], pg.lm_pose,
                                       xs[pg.name], acc=u, **kw)
            return u

        before = ba_coupling.ba_wtx.launches
        v = wtx(ba_coupling.ba_wtx)
        if ba_coupling.ba_wtx.launches - before != 1:
            raise AssertionError(f"ba_wtx{sfx}: "
                                 f"{ba_coupling.ba_wtx.launches - before} "
                                 f"launches for {len(pat.pose_groups)} pose "
                                 "groups, not one")
        if not torch.equal(v, wtx(ba_coupling.ba_wtx)):
            raise AssertionError(f"ba_wtx{sfx} does not repeat its bits")
        case("ba_wtx", tag, f"L={L}, pose groups "
             f"{[(pg.dim, pg.lm_pose.shape[0]) for pg in pat.pose_groups]} "
             "(Dp, K), one launch, Hinv applied",
             lambda: wtx(ba_coupling.ba_wtx),
             lambda: wtx(ba_coupling.ba_wtx_plain),
             nbytes=s * (sum(pg.dim * dl * pg.lm_pose.numel()
                             for pg in pat.pose_groups) + Tp
                         + dl * dl * L + dl * L) + 4 * n_slots,
             flops=2 * n_w + 2 * dl * dl * L, label=name("ba_wtx"),
             library=lambda: WT_csr @ x_col, slow_plain=True)
        rows_wtx = {"kernel": lambda: wtx(ba_coupling.ba_wtx),
                    "CSR product W^T x (W^T alone)": lambda: WT_csr @ x_col}
        if len(pat.pose_groups) > 1:
            rows_wtx["chained, a launch per pose group"] = wtx_chained
        device_rows(name("ba_wtx"), tag, rows_wtx)
        v_col = v.reshape(-1, 1).contiguous()
        hx = hpp_d @ x_col[:, 0]

        extra = {pg.name: hx[pg.offset:pg.offset + pg.size].view(
            pg.dim, pg.count) for pg in pat.pose_groups}

        def wv(fn):
            return [fn(sys_["W_pose"][pg.name], pg.rows, v, x=xs[pg.name],
                        extra=extra[pg.name], want_dot=True)
                    for pg in pat.pose_groups]

        def y_and_dot(out):
            return tuple(o[0] for o in out) + (sum(o[1].sum() for o in out),)

        mags = [wv_error_scale(ba_coupling, sys_["W_pose"][pg.name], pg.rows,
                               v, xs[pg.name], extra=extra[pg.name])
                for pg in pat.pose_groups]
        n_chunks = sum(pg.rows.n_chunks for pg in pat.pose_groups)
        case("ba_wv", tag, f"pose groups "
             f"{[(pg.dim, pg.count, pg.n_entries, pg.rows.n_chunks) for pg in pat.pose_groups]}"
             " (Dp, N, entries, chunks), S x with the dot (error per "
             "element over the sum of its terms' magnitudes)",
             lambda: wv(ba_coupling.ba_wv),
             lambda: wv(ba_coupling.ba_wv_plain),
             nbytes=s * (n_w + dl * L + 3 * Tp
                         + sum(pg.count for pg in pat.pose_groups))
             + 4 * (sum(pg.n_entries for pg in pat.pose_groups) + n_chunks
                    + 2 * len(pat.pose_groups)
                    + sum(pg.count for pg in pat.pose_groups)),
             flops=2 * n_w + 2 * Tp, label=name("ba_wv"),
             library=lambda: W_csr @ v_col, post=y_and_dot, slow_plain=True,
             scale=lambda: tuple(m[0] for m in mags)
             + (sum(m[1] for m in mags),), library_what="W·v only")
        device_rows(name("ba_wv"), tag, {
            "kernel (every pose group)": lambda: wv(ba_coupling.ba_wv),
            "CSR product, W·v only": lambda: W_csr @ v_col})
        # what the check reads for a kernel whose row is 1% off: the row of
        # most entries and the row where 1% shows least
        got_wv = wv(ba_coupling.ba_wv)
        lim = TOL["ba_wv"][tag]
        for pg, (y_, _), (m_, _) in zip(pat.pose_groups, got_wv, mags):
            (hub, deg, r_hub), (low, deg_l, r_low) = wrong_row_reading(
                y_, m_, pg.rows)
            print(f"phase 3 kernel ba_wv{sfx} {tag}: a row 1% off reads "
                  f"{r_hub:.3e} at {pg.name} {hub} ({deg} entries) and "
                  f"{r_low:.3e} at {pg.name} {low} ({deg_l} entries), "
                  f"against the limit {lim:.3e} [{card}]")
        again = wv(ba_coupling.ba_wv)
        if not all(torch.equal(a_, b_) for o1, o2 in zip(got_wv, again)
                   for a_, b_ in zip(o1, o2)):
            raise AssertionError("ba_wv does not repeat its bits")
        del got_wv, again, mags
        hcc = {pg.name: ba_general.diag_blocks(hpp_d, pg)
               for pg in pat.pose_groups}

        def sandwich(fn):
            return [fn(sys_["W_pose"][pg.name], pg.rows, hinv, hcc[pg.name])
                    for pg in pat.pose_groups]

        case("ba_sandwich", tag, f"pose groups "
             f"{[(pg.dim, pg.count, pg.n_entries) for pg in pat.pose_groups]}",
             lambda: sandwich(ba_coupling.ba_sandwich),
             lambda: sandwich(ba_coupling.ba_sandwich_plain),
             nbytes=s * (n_w + dl * dl * L + 2 * sum(
                 pg.dim * pg.dim * pg.count for pg in pat.pose_groups))
             + 4 * (sum(pg.n_entries for pg in pat.pose_groups) + n_chunks),
             flops=sum(2 * (pg.dim * dl * dl + pg.dim * pg.dim * dl)
                       * pg.n_entries for pg in pat.pose_groups),
             label=name("ba_sandwich"), slow_plain=True)
        s1 = sandwich(ba_coupling.ba_sandwich)
        if not all(torch.equal(a_, b_) for a_, b_ in
                   zip(s1, sandwich(ba_coupling.ba_sandwich))):
            raise AssertionError("ba_sandwich does not repeat its bits")
        device_rows(name("ba_sandwich"), tag, {
            "kernel, every pose group": lambda: sandwich(
                ba_coupling.ba_sandwich),
            **{f"group {pg.name} (Dp = {pg.dim}, {pg.count} vertices, "
               f"{pg.rows.n_chunks} chunks)": (
                   lambda pg=pg: ba_coupling.ba_sandwich(
                       sys_["W_pose"][pg.name], pg.rows, hinv, hcc[pg.name]))
               for pg in pat.pose_groups}})
        for pg, blk in zip(pat.pose_groups, s1):
            if pg.dim == 6 and sfx == "@intrinsics":
                # 4l's cameras: printed beside the D = 4 row
                precond_rows("lane_block_mv_dot@4l", tag,
                             ba_inv.ba_block_inv(blk)[1], xs[pg.name],
                             "4l's cameras' preconditioner")
            if pg.dim != 4:
                continue
            D, N = pg.dim, pg.count
            mats = blk.view(D, D, N).permute(2, 0, 1)
            cond = float(torch.linalg.cond(mats.double()).max())
            case("ba_block_inv", tag, f"D=4 N={N}, the intrinsics "
                 f"preconditioner block, condition number {cond:.2e}",
                 lambda b_=blk: ba_inv.ba_block_inv(b_)[1],
                 lambda b_=blk: ba_inv.ba_block_inv_plain(b_)[1],
                 nbytes=s * 2 * D * D * N, flops=150 * N,
                 label="ba_block_inv@d4", library=lambda m_=mats:
                 torch.linalg.inv(m_), tol=block_inv_tol(tag, cond))
            device_rows("ba_block_inv@d4", tag, {
                "kernel": lambda b_=blk: ba_inv.ba_block_inv(b_),
                "torch.linalg.inv": lambda m_=mats: torch.linalg.inv(m_),
                "torch.linalg.inv_ex (no error check, no host read)":
                    lambda m_=mats: torch.linalg.inv_ex(m_)[0]})
            binv = ba_inv.ba_block_inv(blk)[1]
            xd = xs[pg.name]
            # the preconditioner step is lane_block_mv_dot (its JSON row
            # @d4)
            precond_rows("lane_block_mv_dot@d4", tag, binv, xd,
                         "4l's intrinsics hub's preconditioner")
            device_rows("lane_block_mv_dot@d4", tag, {
                "torch.einsum (z alone)": lambda: torch.einsum(
                    "abn,bn->an", binv.view(D, D, N), xd)})
        # K15 on the pose slots: at @psi2uv both cameras' blocks and their
        # coupling (block + transpose where the two slots name one
        # camera), at @intrinsics the cameras, the intrinsics hub and
        # their coupling
        k15_row("dense_assemble" + sfx, tag,
                pose_slot_dargs(torch, dense_assemble, gprob, pat, lin))
        del W_csr, WT_csr, sys_, lin, hpp_d, got_w, want_w

    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
        s = torch.empty((), dtype=dt).element_size()
        for sfx, g_ in general_graphs.items():
            general_rows(g_.compile(dtype=dt), sfx, tag, s)
        # K15 on the camera slots of phases 4j and 4n (binary XYZ2UV at
        # both BAL shapes through the general path)
        for shape, sfx in ((BA_80K, "@4j"), (BA_400K, "@4n")):
            gprob = synthetic_bal_problem(*shape, BA_OBS, dtype=dt)[0]
            k15_row("dense_assemble" + sfx, tag, pose_slot_dargs(
                torch, dense_assemble, gprob,
                ba_general.build_schur_pattern(gprob),
                problem_mod.linearize(gprob)))
            del gprob
        torch.cuda.empty_cache()

    # K14 at (9, 3) and K15 at block width 9: phase 4q's BAL camera scenes
    # through the general Schur path (K14, then K15 on the camera slots:
    # rows @bal, @bal400k) and phase 4r's dense scene (K15's 3 x 3, 3 x 9
    # and 9 x 9 pairs, the zero fill of H and the unit diagonal of camera
    # 0: row dense_assemble@d9)
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
        for key_b, sfx in (("80k", "@bal"), ("400k", "@bal400k")):
            gprob = load_bal_problem(bal_scenes[key_b]["path"], dtype=dt)[0]
            pat = ba_general.build_schur_pattern(gprob)
            lin = problem_mod.linearize(gprob)
            new_w, edge_run, k14_bytes, k14_flops, k14_shape = k14_operands(
                torch, ba_edge, gprob, pat, lin)
            got_w, want_w = new_w(), new_w()
            label_k14 = "schur_edge_blocks" + sfx
            case("schur_edge_blocks", tag, k14_shape,
                 lambda: edge_run(schur_general.schur_edge_blocks, got_w),
                 lambda: edge_run(schur_general.schur_edge_blocks_plain,
                                  want_w),
                 nbytes=k14_bytes, flops=k14_flops, label=label_k14,
                 slow_plain=True)
            again_w = edge_run(schur_general.schur_edge_blocks, new_w())
            if not all(torch.equal(a_, b_) for a_, b_ in zip(
                    edge_run(schur_general.schur_edge_blocks, new_w()),
                    again_w)):
                raise AssertionError(f"{label_k14} does not repeat its bits")
            device_rows(label_k14, tag, {"kernel": lambda: edge_run(
                schur_general.schur_edge_blocks, got_w)})
            k15_row("dense_assemble" + sfx, tag, pose_slot_dargs(
                torch, dense_assemble, gprob, pat, lin))
            del gprob, pat, lin, got_w, want_w, again_w
        dprob_b = load_bal_problem(bal_scenes["dense"]["path"], dtype=dt)[0]
        dargs = dense_world_dargs(dense_assemble, problem_mod, dprob_b)
        k15_row("dense_assemble@d9", tag, dargs)
        once = dense_assemble.dense_assemble(*dargs)
        # the mirrored writes make H symmetric to the bit outside the
        # diagonal blocks, which are at most 9 wide
        skew = (once[0] - once[0].T).abs_()
        if float(skew.max()) > TOL_DEFAULT[tag] * float(once[0].abs().max()) \
                or bool(skew.triu(9).any()):
            raise AssertionError("dense_assemble@d9: H is not symmetric")
        fixed_b = dargs[2].bool()
        if int(fixed_b.sum()) != 9 or not bool(
                (once[0].diagonal()[fixed_b] == 1.0).all()):
            raise AssertionError("dense_assemble@d9: the fixed camera's "
                                 "diagonal is not 1")
        del dprob_b, dargs, once, skew
        torch.cuda.empty_cache()

    # K17: each wrapper against its plain version (the error and
    # torch.func.jvp, or the closed form in torch), twice for the same
    # bits, by device time: on the edge groups of its phase's scene
    # (LIN_ROWS: the worlds of 4d and 4f, the 4j BAL problem, the 4k and 4l
    # scenes, 4m's two-pose-group and stereo scenes), and the types of
    # phase 4o on a seeded group of LIN_GROUP_EDGES edges each (lin_group)
    geo_two = bal_geometry(12, 400)
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
        groups = {}
        for label, make in (
                ("4d", lambda: world.compile(dtype=dt)),
                ("4f", lambda: world3.compile(dtype=dt)),
                ("4j", lambda: synthetic_bal_problem(*BA_80K, BA_OBS,
                                                     dtype=dt)[0]),
                ("4k", lambda: general_graphs["@psi2uv"].compile(dtype=dt)),
                ("4l",
                 lambda: general_graphs["@intrinsics"].compile(dtype=dt)),
                ("4m", lambda: two_pose_group_graph(
                    Graph, geo_two).compile(dtype=dt)),
                ("4m", lambda: stereo_sba_graph(Graph).compile(dtype=dt)),
                ("4p", lambda: load_bal_problem(bal80_path, dtype=dt)[0])):
            lprob = make()
            for eg in lprob.static.egroups:
                wname = edge_lin.LINEARIZERS[eg.etype.name]
                if LIN_ROWS[wname] == label and wname not in groups:
                    groups[wname] = (
                        eg.etype.name, lin_args(lprob, eg),
                        f"E={eg.count} slots {list(eg.slots)}, phase "
                        f"{label}")
            del lprob
        for tname, wname in edge_lin.LINEARIZERS.items():
            if LIN_ROWS[wname] == "4o":
                groups[wname] = (
                    tname, lin_group(torch, tname, LIN_GROUP_EDGES, dt, dev,
                                     seed=7),
                    f"E={LIN_GROUP_EDGES} seeded group (lin_group), phase "
                    "4o")
        if set(groups) != set(LIN_ROWS):
            raise AssertionError(f"K17 rows missing: "
                                 f"{set(LIN_ROWS) - set(groups)}")
        flat = lambda o: (o[0], *o[1], o[2])
        for wname, (tname, largs, shape) in groups.items():
            dims = [t_.shape[2] for t_ in
                    edge_lin.linearize_plain(tname, *largs)[1]]
            run_l = lambda w_=wname, a_=largs: flat(
                getattr(edge_lin, w_)(*a_))
            plain_l = lambda w_=wname, a_=largs: flat(
                getattr(edge_lin, w_ + "_plain")(*a_))
            nbytes, flops = lin_bytes_flops(tname, largs)
            case(wname, tag, f"{shape}, widths {dims}", run_l, plain_l,
                 nbytes=nbytes, flops=flops, slow_plain=True)
            first = tuple(t_.clone() for t_ in run_l())
            if not all(torch.equal(a_, b_)
                       for a_, b_ in zip(first, run_l())):
                raise AssertionError(f"{wname} does not repeat its bits")
            del first
            device_rows(wname, tag, {"kernel": run_l})
        del groups
        torch.cuda.empty_cache()

    # K17's closed forms and K7's chi2 on their phases' own groups
    # (PHASE_ROWS: the scenes of 4d, 4f, 4j, 4k, 4l, 4n and the three
    # worlds of 4o), against their plain versions, twice for the same bits,
    # by device time; K7's under the group's own robust kernel
    phase_scenes = (
        ("4d", lambda dt: world.compile(dtype=dt)),
        ("4f", lambda dt: world3.compile(dtype=dt)),
        ("4j", lambda dt: synthetic_bal_problem(*BA_80K, BA_OBS,
                                                dtype=dt)[0]),
        ("4k", lambda dt: general_graphs["@psi2uv"].compile(dtype=dt)),
        ("4l", lambda dt: general_graphs["@intrinsics"].compile(dtype=dt)),
        ("4n", lambda dt: synthetic_bal_problem(*BA_400K, BA_OBS,
                                                dtype=dt)[0]),
        ("4p", lambda dt: load_bal_problem(bal80_path, dtype=dt)[0]),
        *(("4o", lambda dt, g_=make_o(Graph, *size_o): g_.compile(dtype=dt))
          for make_o, size_o in ((world2d_all_graph, ALL2D),
                                 (world3d_all_graph, ALL3D),
                                 (sba_all_graph, ALLSBA))))
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
        rows_p = {}
        for label, make in phase_scenes:
            pprob = make(dt)
            for eg in pprob.static.egroups:
                short = edge_lin.LINEARIZERS[eg.etype.name][len("edge_lin_"):]
                for w_ in ("edge_lin_" + short, "trial_chi2_" + short):
                    key = f"{w_}@{label}"
                    if PHASE_ROWS.get(key) == label and key not in rows_p:
                        rows_p[key] = (eg.etype.name, lin_args(pprob, eg),
                                       f"E={eg.count} slots "
                                       f"{list(eg.slots)}, phase {label}")
            del pprob
        if set(rows_p) != set(PHASE_ROWS):
            raise AssertionError(f"phase rows missing: "
                                 f"{set(PHASE_ROWS) - set(rows_p)}")
        for key, (tname, largs, shape) in rows_p.items():
            wname = key.split("@")[0]
            if wname.startswith("edge_lin_"):
                run_p = lambda w_=wname, a_=largs: (
                    lambda o: (o[0], *o[1], o[2]))(
                        getattr(edge_lin, w_)(*a_))
                plain_p = lambda w_=wname, a_=largs: (
                    lambda o: (o[0], *o[1], o[2]))(
                        getattr(edge_lin, w_ + "_plain")(*a_))
                nbytes, flops = lin_bytes_flops(tname, largs)
                case(wname, tag, shape, run_p, plain_p, nbytes=nbytes,
                     flops=flops, slow_plain=True, label=key)
            else:
                params_p, _, idx_p, meas_p, info_p, delta_p, pdata_p, kid_p \
                    = largs
                a_p = (params_p, idx_p, meas_p, info_p, delta_p, pdata_p,
                       kid_p)
                run_p = lambda w_=wname, a_=a_p: (getattr(trial, w_)(*a_),)
                plain_p = lambda w_=wname, a_=a_p: (
                    getattr(trial, w_ + "_plain")(*a_),)
                nbytes, flops = chi2_bytes_flops(tname, largs)
                case(wname, tag, shape, run_p, plain_p, nbytes=nbytes,
                     flops=flops, post=lambda o: (o[0].sum(),),
                     slow_plain=True, label=key)
                if dt == torch.float32:
                    chi2_witness(key, wname, a_p, run_p()[0],
                                 plain_p()[0])
            first = tuple(t_.clone() for t_ in run_p())
            if not all(torch.equal(a_, b_) for a_, b_ in zip(first,
                                                             run_p())):
                raise AssertionError(f"{key} does not repeat its bits")
            del first
            device_rows(key, tag, {"kernel": run_p})
        del rows_p
        torch.cuda.empty_cache()

    # K7 on the dense and Schur routes: each retraction on a seeded group of
    # TRIAL_GROUP vertices (trial_vertex_group), each edge type's chi2 on a
    # seeded group of TRIAL_GROUP edges (lin_group, every vertex table at
    # the candidate), chi2_sum on the partials of a 400,000-edge group;
    # each against its plain version (the candidate relative to its
    # largest entry, the partials summed), twice for the same bits, by
    # device time
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
        for vname in trial.RETRACT_IDS:
            x_t, dx_t, b_t, free_t, lam_t = trial_vertex_group(
                torch, vname, TRIAL_GROUP, dt, dev, seed=9)
            nbytes, flops = trial_bytes_flops(vname, x_t, dx_t)
            # trial_retract_groups over this one group
            label_t = f"trial_retract_groups@{vname}"
            grp_t = [trial.RetractGroup(vname, x_t, dx_t, free_t, b_t, 0)]
            out_t = torch.empty(trial.partial_count(TRIAL_GROUP, dev),
                                dtype=dt, device=dev)
            run_g = lambda g_=grp_t, o_=out_t, l_=lam_t: (
                trial.trial_retract_groups(g_, l_, o_)[0], o_)

            def plain_g(g_=grp_t, o_=out_t, l_=lam_t):
                o_ = torch.zeros_like(o_)
                return trial.trial_retract_groups_plain(g_, l_, o_)[0], o_

            case("trial_retract_groups", tag, f"N={TRIAL_GROUP} {vname} "
                 "vertices (every 7th fixed), one group, dx and b "
                 "lane-major [D, N] seen transposed", run_g, plain_g,
                 nbytes=nbytes, flops=flops,
                 post=lambda o: (o[0], o[1].sum()), label=label_t)
            first = [t_.clone() for t_ in run_g()]
            if not all(torch.equal(a_, b_) for a_, b_ in zip(first,
                                                             run_g())):
                raise AssertionError(f"{label_t} {tag} does not repeat its "
                                     "bits")
            device_rows(label_t, tag, {"kernel": run_g})
            del x_t, dx_t, b_t, free_t, first, grp_t, out_t
        for tname, wname in trial.CHI2.items():
            params_c, _, idx_c, meas_c, info_c, delta_c, pdata_c, _ = \
                cargs = lin_group(torch, tname, TRIAL_GROUP, dt, dev,
                                  kernel_id=1, seed=9)
            a_c = (params_c, idx_c, meas_c, info_c, delta_c, pdata_c, 1)
            run_c = lambda w_=wname, a_=a_c: getattr(trial, w_)(*a_)
            plain_c = lambda w_=wname, a_=a_c: getattr(trial,
                                                       w_ + "_plain")(*a_)
            nbytes, flops = chi2_bytes_flops(tname, cargs)
            slots_c = list(registry_mod.edge_type(tname).vertex_types)
            case(wname, tag, f"E={TRIAL_GROUP} seeded group (lin_group), "
                 f"Huber, slots {slots_c}", run_c, plain_c, nbytes=nbytes,
                 flops=flops, post=lambda o: o.sum(), slow_plain=True)
            first = run_c().clone()
            if not torch.equal(first, run_c()):
                raise AssertionError(f"{wname} does not repeat its bits")
            device_rows(wname, tag, {"kernel": run_c})
            del cargs, a_c, params_c, idx_c, meas_c, info_c, delta_c, pdata_c
        # trial_retract_groups on seeded groups of the sizes of 4g's, 4p
        # @400k's and 4l's trials, beside one launch per group into the
        # same partial vector (the launches of the parent's trial): the
        # same bits
        for label_g, (_, spec_g) in GROUP_ROWS.items():
            groups_g, off_g, nb_g, fl_g = [], 0, 0, 0
            for i_, (vname, n_) in enumerate(spec_g):
                x_t, dx_t, b_t, free_t, lam_g = trial_vertex_group(
                    torch, vname, n_, dt, dev, seed=11 + i_)
                groups_g.append(trial.RetractGroup(vname, x_t, dx_t, free_t,
                                                   b_t, off_g))
                off_g += trial.partial_count(n_, dev)
                nb_, fl_ = trial_bytes_flops(vname, x_t, dx_t)
                nb_g, fl_g = nb_g + nb_, fl_g + fl_
            out_g = torch.empty(off_g, dtype=dt, device=dev)
            run_g = lambda g_=groups_g, o_=out_g, l_=lam_g: (
                *trial.trial_retract_groups(g_, l_, o_), o_)

            def plain_g(g_=groups_g, o_=out_g, l_=lam_g):
                o_ = torch.zeros_like(o_)
                return (*trial.trial_retract_groups_plain(g_, l_, o_), o_)

            def parent_g(g_=groups_g, o_=out_g, l_=lam_g):
                return (*(trial.trial_retract_groups([gr_], l_, o_)[0]
                          for gr_ in g_), o_)

            case("trial_retract_groups", tag, " + ".join(
                 f"{n_} {v_}" for v_, n_ in spec_g) + " vertices (seeded), "
                 "dx and b lane-major [D, N] seen transposed", run_g,
                 plain_g, nbytes=nb_g, flops=fl_g, label=label_g,
                 post=lambda o: (*o[:-1], o[-1].sum()))
            first = [t_.clone() for t_ in run_g()]
            if not all(torch.equal(a_, b_) for a_, b_ in zip(first,
                                                             parent_g())):
                raise AssertionError(f"{label_g} {tag}: not the bits of "
                                     "one launch per group")
            if not all(torch.equal(a_, b_) for a_, b_ in zip(first,
                                                             run_g())):
                raise AssertionError(f"{label_g} {tag} does not repeat "
                                     "its bits")
            device_rows(label_g, tag, {
                "kernel": run_g,
                f"one launch per group ({len(spec_g)})": parent_g})
            del groups_g, out_g, first
        part_s = torch.rand(trial.partial_count(400000, dev),
                            dtype=dt, device=dev)
        case("chi2_sum", tag, f"{part_s.numel()} partials (a 400,000-edge "
             "group's)", lambda: trial.chi2_sum(part_s),
             lambda: trial.chi2_sum_plain(part_s),
             nbytes=part_s.element_size() * (part_s.numel() + 1),
             flops=part_s.numel(), library=lambda: part_s.sum(),
             library_what="torch.sum")
        if not torch.equal(trial.chi2_sum(part_s), trial.chi2_sum(part_s)):
            raise AssertionError("chi2_sum does not repeat its bits")
        device_rows("chi2_sum", tag, {"kernel": lambda: trial.chi2_sum(
            part_s), "torch.sum": lambda: part_s.sum()})
        del part_s
        torch.cuda.empty_cache()
    # K2' (both passes), K4', K5' (its three forms), K8' and K3 / K4's
    # lane_block_mv at D = 2: LM-PCG over several vertex groups, at phase
    # 4s's full width (the 9000-pose landmark world, PAIR_WORLD: T =
    # 34,108), float32 and float64; every kernel twice for the same bits
    # and by device time
    t_sim_s = time.monotonic()
    world_s, _ = Simulator2D(**PAIR_WORLD).simulate(n_poses=PAIR_POSES)
    t_sim_s = time.monotonic() - t_sim_s
    # rows "@3d": the pair kernels at phase 4f's world, whose pairs 4s runs
    # at (6, 6), (6, 3), (3, 6) and (3, 3)
    for sfx, world_p, dt in ((sfx_, w_, d_) for sfx_, w_ in (
            ("", world_s), ("@3d", world3))
            for d_ in (torch.float32, torch.float64)):
        tag = str(dt).split(".")[-1]
        s = torch.empty((), dtype=dt).element_size()
        sprob = world_p.compile(dtype=dt)
        spat = sparse.build_ell_pattern(sprob)
        if not isinstance(spat, sparse.PairPattern):
            raise AssertionError("the 4s world did not get pair tables")
        plan_s = spat.plan
        lin_s = sparse.pair_linearize(sprob)
        srcs, bsrcs = sparse.pair_sources(sprob, spat, lin_s)
        tables = ([(pt.table, src) for pt, src in zip(spat.pairs, srcs)]
                  + [(spat.b_tables[g], bsrcs[g]) for g in spat.groups])

        def assemble_all():
            return pair_ell.pair_assemble(
                plan_s, pair_ell.pair_stream(plan_s, lin_s))

        def assemble_all_plain():
            return pair_ell.pair_assemble_plain(
                plan_s, pair_ell.pair_stream_plain(plan_s, lin_s))

        n_contrib = sum(d.numel() for tb, _ in tables for d in tb.dest)
        # the yardsticks: one index_add_ per pair table and per group of the
        # blocks formed beforehand, and the whole function: each source's
        # blocks by torch.bmm, then the index_add_
        lib_ops = [(torch.cat(list(tb.dest)),
                    torch.cat([_pair_blocks(torch, so, tb.dc) for so in src]),
                    (tb.n_dest, tb.entries)) for tb, src in tables]
        lib_src = [(torch.cat(list(tb.dest)), src, tb.dc,
                    (tb.n_dest, tb.entries)) for tb, src in tables]

        def lib_assemble():
            return [torch.zeros(shape, dtype=dt, device=dev).index_add_(
                0, d_, b_) for d_, b_, shape in lib_ops]

        def lib_bmm_assemble():
            out_ = []
            for d_, src_, dc_, shape in lib_src:
                blocks = []
                for so in src_:
                    jw = torch.bmm(so.js.transpose(1, 2),
                                   so.rho1[:, None, None] * so.info)
                    blocks.append((torch.bmm(jw, so.jt) if dc_ else
                                   -torch.bmm(jw, so.resid[:, :, None]))
                                  .reshape(so.resid.shape[0], -1))
                out_.append(torch.zeros(shape, dtype=dt, device=dev)
                            .index_add_(0, d_, torch.cat(blocks)))
            return out_

        lay_probe = spat.flat_layout([torch.zeros(
            (pt.dr * pt.dc, pt.used), dtype=dt, device=dev)
            for pt in spat.pairs])
        bound_in = {k_: dict(nbytes=b_, flops=f_) for k_, (b_, f_)
                    in pair_work(spat, srcs, bsrcs, s,
                                 lay_probe.blocks).items()}
        del lay_probe
        case("pair_stream", tag,
             f"{len(plan_s.units)} edge group slots, {n_contrib} "
             "contributions", label="pair_stream" + sfx,
             run=lambda: [pair_ell.pair_stream(plan_s, lin_s)[
                 :plan_s.stream_len]],
             plain=lambda: [pair_ell.pair_stream_plain(plan_s, lin_s)],
             **bound_in["pair_stream"], slow_plain=True)
        if not torch.equal(pair_ell.pair_stream(plan_s, lin_s),
                           pair_ell.pair_stream(plan_s, lin_s)):
            raise AssertionError("pair_stream does not repeat its bits")
        device_rows("pair_stream" + sfx, tag, {
            "kernel": lambda: pair_ell.pair_stream(plan_s, lin_s)})
        case("pair_assemble", tag,
             f"{len(spat.pairs)} pair tables + {len(spat.groups)} b, "
             f"{n_contrib} contributions, both passes",
             label="pair_assemble" + sfx, run=assemble_all,
             plain=assemble_all_plain, **bound_in["pair_assemble"],
             library=lib_bmm_assemble,
             library_what="torch.bmm of each source's blocks, then "
             "index_add_ per pair table and per group", slow_plain=True)
        once = assemble_all()
        if not all(torch.equal(a_, b_) for a_, b_ in zip(
                once, assemble_all())):
            raise AssertionError("pair_assemble does not repeat its bits")
        stream_s = pair_ell.pair_stream(plan_s, lin_s)
        device_rows("pair_assemble" + sfx, tag, {
            "kernel (both passes)": assemble_all,
            "pass 2 alone (pair_sum)": lambda: pair_ell.pair_assemble(
                plan_s, stream_s),
            "index_add_ per table (blocks formed beforehand)":
                lib_assemble,
            "torch.bmm + index_add_ (the same function)": lib_bmm_assemble})
        del lib_ops, lib_src, stream_s
        values_s = once[:len(spat.pairs)]
        bT_s = dict(zip(spat.groups, once[len(spat.pairs):]))
        lam_s = torch.tensor(0.5, dtype=dt, device=dev)
        linv_s, lchol_s, extra_s = {}, {}, {}
        for g_, i_ in spat.square.items():
            linv_s[g_], lchol_s[g_], _, extra_s[g_] = damp_chol.damp_chol(
                values_s[i_], sprob.free[g_], bT_s[g_], lam_s)
        if sfx == "":
            # K3 and K4's lane_block_mv at D = 2: the landmarks of 4s
            i2 = spat.square["point_xy"]
            N2 = spat.counts["point_xy"]
            free2 = sprob.free["point_xy"]
            eye2 = torch.eye(2, dtype=dt, device=dev)

            def lib_chol2():
                blocks = (values_s[i2][0].view(2, 2, N2).permute(2, 0, 1)
                          + (lam_s * free2 + (1 - free2))[:, None, None]
                          * eye2)
                L = torch.linalg.cholesky_ex(blocks)[0]
                return torch.linalg.solve_triangular(
                    L, eye2.expand(N2, 2, 2), upper=False)

            case("damp_chol", tag, f"D=2 N={N2} (the landmarks of 4s)",
                 lambda: damp_chol.damp_chol(values_s[i2], free2,
                                             bT_s["point_xy"], lam_s),
                 lambda: damp_chol.damp_chol_plain(values_s[i2], free2,
                                                   bT_s["point_xy"], lam_s),
                 nbytes=s * (4 + 1 + 2 + 4 + 4 + 2 + 1) * N2, flops=30 * N2,
                 library=lib_chol2, label="damp_chol@d2",
                 library_what="torch.linalg.cholesky_ex + solve_triangular")
            device_rows("damp_chol@d2", tag, {
                "kernel": lambda: damp_chol.damp_chol(
                    values_s[i2], free2, bT_s["point_xy"], lam_s),
                "cholesky_ex + solve_triangular": lib_chol2})
            x2 = torch.randn((2, N2), dtype=dt, device=dev)
            l2 = linv_s["point_xy"].view(2, 2, N2)
            case("lane_block_mv", tag, f"D=2 N={N2} (and its transpose)",
                 lambda: (jacobi_scale.lane_block_mv(linv_s["point_xy"], x2,
                                                     True),
                          jacobi_scale.lane_block_mv(linv_s["point_xy"], x2,
                                                     False)),
                 lambda: (jacobi_scale.lane_block_mv_plain(
                     linv_s["point_xy"], x2, True),
                          jacobi_scale.lane_block_mv_plain(
                              linv_s["point_xy"], x2, False)),
                 nbytes=2 * s * 8 * N2, flops=2 * 8 * N2,
                 library=lambda: (torch.einsum("ban,bn->an", l2, x2),
                                  torch.einsum("abn,bn->an", l2, x2)),
                 label="lane_block_mv@d2", library_what="torch.einsum")
            device_rows("lane_block_mv@d2", tag, {
                "kernel": lambda: jacobi_scale.lane_block_mv(
                    linv_s["point_xy"], x2, True),
                "torch.einsum": lambda: torch.einsum("ban,bn->an", l2, x2)})

        def scale_all(fn, fac=linv_s):
            return [fn(pt.nb, pt.rowptr, v, fac[pt.rg], fac[pt.cg],
                       extra_s[pt.rg] if pt.square else None, pt.used)
                    for pt, v in zip(spat.pairs, values_s)]

        case("pair_scale", tag, "every pair table (K = "
             + ", ".join(str(pt.k) for pt in spat.pairs) + ", U = "
             + ", ".join(str(pt.used) for pt in spat.pairs) + ")",
             lambda: scale_all(pair_ell.pair_scale),
             lambda: scale_all(pair_ell.pair_scale_plain),
             **bound_in["pair_scale"], label="pair_scale" + sfx)
        g0 = spat.groups[0]                      # the poses
        bad_s = {**linv_s, g0: linv_s[g0].clone()}
        bad_s[g0][:, 0] = float("nan")           # pose 0's factor
        case("pair_scale", tag, "NaN factor of pose 0",
             lambda: scale_all(pair_ell.pair_scale, bad_s),
             lambda: scale_all(pair_ell.pair_scale_plain, bad_s), 0, 0,
             same_nan=True, label="pair_scale@nan" + sfx, timed=False)
        for pt, v, sv in zip(spat.pairs, values_s,
                             scale_all(pair_ell.pair_scale, bad_s)):
            rows_u, slots_u = pair_ell.used_slots(pt.rowptr)
            zero = (v == 0).all(dim=1)[slots_u, rows_u]
            if pt.square:
                zero &= slots_u != 0
            if (sv[:, zero] != 0).any():
                raise AssertionError("pair_scale: an all-zero slot without "
                                     "damping is not exactly zero")
        del bad_s
        svals_s = scale_all(pair_ell.pair_scale)
        if not all(torch.equal(a_, b_) for a_, b_ in zip(
                svals_s, scale_all(pair_ell.pair_scale))):
            raise AssertionError("pair_scale does not repeat its bits")
        device_rows("pair_scale" + sfx, tag, {
            "kernel": lambda: scale_all(pair_ell.pair_scale)})
        op_s = sparse.PairOperator(spat, svals_s)
        lay_s = op_s.layout
        lay_plain = pair_ell.FlatLayout.__new__(pair_ell.FlatLayout)
        lay_plain.__dict__.update(lay_s.__dict__)
        lay_plain.on_card = False            # the plain versions on it
        xT_s = {g_: torch.randn((spat.widths[g_], spat.counts[g_]),
                                dtype=dt, device=dev) for g_ in spat.groups}
        # the flat vectors of K5' (each group vertex-major): x_vec is also
        # the CSR product's stacked vector
        x_vec = spat.flatten(xT_s)
        r_vec = torch.randn_like(x_vec)
        # the same H as one CSR matrix over the stacked vertex-major vector
        offs, tot = {}, 0
        for g_ in spat.groups:
            offs[g_] = tot
            tot += spat.widths[g_] * spat.counts[g_]
        rows_c, cols_c, vals_c = [], [], []
        for pt, sv in zip(spat.pairs, svals_s):
            row_u, _ = pair_ell.used_slots(pt.rowptr)
            aa, cc, uu = torch.meshgrid(
                torch.arange(pt.dr, device=dev),
                torch.arange(pt.dc, device=dev),
                torch.arange(pt.used, device=dev), indexing="ij")
            rows_c.append((offs[pt.rg] + row_u[uu] * pt.dr + aa).reshape(-1))
            cols_c.append((offs[pt.cg] + pt.cols.long()[uu] * pt.dc
                           + cc).reshape(-1))
            vals_c.append(sv.view(pt.dr, pt.dc, pt.used).reshape(-1))
        keep = torch.cat(vals_c) != 0
        H_csr = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows_c)[keep], torch.cat(cols_c)[keep]]),
            torch.cat(vals_c)[keep], (tot, tot)).coalesce().to_sparse_csr()
        x_flat = x_vec
        del rows_c, cols_c, vals_c, keep
        y_csr = (H_csr @ x_flat[:, None])[:, 0]
        y_k_flat = spat.flatten(sparse.ell_matvec_lane(spat, svals_s, xT_s))
        err_csr = float((y_k_flat - y_csr).abs().max()
                        / y_csr.abs().max())
        if not err_csr <= 10 * TOL_DEFAULT[tag]:
            raise AssertionError(f"pair_spmv differs from the CSR product "
                                 f"of the same H: {err_csr:.3e}")
        case("pair_spmv", tag, f"T={tot}, one launch over every row group",
             lambda: [pair_ell.pair_spmv(lay_s, x_vec)],
             lambda: [pair_ell.pair_spmv_plain(lay_plain, x_vec)],
             **bound_in["pair_spmv"],
             library=lambda: H_csr @ x_flat[:, None], label="pair_spmv" + sfx,
             library_what="torch.sparse CSR product of the same H")
        case("pair_spmv_dot", tag, f"T={tot}, with p . H p",
             lambda: (lambda o: [o[0], o[1].sum()])(
                 pair_ell.pair_spmv_dot(lay_s, x_vec)),
             lambda: (lambda o: [o[0], o[1].sum()])(
                 pair_ell.pair_spmv_dot_plain(lay_plain, x_vec)),
             **bound_in["pair_spmv_dot"],
             library=lambda: H_csr @ x_flat[:, None],
             label="pair_spmv_dot" + sfx,
             library_what="torch.sparse CSR product of the same H, no dot")
        hp1, part1 = op_s.matvec_dot(x_vec)
        hp1, part1 = hp1.clone(), part1.clone()
        hp2, part2 = op_s.matvec_dot(x_vec)
        if not (torch.equal(part1, part2) and torch.equal(hp1, hp2)):
            raise AssertionError("pair_spmv_dot does not repeat its bits")
        scal_s = torch.zeros(cg_step.N_SCALARS, dtype=dt, device=dev)
        scal_s[cg_step.BETA] = 0.37
        pn_k, pn_p = torch.empty_like(x_vec), torch.empty_like(x_vec)
        case("pair_spmv_dot_p", tag,
             f"T={tot}, p_new = beta p + r folded in, with p_new . H p_new",
             lambda: (lambda o: [pn_k, o[0], o[1].sum()])(
                 pair_ell.pair_spmv_dot_p(lay_s, scal_s, x_vec, r_vec,
                                          pn_k)),
             lambda: (lambda o: [pn_p, o[0], o[1].sum()])(
                 pair_ell.pair_spmv_dot_p_plain(lay_plain, scal_s, x_vec,
                                                r_vec, pn_p)),
             **bound_in["pair_spmv_dot_p"],
             library=lambda: H_csr @ x_flat[:, None],
             label="pair_spmv_dot_p" + sfx,
             library_what="torch.sparse CSR product of the same H, no dot, "
             "no p update")
        y1, q1 = pair_ell.pair_spmv_dot_p(lay_s, scal_s, x_vec, r_vec,
                                          pn_k)
        y1, q1, pn1 = y1.clone(), q1.clone(), pn_k.clone()
        y2, q2 = pair_ell.pair_spmv_dot_p(lay_s, scal_s, x_vec, r_vec,
                                          pn_k)
        if not (torch.equal(y1, y2) and torch.equal(q1, q2)
                and torch.equal(pn1, pn_k)):
            raise AssertionError("pair_spmv_dot_p does not repeat its bits")
        device_rows("pair_spmv_dot" + sfx, tag, {
            "kernel": lambda: pair_ell.pair_spmv_dot(lay_s, x_vec),
            "pair_spmv (no dot)": lambda: pair_ell.pair_spmv(lay_s, x_vec),
            "pair_spmv_dot_p (p folded in)": lambda: pair_ell.pair_spmv_dot_p(
                lay_s, scal_s, x_vec, r_vec, pn_k),
            "torch.sparse CSR product of the same H":
                lambda: H_csr @ x_flat[:, None]})
        device_rows("pair_spmv_dot_p" + sfx, tag, {
            "kernel": lambda: pair_ell.pair_spmv_dot_p(
                lay_s, scal_s, x_vec, r_vec, pn_k)})
        case("pair_gershgorin", tag, f"T={tot}, {len(spat.groups)} row "
             "groups, one pass", lambda: pair_ell.pair_gershgorin(lay_s),
             lambda: pair_ell.pair_gershgorin_plain(lay_plain),
             **bound_in["pair_gershgorin"], label="pair_gershgorin" + sfx)
        if not torch.equal(pair_ell.pair_gershgorin(lay_s),
                           pair_ell.pair_gershgorin(lay_s)):
            raise AssertionError("pair_gershgorin does not repeat its bits")
        device_rows("pair_gershgorin" + sfx, tag, {
            "kernel": lambda: pair_ell.pair_gershgorin(lay_s)})
        print(f"phase 3 pairs{sfx} {tag}: "
              + (f"Simulator2D({PAIR_WORLD}).simulate({PAIR_POSES}) in "
                 f"{t_sim_s:.2f} s on the host" if sfx == ""
                 else "phase 4f's world") + f"; T={tot}; "
              "pairs " + ", ".join(f"({pt.rg}, {pt.cg}) {pt.dr}x{pt.dc} "
                                   f"K={pt.k} U={pt.used}"
                                   for pt in spat.pairs)
              + f"; K5' lanes {lay_s.lanes} blocks {lay_s.blocks} "
              f"launches {len(lay_s.launches)}; the CSR product agrees to "
              f"{err_csr:.3e} [{card}]")
        del sprob, spat, srcs, bsrcs, tables, once, values_s, bT_s, svals_s
        del op_s, lay_s, lay_plain, H_csr, x_flat, linv_s, lchol_s, extra_s
        del lin_s, plan_s, x_vec, r_vec, pn_k, pn_p, scal_s
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for (label, tag), row in sorted(results.items()):
        tol = row.get("tol", TOL.get(label, TOL.get(row["kname"],
                                                    TOL_DEFAULT))[tag])
        ok = row["rel"] <= tol
        witness = ""
        if "witness" in row:
            w_k, w_p = row["witness"]
            ok = ok or w_k <= CHI2_WITNESS_TOL
            witness = (f" (float64 witness: kernel {w_k:.3e}, plain "
                       f"{w_p:.3e})")
        timing = ""
        if "ms" in row:
            lib = ("none" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f} ms")
            if row["library_what"]:
                lib = f"({row['library_what']}) {lib}"
            timing = (f" kernel {row['ms']:.4f} ms plain "
                      f"{row['plain_ms']:.4f} ms bound "
                      f"{row['bound_ms']:.5f} ms ({row['bound_by']}) "
                      f"library {lib}")
        print(f"phase 3 kernel {label} {tag} {row['shape']}: max_abs_err "
              f"{row['abs']:.3e} max_rel_err {row['rel']:.3e} (tol {tol:g})"
              f"{witness}{timing} [{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel {label} {tag} disagrees with its "
                                 f"plain version: {row['rel']:.3e} > {tol:g}")
    del probs["float64"]

    # -- 4. the paths on the card -------------------------------------------
    prob = probs["float32"]
    # every wrapper and its plain version, for the plain-route runs
    swaps = [(spmv, "block_ell_spmv"), (edge_se2, "edge_se2_blocks"),
             (edge_se3, "edge_se3_blocks"), (retract_chi2, "retract_se3"),
             (retract_chi2, "se3_edge_chi2"),
             (assemble, "assemble_gather"), (damp_chol, "damp_chol"),
             (jacobi_scale, "jacobi_scale"), (jacobi_scale, "lane_block_mv"),
             (jacobi_scale, "lane_block_mv_dot"), (cg_step, "spmv_dot"),
             (cg_step, "spmv_dot_p"), (cg_step, "dot_partials"),
             (cg_step, "cg_residual"), (cg_step, "cg_start"),
             (cg_step, "cg_update_xr"), (cg_step, "cg_update_p"),
             (cg_step, "cg_finish"), (chebyshev, "gershgorin_bound"),
             (chebyshev, "chebyshev_coeffs"), (chebyshev, "chebyshev_init"),
             (chebyshev, "chebyshev_update"), (gather, "lane_gather"),
             (retract_chi2, "retract_chi2"), (retract_chi2, "lm_outcome"),
             (dense_assemble, "dense_assemble"),
             (ba_edge, "ba_xyz2uv_blocks"), (ba_edge, "ba_edge_blocks"),
             (ba_edge, "ba_lm_sums"), (ba_edge, "ba_cam_sums"),
             (ba_inv, "ba_block_inv"), (ba_schur, "ba_schur_dense"),
             (ba_schur, "ba_schur_records"),
             (ba_coupling, "ba_wtx"), (ba_coupling, "ba_wv"),
             (ba_coupling, "ba_sandwich"),
             (schur_general, "schur_edge_blocks"),
             (pair_ell, "pair_stream"), (pair_ell, "pair_assemble"),
             (pair_ell, "pair_scale"), (pair_ell, "pair_spmv"),
             (pair_ell, "pair_spmv_dot"), (pair_ell, "pair_spmv_dot_p"),
             (pair_ell, "pair_gershgorin"),
             *((edge_lin, w_) for w_ in edge_lin.LINEARIZERS.values()),
             *((trial, w_) for w_ in (*trial.CHI2.values(), "chi2_sum",
                                      "trial_retract_groups"))]

    def read_counts():
        """kernels.launch_counts() and, as trial_retract_groups@<vertex
        type>, the launches of trial_retract_groups that served a group of
        each type (launches_by_type): a phase's counts, read once its run
        ends, so that no later timing loop adds to them."""
        counts_ = kernels.launch_counts()
        by_type_ = trial.trial_retract_groups.launches_by_type
        counts_.update((f"trial_retract_groups@{v_}", by_type_[v_])
                       for v_ in trial.RETRACT_IDS)
        return counts_

    # From here on no built-in edge type may reach the generic
    # linearization (the model's torch error with torch.func.jvp or its
    # torch closed form) on CUDA tensors outside a plain-route run: K17
    # serves every type of openslam_g2o_torch.models. Each such call is
    # recorded (phase 6 asserts there is none).
    generic_calls, plain_depth = [], [0]

    def count_generic(fn, name):
        def counted(*a, **k):
            et, meas = ((a[0], a[5]) if name == "linearize_edges"
                        else (a[0].etype, a[2]))
            if (plain_depth[0] == 0 and meas.device.type == "cuda"
                    and et.name in edge_lin.LINEARIZERS):
                generic_calls.append((name, et.name))
            return fn(*a, **k)
        return counted

    for fn_name in ("linearize_edges", "forward_jacobians"):
        setattr(problem_mod, fn_name,
                count_generic(getattr(problem_mod, fn_name), fn_name))

    # Nor may a built-in vertex or edge type reach the plain trial (the
    # model's retraction, its error and robustify in torch) on CUDA tensors
    # outside a plain-route run: K7 serves every type on the dense and
    # Schur routes. Each such call is recorded (phase 6 asserts none).
    plain_trial_calls = []

    def count_plain_trial(fn, name):
        def counted(*a, **k):
            t_, table, x_ = ((a[0], trial.RETRACT_IDS, a[1])
                             if name == "retract_plain"
                             else (a[0], trial.CHI2, a[4]))
            if (plain_depth[0] == 0 and x_.device.type == "cuda"
                    and t_.name in table):
                plain_trial_calls.append((name, t_.name))
            return fn(*a, **k)
        return counted

    for fn_name in ("retract_plain", "chi2_plain"):
        setattr(trial, fn_name,
                count_plain_trial(getattr(trial, fn_name), fn_name))

    def trial_split(phase, prob_, dx_parts, b_parts, lam_, ok_):
        """One trial's K7 at prob_'s params: ms of the candidate and its
        chi2 (apply_update_parts + robust_chi2, the split 4d has printed
        since PR 3) and of the whole outcome (lm_trial_outcome: candidate,
        dot and chi2 partials, lm_outcome), CUDA events around one call,
        median of 5; the outcome's launches, which must be one per vertex
        group range of trial_retract_groups (one launch for up to
        MAX_RETRACT_GROUPS vertex groups), one per edge group and
        lm_outcome's. Prints a line and returns the ms."""
        ni_ = torch.tensor(2.0, dtype=prob_.dtype, device=dev)
        chi_ = robust_chi2(prob_)
        st_ = prob_.static

        def retract_chi2_():
            robust_chi2(prob_, problem_mod.apply_update_parts(prob_,
                                                               dx_parts))

        def outcome_():
            problem_mod.lm_trial_outcome(prob_, dx_parts, b_parts, ok_, lam_,
                                         ni_, chi_)

        before_ = kernels.launch_counts()
        outcome_()
        k7_ = {k: v - before_[k] for k, v in kernels.launch_counts().items()
               if v != before_[k]}
        want_ = {"lm_outcome": 1, "trial_retract_groups": -(
            -len(st_.vgroups) // trial.MAX_RETRACT_GROUPS)}
        for eg_ in st_.egroups:
            w_ = trial.CHI2[eg_.etype.name]
            want_[w_] = want_.get(w_, 0) + 1
        if k7_ != want_:
            raise AssertionError(f"phase {phase}: one trial's outcome "
                                 f"launched {k7_}, not {want_}")
        ms_ = {"retract+chi2": _median_ms(torch, retract_chi2_, repeats=5,
                                          inner=1, warmup=1),
               "trial outcome": _median_ms(torch, outcome_, repeats=5,
                                           inner=1, warmup=1)}

        def candidate_():
            problem_mod.trial_candidate(prob_, dx_parts, b_parts, lam_)

        # the retraction alone: device time (CUDA events behind a spin)
        # and the host's time per call (enqueue, no synchronize)
        dev_ms_, n_dev_, held_ = _device_ms(torch, candidate_)
        t_host_ = time.perf_counter()
        for _ in range(20):
            candidate_()
        host_us_ = (time.perf_counter() - t_host_) / 20 * 1e6
        torch.cuda.synchronize()
        print(f"phase {phase} K7 split of one trial (CUDA events around one "
              f"call, median of 5): " + "; ".join(
                  f"{k} {v:.3f} ms" for k, v in ms_.items())
              + f"; {sum(k7_.values())} launches per trial outcome "
              f"({len(st_.vgroups)} vertex groups, {len(st_.egroups)} edge "
              f"groups, lm_outcome); the retraction (trial_candidate, "
              f"{k7_['trial_retract_groups']} launch): device "
              f"{1e3 * dev_ms_:.2f} us ({n_dev_} calls"
              f"{'' if held_ else ', host-bound'}), host {host_us_:.1f} us "
              f"a call [{card}]")
        return ms_

    def dense_trial_split(phase, dprob_, dpat_):
        """trial_split on the dense route: the step of LM's first trial
        (lambda init, damped solve) at dprob_'s params."""
        H_, b_, _ = problem_mod.build_dense_system(dprob_, pattern=dpat_)
        lam_ = LevenbergMarquardt().init(dprob_)["lam"]
        H_.diagonal().add_(lam_ * problem_mod.tangent_masks(dprob_)[0])
        dx_, ok_ = solve_dense_cholesky(H_, b_)
        del H_
        return trial_split(phase, dprob_, problem_mod.tangent_parts(
            dprob_, dx_), problem_mod.tangent_parts(dprob_, b_), lam_, ok_)

    def schur_trial_split(phase, prob_, solved, lam_):
        """trial_split on a Schur route from its _solve's (dxT, ok, bT)."""
        dxT_, ok_, bT_ = solved
        return trial_split(phase, prob_, {k: v.T for k, v in dxT_.items()},
                           {k: v.T for k, v in bT_.items()}, lam_, ok_)

    class plain_versions:
        """Every wrapper swapped for its plain version (CUDA tensors, plain
        PyTorch ops) inside the block; fails if a kernel launched in it."""

        def __enter__(self):
            plain_depth[0] += 1
            self.before = kernels.launch_counts()
            self.saved = [(mod, attr, getattr(mod, attr))
                          for mod, attr in swaps]
            for mod, attr in swaps:
                setattr(mod, attr, getattr(mod, attr + "_plain"))
            # the plain K12 reads w_lm; its caller also hands W's records
            plain_schur = ba_schur.ba_schur_dense_plain
            ba_schur.ba_schur_dense = \
                lambda *a, w_rec, **k: plain_schur(*a, **k)

        def __exit__(self, *exc):
            plain_depth[0] -= 1
            for mod, attr, fn in self.saved:
                setattr(mod, attr, fn)
            if exc[0] is None and kernels.launch_counts() != self.before:
                raise AssertionError("the plain-route run launched a kernel")

    def plain_route(alg, pattern, ni, prob=prob, **pcg):
        """The first 3 iterations on the plain versions: (lambda0, chi2
        list)."""
        with plain_versions():
            lam_p = _lambda_init_pcg(
                prob, pattern, prob.params,
                torch.tensor(alg.tau, dtype=prob.dtype, device=dev))
            out_p = lm_pcg_optimize_fused(
                prob, pattern, prob.params, lam_p, ni, robust_chi2(prob),
                n_iters=3, **pcg)
        return float(lam_p), out_p[4].tolist()

    def start(alg, prob=prob):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.monotonic()
        state = alg.init(prob)
        pattern = alg.pattern(prob)
        torch.cuda.synchronize()
        return state, pattern, time.monotonic() - t, t

    def window(pattern, st, n, prob=prob, **kw):
        t = time.monotonic()
        out = lm_pcg_optimize_fused(prob, pattern, *st, n_iters=n, **kw)
        torch.cuda.synchronize()
        return out[:4], out[4].tolist(), time.monotonic() - t

    def cg_launches(counts):
        """Launches of the CG iterations' own kernels."""
        return sum(counts[k] for k in ("spmv_dot", "spmv_dot_p",
                                       "cg_update_xr", "cg_update_p",
                                       "dot_partials"))

    def two_launch_step(what, counts):
        """Unpreconditioned solves: 2 launches per CG iteration, no
        cg_update_p, spmv_dot only in each solve's first iteration."""
        iters, solves = counts["cg_update_xr"], counts["cg_finish"]
        if not (counts["cg_update_p"] == 0 and counts["dot_partials"] == 0
                and 0 < counts["spmv_dot"] <= solves
                and counts["spmv_dot"] + counts["spmv_dot_p"] == iters
                and cg_launches(counts) == 2 * iters):
            raise AssertionError(f"{what}: not two launches per CG "
                                 f"iteration: {counts}")

    # 4. main path
    pcg = dict(pcg_iters=100, pcg_tol=0.15)
    alg = LevenbergMarquardtPCG(**pcg)
    state, pattern, init_s, t_start = start(alg)
    st = (state["params"], state["lam"], state["ni"], state["chi2"])
    lam0, chi0 = float(st[1]), float(st[3])
    st, first_traj, dt_first = window(pattern, st, 10, **pcg)
    traj = list(first_traj)
    windows = [(10, dt_first)]
    for _ in range(8):
        if float(st[3]) <= 1.05 * floor:
            break
        st, t_, dt_w = window(pattern, st, 10, **pcg)
        traj += t_
        windows.append((10, dt_w))
    window_counts = read_counts()
    n_polish = 0
    for _ in range(10):
        if float(st[3]) <= 1.02 * floor:
            break
        st, t_, dt_w = window(pattern, st, 5, pcg_iters=600, pcg_tol=1e-6,
                              warm=True)
        traj += t_
        n_polish += 1
    main_s = time.monotonic() - t_start
    counts_main = read_counts()    # the main path's launches
    final = float(st[3])
    steady = [dt / n for n, dt in windows[1:]] or [windows[0][1] / 10]
    ms_first = dt_first / 10 * 1e3
    ms_steady = sorted(steady)[len(steady) // 2] * 1e3
    cg_iters = window_counts["cg_update_xr"]
    per_cg = cg_launches(window_counts) / max(cg_iters, 1)
    two_launch_step("phase 4 main path", counts_main)
    print(f"phase 4 main path: {N_POSES} poses "
          f"{prob.static.egroups[0].count} edges K={pattern.k} float32; "
          f"init+lambda0 {init_s:.3f} s lambda0 {lam0:.6g} chi2_0 "
          f"{chi0:.1f}; first 10-iteration window {ms_first:.2f} ms/LM "
          f"iteration, later windows median {ms_steady:.2f} ms/LM iteration "
          f"({len(windows)} windows of 10, pcg 100 tol 0.15: {cg_iters} CG "
          f"iterations, {per_cg:.2f} launches per CG iteration; {n_polish} "
          f"polish windows of 5, pcg 600 tol 1e-6); total {main_s:.2f} s "
          f"[{card}]")
    print("phase 4 chi2 trajectory: "
          + " ".join(f"{c:.1f}" for c in traj))
    print(f"phase 4 final chi2 {final:.1f} noise floor {floor:.1f} ratio "
          f"{final / floor:.5f} (gate 1.02)")
    if not np.isfinite(final) or final > 1.02 * floor:
        raise AssertionError(f"chi2 {final} above 1.02 x floor {floor}")
    lam_p, plain_traj = plain_route(alg, pattern, state["ni"], **pcg)
    np.testing.assert_allclose(first_traj[:3], plain_traj,
                               rtol=PLAIN_ROUTE_RTOL)
    np.testing.assert_allclose(lam_p, lam0, rtol=PLAIN_ROUTE_RTOL)
    print("phase 4 plain route: first 3 chi2 "
          + " ".join(f"{c:.2f}" for c in plain_traj) + " vs kernel route "
          + " ".join(f"{c:.2f}" for c in first_traj[:3])
          + f" (rtol {PLAIN_ROUTE_RTOL:g}) OK")

    # one trial's retract + chi2 + outcome (K7) at the final state, outside
    # the counted path: CUDA events around _trial_outcome, median of 9
    work = prob.with_params(st[0])
    pre = _pcg_precomp(work, pattern)
    dxT_t, ok_t = _pcg_trial(work, pattern, pre, st[1], None, 100, 0.15, 0)
    before = read_counts()
    k7_ms = _median_ms(torch, lambda: _trial_outcome(
        work, pattern, pre["bT"], dxT_t, ok_t, st[1], st[2], st[3]),
        repeats=9, inner=1)
    k7_calls = {k: (v - before[k]) // 12 for k, v in
                read_counts().items() if v != before[k]}
    n_groups = len(prob.static.egroups)
    print(f"phase 4 K7: retract + chi2 + outcome {k7_ms:.4f} ms per trial "
          f"(CUDA events, one call per event pair, median of 9); wrapper "
          f"calls per trial {k7_calls}; kernel launches per trial "
          f"{2 + n_groups} (retract_se2, {n_groups} se2_edge_chi2, "
          f"lm_outcome) [{card}]")
    if k7_calls != {"retract_chi2": 1, "lm_outcome": 1}:
        raise AssertionError(f"a trial's outcome launched {k7_calls}")
    del work, pre, dxT_t

    # 4b. the Chebyshev-preconditioned configuration
    cheb_pcg = dict(pcg_iters=100, pcg_tol=0.15, pcg_cheby=4)
    alg_c = LevenbergMarquardtPCG(**cheb_pcg)
    state_c, pattern_c, init_c, t_start = start(alg_c)
    st = (state_c["params"], state_c["lam"], state_c["ni"], state_c["chi2"])
    traj_c, win_c = [], []
    for _ in range(3):
        st, t_, dt_w = window(pattern_c, st, 10, **cheb_pcg)
        traj_c += t_
        win_c.append(dt_w / 10 * 1e3)
    counts_cheb = read_counts()
    print(f"phase 4b Chebyshev path (pcg_cheby 4, pcg 100, tol 0.15): "
          f"3 windows of 10: {' '.join(f'{w:.2f}' for w in win_c)} ms/LM "
          f"iteration; {counts_cheb['cg_update_xr']} outer CG iterations, "
          f"{counts_cheb['block_ell_spmv'] + counts_cheb['spmv_dot']} "
          f"matvecs [{card}]")
    print("phase 4b chi2 trajectory: "
          + " ".join(f"{c:.1f}" for c in traj_c))
    print(f"phase 4b final chi2 {traj_c[-1]:.1f} noise floor {floor:.1f} "
          f"ratio {traj_c[-1] / floor:.5f} (no gate)")
    steps = np.diff(np.array([chi0] + traj_c))
    if not (np.all(np.isfinite(traj_c)) and np.all(steps <= 0)
            and traj_c[-1] < chi0):
        raise AssertionError(f"Chebyshev path: chi2 not finite, increasing "
                             f"or not below chi2_0 {chi0}: {traj_c}")
    _, plain_c = plain_route(alg_c, pattern_c, state_c["ni"], **cheb_pcg)
    np.testing.assert_allclose(traj_c[:3], plain_c, rtol=PLAIN_ROUTE_RTOL)
    print("phase 4b plain route: first 3 chi2 "
          + " ".join(f"{c:.2f}" for c in plain_c) + " vs kernel route "
          + " ".join(f"{c:.2f}" for c in traj_c[:3])
          + f" (rtol {PLAIN_ROUTE_RTOL:g}) OK")
    prob3 = probs["se3_float32"]
    del probs, prob, st, state, state_c

    # 4c. the probe's comparison on the probe's data: an SpMV composed of
    # the lane gather and a multiply-sum equals the fused kernel A
    r = np.random.default_rng(0)
    Np, Kp = 3500, 10
    nb_np = r.integers(0, Np, size=(Np, Kp)).astype(np.int32)
    xT = torch.as_tensor(r.normal(size=(8, Np)).astype(np.float32),
                         device=dev)
    idx = torch.as_tensor(np.broadcast_to(nb_np.reshape(1, -1),
                                          (8, Np * Kp)).copy(), device=dev)
    V = torch.as_tensor(r.normal(size=(9, Np, Kp)).astype(np.float32),
                        device=dev)
    kernels.reset_launch_counts()
    xg = gather.lane_gather(xT, idx)[:3].view(3, Np, Kp)
    y_gather = (V.view(3, 3, Np, Kp) * xg[None]).sum(dim=(1, 3))
    y_fused = spmv.block_ell_spmv(
        torch.as_tensor(nb_np.T.copy(), device=dev),
        V.permute(2, 0, 1).contiguous(), xT[:3].contiguous())
    counts_probe = read_counts()
    abs_e, rel_e = _errors(torch, y_gather, y_fused)
    print(f"phase 4c probe path: lane_gather + multiply-sum vs kernel A at "
          f"N={Np} K={Kp} float32: max_abs_err {abs_e:.3e} max_rel_err "
          f"{rel_e:.3e} (tol {TOL_DEFAULT['float32']:g})")
    if rel_e > TOL_DEFAULT["float32"]:
        raise AssertionError("the gather-composed SpMV disagrees with "
                             "kernel A")
    # device time of the two probe kernels at the probe's shape (20 launches
    # each under torch.profiler, after the path's counts were read)
    from torch.profiler import ProfilerActivity, profile
    nb_probe = torch.as_tensor(nb_np.T.copy(), device=dev)
    V_probe = V.permute(2, 0, 1).contiguous()
    x_probe = xT[:3].contiguous()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_probe:
        for _ in range(20):
            gather.lane_gather(xT, idx)
            spmv.block_ell_spmv(nb_probe, V_probe, x_probe)
        torch.cuda.synchronize()
    probe_us = {e.key.split("(")[0].split("::")[-1].split("<")[0]:
                e.self_device_time_total / e.count
                for e in prof_probe.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.count == 20 and "g2o_torch" in e.key}
    if set(probe_us) != {"lane_gather_kernel", "block_ell_spmv_kernel"}:
        raise AssertionError(f"the probe profile saw {probe_us}")
    print("phase 4c device time per launch at the probe's shape "
          "(torch.profiler, 20 launches each): "
          + ", ".join(f"{k} {v:.2f} us" for k, v in sorted(probe_us.items()))
          + f" [{card}]")
    del prof_probe, nb_probe, V_probe

    # 4d. the dense path at full size: the default algorithm and GN
    dprob = world.compile()                   # default device, float64
    T = dprob.static.total_dim
    if dprob.device.type != "cuda" or dprob.dtype != torch.float64 \
            or T < 8000:
        raise AssertionError(f"dense path: {dprob.device} {dprob.dtype} T={T}")
    by_type = " ".join(f"{eg.key}={eg.count}" for eg in dprob.static.egroups)
    chi0_d = float(robust_chi2(dprob))
    optimize(dprob, iterations=1)             # cuSOLVER's first call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_lm = time.monotonic()
    lm_out, lm_stats = optimize(dprob)        # LevenbergMarquardt, 10 its
    t_lm = time.monotonic() - t_lm
    t_gn = time.monotonic()
    _, gn_stats = optimize(dprob, GaussNewton(), iterations=5)
    t_gn = time.monotonic() - t_gn
    counts_dense = read_counts()    # the dense path's launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lm_chi = [st_["chi2"] for st_ in lm_stats]
    gn_chi = [st_["chi2"] for st_ in gn_stats]
    trials = sum(st_["levenberg_iters"] for st_ in lm_stats)
    print(f"phase 4d dense path: Simulator2D({DENSE_WORLD}).simulate("
          f"{DENSE_POSES}) in {t_sim:.2f} s on the host; T={T} "
          f"({dprob.static.vgroups[0].count} poses, "
          f"{dprob.static.vgroups[1].count} landmarks) {by_type} float64; "
          f"chi2_0 {chi0_d:.1f}; LM 10 iterations {t_lm * 100:.2f} ms/"
          f"iteration ({trials} trials), GN 5 iterations "
          f"{t_gn * 200:.2f} ms/iteration; peak memory {peak_gb:.2f} GB "
          f"[{card}]")
    print("phase 4d LM chi2: " + " ".join(f"{c:.4f}" for c in lm_chi))
    print("phase 4d GN chi2: " + " ".join(f"{c:.4f}" for c in gn_chi))
    steps_d = np.diff(np.array([chi0_d] + lm_chi))
    # a step at the converged plateau (gain below 1e-10 of chi2) may be
    # rejected on rounding noise; every other step must be accepted
    gaining = -steps_d > 1e-10 * np.array(lm_chi)
    bad_ok = [i for i, st_ in enumerate(lm_stats)
              if not st_["ok"] and (i == 0 or gaining[i - 1])]
    if not (np.all(np.isfinite(lm_chi)) and np.all(steps_d <= 0)) or bad_ok \
            or not all(st_["ok"] for st_ in gn_stats):
        raise AssertionError(f"dense path: chi2 increased or a step failed: "
                             f"{lm_stats} {gn_stats}")
    gap = abs(lm_chi[-1] - gn_chi[-1]) / gn_chi[-1]
    if not gap <= 1e-6:
        raise AssertionError(f"dense path: LM {lm_chi[-1]} and GN "
                             f"{gn_chi[-1]} differ by {gap:.3e}")
    with plain_versions():
        _, plain_stats = optimize(dprob)
    np.testing.assert_allclose(lm_chi, [st_["chi2"] for st_ in plain_stats],
                               rtol=DENSE_ROUTE_RTOL)
    live = int(np.argmin(gaining)) if not gaining.all() else len(gaining)
    if ([st_["levenberg_iters"] for st_ in plain_stats[:live]]
            != [st_["levenberg_iters"] for st_ in lm_stats[:live]]):
        raise AssertionError("dense path: the plain route took other trials")
    lm_again, again_stats = optimize(dprob)
    if [st_["chi2"] for st_ in again_stats] != lm_chi or not all(
            torch.equal(lm_again.params[k], lm_out.params[k])
            for k in lm_out.params):
        raise AssertionError("dense path: a second run gave other bits")
    lin_d = {k: counts_dense[k] for k in ("edge_lin_se2", "edge_lin_se2_xy")}
    if min(lin_d.values()) <= 0:
        raise AssertionError(f"phase 4d: K17 did not launch: {lin_d}")
    print(f"phase 4d checks: LM chi2 never increases, every gaining step "
          f"accepted; |LM - GN| / GN = {gap:.3e} (<= 1e-6); plain route "
          f"equal to rtol {DENSE_ROUTE_RTOL:g} with the same trials while "
          f"gaining; second run bit-identical; K17 launches {lin_d} OK")
    del lm_again, plain_stats

    def dense_split(phase, dprob_, dpat_):
        """The split of one dense LM iteration at the start (CUDA events,
        median of 5): linearize, assemble (K15), factor + solve (cuSOLVER,
        with the clone of H it starts from), retract + chi2; printed and
        returned in ms."""
        lam_d = LevenbergMarquardt().init(dprob_)["lam"]
        free_d = problem_mod.tangent_masks(dprob_)[0]
        holder = {}

        def t_linearize():
            holder["lin"] = problem_mod.linearize(dprob_)

        def t_assemble():
            holder["H"], holder["b"], _ = problem_mod.build_dense_system(
                dprob_, lin=holder["lin"], pattern=dpat_)

        def t_solve():
            damped = holder["H"].clone()
            damped.diagonal().add_(lam_d * free_d)
            holder["dx"], _ = solve_dense_cholesky(damped, holder["b"])

        def t_clone():
            holder["H"].clone()

        def t_retract():
            robust_chi2(dprob_, problem_mod.apply_update(dprob_,
                                                         holder["dx"]))

        split_ms = {}
        for label, fn in (("linearize", t_linearize),
                          ("assemble", t_assemble),
                          ("factor+solve", t_solve),
                          ("of which clone", t_clone),
                          ("retract+chi2", t_retract)):
            split_ms[label] = _median_ms(torch, fn, repeats=5, inner=1,
                                         warmup=1)
        print(f"phase {phase} split of one LM iteration (CUDA events, "
              f"median of 5): "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in split_ms.items())
              + f" [{card}]")
        return split_ms

    # the split of one LM iteration at the start
    dpat = dense_assemble.build_dense_pattern(dprob)
    dense_split("4d", dprob, dpat)
    dense_trial_split("4d", dprob, dpat)
    del lm_out, dpat

    def dense_profile(dprob_, phase, also=()):
        """Where the device's time goes in 3 LM iterations of the dense
        route (torch.profiler; the device-typed rows are the kernels and
        copies): prints the busy time, the idle share, the 12 largest rows
        and every row whose name holds one of `also`."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_prof = time.monotonic()
            optimize(dprob_, iterations=3)
            torch.cuda.synchronize()
            t_prof = (time.monotonic() - t_prof) * 1e3
        dev_rows = sorted(
            ((e.self_device_time_total / 1e3, e.count, e.key)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0), reverse=True)
        busy = sum(r[0] for r in dev_rows)
        if busy <= 0:
            raise AssertionError("torch.profiler reported no device time")
        print(f"phase {phase} profile of 3 LM iterations with lambda init: "
              f"wall {t_prof:.2f} ms, device busy {busy:.2f} ms in "
              f"{sum(r[1] for r in dev_rows)} kernels and copies, idle share "
              f"{100 * (1 - busy / t_prof):.1f}% [{card}]")
        for i, (ms, count, key) in enumerate(dev_rows):
            if i < 12 or any(word in key for word in also):
                print(f"  device {ms:8.3f} ms {count:5d} calls "
                      f"{ms / count * 1e3:9.2f} us/call  {key[:80]}")

    dense_profile(dprob, "4d")
    del dprob

    # 4e. the SE3 main path at full width: the sphere through the same entry
    # points, on the schedule of the JAX package's sphere benchmark (lambda
    # init, 6 windows of 10 at pcg 200 / tol 0.05, then warm polish windows
    # of 5 at pcg 600 / tol 1e-6)
    def sphere_path(prob_s, what, n_polish):
        """Run the schedule on one sphere problem and check that chi2 is
        finite, never increases and ends below chi2_0. Returns a dict:
        traj (chi2 per iteration), win_ms (ms per LM iteration per window),
        per_window ((CG iterations, trials, CG cap) per window, from the
        launch counts), counts (launches), st (final params, lambda, nu,
        chi2), state (at init), pattern, alg, init_s, seconds."""
        pcg_s = dict(pcg_iters=200, pcg_tol=0.05)
        alg_s = LevenbergMarquardtPCG(**pcg_s)
        state_s, pattern_s, init_t, t0_s = start(alg_s, prob_s)
        st_s = (state_s["params"], state_s["lam"], state_s["ni"],
                state_s["chi2"])
        traj_s, win_ms, per_window = [], [], []
        schedule = [(10, pcg_s)] * 6 + [
            (5, dict(pcg_iters=600, pcg_tol=1e-6, warm=True))] * n_polish
        for n_it, kw in schedule:
            seen = read_counts()
            st_s, t_, dt_w = window(pattern_s, st_s, n_it, prob_s, **kw)
            now = read_counts()
            traj_s += t_
            win_ms.append(dt_w / n_it * 1e3)
            per_window.append((now["cg_update_xr"] - seen["cg_update_xr"],
                               now["damp_chol"] - seen["damp_chol"],
                               kw["pcg_iters"]))
        seconds = time.monotonic() - t0_s
        counts_s = read_counts()
        chi0_s = float(state_s["chi2"])
        steps_s = np.diff(np.array([chi0_s] + traj_s))
        if not (np.all(np.isfinite(traj_s)) and np.all(steps_s <= 0)
                and traj_s[-1] < chi0_s):
            raise AssertionError(f"{what}: chi2 not finite, increasing or "
                                 f"not below chi2_0 {chi0_s}: {traj_s}")
        return dict(traj=traj_s, win_ms=win_ms, per_window=per_window,
                    counts=counts_s, st=st_s, state=state_s,
                    pattern=pattern_s, alg=alg_s, init_s=init_t,
                    seconds=seconds)

    E3 = prob3.static.egroups[0].count
    N3 = prob3.static.vgroups[0].count
    floor3 = 6.0 * E3 - 6.0 * (N3 - 1)
    run3 = sphere_path(prob3, "sphere path", SPHERE_POLISH_WINDOWS)
    traj3, win3, counts_sphere = run3["traj"], run3["win_ms"], run3["counts"]
    st3, state3, pattern3 = run3["st"], run3["state"], run3["pattern"]
    alg3, init3, secs3 = run3["alg"], run3["init_s"], run3["seconds"]
    final3 = float(st3[3])
    cg3 = counts_sphere["cg_update_xr"]
    two_launch_step("phase 4e sphere path", counts_sphere)
    print(f"phase 4e SE3 main path: create_sphere({SPHERE}) in "
          f"{t_sphere:.2f} s on the host; {N3} poses {E3} edges "
          f"K={pattern3.k} 6x6 blocks float32, values "
          f"{pattern3.k * 36 * N3 * 4 / 1e6:.1f} MB; init+lambda0 "
          f"{init3:.3f} s lambda0 {float(state3['lam']):.6g} chi2_0 "
          f"{float(state3['chi2']):.1f}; 6 windows of 10 (pcg 200, tol "
          f"0.05): {' '.join(f'{w:.2f}' for w in win3[:6])} ms/LM iteration; "
          f"{SPHERE_POLISH_WINDOWS} polish windows of 5 (pcg 600, tol 1e-6, "
          f"warm): {' '.join(f'{w:.2f}' for w in win3[6:])} ms/LM iteration; "
          f"{cg3} CG iterations; total {secs3:.2f} s [{card}]")
    print("phase 4e chi2 trajectory: "
          + " ".join(f"{c:.1f}" for c in traj3))
    print("phase 4e CG iterations / trials (cap per trial) per window: "
          + " ".join(f"{c}/{t_}({cap})" for c, t_, cap in run3["per_window"]))
    # the cause of the slow tail, held in the run: from the third window on
    # every trial's CG ends at its cap, not at its tolerance
    uncapped = [i for i, (c, t_, cap) in enumerate(run3["per_window"])
                if i >= 2 and c != t_ * cap]
    if uncapped:
        raise AssertionError(f"sphere path: CG ended below its cap in "
                             f"windows {uncapped}: {run3['per_window']}")
    print(f"phase 4e final chi2 {final3:.1f} expected 6E - 6(N - 1) = "
          f"{floor3:.1f} ratio {final3 / floor3:.5f} after the fixed "
          f"schedule (gate {SPHERE_GATE}); after the six windows "
          f"{traj3[59] / floor3:.5f}")
    if final3 > SPHERE_GATE * floor3:
        raise AssertionError(f"sphere chi2 {final3} above {SPHERE_GATE} x "
                             f"{floor3}")
    lam_p3, plain3 = plain_route(alg3, pattern3, state3["ni"], prob3,
                                 pcg_iters=200, pcg_tol=0.05)
    np.testing.assert_allclose(traj3[:3], plain3, rtol=PLAIN_ROUTE_RTOL)
    np.testing.assert_allclose(lam_p3, float(state3["lam"]),
                               rtol=PLAIN_ROUTE_RTOL)
    print("phase 4e plain route: first 3 chi2 "
          + " ".join(f"{c:.2f}" for c in plain3) + " vs kernel route "
          + " ".join(f"{c:.2f}" for c in traj3[:3])
          + f" (rtol {PLAIN_ROUTE_RTOL:g}) OK")
    # K16 + C per linearization and K7 per trial at the final state (CUDA
    # events, one call per event pair, median of 9), outside the counted path
    work3 = prob3.with_params(st3[0])
    k16_ms = _median_ms(torch, lambda: _pcg_precomp(work3, pattern3),
                        repeats=9, inner=1)
    pre3 = _pcg_precomp(work3, pattern3)
    dx3, ok3 = _pcg_trial(work3, pattern3, pre3, st3[1], None, 200, 0.05, 0)
    before = read_counts()
    k7_ms3 = _median_ms(torch, lambda: _trial_outcome(
        work3, pattern3, pre3["bT"], dx3, ok3, st3[1], st3[2], st3[3]),
        repeats=9, inner=1)
    k7_calls3 = {k: (v - before[k]) // 12 for k, v in
                 read_counts().items() if v != before[k]}
    print(f"phase 4e K16 + C: linearize + assemble {k16_ms:.4f} ms per "
          f"linearization; K7: retract + chi2 + outcome {k7_ms3:.4f} ms per "
          f"trial, wrapper calls per trial {k7_calls3} (CUDA events, median "
          f"of 9) [{card}]")
    if k7_calls3 != {"retract_se3": 1, "se3_edge_chi2": 1, "lm_outcome": 1}:
        raise AssertionError(f"an SE3 trial's outcome launched {k7_calls3}")
    # the same sphere with pcg_cheby=4: one window of 10 from the start
    cheb3 = dict(pcg_iters=200, pcg_tol=0.05, pcg_cheby=4)
    alg_c3 = LevenbergMarquardtPCG(**cheb3)
    state_c3, pattern_c3, _, _ = start(alg_c3, prob3)
    st_c3 = (state_c3["params"], state_c3["lam"], state_c3["ni"],
             state_c3["chi2"])
    st_c3, traj_c3, dt_c3 = window(pattern_c3, st_c3, 10, prob3, **cheb3)
    counts_sphere_cheb = read_counts()
    steps_c3 = np.diff(np.array([float(state_c3["chi2"])] + traj_c3))
    if not (np.all(np.isfinite(traj_c3)) and np.all(steps_c3 <= 0)):
        raise AssertionError(f"sphere Chebyshev path: chi2 not finite or "
                             f"increasing: {traj_c3}")
    _, plain_c3 = plain_route(alg_c3, pattern_c3, state_c3["ni"], prob3,
                              **cheb3)
    np.testing.assert_allclose(traj_c3[:3], plain_c3, rtol=PLAIN_ROUTE_RTOL)
    matvecs_c3 = (counts_sphere_cheb["block_ell_spmv"]
                  + counts_sphere_cheb["spmv_dot"])
    print(f"phase 4e Chebyshev (pcg_cheby 4, pcg 200, tol 0.05): one window "
          f"of 10: {dt_c3 * 100:.2f} ms/LM iteration, "
          f"{counts_sphere_cheb['cg_update_xr']} outer CG iterations, "
          f"{matvecs_c3} matvecs; chi2 "
          + " ".join(f"{c:.1f}" for c in traj_c3)
          + f"; first 3 equal to the plain route (rtol {PLAIN_ROUTE_RTOL:g}) "
          f"[{card}] OK")
    del work3, pre3, dx3, prob3, run3, st3, state3, pattern3, st_c3, state_c3

    # the same schedule in float64: the slow tail is the truncated solves',
    # not float32's
    run64 = sphere_path(sphere.compile(dtype=torch.float64),
                        "sphere path in float64", SPHERE_POLISH_WINDOWS)
    traj64 = run64["traj"]
    two_launch_step("phase 4e sphere path in float64", run64["counts"])
    print(f"phase 4e in float64, same schedule: chi2 / expected "
          f"{traj64[59] / floor3:.5f} after the six windows, "
          f"{traj64[-1] / floor3:.5f} after {SPHERE_POLISH_WINDOWS} polish "
          f"windows (float32: {traj3[59] / floor3:.5f}, "
          f"{final3 / floor3:.5f}); CG iterations / trials per window "
          + " ".join(f"{c}/{t_}" for c, t_, _ in run64["per_window"])
          + f"; total {run64['seconds']:.2f} s [{card}]")
    if traj64[-1] > SPHERE_GATE * floor3:
        raise AssertionError(f"sphere chi2 in float64 {traj64[-1]} above "
                             f"{SPHERE_GATE} x {floor3}")
    del run64, sphere

    bench_prob = create_sphere(**SPHERE_BENCH)[0].compile(dtype=torch.float32)
    run_b = sphere_path(bench_prob, "benchmark-shaped sphere", 6)
    traj_b, win_b = run_b["traj"], run_b["win_ms"]
    counts_bench = run_b["counts"]
    two_launch_step("phase 4e benchmark-shaped sphere", counts_bench)
    state_b, secs_b = run_b["state"], run_b["seconds"]
    print(f"phase 4e benchmark shape: create_sphere({SPHERE_BENCH}), default "
          f"noise, {bench_prob.static.vgroups[0].count} poses "
          f"{bench_prob.static.egroups[0].count} edges float32: chi2_0 "
          f"{float(state_b['chi2']):.1f}; 6 windows of 10: "
          f"{' '.join(f'{w:.2f}' for w in win_b[:6])} ms/LM iteration; 6 "
          f"polish windows of 5: {' '.join(f'{w:.2f}' for w in win_b[6:])} "
          f"ms/LM iteration; total {secs_b:.2f} s [{card}]")
    print("phase 4e benchmark shape chi2 trajectory: "
          + " ".join(f"{c:.1f}" for c in traj_b))
    del bench_prob, run_b, state_b

    # 4f. the dense route on 3D: poses, XYZ landmarks and the offset
    # parameter through the default algorithm and GN, K15 at width 6
    dprob3 = world3.compile()                 # default device, float64
    T3 = dprob3.static.total_dim
    if dprob3.device.type != "cuda" or dprob3.dtype != torch.float64 \
            or T3 < 8000:
        raise AssertionError(f"dense 3D path: {dprob3.device} {dprob3.dtype} "
                             f"T={T3}")
    by_type3 = " ".join(f"{eg.key}={eg.count}"
                        for eg in dprob3.static.egroups)
    chi0_3 = float(robust_chi2(dprob3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_lm3 = time.monotonic()
    lm_out3, lm_stats3 = optimize(dprob3)     # LevenbergMarquardt, 10 its
    t_lm3 = time.monotonic() - t_lm3
    t_gn3 = time.monotonic()
    _, gn_stats3 = optimize(dprob3, GaussNewton(), iterations=5)
    t_gn3 = time.monotonic() - t_gn3
    counts_dense3 = read_counts()
    peak3 = torch.cuda.max_memory_allocated() / 1e9
    lm_chi3 = [st_["chi2"] for st_ in lm_stats3]
    gn_chi3 = [st_["chi2"] for st_ in gn_stats3]
    print(f"phase 4f dense 3D path: Simulator3D({DENSE3_WORLD}).simulate("
          f"{DENSE3_POSES}) in {t_sim3:.2f} s on the host; T={T3} "
          f"({dprob3.static.vgroups[0].count} poses, "
          f"{dprob3.static.vgroups[1].count} landmarks) {by_type3} float64; "
          f"chi2_0 {chi0_3:.1f}; LM 10 iterations {t_lm3 * 100:.2f} ms/"
          f"iteration ({sum(st_['levenberg_iters'] for st_ in lm_stats3)} "
          f"trials), GN 5 iterations {t_gn3 * 200:.2f} ms/iteration; peak "
          f"memory {peak3:.2f} GB [{card}]")
    print("phase 4f LM chi2: " + " ".join(f"{c:.4f}" for c in lm_chi3))
    print("phase 4f GN chi2: " + " ".join(f"{c:.4f}" for c in gn_chi3))
    steps_3 = np.diff(np.array([chi0_3] + lm_chi3))
    gaining3 = -steps_3 > 1e-10 * np.array(lm_chi3)
    bad_ok3 = [i for i, st_ in enumerate(lm_stats3)
               if not st_["ok"] and (i == 0 or gaining3[i - 1])]
    if not (np.all(np.isfinite(lm_chi3)) and np.all(steps_3 <= 0)) \
            or bad_ok3 or not all(st_["ok"] for st_ in gn_stats3):
        raise AssertionError(f"dense 3D path: chi2 increased or a step "
                             f"failed: {lm_stats3} {gn_stats3}")
    gap3 = abs(lm_chi3[-1] - gn_chi3[-1]) / gn_chi3[-1]
    if not gap3 <= 1e-6:
        raise AssertionError(f"dense 3D path: LM {lm_chi3[-1]} and GN "
                             f"{gn_chi3[-1]} differ by {gap3:.3e}")
    with plain_versions():
        _, plain_stats3 = optimize(dprob3)
    np.testing.assert_allclose(lm_chi3,
                               [st_["chi2"] for st_ in plain_stats3],
                               rtol=DENSE_ROUTE_RTOL)
    lm_again3, again_stats3 = optimize(dprob3)
    if [st_["chi2"] for st_ in again_stats3] != lm_chi3 or not all(
            torch.equal(lm_again3.params[k], lm_out3.params[k])
            for k in lm_out3.params):
        raise AssertionError("dense 3D path: a second run gave other bits")
    holder3 = {}
    dpat3 = dense_assemble.build_dense_pattern(dprob3)

    def t_linearize3():
        holder3["lin"] = problem_mod.linearize(dprob3)

    def t_assemble3():
        problem_mod.build_dense_system(dprob3, lin=holder3["lin"],
                                       pattern=dpat3)

    split3 = {label: _median_ms(torch, fn, repeats=5, inner=1, warmup=1)
              for label, fn in (("linearize", t_linearize3),
                                ("assemble", t_assemble3))}
    lin3 = {k: counts_dense3[k] for k in ("edge_lin_se3", "edge_lin_se3_xyz")}
    if min(lin3.values()) <= 0:
        raise AssertionError(f"phase 4f: K17 did not launch: {lin3}")
    print(f"phase 4f checks: LM chi2 never increases, every gaining step "
          f"accepted; |LM - GN| / GN = {gap3:.3e} (<= 1e-6); plain route "
          f"equal to rtol {DENSE_ROUTE_RTOL:g}; second run bit-identical; "
          f"K17 launches {lin3}; split (CUDA events, median of 5): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in split3.items())
          + f" [{card}] OK")
    dense_trial_split("4f", dprob3, dpat3)
    del lm_out3, lm_again3, holder3, dpat3, plain_stats3
    dense_profile(dprob3, "4f", also=("dense_pair",))
    del dprob3

    # 4g / 4h. Schur bundle adjustment at the JAX bench's two BAL shapes:
    # lambda init, one warm-up trial, 10 iterations through
    # ba_ell_optimize_fused (one trial per iteration), then the same 10
    # iterations from the same start through ba_ell_step
    ell_traj = {}

    def ba_path(phase, shape, dense):
        n_cams, n_points = shape
        t_gen = time.monotonic()
        bprob, bgt = synthetic_bal_problem(n_cams, n_points, BA_OBS,
                                           dtype=torch.float32)
        t_gen = time.monotonic() - t_gen
        if bprob.device.type != "cuda":
            raise AssertionError("the BAL problem is not on the card")
        E = bgt["n_obs"]
        expected = 2.0 * E - 6.0 * (n_cams - 1) - 3.0 * n_points
        alg = ba_ell.LevenbergMarquardtSchurELL(**BA_PCG)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        state = alg.init(bprob)
        pattern = alg.pattern(bprob)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        if ba_ell.dense_schur_ok(bprob, pattern) != dense:
            raise AssertionError(f"phase {phase}: the route is not the "
                                 f"{'dense' if dense else 'implicit'} one")
        st0 = (state["params"], state["lam"], state["ni"], state["chi2"])
        chi0 = float(state["chi2"])
        # one trial first, its result dropped: the first factorization in
        # this dtype sets cuSOLVER up, which the timed window should not hold
        ba_ell.ba_ell_optimize_fused(bprob, pattern, *st0, n_iters=1,
                                     **BA_PCG)
        torch.cuda.synchronize()
        cg_w = read_counts()["cg_update_xr"]
        t1 = time.monotonic()
        out = ba_ell.ba_ell_optimize_fused(bprob, pattern, *st0, n_iters=10,
                                           **BA_PCG)
        torch.cuda.synchronize()
        fused_ms = (time.monotonic() - t1) * 100
        counts_f = read_counts()
        traj = out[4].tolist()
        ell_traj[phase] = (traj, expected)
        st, step_traj, n_trials = st0, [], 0
        t2 = time.monotonic()
        for _ in range(10):
            params_, lam_, ni_, chi_, tr_, _ = ba_ell.ba_ell_step(
                bprob, pattern, *st, **BA_PCG)
            st = (params_, lam_, ni_, chi_)
            step_traj.append(chi_)
            n_trials += tr_
        torch.cuda.synchronize()
        step_ms = (time.monotonic() - t2) * 100
        counts_b = read_counts()
        step_traj = [float(c) for c in step_traj]
        cg_f = counts_f["cg_update_xr"] - cg_w
        cg_b = counts_b["cg_update_xr"] - counts_f["cg_update_xr"]
        print(f"phase {phase} BA {'dense-Schur' if dense else 'implicit'} "
              f"route: synthetic_bal_problem({n_cams}, {n_points}, {BA_OBS}) "
              f"in {t_gen:.2f} s on the host; E={E} "
              f"K_l={pattern.lm_edge.shape[0]} "
              f"Tp={pattern.pose_dim} float32, pcg {BA_PCG['pcg_iters']} tol "
              f"{BA_PCG['pcg_tol']}; init+lambda0 {init_s:.3f} s lambda0 "
              f"{float(state['lam']):.6g} chi2_0 {chi0:.1f}; "
              f"ba_ell_optimize_fused {fused_ms:.3f} ms/LM iteration (10 "
              f"trials, {cg_f} CG iterations, {cg_f / 10:.1f} per trial); "
              f"ba_ell_step {step_ms:.3f} ms/LM iteration ({n_trials} trials, "
              f"{cg_b} CG iterations) [{card}]")
        print(f"phase {phase} chi2 fused: "
              + " ".join(f"{c:.1f}" for c in traj))
        print(f"phase {phase} chi2 step:  "
              + " ".join(f"{c:.1f}" for c in step_traj))
        for what, tr in (("fused", traj), ("step", step_traj)):
            steps = np.diff(np.array([chi0] + tr))
            if not (np.all(np.isfinite(tr)) and np.all(steps <= 0)):
                raise AssertionError(f"phase {phase} {what}: chi2 not finite "
                                     f"or increasing: {tr}")
            if tr[-1] > BA_GATE * expected:
                raise AssertionError(f"phase {phase} {what}: chi2 {tr[-1]} "
                                     f"above {BA_GATE} x {expected}")
        print(f"phase {phase} final chi2 {traj[-1]:.1f} (step: "
              f"{step_traj[-1]:.1f}) expected 2E - 6(C - 1) - 3P = "
              f"{expected:.1f} ratio {traj[-1] / expected:.5f} (gate "
              f"{BA_GATE}); never increases")
        work_t = bprob.with_params(st0[0])
        schur_trial_split(phase, work_t, ba_ell._solve(
            work_t, pattern, ba_ell._build(work_t, pattern), st0[1],
            BA_PCG["pcg_iters"], BA_PCG["pcg_tol"]), st0[1])
        del work_t
        if dense:
            # K12 in the loop: one linearization and one trial's solve at
            # the end state, profiled: the pair kernel, the zero fill of S
            # and the record copies (W's in _build, Hinv's in the solve)
            work = bprob.with_params(st[0])
            solve_k = lambda sys_k: ba_ell._solve(
                work, pattern, sys_k, st[1], BA_PCG["pcg_iters"],
                BA_PCG["pcg_tol"])
            solve_k(ba_ell._build(work, pattern))
            torch.cuda.synchronize()
            # a profile can miss its records: up to 3 tries, each of which
            # must launch K12 once by its count
            for attempt in range(1, 4):
                k12_before = ba_schur.ba_schur_dense.launches
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof_k:
                    solve_k(ba_ell._build(work, pattern))
                    torch.cuda.synchronize()
                if ba_schur.ba_schur_dense.launches - k12_before != 1:
                    raise AssertionError(f"phase {phase}: the profiled "
                                         "solve did not launch K12 once")
                rows_k = [(e.self_device_time_total, e.count, e.key)
                          for e in prof_k.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and e.self_device_time_total > 0
                          and any(w_ in e.key for w_ in (
                              "ba_schur", "records", "zero_fill"))]
                if any("ba_schur_kernel" in k_ for _, _, k_ in rows_k):
                    break
            else:
                raise AssertionError(f"phase {phase}: the profiler saw no "
                                     "K12 launch in 3 tries")
            print(f"phase {phase} K12 in one linearization + trial solve "
                  f"(profiler, try {attempt}): " + "; ".join(
                      f"{k_[:48]} {us / n_:.2f} us x {n_}"
                      for us, n_, k_ in sorted(rows_k, reverse=True))
                  + f" [{card}]")
            del work
        used = ("ba_schur_dense",) if dense else ("ba_sandwich",
                                                  "lane_block_mv_dot")
        unused = "ba_sandwich" if dense else "ba_schur_dense"
        if min(counts_b[k] for k in used) <= 0 or counts_b[unused]:
            raise AssertionError(f"phase {phase}: the launches show another "
                                 f"route: {counts_b}")
        with plain_versions():
            alg_p = ba_ell.LevenbergMarquardtSchurELL(**BA_PCG)
            state_p = alg_p.init(bprob)
            out_p = ba_ell.ba_ell_optimize_fused(
                bprob, alg_p.pattern(bprob), state_p["params"],
                state_p["lam"], state_p["ni"], state_p["chi2"], n_iters=3,
                **BA_PCG)
        plain_traj = out_p[4].tolist()
        np.testing.assert_allclose(traj[:3], plain_traj, rtol=PLAIN_ROUTE_RTOL)
        np.testing.assert_allclose(float(state_p["lam"]), float(state["lam"]),
                                   rtol=PLAIN_ROUTE_RTOL)
        print(f"phase {phase} plain route: first 3 chi2 "
              + " ".join(f"{c:.2f}" for c in plain_traj) + " vs kernel route "
              + " ".join(f"{c:.2f}" for c in traj[:3])
              + f" (rtol {PLAIN_ROUTE_RTOL:g}) OK")
        del out, out_p, st, st0, state, state_p
        return bprob, pattern, counts_b

    ba80, _, counts_ba80 = ba_path("4g", BA_80K, True)
    del ba80
    torch.cuda.empty_cache()
    ba400, pattern400, counts_ba400 = ba_path("4h", BA_400K, False)
    del ba400, pattern400
    torch.cuda.empty_cache()

    # 4i. the landmark worlds of 4d and 4f through the Schur solver
    # (float64, 10 iterations): LevenbergMarquardtSchurELL() as the
    # predicate routes it (implicit), and on the dense-Schur route, against
    # the dense LM's end
    counts_4i = {}
    for world_g, lm_end, label in ((world, lm_chi[-1], "2D"),
                                   (world3, lm_chi3[-1], "3D")):
        wprob = world_g.compile()                 # default device, float64
        chi0_w = float(robust_chi2(wprob))
        kernels.reset_launch_counts()
        runs_w = {}
        routing = (ba_ell._DENSE_SCHUR_MAX_TP,
                   ba_ell._DENSE_SCHUR_MAX_OPERAND_BYTES)
        for name_w in ("implicit", "dense-Schur"):
            if name_w == "dense-Schur":
                ba_ell._DENSE_SCHUR_MAX_TP = 10 ** 9
                ba_ell._DENSE_SCHUR_MAX_OPERAND_BYTES = 1e15
            try:
                alg_w = ba_ell.LevenbergMarquardtSchurELL()
                if ba_ell.dense_schur_ok(wprob, alg_w.pattern(wprob)) != (
                        name_w == "dense-Schur"):
                    raise AssertionError(f"phase 4i {label}: not on the "
                                         f"{name_w} route")
                t_w = time.monotonic()
                _, wstats = optimize(wprob, alg_w, iterations=10)
                runs_w[name_w] = ([st_["chi2"] for st_ in wstats],
                                  (time.monotonic() - t_w) * 100,
                                  sum(st_["levenberg_iters"]
                                      for st_ in wstats))
            finally:
                (ba_ell._DENSE_SCHUR_MAX_TP,
                 ba_ell._DENSE_SCHUR_MAX_OPERAND_BYTES) = routing
            del alg_w
        counts_4i[label] = read_counts()
        pat_w = ba_ell.build_ba_ell_pattern(wprob)
        for name_w, (chis_w, ms_w, tr_w) in runs_w.items():
            steps_w = np.diff(np.array([chi0_w] + chis_w))
            if not (np.all(np.isfinite(chis_w)) and np.all(steps_w <= 0)):
                raise AssertionError(f"phase 4i {label} {name_w}: chi2 not "
                                     f"finite or increasing: {chis_w}")
            margin = (chis_w[-1] - lm_end) / lm_end
            print(f"phase 4i {label} world through "
                  f"LevenbergMarquardtSchurELL() on the {name_w} route, "
                  f"Tp={pat_w.pose_dim} "
                  f"L={pat_w.n_lm} K={pat_w.lm_edge.shape[0]} float64: "
                  f"{ms_w:.2f} ms/LM iteration ({tr_w} trials); chi2 "
                  + " ".join(f"{c:.4f}" for c in chis_w)
                  + f"; end {chis_w[-1]:.4f} vs dense LM {lm_end:.4f}: margin "
                  f"{100 * margin:+.4f}% [{card}]")
            if name_w == "dense-Schur" and abs(margin) > BA_WORLD_GATE:
                raise AssertionError(f"phase 4i {label}: the Schur LM ends "
                                     f"{margin:.3e} from the dense LM")
        if counts_4i[label]["ba_edge_blocks"] <= 0 or \
                counts_4i[label]["dense_assemble"] <= 0:
            raise AssertionError(f"phase 4i {label}: the generic entry or "
                                 f"K15 did not launch: {counts_4i[label]}")
        del wprob, pat_w
    torch.cuda.empty_cache()

    # 4j-4n. the general Schur path (core/ba.py, LevenbergMarquardtSchur
    # with its defaults: pcg 250, tol 1e-8, 10 trials) on the ba_80k
    # geometry as binary XYZ2UV (j), ternary PSI2UV (k) and ternary
    # P2MC_INTRINSICS with two pose groups (l), float32, lambda init + 10
    # iterations each; the routing of _SchurAuto and the anchored demo scene
    # against the JAX package's float64 end (m); the 400k BAL shape (n)
    def general_path(phase, what, gprob, expected, jax_key=None,
                     plain_route=True):
        """Lambda init + 10 iterations of LevenbergMarquardtSchur() on
        gprob: chi2 finite, never increasing, at most BA_GATE x expected;
        ms per LM iteration, CG iterations; one trial's solve timed on the
        host clock and profiled for its device time per CG iteration; K14's
        and K15's device time in one profiled schur_build; the first 3 chi2
        against the plain route (unless plain_route is False). Returns
        (trajectory, launches of the run, with K11's and lane_block_mv's
        at D = 4 also under "<wrapper>@d4")."""
        alg = ba_general.LevenbergMarquardtSchur()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        state = alg.init(gprob)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        pat = alg.pattern(gprob)
        chi0, lam0 = float(state["chi2"]), float(state["lam"])
        traj, n_trials, lams = [], 0, []
        t1 = time.monotonic()
        for _ in range(10):
            state, info = alg.step(gprob, state)
            traj.append(info["chi2"])
            lams.append(state["lam"])
            n_trials += info["levenberg_iters"]
        torch.cuda.synchronize()
        ms = (time.monotonic() - t1) * 100
        counts = read_counts()
        # the D = 4 launches (the intrinsics group's blocks) and the D = 9
        # ones (the BAL camera's) apart
        for w_ in (ba_inv.ba_block_inv, jacobi_scale.lane_block_mv,
                   jacobi_scale.lane_block_mv_dot):
            for d_ in (4, 6, 9):
                counts[f"{w_.__name__}@d{d_}"] = w_.launches_by_width[d_]
        n_groups = len(pat.pose_groups)
        cg_iters = counts["cg_update_xr"] // n_groups
        # one ba_wtx launch per S x (a solve's first product and one per CG
        # iteration) and per back-substitution, however many pose groups
        solves = counts["cg_finish"]
        if counts["ba_wtx"] != cg_iters + 2 * solves:
            raise AssertionError(
                f"phase {phase}: {counts['ba_wtx']} ba_wtx launches for "
                f"{cg_iters + solves} S x and {solves} back-substitutions "
                f"over {n_groups} pose groups")
        print(f"phase {phase} ba_wtx: {counts['ba_wtx']} launches, one per "
              f"S x ({cg_iters + solves}) and per back-substitution "
              f"({solves}), {n_groups} pose group(s)")
        steps = np.diff(np.array([chi0] + traj))
        if not (np.all(np.isfinite(traj)) and np.all(steps <= 0)):
            raise AssertionError(f"phase {phase}: chi2 not finite or "
                                 f"increasing: {traj}")
        print(f"phase {phase} general Schur path, {what}: Tp={pat.pose_dim} "
              f"pose groups {[(pg.name, pg.dim, pg.count, pg.n_entries) for pg in pat.pose_groups]} "
              f"L={pat.n_lm} landmark edges {pat.n_lm_edges} {gprob.dtype}; "
              f"LevenbergMarquardtSchur() (pcg 250, tol 1e-8): init+lambda0 "
              f"{init_s:.3f} s lambda0 {lam0:.6g} chi2_0 {chi0:.1f}; "
              f"{ms:.2f} ms/LM iteration ({n_trials} trials, {cg_iters} CG "
              f"iterations) [{card}]")
        print(f"phase {phase} chi2 / expected ({expected:.1f}): "
              + " ".join(f"{c / expected:.5f}" for c in traj))
        if jax_key is not None:
            print(f"phase {phase} the JAX package, float64 on the CPU: "
                  + " ".join(f"{c:.5f}" for c in JAX_SCHUR_TRAJ[jax_key]))
        if traj[-1] > BA_GATE * expected:
            raise AssertionError(f"phase {phase}: chi2 {traj[-1]} above "
                                 f"{BA_GATE} x {expected}")
        # one trial's solve at the end state with the lambda of the third
        # iteration (while chi2 still gains: a float32 run past convergence
        # can end at lambda inf): host clock, then device time
        work = gprob.with_params(state["params"])
        sys_ = ba_general.schur_build(work, pattern=pat)
        lam_t = lams[2]
        # one build split: linearize against the rest of schur_build
        lin_w = problem_mod.linearize(work)
        split_g = {
            "linearize": _median_ms(
                torch, lambda: problem_mod.linearize(work), 5, 1, 1),
            "schur_build without linearize": _median_ms(
                torch, lambda: ba_general.schur_build(work, lin=lin_w,
                                                      pattern=pat), 5, 1, 1)}
        del lin_w
        schur_trial_split(phase, work, ba_general._solve(
            work, sys_, lam_t, 250, 1e-8), lam_t)
        ba_general._solve(work, sys_, lam_t, 250, 1e-8)
        torch.cuda.synchronize()
        before = read_counts()["cg_update_xr"]
        t2 = time.monotonic()
        ba_general._solve(work, sys_, lam_t, 250, 1e-8)
        torch.cuda.synchronize()
        wall = (time.monotonic() - t2) * 1e6
        n_cg = max((read_counts()["cg_update_xr"] - before)
                   // n_groups, 1)
        # a profile opened after another can lose records: one that saw
        # fewer ba_wv or ba_sandwich kernels than the wrappers launched is
        # taken once more (the checks below hold the profile taken). The
        # phase's launch counts were read after its 10 iterations, above:
        # no solve of these profiles is in them
        for attempt in range(2):
            wv_calls = ba_coupling.ba_wv.launches
            sandwich_calls = ba_coupling.ba_sandwich.launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof_g:
                ba_general._solve(work, sys_, lam_t, 250, 1e-8)
                torch.cuda.synchronize()
            wv_calls = ba_coupling.ba_wv.launches - wv_calls
            sandwich_calls = (ba_coupling.ba_sandwich.launches
                              - sandwich_calls)
            rows_g = sorted(((e.self_device_time_total, e.count, e.key)
                             for e in prof_g.key_averages()
                             if e.device_type
                             == torch.autograd.DeviceType.CUDA
                             and e.self_device_time_total > 0),
                            reverse=True)
            seen = [sum(n_ for _, n_, k_ in rows_g if name_ in k_)
                    for name_ in ("ba_wv", "ba_sandwich")]
            if seen[0] >= wv_calls and seen[1] >= sandwich_calls:
                break
            print(f"phase {phase} the profiler saw {seen[0]} ba_wv and "
                  f"{seen[1]} ba_sandwich kernels in {wv_calls} and "
                  f"{sandwich_calls} calls (records lost); profile "
                  f"{'taken again' if attempt == 0 else 'kept'}")
        # kernels per ba_wv call, to the nearest integer (a profile can
        # miss a record)
        wv_kernels = sum(n_ for _, n_, k_ in rows_g if "ba_wv" in k_)
        per_call = round(wv_kernels / max(wv_calls, 1))
        print(f"phase {phase} ba_wv in that solve: {per_call} launch per "
              f"call ({wv_kernels} kernels seen by the profiler in "
              f"{wv_calls} calls)")
        if wv_calls <= 0 or per_call != 1:
            raise AssertionError(f"phase {phase}: ba_wv launched "
                                 f"{wv_kernels} kernels in {wv_calls} calls")
        # and ba_sandwich, one kernel a call since its vertex pass went
        sandwich_kernels = sum(n_ for _, n_, k_ in rows_g
                               if "ba_sandwich" in k_)
        print(f"phase {phase} ba_sandwich in that solve: {sandwich_kernels} "
              f"kernels in {sandwich_calls} calls")
        if (sandwich_calls <= 0
                or round(sandwich_kernels / sandwich_calls) != 1):
            raise AssertionError(f"phase {phase}: ba_sandwich launched "
                                 f"{sandwich_kernels} kernels in "
                                 f"{sandwich_calls} calls")
        busy = sum(r[0] for r in rows_g)
        if busy <= 0:
            raise AssertionError(f"phase {phase}: the profiler saw no "
                                 "device time")
        # and one linearization + build (schur_build), for its kernels;
        # taken once more where the profile lost K14's records
        for attempt in range(2):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof_b:
                ba_general.schur_build(work, pattern=pat)
                torch.cuda.synchronize()
            rows_b = sorted(((e.self_device_time_total, e.count, e.key)
                             for e in prof_b.key_averages()
                             if e.device_type
                             == torch.autograd.DeviceType.CUDA
                             and e.self_device_time_total > 0),
                            reverse=True)
            if any("schur_tile" in k_ for _, _, k_ in rows_b):
                break
            print(f"phase {phase} the profiler saw no K14 kernel in one "
                  f"schur_build (records lost); profile "
                  f"{'taken again' if attempt == 0 else 'kept'}")
        for what_p, rows_p in (
                ("the solve", rows_g[:8] + [r for r in rows_g[8:]
                                            if "sandwich" in r[2]]),
                ("schur_build", rows_b[:6] + [r for r in rows_b[6:]
                                              if "dense_pair" in r[2]])):
            print(f"phase {phase} device time by kernel in {what_p}: "
                  + "; ".join(f"{k_[:48]} {us / n_:.1f} us x {n_}"
                              for us, n_, k_ in rows_p))
        k14_us = sum(us for us, _, k_ in rows_b
                     if "schur_tile" in k_ or "schur_dest" in k_)
        k15_us = sum(us for us, _, k_ in rows_b
                     if any(w_ in k_ for w_ in ("zero_fill", "dense_pair",
                                                "dense_finalize")))
        print(f"phase {phase} per schur_build (profiler): K14 "
              f"schur_edge_blocks {k14_us:.1f} us, K15 dense_assemble "
              f"{k15_us:.1f} us of {sum(r[0] for r in rows_b):.1f} us of "
              f"device time [{card}]")
        print(f"phase {phase} one trial's solve at the end, lambda of "
              f"iteration 3 ({n_cg} CG "
              f"iterations, lambda {float(lam_t):.4g}): wall "
              f"{wall / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms: {wall / n_cg:.1f} us of wall and "
              f"{busy / n_cg:.1f} us of device time per CG iteration, idle "
              f"share {100 * (1 - busy / wall):.1f}% [{card}]")
        print(f"phase {phase} split of one build (CUDA events around one "
              f"call, median of 5): "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in split_g.items())
              + f"; one trial's solve (wall above) {wall / 1e3:.3f} ms "
              f"[{card}]")
        del sys_, work
        if not plain_route:
            del state
            return traj, counts
        with plain_versions():
            alg_p = ba_general.LevenbergMarquardtSchur()
            st_p = alg_p.init(gprob)
            lam_p = float(st_p["lam"])
            plain_traj = []
            for _ in range(3):
                st_p, info_p = alg_p.step(gprob, st_p)
                plain_traj.append(info_p["chi2"])
        np.testing.assert_allclose(traj[:3], plain_traj, rtol=PLAIN_ROUTE_RTOL)
        np.testing.assert_allclose(lam_p, lam0, rtol=PLAIN_ROUTE_RTOL)
        print(f"phase {phase} plain route: first 3 chi2 "
              + " ".join(f"{c:.2f}" for c in plain_traj) + " vs kernel route "
              + " ".join(f"{c:.2f}" for c in traj[:3])
              + f" (rtol {PLAIN_ROUTE_RTOL:g}) OK")
        del state, st_p
        return traj, counts

    counts_gen = {}
    bal80, bal80_info = synthetic_bal_problem(*BA_80K, BA_OBS,
                                              dtype=torch.float32)
    E80 = bal80_info["n_obs"]
    expected80 = 2.0 * E80 - 6.0 * (BA_80K[0] - 1) - 3.0 * BA_80K[1]
    traj_j, counts_gen["4j"] = general_path(
        "4j", f"synthetic_bal_problem{BA_80K + (BA_OBS,)}, binary "
        "EDGE_PROJECT_XYZ2UV", bal80, expected80, "bal")
    ell80, ell_expected = ell_traj["4g"]
    print("phase 4j beside phase 4g's dual-ELL route (pcg 30, tol 0.05): "
          + " ".join(f"{c / ell_expected:.5f}" for c in ell80))
    kprob = general_graphs["@psi2uv"].compile(dtype=torch.float32)
    traj_k, counts_gen["4k"] = general_path(
        "4k", "the same observations as ternary EDGE_PROJECT_PSI2UV "
        "(anchor: the point's first camera; camera 0 fixed)", kprob,
        expected80, "psi2uv")
    lprob = general_graphs["@intrinsics"].compile(dtype=torch.float32)
    expected_l = expected80 - 4.0
    traj_l, counts_gen["4l"] = general_path(
        "4l", "the same observations as EDGE_PROJECT_P2MC_INTRINSICS (one "
        "VERTEX_INTRINSICS starting at " + str(INTRINSICS_START) + ")",
        lprob, expected_l, "p2mc_intrinsics")
    for ph, want in (("4k", ("schur_edge_blocks", "ba_wv",
                             "ba_sandwich", "ba_wtx", "ba_lm_sums",
                             "dense_assemble", "lane_block_mv_dot",
                             "edge_lin_psi2uv")),
                     ("4l", ("ba_block_inv@d4", "lane_block_mv_dot@d4",
                             "edge_lin_p2mc_intrinsics")),
                     ("4j", ("edge_lin_xyz2uv",))):
        if min(counts_gen[ph].get(k, 0) for k in want) <= 0:
            raise AssertionError(f"phase {ph}: a kernel did not launch: "
                                 f"{counts_gen[ph]}")

    # 4m. _SchurAuto's routes, and the anchored demo scene's end
    from openslam_g2o_torch.core.ba import LevenbergMarquardtSchur
    two = two_pose_group_graph(Graph, bal_geometry(12, 400)).compile()
    stereo = stereo_sba_graph(Graph).compile()
    routes = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for label, p_, want in (
            ("BAL 80k", bal80, "LevenbergMarquardtSchurELL"),
            ("P2SC stereo, examples/sba_demo.py", stereo,
             "LevenbergMarquardtSchurELL"),
            ("PSI2UV (4k)", kprob, "LevenbergMarquardtSchur"),
            ("P2MC_INTRINSICS (4l)", lprob, "LevenbergMarquardtSchur"),
            ("binary, two pose groups", two, "LevenbergMarquardtSchur")):
        auto = factory._SchurAuto()
        auto.init(p_)
        got = type(auto.impl).__name__
        routes.append(f"{label} -> {got}")
        if got != want:
            raise AssertionError(f"phase 4m: _SchurAuto routes {label} to "
                                 f"{got}, not {want}")
    counts_route = read_counts()
    print("phase 4m _SchurAuto: " + "; ".join(routes) + " (the JAX package "
          "routes the two-pose-group graph to its dual-ELL solver)")
    # the routes' inits linearized P2MC and XYZ2UV (two pose groups) and
    # P2SC (the stereo scene's dual-ELL build, K10's generic entry) by K17
    lin_m = {k: counts_route[k] for k in ("edge_lin_p2mc", "edge_lin_p2sc",
                                          "edge_lin_xyz2uv")}
    if min(lin_m.values()) <= 0:
        raise AssertionError(f"phase 4m: K17 did not launch: {lin_m}")
    pat_two = ba_general.build_schur_pattern(two)
    lin_two = problem_mod.linearize(two)
    split_m = {
        "linearize (two pose groups)": _median_ms(
            torch, lambda: problem_mod.linearize(two), 5, 1, 1),
        "schur_build without linearize (two pose groups)": _median_ms(
            torch, lambda: ba_general.schur_build(two, lin=lin_two,
                                                  pattern=pat_two), 5, 1, 1),
        "linearize (stereo)": _median_ms(
            torch, lambda: problem_mod.linearize(stereo), 5, 1, 1)}
    del pat_two, lin_two
    print(f"phase 4m K17 launches in the routes' inits {lin_m}; split "
          f"(CUDA events around one call, median of 5, float64): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in split_m.items())
          + f" [{card}]")
    demo = anchored_demo_graph(Graph).compile()          # card, float64
    kernels.reset_launch_counts()
    t_demo = time.monotonic()
    _, demo_stats = optimize(demo, LevenbergMarquardtSchur(), iterations=30)
    t_demo = time.monotonic() - t_demo
    counts_gen["4m"] = {k: v + counts_route[k]
                        for k, v in read_counts().items()}
    demo_end = demo_stats[-1]["chi2"]
    print(f"phase 4m examples/ba_anchored_inverse_depth_demo.py scene "
          f"({demo.static.egroups[0].count} observations, float64): 30 "
          f"iterations in {t_demo:.2f} s ("
          f"{sum(s_['levenberg_iters'] for s_ in demo_stats)} trials), "
          f"chi2 {demo_end:.6f} vs the JAX package's {JAX_DEMO_CHI2:.6f} "
          f"(rel {abs(demo_end - JAX_DEMO_CHI2) / JAX_DEMO_CHI2:.2e}, rtol "
          f"1e-6) [{card}]")
    np.testing.assert_allclose(demo_end, JAX_DEMO_CHI2, rtol=1e-6)
    with plain_versions():
        _, demo_plain = optimize(demo, LevenbergMarquardtSchur(), iterations=3)
    np.testing.assert_allclose([s_["chi2"] for s_ in demo_stats[:3]],
                               [s_["chi2"] for s_ in demo_plain],
                               rtol=PLAIN_ROUTE_RTOL)
    print("phase 4m plain route on the demo scene: first 3 chi2 "
          + " ".join(f"{s_['chi2']:.4f}" for s_ in demo_plain)
          + f" (rtol {PLAIN_ROUTE_RTOL:g}) OK")
    alg_m = LevenbergMarquardtSchur()
    lam_m = alg_m.init(demo)["lam"]
    schur_trial_split("4m", demo, ba_general._solve(
        demo, ba_general.schur_build(demo, pattern=alg_m.pattern(demo)),
        lam_m, 250, 1e-8), lam_m)
    del two, stereo, demo, kprob, lprob, bal80, alg_m
    torch.cuda.empty_cache()

    # 4n. the 400k BAL shape through the general path: the dense [Tp, Tp]
    # product at Tp = 5400 in every CG iteration
    bal400, bal400_info = synthetic_bal_problem(*BA_400K, BA_OBS,
                                                dtype=torch.float32)
    expected400 = (2.0 * bal400_info["n_obs"] - 6.0 * (BA_400K[0] - 1)
                   - 3.0 * BA_400K[1])
    traj_n, counts_gen["4n"] = general_path(
        "4n", f"synthetic_bal_problem{BA_400K + (BA_OBS,)}, binary "
        "EDGE_PROJECT_XYZ2UV", bal400, expected400)
    if counts_gen["4n"]["edge_lin_xyz2uv"] <= 0:
        raise AssertionError("phase 4n: K17 did not launch for XYZ2UV")
    ell400, ell400_expected = ell_traj["4h"]
    print("phase 4n beside phase 4h's dual-ELL route (pcg 30, tol 0.05): "
          + " ".join(f"{c / ell400_expected:.5f}" for c in ell400))
    del bal400
    torch.cuda.empty_cache()

    # 4o. the dense LM over the types without a scene of their own: phase
    # 4o's three worlds at T of 9,000-9,203 (float64, the card) through
    # optimize(prob), the default dense LevenbergMarquardt, 10 iterations,
    # with 4d's checks: chi2 never increases, every gaining step accepted,
    # the plain route equal to rtol DENSE_ROUTE_RTOL with the same trials
    # while gaining, a second run bit-identical; K17 launched for every
    # type of the world; the split of one LM iteration's build
    counts_4o = {}
    for label, make, size in (("2D", world2d_all_graph, ALL2D),
                              ("3D", world3d_all_graph, ALL3D),
                              ("SBA", sba_all_graph, ALLSBA)):
        t_b = time.monotonic()
        oprob = make(Graph, *size).compile()    # default device, float64
        t_b = time.monotonic() - t_b
        T_o = oprob.static.total_dim
        if oprob.device.type != "cuda" or oprob.dtype != torch.float64 \
                or not 8000 <= T_o <= 12000:
            raise AssertionError(f"phase 4o {label}: {oprob.device} "
                                 f"{oprob.dtype} T={T_o}")
        by_type_o = " ".join(f"{eg.key}={eg.count}"
                             for eg in oprob.static.egroups)
        chi0_o = float(robust_chi2(oprob))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t_o = time.monotonic()
        out_o, stats_o = optimize(oprob)          # LevenbergMarquardt, 10
        t_o = time.monotonic() - t_o
        c_o = read_counts()
        for k, v in c_o.items():
            counts_4o[k] = counts_4o.get(k, 0) + v
        chi_o = [st_["chi2"] for st_ in stats_o]
        steps_o = np.diff(np.array([chi0_o] + chi_o))
        gaining_o = -steps_o > 1e-10 * np.array(chi_o)
        bad_o = [i for i, st_ in enumerate(stats_o)
                 if not st_["ok"] and (i == 0 or gaining_o[i - 1])]
        print(f"phase 4o {label} world: {make.__name__}(Graph, {size}) in "
              f"{t_b:.2f} s on the host; T={T_o} {by_type_o} float64; "
              f"chi2_0 {chi0_o:.1f}; LM 10 iterations {t_o * 100:.2f} ms/"
              f"iteration ({sum(st_['levenberg_iters'] for st_ in stats_o)}"
              f" trials) [{card}]")
        print(f"phase 4o {label} LM chi2: "
              + " ".join(f"{c:.4f}" for c in chi_o))
        if not (np.all(np.isfinite(chi_o)) and np.all(steps_o <= 0)) \
                or bad_o:
            raise AssertionError(f"phase 4o {label}: chi2 increased or a "
                                 f"gaining step failed: {stats_o}")
        with plain_versions():
            _, plain_o = optimize(oprob)
        np.testing.assert_allclose(chi_o, [st_["chi2"] for st_ in plain_o],
                                   rtol=DENSE_ROUTE_RTOL)
        live_o = (int(np.argmin(gaining_o)) if not gaining_o.all()
                  else len(gaining_o))
        if ([st_["levenberg_iters"] for st_ in plain_o[:live_o]]
                != [st_["levenberg_iters"] for st_ in stats_o[:live_o]]):
            raise AssertionError(f"phase 4o {label}: the plain route took "
                                 "other trials")
        again_o, again_stats_o = optimize(oprob)
        if [st_["chi2"] for st_ in again_stats_o] != chi_o or not all(
                torch.equal(again_o.params[k], out_o.params[k])
                for k in out_o.params):
            raise AssertionError(f"phase 4o {label}: a second run gave "
                                 "other bits")
        lin_o = {edge_lin.LINEARIZERS[eg.etype.name]:
                 c_o[edge_lin.LINEARIZERS[eg.etype.name]]
                 for eg in oprob.static.egroups}
        if min(lin_o.values()) <= 0:
            raise AssertionError(f"phase 4o {label}: K17 did not launch: "
                                 f"{lin_o}")
        holder_o = {}
        dpat_o = dense_assemble.build_dense_pattern(oprob)

        def t_lin_o():
            holder_o["lin"] = problem_mod.linearize(oprob)

        def t_asm_o():
            problem_mod.build_dense_system(oprob, lin=holder_o["lin"],
                                           pattern=dpat_o)

        split_o = {k: _median_ms(torch, fn, repeats=5, inner=1, warmup=1)
                   for k, fn in (("linearize", t_lin_o),
                                 ("assemble", t_asm_o))}
        print(f"phase 4o {label} checks: LM chi2 never increases, every "
              f"gaining step accepted; plain route equal to rtol "
              f"{DENSE_ROUTE_RTOL:g} with the same trials while gaining; "
              f"second run bit-identical; K17 launches {lin_o}; split "
              f"(CUDA events, median of 5): "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in split_o.items())
              + f" [{card}] OK")
        dense_trial_split(f"4o {label}", oprob, dpat_o)
        del oprob, out_o, again_o, plain_o, holder_o, dpat_o
        torch.cuda.empty_cache()

    # 4p. BAL bundle adjustment (models/bal.py, the 9-wide Snavely camera)
    # on the dual-ELL Schur solver, on phase 3's scenes (bal_camera_scene at
    # ba_80k and ba_400k) as load_bal_problem reads them: lambda init + 10
    # iterations through optimize(LevenbergMarquardtSchurELL(pcg 30, tol
    # 0.05)) and, from the same init, 10 through ba_ell_optimize_fused with
    # one trial per iteration and with ba_ell_step's trials; float32 at
    # both shapes (80k: the dense-Schur route, 400k: the implicit one) and
    # float64 at 80k, held to the JAX package's float64 CPU trajectory;
    # _SchurAuto's route on the 80k graph; the float32 80k result written
    # by save_bal_problem and read back
    counts_bal = {}
    bal_ends = {}                       # (key, dtype) -> final chi2

    def bal_path(key, dt):
        sc = bal_scenes[key]
        n_cams, n_points = sc["shape"]
        expected = float(sc["expected"])
        tag_b = str(dt).split(".")[-1]
        phase = f"4p {key} {tag_b}"
        dense = key == "80k"
        t_l = time.monotonic()
        bprob, meta = load_bal_problem(sc["path"], dtype=dt)
        t_l = time.monotonic() - t_l
        if bprob.device.type != "cuda" or meta["n_obs"] != sc["n_obs"]:
            raise AssertionError(f"phase {phase}: {bprob.device}, "
                                 f"{meta['n_obs']} observations")
        chi0 = float(robust_chi2(bprob))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out, stats = optimize(bprob, ba_ell.LevenbergMarquardtSchurELL(
            **BA_PCG), iterations=10)
        traj = [st_["chi2"] for st_ in stats]
        opt_ms = 1e3 * stats[-1]["cum_time"] / len(stats)
        alg = ba_ell.LevenbergMarquardtSchurELL(**BA_PCG)
        state = alg.init(bprob)
        pattern = alg.pattern(bprob)
        if ba_ell.dense_schur_ok(bprob, pattern) != dense:
            raise AssertionError(f"phase {phase}: the route is not the "
                                 f"{'dense' if dense else 'implicit'} one")
        st0 = (state["params"], state["lam"], state["ni"], state["chi2"])
        fused = {}
        for per_iter in (True, False):
            torch.cuda.synchronize()
            cg0 = read_counts()["cg_update_xr"]
            t1 = time.monotonic()
            res = ba_ell.ba_ell_optimize_fused(
                bprob, pattern, *st0, n_iters=10, trial_per_iter=per_iter,
                **BA_PCG)
            torch.cuda.synchronize()
            fused[per_iter] = (res[4].tolist(),
                               (time.monotonic() - t1) * 100,
                               read_counts()["cg_update_xr"] - cg0)
        counts = read_counts()
        for w_ in (ba_inv.ba_block_inv, jacobi_scale.lane_block_mv,
                   jacobi_scale.lane_block_mv_dot):
            counts[f"{w_.__name__}@d9"] = w_.launches_by_width[9]
        counts_bal[(key, tag_b)] = counts
        bal_ends[(key, tag_b)] = traj[-1]
        print(f"phase {phase} BAL {'dense-Schur' if dense else 'implicit'} "
              f"route: bal_camera_scene{sc['shape']} read by "
              f"load_bal_problem in {t_l:.2f} s; E={sc['n_obs']} "
              f"K_l={pattern.lm_edge.shape[0]} Tp={pattern.pose_dim} "
              f"{tag_b}, pcg {BA_PCG['pcg_iters']} tol {BA_PCG['pcg_tol']}; "
              f"chi2_0 {chi0:.1f}; optimize(LevenbergMarquardtSchurELL) "
              f"{opt_ms:.3f} ms/LM iteration "
              f"({sum(st_['levenberg_iters'] for st_ in stats)} trials); "
              f"ba_ell_optimize_fused {fused[True][1]:.3f} ms/LM iteration "
              f"(one trial each, {fused[True][2]} CG iterations), with "
              f"ba_ell_step's trials {fused[False][1]:.3f} ms/LM iteration "
              f"({fused[False][2]} CG iterations) [{card}]")
        for what, tr in (("optimize", traj), ("fused", fused[True][0]),
                         ("step", fused[False][0])):
            print(f"phase {phase} chi2 / expected ({expected:.1f}) {what}: "
                  + " ".join(f"{c / expected:.5f}" for c in tr))
            steps = np.diff(np.array([chi0] + tr))
            if not (np.all(np.isfinite(tr)) and np.all(steps <= 0)):
                raise AssertionError(f"phase {phase} {what}: chi2 not finite "
                                     f"or increasing: {tr}")
            if tr[-1] > BA_GATE * expected:
                raise AssertionError(f"phase {phase} {what}: chi2 {tr[-1]} "
                                     f"above {BA_GATE} x {expected}")
        print(f"phase {phase} final chi2 {traj[-1]:.1f} expected 2E - 9(C - "
              f"1) - 3P = {expected:.1f} ratio {traj[-1] / expected:.5f} "
              f"(gate {BA_GATE}); never increases")
        used = ("ba_schur_dense",) if dense else ("ba_sandwich",
                                                  "lane_block_mv_dot@d9")
        unused = "ba_sandwich" if dense else "ba_schur_dense"
        if min(counts[k] for k in used) <= 0 or counts[unused]:
            raise AssertionError(f"phase {phase}: the launches show another "
                                 f"route: {counts}")
        if not dense:
            # one trial's solve at the end state, lambda of the fused run's
            # end: wall, then device time by the profiler
            work = bprob.with_params(res[0])
            sys_ = ba_ell._build(work, pattern)
            lam_t = res[1]
            solve = lambda: ba_ell._solve(work, pattern, sys_, lam_t,
                                          BA_PCG["pcg_iters"],
                                          BA_PCG["pcg_tol"])
            solve()
            torch.cuda.synchronize()
            before = read_counts()["cg_update_xr"]
            t2 = time.monotonic()
            solve()
            torch.cuda.synchronize()
            wall = (time.monotonic() - t2) * 1e6
            n_cg = max(read_counts()["cg_update_xr"] - before, 1)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof_p:
                solve()
                torch.cuda.synchronize()
            rows_p = sorted(((e.self_device_time_total, e.count, e.key)
                             for e in prof_p.key_averages()
                             if e.device_type
                             == torch.autograd.DeviceType.CUDA
                             and e.self_device_time_total > 0),
                            reverse=True)
            busy = sum(r[0] for r in rows_p)
            if busy <= 0:
                raise AssertionError(f"phase {phase}: the profiler saw no "
                                     "device time")
            print(f"phase {phase} one trial's solve at the end ({n_cg} CG "
                  f"iterations, lambda {float(lam_t):.4g}): wall "
                  f"{wall / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms: "
                  f"{wall / n_cg:.1f} us of wall and {busy / n_cg:.1f} us of "
                  f"device time per CG iteration, idle share "
                  f"{100 * (1 - busy / wall):.1f}%; by kernel: "
                  + "; ".join(f"{k_[:40]} {us / n_:.1f} us x {n_}"
                              for us, n_, k_ in rows_p[:8]) + f" [{card}]")
            del work, sys_
        if key == "80k" and dt == torch.float64:
            got_traj = tuple(float(f"{c / expected:.5f}") for c in traj)
            print(f"phase {phase} the JAX package, float64 on the CPU: "
                  + " ".join(f"{c:.5f}" for c in JAX_BAL_TRAJ))
            if got_traj != JAX_BAL_TRAJ:
                raise AssertionError(f"phase {phase}: {got_traj} is not the "
                                     f"JAX package's {JAX_BAL_TRAJ}")
        if key == "80k" and dt == torch.float32:
            auto = factory._SchurAuto(**BA_PCG)
            auto.init(bprob)
            print(f"phase {phase} _SchurAuto on this graph: "
                  f"{type(auto.impl).__name__}")
            if not isinstance(auto.impl, ba_ell.LevenbergMarquardtSchurELL):
                raise AssertionError(f"phase {phase}: _SchurAuto chose "
                                     f"{type(auto.impl).__name__}")
            del auto
            saved = os.path.join(bal_dir, "bal_80k_result.txt")
            save_bal_problem(out, saved)
            back, _ = load_bal_problem(saved, dtype=dt)
            chi_back = float(robust_chi2(back))
            print(f"phase {phase} save_bal_problem of the result, read back: "
                  f"chi2 {chi_back!r} against the final {traj[-1]!r}")
            if chi_back != traj[-1]:
                raise AssertionError(f"phase {phase}: the saved result's "
                                     f"chi2 {chi_back} is not {traj[-1]}")
            del back
        del bprob, out, state, res
        torch.cuda.empty_cache()

    for key_b, dt_b in (("80k", torch.float32), ("400k", torch.float32),
                        ("80k", torch.float64)):
        bal_path(key_b, dt_b)
    counts_4p = {}
    for c_ in counts_bal.values():
        for k, v in c_.items():
            counts_4p[k] = counts_4p.get(k, 0) + v

    # 4q. the same BAL files through the general Schur path
    # (LevenbergMarquardtSchur(), pcg 250, tol 1e-8, as 4j): K14 at (9, 3),
    # K15 on the 9-wide camera slots, K13, K11 and K4 at (9, 3) / D = 9;
    # lambda init + 10 iterations, float32 at 80k and 400k, float64 at 80k,
    # whose end must lie within BAL_GENERAL_GAP of 4p's dual-ELL float64 end
    ends_4q = {}
    for key_b, dt_b in (("80k", torch.float32), ("80k", torch.float64),
                        ("400k", torch.float32)):
        tag_b = str(dt_b).split(".")[-1]
        sc = bal_scenes[key_b]
        qprob = load_bal_problem(sc["path"], dtype=dt_b)[0]
        phase_q = f"4q {key_b} {tag_b}"
        traj_q, counts_gen[phase_q] = general_path(
            phase_q, f"bal_camera_scene{sc['shape']} read by "
            "load_bal_problem, EDGE_PROJECT_BAL on the 9-wide camera",
            qprob, float(sc["expected"]), plain_route=False)
        ends_4q[(key_b, tag_b)] = traj_q[-1]
        print(f"phase {phase_q} beside phase 4p's dual-ELL route (pcg 30, "
              f"tol 0.05), chi2 / expected at the end: general "
              f"{traj_q[-1] / sc['expected']:.5f}, dual-ELL "
              f"{bal_ends[(key_b, tag_b)] / sc['expected']:.5f}")
        del qprob
        torch.cuda.empty_cache()
    gap_q = (abs(ends_4q[("80k", "float64")] - bal_ends[("80k", "float64")])
             / bal_ends[("80k", "float64")])
    print(f"phase 4q float64 80k: general path ends at "
          f"{ends_4q[('80k', 'float64')]!r}, the dual-ELL route (4p) at "
          f"{bal_ends[('80k', 'float64')]!r}: gap {gap_q:.3e} (limit "
          f"{BAL_GENERAL_GAP:g})")
    if not gap_q <= BAL_GENERAL_GAP:
        raise AssertionError(f"phase 4q: the general path's float64 end is "
                             f"{gap_q:.3e} from the dual-ELL route's")
    for ph, c_ in counts_gen.items():
        if ph.startswith("4q") and min(c_[k] for k in (
                "schur_edge_blocks", "dense_assemble", "ba_wtx", "ba_wv",
                "ba_sandwich", "ba_lm_sums", "ba_block_inv@d9",
                "lane_block_mv_dot@d9", "edge_lin_bal", "trial_chi2_bal",
                "trial_retract_groups")) <= 0:
            raise AssertionError(f"phase {ph}: a kernel did not launch: {c_}")

    # 4r. the dense GN / LM route at block width 9: optimize(prob) (the
    # default dense LevenbergMarquardt) for 10 iterations on a BAL file of
    # the dense worlds' size, GaussNewton() for 3 from its end, and the
    # dual-ELL solver's dense-Schur route on the same scene
    sc_r = bal_scenes["dense"]
    rprob = load_bal_problem(sc_r["path"], dtype=torch.float64)[0]
    T_r = rprob.static.total_dim
    expected_r = float(sc_r["expected"])
    chi0_r = float(robust_chi2(rprob))
    optimize(rprob, iterations=1)             # cuSOLVER's first call
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lm_last = {}
    t_lm = time.monotonic()
    out_r, lm_stats_r = optimize(
        rprob, post_iteration=lambda it, st: lm_last.update(state=st))
    torch.cuda.synchronize()
    t_lm = time.monotonic() - t_lm
    t_gn = time.monotonic()
    _, gn_stats_r = optimize(out_r, GaussNewton(), iterations=3)
    torch.cuda.synchronize()
    t_gn = time.monotonic() - t_gn
    lm_r = [st_["chi2"] for st_ in lm_stats_r]
    gn_r = [st_["chi2"] for st_ in gn_stats_r]
    # LM after its 10 iterations is still on its way down (its lambda,
    # set from tau max |diag H|, which the focal length's column
    # dominates, falls by at most 3x an iteration): it goes on from its
    # state until it comes within 1e-6 of GN's end, at most 30 more
    lm_more = LevenbergMarquardt()
    state_r, more_r = lm_last["state"], []
    while len(more_r) < 30 and not (
            more_r and abs(more_r[-1] - gn_r[-1]) <= 1e-6 * gn_r[-1]):
        state_r, info_r = lm_more.step(rprob, state_r)
        more_r.append(info_r["chi2"])
    torch.cuda.synchronize()
    counts_4r = read_counts()
    del state_r, lm_last
    print(f"phase 4r dense route at block width 9: bal_camera_scene"
          f"{sc_r['shape']} read by load_bal_problem, T={T_r}, "
          f"E={sc_r['n_obs']}, float64; chi2_0 {chi0_r:.1f}; LM 10 "
          f"iterations {t_lm * 100:.2f} ms/iteration "
          f"({sum(st_['levenberg_iters'] for st_ in lm_stats_r)} trials), "
          f"GN 3 iterations from its end {t_gn * 1e3 / 3:.2f} ms/iteration "
          f"[{card}]")
    print(f"phase 4r LM chi2 / expected ({expected_r:.1f}): "
          + " ".join(f"{c / expected_r:.5f}" for c in lm_r))
    print("phase 4r GN chi2 from LM's end: " + " ".join(f"{c!r}"
                                                        for c in gn_r))
    print(f"phase 4r LM on from its 10th iteration: {len(more_r)} more "
          f"iterations to {more_r[-1]!r}, against GN's end {gn_r[-1]!r}; "
          f"LM's 10th iteration was {(lm_r[-1] - gn_r[-1]) / gn_r[-1]:.3e} "
          f"above it")
    if not (np.all(np.isfinite(lm_r))
            and np.all(np.diff([chi0_r] + lm_r) <= 0)):
        raise AssertionError(f"phase 4r: LM chi2 not finite or increasing: "
                             f"{lm_r}")
    if lm_r[-1] > BA_GATE * expected_r:
        raise AssertionError(f"phase 4r: LM chi2 {lm_r[-1]} above {BA_GATE} "
                             f"x {expected_r}")
    gap_gn = abs(gn_r[-1] - more_r[-1]) / gn_r[-1]
    if not (gap_gn <= 1e-6 and np.all(np.diff(lm_r + more_r) <= 0)):
        raise AssertionError(f"phase 4r: GN ends {gap_gn:.3e} from LM "
                             f"({more_r})")
    if min(counts_4r[k] for k in ("dense_assemble", "edge_lin_bal",
                                  "trial_chi2_bal",
                                  "trial_retract_groups",
                                  "lm_outcome")) <= 0:
        raise AssertionError(f"phase 4r: a kernel did not launch: "
                             f"{counts_4r}")
    dpat_r = dense_assemble.build_dense_pattern(rprob)
    split_r = dense_split("4r", rprob, dpat_r)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_r:
        problem_mod.build_dense_system(rprob, pattern=dpat_r)
        torch.cuda.synchronize()
    k15_r = sorted(((e.self_device_time_total, e.count, e.key)
                    for e in prof_r.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and any(w_ in e.key for w_ in (
                        "zero_fill", "dense_pair", "dense_finalize"))),
                   reverse=True)
    print(f"phase 4r K15 per build (profiler): "
          f"{sum(r[0] for r in k15_r):.1f} us ("
          + "; ".join(f"{k_[:40]} {us / n_:.1f} us x {n_}"
                      for us, n_, k_ in k15_r)
          + f"); cuSOLVER's factor + solve {split_r['factor+solve']:.3f} ms "
          f"of the {t_lm * 100:.2f} ms LM iteration "
          f"({100 * split_r['factor+solve'] / (t_lm * 100):.1f}%) [{card}]")
    del dpat_r
    alg_r = ba_ell.LevenbergMarquardtSchurELL()
    _, ell_stats_r = optimize(rprob, alg_r, iterations=10)
    if not ba_ell.dense_schur_ok(rprob, alg_r.pattern(rprob)):
        raise AssertionError("phase 4r: the dual-ELL solver did not take "
                             "the dense-Schur route")
    ell_r = ell_stats_r[-1]["chi2"]
    gap_ell = (ell_r - lm_r[-1]) / lm_r[-1]
    print(f"phase 4r LevenbergMarquardtSchurELL() on the same scene "
          f"(dense-Schur route), 10 iterations: chi2 {ell_r!r} against the "
          f"dense LM's 10th {lm_r[-1]!r}: {100 * gap_ell:+.4f}% (limit "
          f"{100 * BA_WORLD_GATE:g}%)")
    if not abs(gap_ell) <= BA_WORLD_GATE:
        raise AssertionError(f"phase 4r: the dense-Schur end is "
                             f"{gap_ell:.3e} from the dense LM's")
    del rprob, out_r
    torch.cuda.empty_cache()
    shutil.rmtree(bal_dir, ignore_errors=True)

    # 4s. LM-PCG over several vertex groups (core/sparse.py PairPattern:
    # K17, K2' (two passes), K3 per group, K4' per pair table, K5' over
    # every row group in the two-launch CG step (the three-launch one with
    # pcg_cheby 4), K7; K8' with pcg_cheby 4): lambda init + 10
    # iterations of lm_pcg_optimize_fused in float32 and float64 on the
    # 9000-pose landmark world of phase 3's pair rows (T = 34,108), on phase
    # 4d's world and on phase 4f's world, CG budget PAIR_PCG
    pair_names = ("pair_stream", "pair_assemble", "pair_scale", "pair_spmv",
                  "pair_spmv_dot", "pair_spmv_dot_p")
    counts_4s = {}
    launches_d2 = {"damp_chol@d2": 0, "lane_block_mv@d2": 0}
    generic_before = (len(generic_calls), len(plain_trial_calls))

    def pair_run(label, graph_, dt, cheby=0):
        """One 4s run: (trajectory, launch counts, widths' launches of K3
        and lane_block_mv, ms per LM iteration, init s, the problem, its
        pattern and the run's final state)."""
        prob_ = graph_.compile(dtype=dt)
        if prob_.device.type != "cuda":
            raise AssertionError(f"phase 4s {label}: {prob_.device}")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0_ = time.monotonic()
        alg_ = LevenbergMarquardtPCG(pcg_cheby=cheby, **PAIR_PCG)
        pat_ = alg_.pattern(prob_)
        if not isinstance(pat_, sparse.PairPattern):
            raise AssertionError(f"phase 4s {label}: not on pair tables")
        lam_ = _lambda_init_pcg(prob_, pat_, prob_.params,
                                torch.tensor(alg_.tau, dtype=dt, device=dev))
        chi_ = robust_chi2(prob_)
        ni_ = torch.tensor(2.0, dtype=dt, device=dev)
        torch.cuda.synchronize()
        t1_ = time.monotonic()
        out_ = lm_pcg_optimize_fused(prob_, pat_, prob_.params, lam_, ni_,
                                     chi_, n_iters=10, pcg_cheby=cheby,
                                     **PAIR_PCG)
        torch.cuda.synchronize()
        t2_ = time.monotonic()
        counts_ = read_counts()
        widths_ = (dict(damp_chol.damp_chol.launches_by_width),
                   dict(jacobi_scale.lane_block_mv.launches_by_width))
        launches_d2["damp_chol@d2"] += widths_[0].get(2, 0)
        launches_d2["lane_block_mv@d2"] += widths_[1].get(2, 0)
        traj_ = [float(chi_)] + out_[4].tolist()
        if not (np.all(np.isfinite(traj_)) and np.all(np.diff(traj_) <= 0)):
            raise AssertionError(f"phase 4s {label}: chi2 not finite or "
                                 f"increasing: {traj_}")
        return dict(traj=traj_, counts=counts_, widths=widths_,
                    ms=(t2_ - t1_) * 100.0, init_s=t1_ - t0_, prob=prob_,
                    pat=pat_, lam0=float(lam_), final=out_[:4], alg=alg_)

    def cheby_flat(c_, label):
        """A pcg_cheby 4 run on the flat vectors: one K5' launch a product
        (the CG step's, each of the preconditioner's three, and a trial's
        first residual), and every vector kernel once a CG iteration over
        every group's part (the preconditioner's: once an application)."""
        outer, trials = c_["cg_update_p"], c_["lm_outcome"]
        if not (outer > 0 and c_["cg_update_xr"] == outer
                and c_["pair_spmv_dot"] == outer
                and c_["pair_spmv"] == c_["chebyshev_update"] + trials
                and c_["chebyshev_update"] == 3 * c_["chebyshev_init"]
                and c_["chebyshev_init"] == outer + 2 * trials
                and c_["pair_spmv_dot_p"] == 0):
            raise AssertionError(f"phase 4s {label} pcg_cheby 4: not one "
                                 f"launch a product and a vector step: "
                                 f"{c_}")
        print(f"phase 4s {label} float32 pcg_cheby 4: {outer} CG iterations"
              f", each pair_spmv_dot, cg_update_xr and cg_update_p once "
              f"over the flat vector; {c_['pair_spmv']} preconditioner "
              f"products, as many chebyshev_update, "
              f"{c_['chebyshev_init']} chebyshev_init OK")

    runs_4s = {}
    for label, graph_ in (("9000-pose world", world_s), ("4d world", world),
                          ("4f world", world3)):
        for dt in (torch.float32, torch.float64):
            tag = str(dt).split(".")[-1]
            r_ = pair_run(label, graph_, dt)
            runs_4s[(label, tag)] = r_
            counts_4s[(label, tag)] = r_["counts"]
            st_ = r_["prob"].static
            c_ = r_["counts"]
            trials_ = c_["lm_outcome"]
            # the two-launch step: one cg_update_xr over every group's part
            # a CG iteration, one product a CG iteration, no cg_update_p
            cg_ = c_["cg_update_xr"]
            never_ = [k for k in pair_names + (
                "damp_chol", "lane_block_mv", "cg_update_xr",
                "cg_residual", "cg_finish", "lm_outcome") if c_[k] <= 0]
            if never_ or c_["spmv_dot"] or c_["spmv_dot_p"] \
                    or c_["block_ell_spmv"] or c_["assemble_gather"] \
                    or c_["cg_update_p"] or c_["pair_spmv_dot"] \
                    + c_["pair_spmv_dot_p"] != cg_:
                raise AssertionError(f"phase 4s {label} {tag}: a kernel of "
                                     f"the pair path did not launch, the "
                                     f"one-group path's did, or the CG step "
                                     f"is not two launches: {never_} {c_}")
            if label == "9000-pose world" and r_["widths"][0].get(2, 0) <= 0:
                raise AssertionError("phase 4s: K3 did not launch at D = 2")
            print(f"phase 4s {label} {tag}: T={st_.total_dim} ("
                  + ", ".join(f"{g_.count} {g_.name}" for g_ in st_.vgroups)
                  + "; " + ", ".join(f"{eg_.count} {eg_.key}"
                                     for eg_ in st_.egroups)
                  + f"), pairs " + ", ".join(
                      f"{pt.dr}x{pt.dc} K={pt.k}" for pt in r_["pat"].pairs)
                  + f"; {PAIR_PCG}; init + lambda0 {r_['init_s']:.3f} s "
                  f"lambda0 {r_['lam0']:.6g}; {r_['ms']:.2f} ms per LM "
                  f"iteration (10 of lm_pcg_optimize_fused), {trials_} "
                  f"trials, {cg_} CG iterations ({cg_ / max(trials_, 1):.1f}"
                  f" per trial) [{card}]")
            print(f"phase 4s {label} {tag} chi2: "
                  + " ".join(f"{c!r}" for c in r_["traj"]))
            print(f"phase 4s {label} {tag} launches: " + " ".join(
                f"{k}={c_[k]}" for k in pair_names + (
                    "damp_chol", "lane_block_mv", "cg_update_xr",
                    "cg_update_p", "lm_outcome") if c_[k])
                  + f"; K3 by width {r_['widths'][0]}, lane_block_mv by "
                  f"width {r_['widths'][1]}")
            if dt == torch.float32:
                lam_p, plain_s = plain_route(r_["alg"], r_["pat"],
                                             torch.tensor(2.0, dtype=dt,
                                                          device=dev),
                                             prob=r_["prob"], **PAIR_PCG)
                np.testing.assert_allclose(r_["traj"][1:4], plain_s,
                                           rtol=PLAIN_ROUTE_RTOL)
                np.testing.assert_allclose(lam_p, r_["lam0"],
                                           rtol=PLAIN_ROUTE_RTOL)
                print(f"phase 4s {label} plain route: first 3 chi2 "
                      + " ".join(f"{c:.6f}" for c in plain_s)
                      + f" (rtol {PLAIN_ROUTE_RTOL:g}) OK")
            if label == "4d world" and dt == torch.float64:
                prev_ = r_["traj"][0]
                n_held = 0
                for i_, (t_, j_) in enumerate(zip(r_["traj"][1:],
                                                  JAX_PAIR_TRAJ)):
                    if prev_ - j_ <= 1e-10 * prev_:
                        break
                    if not abs(t_ - j_) <= 1e-6 * abs(j_):
                        raise AssertionError(
                            f"phase 4s: the float64 4d trajectory leaves "
                            f"the JAX package's at iteration {i_}: {t_!r} "
                            f"against {j_!r}")
                    prev_, n_held = j_, n_held + 1
                print(f"phase 4s 4d world float64: the JAX package's float64 "
                      f"CPU trajectory at the same settings (JAX_PAIR_TRAJ) "
                      f"held to rtol 1e-6 over {n_held} gaining iterations "
                      "OK")
            if r_["ms"] and label != "9000-pose world":
                dense_end = lm_chi[-1] if label == "4d world" else lm_chi3[-1]
                print(f"phase 4s {label} {tag}: end / the dense LM's end "
                      f"(phase {label[:2]}) = "
                      f"{r_['traj'][-1] / dense_end!r}")
            if not (label == "9000-pose world" and dt == torch.float32):
                del r_["prob"], r_["pat"], r_["final"]
                runs_4s[(label, tag)] = {k_: v_ for k_, v_ in r_.items()
                                         if k_ not in ("alg",)}

    # pcg_cheby 4 on the 9000-pose world: K8' brackets the Chebyshev window
    r_c = pair_run("9000-pose world, pcg_cheby 4", world_s, torch.float32,
                   cheby=4)
    counts_4s[("cheby", "float32")] = r_c["counts"]
    if min(r_c["counts"][k] for k in ("pair_gershgorin", "chebyshev_update",
                                      "chebyshev_coeffs")) <= 0:
        raise AssertionError(f"phase 4s: K8' did not launch: "
                             f"{r_c['counts']}")
    cheby_flat(r_c["counts"], "9000-pose world")
    print(f"phase 4s 9000-pose world float32 pcg_cheby 4: chi2 "
          + " ".join(f"{c!r}" for c in r_c["traj"])
          + f"; {r_c['ms']:.2f} ms per LM iteration; pair_gershgorin="
          f"{r_c['counts']['pair_gershgorin']} [{card}]")
    _, plain_c4 = plain_route(r_c["alg"], r_c["pat"],
                              torch.tensor(2.0, dtype=torch.float32,
                                           device=dev),
                              prob=r_c["prob"], pcg_cheby=4, **PAIR_PCG)
    np.testing.assert_allclose(r_c["traj"][1:4], plain_c4,
                               rtol=PLAIN_ROUTE_RTOL)
    print("phase 4s pcg_cheby 4 plain route: first 3 chi2 "
          + " ".join(f"{c:.6f}" for c in plain_c4)
          + f" (rtol {PLAIN_ROUTE_RTOL:g}) OK")
    del r_c
    # and on 4f's world: K8' at the (6, 6), (6, 3), (3, 6), (3, 3) pairs
    r_c = pair_run("4f world, pcg_cheby 4", world3, torch.float32, cheby=4)
    counts_4s[("cheby 4f", "float32")] = r_c["counts"]
    if r_c["counts"]["pair_gershgorin"] <= 0:
        raise AssertionError(f"phase 4s: K8' did not launch on 4f's world: "
                             f"{r_c['counts']}")
    cheby_flat(r_c["counts"], "4f world")
    print(f"phase 4s 4f world float32 pcg_cheby 4: chi2 "
          + " ".join(f"{c!r}" for c in r_c["traj"])
          + f"; {r_c['ms']:.2f} ms per LM iteration; pair_gershgorin="
          f"{r_c['counts']['pair_gershgorin']}; end / the dense LM's end "
          f"(phase 4f) = {r_c['traj'][-1] / lm_chi3[-1]!r} [{card}]")
    del r_c
    # one trial's solve on the 9000-pose world in float32, at the run's
    # end: wall, device busy and their share per CG iteration
    r_s = runs_4s[("9000-pose world", "float32")]
    sprob_, spat_ = r_s["prob"], r_s["pat"]
    work_s = sprob_.with_params(r_s["final"][0])
    pre_s = _pcg_precomp(work_s, spat_)
    _pcg_trial(work_s, spat_, pre_s, r_s["final"][1], None, **{
        "pcg_iters": PAIR_PCG["pcg_iters"], "pcg_tol": PAIR_PCG["pcg_tol"],
        "pcg_cheby": 0})
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_w = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_s:
        _pcg_trial(work_s, spat_, pre_s, r_s["final"][1], None,
                   PAIR_PCG["pcg_iters"], PAIR_PCG["pcg_tol"], 0)
        torch.cuda.synchronize()
    wall_s = (time.monotonic() - t_w) * 1e6
    c_s = read_counts()
    n_cg_s = c_s["cg_update_xr"]
    rows_s = sorted(((e.self_device_time_total, e.count, e.key)
                     for e in prof_s.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.self_device_time_total > 0), reverse=True)
    busy_s = sum(r[0] for r in rows_s)
    if busy_s <= 0 or n_cg_s <= 0:
        raise AssertionError("phase 4s: the profiler saw no device time")
    # two launches a CG iteration: the product (pair_spmv_dot once, then
    # pair_spmv_dot_p) and cg_update_xr; the solve's set-up and finish are
    # a few kernels more, and no copy or cat runs per iteration
    kern_s = sum(n_ for _, n_, k_ in rows_s
                 if not k_.startswith(("Memcpy", "Memset")))
    steps_s = (c_s["pair_spmv_dot"] + c_s["pair_spmv_dot_p"]
               + c_s["cg_update_xr"] + c_s["cg_update_p"])
    print(f"phase 4s 9000-pose world float32, that solve: {steps_s} launches "
          f"of the CG step's kernels in {n_cg_s} CG iterations "
          f"({steps_s / n_cg_s:.3f} a CG iteration; pair_spmv_dot "
          f"{c_s['pair_spmv_dot']}, pair_spmv_dot_p "
          f"{c_s['pair_spmv_dot_p']}, cg_update_xr {c_s['cg_update_xr']}, "
          f"cg_update_p {c_s['cg_update_p']}); {kern_s} device kernels "
          f"in the profile ({kern_s / n_cg_s:.3f} a CG iteration)")
    if steps_s != 2 * n_cg_s or c_s["cg_update_p"] \
            or kern_s > 2 * n_cg_s + 40:
        raise AssertionError("phase 4s: the unpreconditioned CG iteration "
                             "is not two launches")
    print(f"phase 4s 9000-pose world float32, one trial's solve at the "
          f"end ({n_cg_s} CG iterations): wall {wall_s / 1e3:.3f} ms "
          f"(profiled), device busy {busy_s / 1e3:.3f} ms: "
          f"{wall_s / n_cg_s:.1f} us of wall and {busy_s / n_cg_s:.1f} us "
          f"of device time per CG iteration, idle share "
          f"{100 * (1 - busy_s / wall_s):.1f}% [{card}]")
    print("phase 4s device time by kernel in that solve: "
          + "; ".join(f"{k_[:40]} {us / n_:.1f} us x {n_}"
                      for us, n_, k_ in rows_s[:8]))
    del work_s, pre_s, sprob_, spat_, r_s, runs_4s, prof_s
    plain_4s = (len(generic_calls) - generic_before[0],
                len(plain_trial_calls) - generic_before[1])
    print(f"phase 4s plain calls of built-in types on the card (generic "
          f"linearizations, plain trials): {plain_4s[0]}, {plain_4s[1]}")
    if any(plain_4s):
        raise AssertionError("phase 4s: a built-in type took a plain route")
    torch.cuda.empty_cache()

    # -- 5. a .g2o string through the public API ---------------------------
    rng = np.random.default_rng(5)
    g = Graph()
    gt, pose = [], np.zeros(3)
    for _ in range(30):
        gt.append(pose.copy())
        pose = np_lie.se2_compose(pose, np.array([1.0, 0.0, 2 * np.pi / 30]))
    for i, p in enumerate(gt):
        g.add_vertex(i, "se2", p + (rng.normal(0, 0.1, 3) if i else 0.0),
                     fixed=i == 0)
    for i in range(30):
        j = (i + 1) % 30
        z = np_lie.se2_compose(np_lie.se2_inverse(gt[i]), gt[j])
        g.add_edge("edge_se2", (i, j), z + rng.normal(0, 0.02, 3),
                   np.diag([100.0, 100.0, 400.0]))
    text = save_g2o(g)
    runs = {}
    for device in (None, "cpu"):               # None: the default, the card
        sprob = loads_g2o(text).compile(dtype=torch.float64, device=device)
        c0 = float(robust_chi2(sprob))
        _, stats = optimize(sprob, LevenbergMarquardtPCG(), iterations=5)
        runs[sprob.device.type] = (c0, [s["chi2"] for s in stats])
    c0, chis = runs["cuda"]
    if not (chis[-1] < c0 and all(np.isfinite(chis))):
        raise AssertionError(f".g2o run did not decrease chi2: {c0} {chis}")
    np.testing.assert_allclose(chis, runs["cpu"][1], rtol=1e-6)
    print(f"phase 5 .g2o ({len(text.splitlines())} lines) on cuda float64: "
          f"chi2 {c0:.4f} -> " + " -> ".join(f"{c:.6f}" for c in chis)
          + " (equal to the CPU run, rtol 1e-6) OK")
    # landmarks and an offset-sensor pair, through the default algorithm
    lines = ["PARAMS_SE2OFFSET 1 0.2 0.0 0.1", "PARAMS_SE2OFFSET 2 -0.1 0.1 0.0"]
    off = [np.array([0.2, 0.0, 0.1]), np.array([-0.1, 0.1, 0.0])]
    lms = rng.uniform(-6, 6, size=(8, 2))
    nums = lambda vals: " ".join(repr(float(x)) for x in vals)
    for i, p in enumerate(gt):
        lines.append(f"VERTEX_SE2 {i} "
                     + nums(p + (rng.normal(0, 0.1, 3) if i else 0.0)))
    for k, l in enumerate(lms):
        lines.append(f"VERTEX_XY {100 + k} "
                     + nums(l + rng.normal(0, 0.2, 2)))
    lines.append("FIX 0")
    for i in range(30):
        j = (i + 1) % 30
        z = np_lie.se2_compose(
            np_lie.se2_inverse(np_lie.se2_compose(gt[i], off[0])),
            np_lie.se2_compose(gt[j], off[1])) + rng.normal(0, 0.02, 3)
        lines.append(f"EDGE_SE2_OFFSET {i} {j} 1 2 {nums(z)} "
                     "100 0 0 100 0 400")
        for k in (i % 8, (i + 3) % 8):
            z = np_lie.se2_apply(np_lie.se2_inverse(gt[i]), lms[k]) \
                + rng.normal(0, 0.03, 2)
            lines.append(f"EDGE_SE2_XY {i} {100 + k} {nums(z)} 400 0 400")
    text2 = "\n".join(lines) + "\n"
    runs2 = {}
    for device in (None, "cpu"):
        g2 = loads_g2o(text2)
        if (g2.num_vertices(), g2.num_edges(), len(g2.parameters)) \
                != (38, 90, 2):
            raise AssertionError("the 2D tags did not load")
        sprob = g2.compile(dtype=torch.float64, device=device)
        c0 = float(robust_chi2(sprob))
        if device is None:
            kernels.reset_launch_counts()
        _, stats = optimize(sprob, iterations=6)
        if device is None:
            counts_g2o = read_counts()
        runs2[sprob.device.type] = (c0, [st_["chi2"] for st_ in stats])
    c0, chis = runs2["cuda"]
    if not (chis[-1] < 0.1 * c0 and all(np.isfinite(chis))):
        raise AssertionError(f"2D .g2o run did not converge: {c0} {chis}")
    np.testing.assert_allclose(chis, runs2["cpu"][1], rtol=1e-6)
    if min(counts_g2o["dense_assemble"], counts_g2o["lm_outcome"]) < 6:
        raise AssertionError(f"2D .g2o run missed the kernels: {counts_g2o}")
    print(f"phase 5 .g2o with VERTEX_XY, EDGE_SE2_XY, PARAMS_SE2OFFSET and "
          f"EDGE_SE2_OFFSET ({len(lines)} lines) through optimize() on cuda "
          f"float64: chi2 {c0:.4f} -> "
          + " -> ".join(f"{c:.6f}" for c in chis)
          + " (equal to the CPU run, rtol 1e-6) OK")

    # the 3D tags: a small sphere (VERTEX_SE3:QUAT, EDGE_SE3:QUAT) through
    # LM-PCG, and a landmark world with PARAMS_SE3OFFSET, VERTEX_TRACKXYZ
    # and EDGE_SE3_TRACKXYZ through optimize(), each against its CPU run
    text3 = save_g2o(create_sphere(n_laps=4, n_per_lap=15, radius=10.0,
                                   seed=2)[0])
    text4 = save_g2o(Simulator3D(n_landmarks=60, seed=1).simulate(40)[0])
    for text_, algo, tags in (
            (text3, LevenbergMarquardtPCG, ("VERTEX_SE3:QUAT",
                                            "EDGE_SE3:QUAT")),
            (text4, LevenbergMarquardt, ("PARAMS_SE3OFFSET",
                                         "VERTEX_TRACKXYZ",
                                         "EDGE_SE3_TRACKXYZ"))):
        if not all(any(ln.startswith(t_ + " ") for ln in text_.splitlines())
                   for t_ in tags):
            raise AssertionError(f"the 3D .g2o text lacks one of {tags}")
        runs3 = {}
        for device in (None, "cpu"):
            g3 = loads_g2o(text_)
            sprob = g3.compile(dtype=torch.float64, device=device)
            c0 = float(robust_chi2(sprob))
            if device is None:
                kernels.reset_launch_counts()
            _, stats = optimize(sprob, algo(), iterations=6)
            if device is None:
                counts_g2o3 = read_counts()
            runs3[sprob.device.type] = (c0, [st_["chi2"] for st_ in stats])
        c0, chis = runs3["cuda"]
        if not (chis[-1] < 0.5 * c0 and all(np.isfinite(chis))):
            raise AssertionError(f"3D .g2o run did not converge: {c0} {chis}")
        np.testing.assert_allclose(chis, runs3["cpu"][1], rtol=1e-6)
        need = (("edge_se3_blocks", "retract_se3", "se3_edge_chi2")
                if algo is LevenbergMarquardtPCG else ("dense_assemble",))
        if min(counts_g2o3[k] for k in need) < 6:
            raise AssertionError(f"3D .g2o run missed the kernels: "
                                 f"{counts_g2o3}")
        print(f"phase 5 .g2o with {', '.join(tags)} "
              f"({len(text_.splitlines())} lines) through optimize("
              f"{algo.__name__}) on cuda float64: chi2 {c0:.4f} -> "
              + " -> ".join(f"{c:.6f}" for c in chis)
              + " (equal to the CPU run, rtol 1e-6) OK")

    # a BA scene in the expmap tags (camera-to-world in the file) through
    # the Schur solver, against its CPU run
    rng = np.random.default_rng(9)
    pts = rng.uniform(-2, 2, size=(60, 3)) + np.array([0.0, 0.0, 8.0])
    lines = ["PARAMS_CAMERAPARAMETERS 0 500.0 320.0 240.0 0.1"]
    w2c = []
    for i in range(6):
        c2w = np.array([0.6 * i - 1.5, 0.1 * i, 0.0, 0.0, 0.0, 0.0, 1.0])
        w2c.append(np_lie.se3_inverse(c2w))
        c2w[:3] += rng.normal(0, 0.05, 3) if i else 0.0
        lines.append(f"VERTEX_SE3:EXPMAP {i} {nums(c2w)}")
    lines.append("FIX 0")
    info6 = " ".join("100" if a == b_ else "0" for a in range(6)
                     for b_ in range(a, 6))
    for j, p_ in enumerate(pts):
        lines.append(f"VERTEX_XYZ {100 + j} "
                     + nums(p_ + rng.normal(0, 0.2, 3)))
        for i in range(6):
            pc = np_lie.se3_apply(w2c[i], p_)
            uv = pc[:2] / pc[2] * 500.0 + np.array([320.0, 240.0]) \
                + rng.normal(0, 0.5, 2)
            lines.append(f"EDGE_PROJECT_XYZ2UV:EXPMAP {100 + j} {i} 0 "
                         f"{nums(uv)} 1 0 1")
    for i in range(5):
        z = np_lie.se3_compose(w2c[i + 1], np_lie.se3_inverse(w2c[i]))
        lines.append(f"EDGE_SE3:EXPMAP {i} {i + 1} {nums(z)} {info6}")
    text5 = "\n".join(lines) + "\n"
    runs5 = {}
    for device in (None, "cpu"):
        sprob = loads_g2o(text5).compile(dtype=torch.float64, device=device)
        c0 = float(robust_chi2(sprob))
        if device is None:
            kernels.reset_launch_counts()
        _, stats = optimize(sprob, ba_ell.LevenbergMarquardtSchurELL(),
                            iterations=6)
        if device is None:
            counts_g2o5 = read_counts()
        runs5[sprob.device.type] = (c0, [st_["chi2"] for st_ in stats])
    c0, chis = runs5["cuda"]
    if not (chis[-1] < 0.1 * c0 and all(np.isfinite(chis))):
        raise AssertionError(f"BA .g2o run did not converge: {c0} {chis}")
    np.testing.assert_allclose(chis, runs5["cpu"][1], rtol=1e-6)
    need5 = ("ba_xyz2uv_blocks", "ba_schur_dense", "dense_assemble",
             "lm_outcome")
    if min(counts_g2o5[k] for k in need5) < 6:
        raise AssertionError(f"BA .g2o run missed the kernels: {counts_g2o5}")
    print(f"phase 5 .g2o with PARAMS_CAMERAPARAMETERS, VERTEX_SE3:EXPMAP, "
          f"VERTEX_XYZ, EDGE_PROJECT_XYZ2UV:EXPMAP and EDGE_SE3:EXPMAP "
          f"({len(lines)} lines) through optimize(LevenbergMarquardtSchurELL"
          f"()) on cuda float64: chi2 {c0:.4f} -> "
          + " -> ".join(f"{c:.6f}" for c in chis)
          + " (equal to the CPU run, rtol 1e-6) OK")

    # -- 6. launch counts of the driven paths --------------------------------
    # K4's lane_block_mv_dot on the preconditioned Schur phases: one launch
    # per pose group per CG iteration (cg_update_xr counts one per group)
    # and per solve's start, where the parent launched lane_block_mv and
    # dot_partials; dot_partials launches no more there
    for label, c_ in (("4h", counts_ba400), ("4i 2D", counts_4i["2D"]),
                      ("4i 3D", counts_4i["3D"]),
                      *((f"4p {k_} {t_}", c_)
                        for (k_, t_), c_ in counts_bal.items()
                        if k_ == "400k"),
                      *((ph, c_) for ph, c_ in counts_gen.items())):
        widths_ = {d_: c_[f"lane_block_mv_dot@d{d_}"] for d_ in (4, 6, 9)
                   if c_.get(f"lane_block_mv_dot@d{d_}")}
        print(f"phase 6 preconditioner in phase {label}: lane_block_mv_dot="
              f"{c_['lane_block_mv_dot']} (by width {widths_ or 'not split'}"
              f"), dot_partials={c_['dot_partials']}, lane_block_mv="
              f"{c_['lane_block_mv']}, cg_update_xr={c_['cg_update_xr']} "
              f"(one per pose group per CG iteration), solves (cg_finish)="
              f"{c_['cg_finish']}")
        if c_["dot_partials"] or c_["lane_block_mv_dot"] < (
                c_["cg_update_xr"] + c_["cg_finish"]):
            raise AssertionError(f"phase {label}: the preconditioned CG "
                                 f"did not run on lane_block_mv_dot: {c_}")
    # a wrapper with a 6x6 row of its own counts the SE2, probe and dense 2D
    # paths in its 3x3 row and the SE3 and dense 3D paths in its 6x6 row;
    # every other wrapper counts all of them
    launches_d6 = {k: counts_sphere[k] + counts_sphere_cheb[k]
                   + counts_dense3[k] for k in counts_main}
    two_rows = {wname for wname, _, _ in KERNELS_D6.values()}
    # the BA wrappers' own rows count every BA path (4g, 4h, 4i); their
    # rows at other shapes and instantiations count their own phase
    by_phase = {"4g": counts_ba80, "4h": counts_ba400,
                "4i 2D": counts_4i["2D"], "4i 3D": counts_4i["3D"],
                "4p 80k": counts_bal[("80k", "float32")],
                "4p 400k": counts_bal[("400k", "float32")],
                "4p 80k float64": counts_bal[("80k", "float64")]}
    # ... and, with K14's wrapper, every general Schur phase (4j-4n); the
    # pair kernels' rows count 4s's 2D worlds, their "@3d" rows 4f's world
    launches = {k: counts_main[k] + counts_cheb[k] + counts_probe[k]
                + counts_dense[k] + (0 if k in two_rows else launches_d6[k])
                + (sum(c[k] for c in by_phase.values())
                   if k.startswith(("ba_", "edge_lin_", "trial_",
                                    "chi2_sum", "lane_block_mv_dot"))
                   else 0)
                + (sum(c[k] for c in counts_gen.values())
                   if k.startswith(("ba_", "schur_", "edge_lin_", "trial_",
                                    "chi2_sum", "lane_block_mv_dot"))
                   else 0)
                + (counts_4o[k] + counts_4r[k]
                   if k.startswith(("edge_lin_", "trial_", "chi2_sum"))
                   else 0)
                + (sum(c[k] for (w_, _), c in counts_4s.items()
                       if not (k.startswith("pair_") and "4f" in w_))
                   if k.startswith(("pair_", "edge_lin_", "trial_",
                                    "chi2_sum")) else 0)
                for k in counts_main}
    print("phase 6 trial_retract_groups launches per vertex type served, "
          "summed over the phases as its rows count them: " + " ".join(
              f"{v_}={launches[f'trial_retract_groups@{v_}']}"
              for v_ in trial.RETRACT_IDS))
    for label, counts in (("4 main path", counts_main),
                          ("4b Chebyshev path", counts_cheb),
                          ("4c probe path", counts_probe),
                          ("4d dense path", counts_dense),
                          ("4e SE3 main path", counts_sphere),
                          ("4e SE3 Chebyshev window", counts_sphere_cheb),
                          ("4e benchmark-shaped sphere", counts_bench),
                          ("4f dense 3D path", counts_dense3),
                          ("4g BA dense-Schur route", counts_ba80),
                          ("4h BA implicit route", counts_ba400),
                          ("4i 2D world Schur runs", counts_4i["2D"]),
                          ("4i 3D world Schur runs", counts_4i["3D"]),
                          *((f"{ph} general Schur path", c_)
                            for ph, c_ in counts_gen.items()),
                          ("4o dense LM worlds", counts_4o),
                          *((f"4s {w_} {t_} run", c_)
                            for (w_, t_), c_ in counts_4s.items()),
                          ("4r dense route at block width 9", counts_4r),
                          *((f"4p BAL {k_} {t_} runs", c_)
                            for (k_, t_), c_ in counts_bal.items())):
        print(f"phase 6 launches in the phase-{label}: "
              + " ".join(f"{k}={v}" for k, v in counts.items() if v))
    # the unpreconditioned solves run the two-launch step (spmv_dot_p),
    # the preconditioned ones cg_update_p
    main_kernels = ("block_ell_spmv", "edge_se2_blocks", "assemble_gather",
                    "damp_chol", "jacobi_scale", "lane_block_mv", "spmv_dot",
                    "spmv_dot_p", "cg_residual", "cg_start", "cg_update_xr",
                    "cg_finish", "retract_chi2", "lm_outcome")
    cheb_kernels = tuple(k for k in main_kernels if k != "spmv_dot_p") + (
        "cg_update_p", "dot_partials", "gershgorin_bound",
        "chebyshev_coeffs", "chebyshev_init", "chebyshev_update")
    sphere_kernels = tuple(
        {"edge_se2_blocks": "edge_se3_blocks", "retract_chi2": "retract_se3"}
        .get(k, k) for k in main_kernels) + ("se3_edge_chi2",)
    never = ([k for k in main_kernels if counts_main[k] <= 0]
             + [k for k in sphere_kernels if counts_sphere[k] <= 0]
             + [k for k in ("dense_assemble", "lm_outcome")
                if counts_dense3[k] <= 0]
             + [k for k in ("gershgorin_bound", "chebyshev_update",
                            "cg_update_p") if counts_sphere_cheb[k] <= 0]
             + [k for k, (w, _, _) in KERNELS_D6.items()
                if launches_d6[w] <= 0]
             + [k for k in cheb_kernels if counts_cheb[k] <= 0]
             + [k for k in ("lane_gather",) if counts_probe[k] <= 0]
             + [k for k in ("dense_assemble", "lm_outcome")
                if counts_dense[k] <= 0]
             + [k for k in ("ba_xyz2uv_blocks", "ba_lm_sums", "ba_cam_sums",
                            "ba_block_inv", "ba_schur_dense",
                            "ba_schur_records", "ba_wtx", "ba_wv",
                            "lm_outcome") if counts_ba80[k] <= 0]
             + [k for k in ("ba_xyz2uv_blocks", "ba_lm_sums", "ba_cam_sums",
                            "ba_block_inv", "ba_sandwich", "ba_wtx", "ba_wv",
                            "lane_block_mv_dot", "cg_update_xr",
                            "cg_update_p", "lm_outcome")
                if counts_ba400[k] <= 0]
             + [f"{k} (4p {key_} {tag_})"
                for (key_, tag_), c_ in counts_bal.items()
                for k in (("edge_lin_bal", "trial_chi2_bal",
                           "trial_retract_groups", "ba_edge_blocks",
                           "ba_lm_sums", "ba_cam_sums", "ba_block_inv",
                           "ba_wtx", "ba_wv", "lm_outcome")
                          + (("ba_schur_dense", "ba_schur_records")
                             if key_ == "80k" else
                             ("ba_sandwich", "ba_block_inv@d9",
                              "lane_block_mv_dot@d9", "cg_update_xr",
                              "cg_update_p")))
                if c_[k] <= 0]
             + [f"{k} ({w_})" for w_ in ("2D", "3D")
                for k in ("ba_edge_blocks", "ba_lm_sums", "ba_cam_sums",
                          "ba_block_inv", "ba_sandwich", "ba_wtx", "ba_wv",
                          "dense_assemble", "cg_update_p")
                if counts_4i[w_][k] <= 0]
             + [f"{k} ({ph})" for ph in ("4j", "4k", "4l", "4n")
                for k in ("schur_edge_blocks", "ba_wv", "ba_sandwich",
                          "ba_lm_sums", "ba_wtx", "ba_block_inv",
                          "lane_block_mv_dot", "dense_assemble",
                          "cg_update_xr", "cg_update_p", "lm_outcome")
                if counts_gen[ph][k] <= 0]
             + [f"spmv_dot_p ({ph})" for ph, c_ in (
                 ("4b", counts_cheb), ("4e Chebyshev", counts_sphere_cheb),
                 ("4h", counts_ba400), ("4i 2D", counts_4i["2D"]),
                 ("4i 3D", counts_4i["3D"]),
                 *((ph_, c2) for ph_, c2 in counts_gen.items()))
                if c_.get("spmv_dot_p", 0) > 0]
             + [f"{k} ({ph})" for k, ph in LIN_ROWS.items()
                if {"4d": counts_dense, "4f": counts_dense3,
                    "4o": counts_4o, "4p": counts_4p,
                    **counts_gen}[ph][k] <= 0]
             + [f"{k} ({ph})" for k, ph in TRIAL_ROWS.items()
                if {"4d": counts_dense, "4f": counts_dense3,
                    "4g": counts_ba80, "4o": counts_4o, "4p": counts_4p,
                    **counts_gen}[ph][k] <= 0]
             + [k for k, ph in PHASE_ROWS.items()
                if {"4d": counts_dense, "4f": counts_dense3,
                    "4o": counts_4o, "4p": counts_4p,
                    **counts_gen}[ph][k.split("@")[0]]
                <= 0]
             + [f"{k} (4s {w_} {t_})" for (w_, t_), c_ in counts_4s.items()
                for k in ("pair_stream", "pair_assemble", "pair_scale",
                          "pair_spmv", "pair_spmv_dot")
                + (("cg_update_p",) if "cheby" in w_
                   else ("pair_spmv_dot_p",)) if c_[k] <= 0]
             + [f"pair_gershgorin ({w_})" for w_ in ("cheby", "cheby 4f")
                if counts_4s[(w_, "float32")]["pair_gershgorin"] <= 0]
             + [k for k, v in launches_d2.items() if v <= 0]
             + [f"trial_retract_groups@{v_}" for v_ in trial.RETRACT_IDS
                if launches[f"trial_retract_groups@{v_}"] <= 0]
             + [k for k in KERNELS if launches[k] <= 0]
             + [k for k, phs in WIDE_ROWS.items()
                if min({**counts_gen, "4r": counts_4r}[ph][
                    k.split("@")[0]] for ph in phs) <= 0])
    # every wrapper is a row of the path (read_counts' per-type counts of
    # trial_retract_groups are rows of their own)
    if never or set(KERNELS) != {k for k in launches if not k.startswith(
            "trial_retract_groups@")}:
        raise AssertionError(f"a kernel of a path never launched (or the "
                             f"two-launch step on a preconditioned path): "
                             f"{never}")
    print(f"phase 6 generic linearizations (linearize_edges, "
          f"forward_jacobians) of a built-in edge type on the card outside "
          f"the plain-route runs, phases 4-5: {len(generic_calls)}")
    if generic_calls:
        raise AssertionError(f"the generic route ran on the card: "
                             f"{sorted(set(generic_calls))}")
    # K7 on the dense and Schur routes: its launches per phase, and no
    # built-in type on the plain trial
    k7_names = ("lm_outcome", "chi2_sum", "trial_retract_groups",
                *trial.CHI2.values())
    for label, counts in (("4d", counts_dense), ("4f", counts_dense3),
                          *((f"4s {w_} {t_}", c_)
                            for (w_, t_), c_ in counts_4s.items()),
                          ("4g", counts_ba80), ("4h", counts_ba400),
                          ("4i 2D", counts_4i["2D"]),
                          ("4i 3D", counts_4i["3D"]),
                          *counts_gen.items(), ("4o", counts_4o),
                          ("4p", counts_4p), ("4r", counts_4r)):
        k7_c = {k: counts[k] for k in k7_names if counts[k]}
        print(f"phase 6 K7 launches in phase {label}: "
              f"{sum(k7_c.values())} (" + " ".join(
                  f"{k}={v}" for k, v in k7_c.items()) + ")")
    print(f"phase 6 plain trial retractions and chi2 (trial.retract_plain, "
          f"trial.chi2_plain) of a built-in type on the card outside the "
          f"plain-route runs, phases 4-5: {len(plain_trial_calls)}")
    if plain_trial_calls:
        raise AssertionError(f"the plain trial ran on the card: "
                             f"{sorted(set(plain_trial_calls))}")

    print(f"chip_smoke: every phase in {time.monotonic() - t_main:.1f} s, "
          f"the build included")
    print(smi)
    report = {"kernels": [
        {"name": wname, "route": "cuda",
         "source": f"openslam_g2o_torch/kernels/csrc/{src}",
         "replaces": replaces, "launches": launches[wname],
         "max_abs_err": results[(wname, "float32")]["abs"],
         "ms": results[(wname, "float32")]["ms"],
         "plain_ms": results[(wname, "float32")]["plain_ms"],
         "bound_ms": results[(wname, "float32")]["bound_ms"],
         "bound_by": results[(wname, "float32")]["bound_by"],
         "library_ms": results[(wname, "float32")]["library_ms"]}
        for wname, (src, replaces) in KERNELS.items()]}
    # the 6x6 instantiations, with the launches of the SE3 paths
    report["kernels"] += [
        {"name": label, "route": "cuda",
         "source": f"openslam_g2o_torch/kernels/csrc/{src}",
         "replaces": replaces, "launches": launches_d6[wname],
         "max_abs_err": results[(label, "float32")]["abs"],
         "ms": results[(label, "float32")]["ms"],
         "plain_ms": results[(label, "float32")]["plain_ms"],
         "bound_ms": results[(label, "float32")]["bound_ms"],
         "bound_by": results[(label, "float32")]["bound_by"],
         "library_ms": results[(label, "float32")]["library_ms"]}
        for label, (wname, src, replaces) in KERNELS_D6.items()]
    # the BA kernels' rows at the other shapes and instantiations
    general = lambda lbl: (lbl.endswith(tuple(GENERAL_SUFFIXES))
                           and lbl not in PHASE_ROWS
                           and not lbl.startswith("trial_retract_groups"))
    for label in sorted(lbl for (lbl, tg), row in results.items()
                        if tg == "float32" and "@" in lbl
                        and row["kname"].startswith("ba_")
                        and not general(lbl)):
        row = results[(label, "float32")]
        phase = next((ph for sfx, ph in BA_SUFFIXES.items()
                      if label.endswith(sfx)), "4g")
        src, replaces = KERNELS[row["kname"]]
        # K11's 9-wide inverse rows: its launches at D = 9
        key = row["kname"] + ("@d9" if label.startswith(
            "ba_block_inv@cam@bal") else "")
        report["kernels"].append(
            {"name": label, "route": "cuda",
             "source": f"openslam_g2o_torch/kernels/csrc/{src}",
             "replaces": replaces,
             "launches": by_phase[phase][key],
             "max_abs_err": row["abs"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # the general Schur path's instantiations, with the launches of their
    # phase (the @d4 rows: the launches at D = 4 only)
    for label in sorted(lbl for (lbl, tg) in results
                        if tg == "float32" and general(lbl)):
        row = results[(label, "float32")]
        phase = next(ph for sfx, ph in GENERAL_SUFFIXES.items()
                     if label.endswith(sfx))
        src, _ = KERNELS[row["kname"]]
        key = row["kname"] + ("@d4" if label.endswith("@d4") else "")
        report["kernels"].append(
            {"name": label, "route": "cuda",
             "source": f"openslam_g2o_torch/kernels/csrc/{src}",
             "replaces": GENERAL_REPLACES[row["kname"]],
             "launches": counts_gen[phase][key],
             "max_abs_err": row["abs"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # K14 at (9, 3) and K15 at block width 9, with the launches of the
    # phases that run them there
    for label, phs in WIDE_ROWS.items():
        row = results[(label, "float32")]
        src, replaces = KERNELS[row["kname"]]
        if not label.endswith("@d9"):
            replaces = GENERAL_REPLACES[row["kname"]]
        report["kernels"].append(
            {"name": label, "route": "cuda",
             "source": f"openslam_g2o_torch/kernels/csrc/{src}",
             "replaces": replaces,
             "launches": sum({**counts_gen, "4r": counts_4r}[ph][
                 row["kname"]] for ph in phs),
             "max_abs_err": row["abs"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # K17's closed forms and K7's chi2 at their phases' own group sizes,
    # with the launches of that phase and the figures of the dtype it runs
    phase_counts = {"4d": counts_dense, "4f": counts_dense3,
                    "4o": counts_4o, "4p": counts_4p, **counts_gen}
    for label, phase in PHASE_ROWS.items():
        row = results[(label, "float64" if phase in FLOAT64_PHASES
                       else "float32")]
        src, replaces = KERNELS[row["kname"]]
        report["kernels"].append(
            {"name": label, "route": "cuda",
             "source": f"openslam_g2o_torch/kernels/csrc/{src}",
             "replaces": replaces,
             "launches": phase_counts[phase][row["kname"]],
             "max_abs_err": row["abs"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # K4 at D = 9, the implicit route's preconditioner step on the BAL
    # camera (lane_block_mv_dot), with its launches at that
    # width in phase 4p
    row = results[("lane_block_mv_dot@d9", "float32")]
    report["kernels"].append(
        {"name": "lane_block_mv_dot@d9", "route": "cuda",
         "source": "openslam_g2o_torch/kernels/csrc/jacobi_scale.cu",
         "replaces": "openslam_g2o_tpu/core/ba_ell.py:808",
         "launches": counts_4p["lane_block_mv_dot@d9"],
         "max_abs_err": row["abs"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # K7's trial_retract_groups at 4p @400k's and 4l's groups, with the
    # launches of that phase, and on each vertex type's seeded group, with
    # the launches that served a group of that type (phases 4-5)
    group_counts = {"4p 400k": by_phase["4p 400k"], **counts_gen}
    for label, (phase, _) in GROUP_ROWS.items():
        if label == "trial_retract_groups":
            continue                        # the KERNELS row
        row = results[(label, "float32")]
        report["kernels"].append(
            {"name": label, "route": "cuda",
             "source": "openslam_g2o_torch/kernels/csrc/trial.cu",
             "replaces": KERNELS["trial_retract_groups"][1],
             "launches": group_counts[phase]["trial_retract_groups"],
             "max_abs_err": row["abs"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    for vname in trial.RETRACT_IDS:
        label = f"trial_retract_groups@{vname}"
        row = results[(label, "float32")]
        report["kernels"].append(
            {"name": label, "route": "cuda",
             "source": "openslam_g2o_torch/kernels/csrc/trial.cu",
             "replaces": KERNELS["trial_retract_groups"][1],
             "launches": launches[label],
             "max_abs_err": row["abs"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # K3 and K4's lane_block_mv at D = 2, the landmarks of phase 4s, with
    # their launches at that width there
    for label, src, replaces in (
            ("damp_chol@d2", "damp_chol.cu",
             "openslam_g2o_tpu/core/solvers.py:63"),
            ("lane_block_mv@d2", "jacobi_scale.cu",
             "openslam_g2o_tpu/core/sparse.py:871")):
        row = results[(label, "float32")]
        report["kernels"].append(
            {"name": label, "route": "cuda",
             "source": f"openslam_g2o_torch/kernels/csrc/{src}",
             "replaces": replaces, "launches": launches_d2[label],
             "max_abs_err": row["abs"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # the pair kernels at phase 4f's world ((6, 6), (6, 3), (3, 6), (3, 3)),
    # with the launches of 4s's runs on that world (K8': its pcg_cheby 4
    # run)
    for wname in ("pair_stream", "pair_assemble", "pair_scale", "pair_spmv",
                  "pair_spmv_dot", "pair_spmv_dot_p", "pair_gershgorin"):
        label = wname + "@3d"
        row = results[(label, "float32")]
        src, replaces = KERNELS[wname]
        report["kernels"].append(
            {"name": label, "route": "cuda",
             "source": f"openslam_g2o_torch/kernels/csrc/{src}",
             "replaces": replaces,
             "launches": sum(c_[wname] for (w_, _), c_ in counts_4s.items()
                             if "4f" in w_),
             "max_abs_err": row["abs"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
