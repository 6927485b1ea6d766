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
    landmark worlds of phases 4d and 4f, twice for the same bits, and on
    the 2D world once more with its width-3 instantiation switched off (a
    second build of dense_assemble.cu), for what that instantiation saves.
    On the sphere of phase 4e: K16 (edge_se3_blocks, without and with a robust
    kernel), K7 for SE3 (retract_se3, se3_edge_chi2, a NaN dx) and the 6x6
    instantiations of kernels A and C, damp_chol (a non-SPD 6x6 block),
    jacobi_scale (a NaN factor), lane_block_mv, spmv_dot and
    gershgorin_bound, with torch.linalg.cholesky + solve_triangular, a BSR
    product of block size 6 and torch.bmm as the library yardsticks.
    The CG kernels' scalar buffer is held slot by slot, each scalar
    relative to its own plain value and the pd/continue flags exactly,
    also where they must be 0 (negative and NaN curvature, sticky pd,
    r2 <= thresh);
 4. the main path: the 100,000-pose serpentine (noise 0.03 / 0.002, float32)
    through LevenbergMarquardtPCG's lambda init and lm_pcg_optimize_fused
    windows (pcg 100, tol 0.15) until chi2 <= 1.05 x the noise floor, then
    warm polish windows (pcg 600, tol 1e-6) until <= 1.02 x; the first 3
    iterations are held against the same run with every kernel replaced by
    its plain version, to rtol 2e-4 (float32 sums in another order);
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
    the same bits; ms per iteration split into linearize / assemble /
    factor + solve / retract + chi2, and the device's busy time by kernel
    over 3 iterations (torch.profiler);
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
    checks of 4d (K15 at block width 6) and its profile of 3 iterations;
 5. a small .g2o string through loads_g2o -> compile() (the default
    device) -> optimize(LevenbergMarquardtPCG()), chi2 decreasing and equal
    to the CPU run of the same graph; one with VERTEX_XY, EDGE_SE2_XY
    and a PARAMS_SE2OFFSET / EDGE_SE2_OFFSET pair through optimize(), the
    default algorithm, against its CPU run; and two with the 3D tags: a
    sphere (VERTEX_SE3:QUAT, EDGE_SE3:QUAT) through LM-PCG and a landmark
    world (PARAMS_SE3OFFSET, VERTEX_TRACKXYZ, EDGE_SE3_TRACKXYZ) through
    the dense LM;
 6. every kernel's launch count in the paths of phases 4-4f, each > 0. A
    count is one per wrapper call that launched; cg_finish launches two
    kernels per vector and gershgorin_bound two per call. The 6x6
    instantiations are listed apart, with the launches of the SE3 and
    dense 3D paths, which their 3x3 rows then leave out.
The last two lines are the per-kernel JSON and {"ok": true, "device": ...}.
Exits non-zero without printing a result when no GPU is visible.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
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
       "se3_edge_chi2": {"float32": 1e-4, "float64": 1e-11}}
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
    "spmv_dot": ("cg_step.cu", "openslam_g2o_tpu/core/solvers.py:263"),
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
}
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
    "gershgorin_bound@d6": ("gershgorin_bound", "chebyshev.cu",
                            "openslam_g2o_tpu/core/sparse.py:1270"),
    "dense_assemble@d6": ("dense_assemble", "dense_assemble.cu",
                          "openslam_g2o_tpu/core/problem.py:415"),
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


def _errors(torch, got, want, same_nan=False):
    """(max abs error, max error relative to the largest finite |entry| of
    its output) over the tensors a kernel and its plain version returned.
    With same_nan the two must be NaN in exactly the same places, and the
    errors are taken over the other entries."""
    as_tuple = lambda o: o if isinstance(o, (tuple, list)) else (o,)
    abs_err = rel_err = 0.0
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import numpy as np
    from openslam_g2o_torch import kernels, loads_g2o, save_g2o
    from openslam_g2o_torch.apps.simulator import (
        Simulator2D, Simulator3D, create_sphere, synthetic_pose_graph_2d)
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
        assemble, build, cg_step, chebyshev, damp_chol, dense_assemble,
        edge_se2, edge_se3, gather, jacobi_scale, retract_chi2, spmv)
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
             slow_plain=False):
        """Compare one kernel with its plain version (`run` and `plain`
        return the tensors to compare; `post` first reduces partial sums
        and splits a scalar buffer, on both sides), time both (a plain
        version of tens of ms: median of 5 single calls), and record the
        row under (label or kname, tag)."""
        post = post or (lambda out: out)
        abs_e, rel_e = _errors(torch, post(run()), post(plain()), same_nan)
        row = dict(abs=abs_e, rel=rel_e, shape=shape, kname=kname)
        if timed:
            row.update(ms=_median_ms(torch, run),
                       plain_ms=(_median_ms(torch, plain, 5, 1, 1)
                                 if slow_plain else _median_ms(torch, plain)),
                       library_ms=(None if library is None
                                   else _median_ms(torch, library)))
            row["bound_ms"], row["bound_by"] = _bound(nbytes, flops)
        results[(label or kname, tag)] = row

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

        # B and C
        hk = torch.empty((9, 4 * E), dtype=dt, device=dev)
        bk = torch.empty((3, 2 * E), dtype=dt, device=dev)
        hp_, bp_ = torch.empty_like(hk), torch.empty_like(bk)
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
        hdest = torch.empty(4 * E, dtype=torch.long, device=dev)
        bdest = torch.empty(2 * E, dtype=torch.long, device=dev)
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
        case("damp_chol", tag, f"N={N}",
             lambda: damp_chol.damp_chol(values, free, b, lam),
             lambda: damp_chol.damp_chol_plain(values, free, b, lam),
             nbytes=s * (9 + 1 + 3 + 9 + 9 + 3 + 1) * N, flops=60 * N)
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
        def sums(*which, scal=False):
            """Reduce the partial-sum outputs at the given positions. With
            `scal` the last output is the scalar buffer and is split into
            its slots, one tensor each, so that every scalar is held
            relative to its own plain value and not to the largest of the
            ten (rz, r2 and b2 are ~|b|^2; alpha, beta and the flags ~1)."""
            def post(out):
                out = [o.sum() if i in which else o
                       for i, o in enumerate(out)]
                return (*out[:-1], *out[-1].unbind()) if scal else tuple(out)
            return post

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
        case("cg_update_p", tag, f"n={n}",
             lambda: run_p(cg_step.cg_update_p, state["k"]),
             lambda: run_p(cg_step.cg_update_p_plain, state["p"]),
             nbytes=3 * s * n, flops=2 * n, post=sums(scal=True))
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
        hk = torch.empty((36, 4 * E), dtype=dt, device=dev)
        bk = torch.empty((6, 2 * E), dtype=dt, device=dev)
        hp_, bp_ = torch.empty_like(hk), torch.empty_like(bk)
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
                 nbytes=s * (14 * E + 2 * E + 44 * E + 156 * E) + 8 * E,
                 flops=6000 * E, label=klabel, timed=kid == 0,
                 slow_plain=True)
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
        hdest = torch.empty(4 * E, dtype=torch.long, device=dev)
        bdest = torch.empty(2 * E, dtype=torch.long, device=dev)
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

        def lib_chol():
            blocks = (values[0].view(6, 6, N).permute(2, 0, 1)
                      + (lam * free + (1 - free))[:, None, None] * eye6)
            L = torch.linalg.cholesky(blocks)
            return torch.linalg.solve_triangular(L, eye6.expand(N, 6, 6),
                                                 upper=False)

        case("damp_chol", tag, f"D=6 N={N}",
             lambda: damp_chol.damp_chol(values, free, b, lam),
             lambda: damp_chol.damp_chol_plain(values, free, b, lam),
             nbytes=s * (36 + 1 + 6 + 36 + 36 + 6 + 1) * N, flops=400 * N,
             library=lib_chol, label="damp_chol@d6", slow_plain=True)
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
            T = dprob.static.total_dim
            dpattern = dense_assemble.build_dense_pattern(dprob)
            lin = problem_mod.linearize(dprob)
            dgroups = [dense_assemble.EdgeBlocks(
                lin[eg.key][0].contiguous(),
                tuple(j.contiguous() for j in lin[eg.key][1]), lin[eg.key][2],
                dprob.edges[eg.key].information, dpattern.offsets[i])
                for i, eg in enumerate(dprob.static.egroups)]
            fixed_t = problem_mod.tangent_masks(dprob)[1]
            # the library yardstick: one index_put_ per slot pair on the
            # precomputed blocks (H only; the products are not timed)
            lib_H = torch.zeros((T, T), dtype=dt, device=dev)
            lib_ops = []
            nbytes, flops = s * (T * T + 3 * T), 0
            for gi, gblk in enumerate(dgroups):
                w_om = gblk.rho1[:, None, None] * gblk.info
                E_g, D_g = gblk.resid.shape
                widths = [j.shape[2] for j in gblk.jacs]
                nbytes += s * E_g * (D_g + D_g * sum(widths) + 1 + D_g * D_g)
                nbytes += 4 * sum(tb.ptr.numel() + 2 * tb.n_dest
                                  + 2 * tb.edge.numel()
                                  for tb in dpattern.pairs[gi])
                idx = [o.long()[:, None]
                       + torch.arange(w_, device=dev)[None, :]
                       for o, w_ in zip(gblk.offsets, widths)]
                for s_ in range(len(widths)):
                    jw = edge_se2.bmm_small(gblk.jacs[s_].transpose(1, 2),
                                            w_om)
                    for t_ in range(s_, len(widths)):
                        blk = edge_se2.bmm_small(jw, gblk.jacs[t_])
                        flops += (2 * E_g * widths[s_] * D_g
                                  * (D_g + widths[t_]))
                        lib_ops.append((idx[s_][:, :, None],
                                        idx[t_][:, None, :], blk))
                        if t_ != s_:
                            lib_ops.append((idx[t_][:, :, None],
                                            idx[s_][:, None, :],
                                            blk.transpose(1, 2).contiguous()))

            def lib_dense():                     # accumulates; timed only
                for rows_i, cols_i, blk in lib_ops:
                    lib_H.index_put_((rows_i, cols_i), blk, accumulate=True)

            dargs = (dgroups, T, fixed_t, dpattern, True)
            case("dense_assemble", tag,
                 f"T={T} E="
                 + "+".join(str(g_.resid.shape[0]) for g_ in dgroups)
                 + f" ({nbytes / 1e6:.1f} MB)",
                 lambda: dense_assemble.dense_assemble(*dargs),
                 lambda: dense_assemble.dense_assemble_plain(*dargs),
                 nbytes=nbytes, flops=flops, library=lib_dense,
                 label=k15_label, slow_plain=k15_label is not None)
            once = dense_assemble.dense_assemble(*dargs)
            if not all(torch.equal(a_, b_) for a_, b_ in
                       zip(once, dense_assemble.dense_assemble(*dargs))):
                raise AssertionError("dense_assemble does not repeat its bits")
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
            del lib_H, lib_ops, lin, dgroups, once, dprob, dpattern
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for (label, tag), row in sorted(results.items()):
        tol = TOL.get(label, TOL.get(row["kname"], TOL_DEFAULT))[tag]
        ok = row["rel"] <= tol
        timing = ""
        if "ms" in row:
            lib = ("none" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f} ms")
            timing = (f" kernel {row['ms']:.4f} ms plain "
                      f"{row['plain_ms']:.4f} ms bound "
                      f"{row['bound_ms']:.5f} ms ({row['bound_by']}) "
                      f"library {lib}")
        print(f"phase 3 kernel {label} {tag} {row['shape']}: max_abs_err "
              f"{row['abs']:.3e} max_rel_err {row['rel']:.3e} (tol {tol:g})"
              f"{timing} [{card}] {'OK' if ok else 'FAIL'}")
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
             (cg_step, "spmv_dot"), (cg_step, "dot_partials"),
             (cg_step, "cg_residual"), (cg_step, "cg_start"),
             (cg_step, "cg_update_xr"), (cg_step, "cg_update_p"),
             (cg_step, "cg_finish"), (chebyshev, "gershgorin_bound"),
             (chebyshev, "chebyshev_coeffs"), (chebyshev, "chebyshev_init"),
             (chebyshev, "chebyshev_update"), (gather, "lane_gather"),
             (retract_chi2, "retract_chi2"), (retract_chi2, "lm_outcome"),
             (dense_assemble, "dense_assemble")]

    class plain_versions:
        """Every wrapper swapped for its plain version (CUDA tensors, plain
        PyTorch ops) inside the block; fails if a kernel launched in it."""

        def __enter__(self):
            self.before = kernels.launch_counts()
            self.saved = [(mod, attr, getattr(mod, attr))
                          for mod, attr in swaps]
            for mod, attr in swaps:
                setattr(mod, attr, getattr(mod, attr + "_plain"))

        def __exit__(self, *exc):
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
    window_counts = kernels.launch_counts()
    n_polish = 0
    for _ in range(10):
        if float(st[3]) <= 1.02 * floor:
            break
        st, t_, dt_w = window(pattern, st, 5, pcg_iters=600, pcg_tol=1e-6,
                              warm=True)
        traj += t_
        n_polish += 1
    main_s = time.monotonic() - t_start
    counts_main = kernels.launch_counts()       # the main path's launches
    final = float(st[3])
    steady = [dt / n for n, dt in windows[1:]] or [windows[0][1] / 10]
    ms_first = dt_first / 10 * 1e3
    ms_steady = sorted(steady)[len(steady) // 2] * 1e3
    cg_iters = window_counts["cg_update_xr"]
    per_cg = sum(v for k, v in window_counts.items()
                 if k in ("spmv_dot", "cg_update_xr", "cg_update_p",
                          "dot_partials")) / max(cg_iters, 1)
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
    before = kernels.launch_counts()
    k7_ms = _median_ms(torch, lambda: _trial_outcome(
        work, pattern, pre["bT"], dxT_t, ok_t, st[1], st[2], st[3]),
        repeats=9, inner=1)
    k7_calls = {k: (v - before[k]) // 12 for k, v in
                kernels.launch_counts().items() if v != before[k]}
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
    counts_cheb = kernels.launch_counts()
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
    counts_probe = kernels.launch_counts()
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
    counts_dense = kernels.launch_counts()    # the dense path's launches
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
    print(f"phase 4d checks: LM chi2 never increases, every gaining step "
          f"accepted; |LM - GN| / GN = {gap:.3e} (<= 1e-6); plain route "
          f"equal to rtol {DENSE_ROUTE_RTOL:g} with the same trials while "
          f"gaining; second run bit-identical OK")
    del lm_again, plain_stats

    # the split of one LM iteration at the start (CUDA events, median of 5)
    dpat = dense_assemble.build_dense_pattern(dprob)
    lam_d = LevenbergMarquardt().init(dprob)["lam"]
    free_d = problem_mod.tangent_masks(dprob)[0]
    holder = {}

    def t_linearize():
        holder["lin"] = problem_mod.linearize(dprob)

    def t_assemble():
        holder["H"], holder["b"], _ = problem_mod.build_dense_system(
            dprob, lin=holder["lin"], pattern=dpat)

    def t_solve():
        damped = holder["H"].clone()
        damped.diagonal().add_(lam_d * free_d)
        holder["dx"], _ = solve_dense_cholesky(damped, holder["b"])

    def t_clone():
        holder["H"].clone()

    def t_retract():
        robust_chi2(dprob, problem_mod.apply_update(dprob, holder["dx"]))

    split_ms = {}
    for label, fn in (("linearize", t_linearize), ("assemble", t_assemble),
                      ("factor+solve", t_solve), ("of which clone", t_clone),
                      ("retract+chi2", t_retract)):
        split_ms[label] = _median_ms(torch, fn, repeats=5, inner=1, warmup=1)
    print("phase 4d split of one LM iteration (CUDA events, median of 5): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in split_ms.items())
          + f" [{card}]")
    del holder, lm_out, dpat

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
            seen = kernels.launch_counts()
            st_s, t_, dt_w = window(pattern_s, st_s, n_it, prob_s, **kw)
            now = kernels.launch_counts()
            traj_s += t_
            win_ms.append(dt_w / n_it * 1e3)
            per_window.append((now["cg_update_xr"] - seen["cg_update_xr"],
                               now["damp_chol"] - seen["damp_chol"],
                               kw["pcg_iters"]))
        seconds = time.monotonic() - t0_s
        counts_s = kernels.launch_counts()
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
    before = kernels.launch_counts()
    k7_ms3 = _median_ms(torch, lambda: _trial_outcome(
        work3, pattern3, pre3["bT"], dx3, ok3, st3[1], st3[2], st3[3]),
        repeats=9, inner=1)
    k7_calls3 = {k: (v - before[k]) // 12 for k, v in
                 kernels.launch_counts().items() if v != before[k]}
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
    counts_sphere_cheb = kernels.launch_counts()
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
    counts_dense3 = kernels.launch_counts()
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
    print(f"phase 4f checks: LM chi2 never increases, every gaining step "
          f"accepted; |LM - GN| / GN = {gap3:.3e} (<= 1e-6); plain route "
          f"equal to rtol {DENSE_ROUTE_RTOL:g}; second run bit-identical; "
          "split (CUDA events, median of 5): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in split3.items())
          + f" [{card}] OK")
    del lm_out3, lm_again3, holder3, dpat3, plain_stats3
    dense_profile(dprob3, "4f", also=("dense_pair",))
    del dprob3

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
            counts_g2o = kernels.launch_counts()
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
                counts_g2o3 = kernels.launch_counts()
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

    # -- 6. launch counts of the driven paths --------------------------------
    # a wrapper with a 6x6 row of its own counts the SE2, probe and dense 2D
    # paths in its 3x3 row and the SE3 and dense 3D paths in its 6x6 row;
    # every other wrapper counts all of them
    launches_d6 = {k: counts_sphere[k] + counts_sphere_cheb[k]
                   + counts_dense3[k] for k in counts_main}
    two_rows = {wname for wname, _, _ in KERNELS_D6.values()}
    launches = {k: counts_main[k] + counts_cheb[k] + counts_probe[k]
                + counts_dense[k] + (0 if k in two_rows else launches_d6[k])
                for k in counts_main}
    for label, counts in (("4 main path", counts_main),
                          ("4b Chebyshev path", counts_cheb),
                          ("4c probe path", counts_probe),
                          ("4d dense path", counts_dense),
                          ("4e SE3 main path", counts_sphere),
                          ("4e SE3 Chebyshev window", counts_sphere_cheb),
                          ("4e benchmark-shaped sphere", counts_bench),
                          ("4f dense 3D path", counts_dense3)):
        print(f"phase 6 launches in the phase-{label}: "
              + " ".join(f"{k}={v}" for k, v in counts.items() if v))
    main_kernels = ("block_ell_spmv", "edge_se2_blocks", "assemble_gather",
                    "damp_chol", "jacobi_scale", "lane_block_mv", "spmv_dot",
                    "cg_residual", "cg_start", "cg_update_xr", "cg_update_p",
                    "cg_finish", "retract_chi2", "lm_outcome")
    cheb_kernels = main_kernels + ("dot_partials", "gershgorin_bound",
                                   "chebyshev_coeffs", "chebyshev_init",
                                   "chebyshev_update")
    sphere_kernels = tuple(
        {"edge_se2_blocks": "edge_se3_blocks", "retract_chi2": "retract_se3"}
        .get(k, k) for k in main_kernels) + ("se3_edge_chi2",)
    never = ([k for k in main_kernels if counts_main[k] <= 0]
             + [k for k in sphere_kernels if counts_sphere[k] <= 0]
             + [k for k in ("dense_assemble", "lm_outcome")
                if counts_dense3[k] <= 0]
             + [k for k in ("gershgorin_bound", "chebyshev_update")
                if counts_sphere_cheb[k] <= 0]
             + [k for k, (w, _, _) in KERNELS_D6.items()
                if launches_d6[w] <= 0]
             + [k for k in cheb_kernels if counts_cheb[k] <= 0]
             + [k for k in ("lane_gather",) if counts_probe[k] <= 0]
             + [k for k in ("dense_assemble", "lm_outcome")
                if counts_dense[k] <= 0]
             + [k for k in KERNELS if launches[k] <= 0])
    if never or set(KERNELS) != set(launches):
        raise AssertionError(f"a kernel of a path never launched: {never}")

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
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
