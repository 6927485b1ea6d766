#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the script exits non-zero):
 1. the card: torch's device name and `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`; TF32 off for matmul and cuDNN;
 2. build the CUDA kernels from openslam_g2o_torch/kernels/csrc with nvcc;
 3. each kernel against its plain PyTorch version on the card, float32 and
    float64, with the time per call of both (CUDA events, median):
    kernel A at the slice shape and at the TPU probe's N=3500, K=10,
    kernels B and C on the 100k-pose graph;
 4. the slice: the 100,000-pose serpentine (noise 0.03 / 0.002, float32)
    through LevenbergMarquardtPCG's lambda init and lm_pcg_optimize_fused
    windows (pcg 100, tol 0.15) until chi2 <= 1.05 x the noise floor, then
    warm polish windows (pcg 600, tol 1e-6) until <= 1.02 x; the first 3
    iterations are held against the same run with every kernel replaced by
    its plain version, to rtol 2e-4 (float32 sums in another order);
 5. a small .g2o string through loads_g2o -> compile(device="cuda") ->
    optimize(LevenbergMarquardtPCG()), chi2 decreasing and equal to the CPU
    run of the same graph;
 6. every kernel's launch count in phase 4's main-path run, each > 0.
The last two lines are the per-kernel JSON and {"ok": true, "device": ...}.
Exits non-zero without printing a result when no GPU is visible.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# relative tolerances against the plain version, per kernel and dtype:
# A and C sum a few products in another order with FMA contraction; B's pose
# differences cancel (coordinates ~100 against residuals ~0.03), so a last
# ulp of a coordinate shows in the residual
TOL = {"A": {"float32": 2e-5, "float64": 1e-12},
       "B": {"float32": 1e-4, "float64": 1e-11},
       "C": {"float32": 2e-5, "float64": 1e-12}}
PLAIN_ROUTE_RTOL = 2e-4
N_POSES, GRID = 100000, 100


def _median_ms(torch, fn, repeats=25, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _errors(a, b):
    a, b = a.double(), b.double()
    abs_err = float((a - b).abs().max())
    return abs_err, abs_err / max(float(b.abs().max()), 1e-300)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import numpy as np
    from openslam_g2o_torch import kernels, loads_g2o, save_g2o
    from openslam_g2o_torch.apps.simulator import synthetic_pose_graph_2d
    from openslam_g2o_torch.core import sparse
    from openslam_g2o_torch.core.algorithms import (
        LevenbergMarquardtPCG, _lambda_init_pcg, lm_pcg_optimize_fused,
        optimize)
    from openslam_g2o_torch.core.graph import Graph
    from openslam_g2o_torch.core.problem import robust_chi2
    from openslam_g2o_torch.kernels import assemble, build, edge_se2, spmv
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
          f"{torch.version.cuda}")
    print(smi)

    # -- 2. build ----------------------------------------------------------
    t0 = time.monotonic()
    build.load()
    built = build.last_build()
    regs = [ln.strip() for ln in built["log"].splitlines()
            if "registers" in ln]
    print(f"phase 2 build: {time.monotonic() - t0:.2f} s "
          f"(nvcc {built['seconds']:.2f} s) -> {built['path']}; ptxas: "
          + " | ".join(regs))

    # -- 3. kernels against their plain versions ---------------------------
    results = {}
    probs = {}
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
        prob, info = synthetic_pose_graph_2d(
            n_poses=N_POSES, grid=GRID, trans_noise=0.03, rot_noise=0.002,
            dtype=dt, device=dev)
        floor = info["noise_floor_chi2"]
        probs[tag] = prob
        pattern = sparse.build_ell_pattern(prob)
        ea = prob.edges["edge_se2"]
        E = pattern.e_total
        hk = torch.empty((9, 4 * E), dtype=dt, device=dev)
        bk = torch.empty((3, 2 * E), dtype=dt, device=dev)
        hp, bp = torch.empty_like(hk), torch.empty_like(bk)
        args = (prob.params["se2"], prob.free["se2"], ea.indices[0],
                ea.indices[1], ea.measurement, ea.information, ea.delta, 0)
        run_b = lambda: edge_se2.edge_se2_blocks(*args, hk, bk, 0)
        run_bp = lambda: edge_se2.edge_se2_blocks_plain(*args, hp, bp, 0)
        run_b()
        run_bp()
        errs = [_errors(hk, hp), _errors(bk, bp)]
        results[("B", tag)] = dict(
            abs=max(e[0] for e in errs), rel=max(e[1] for e in errs),
            ms=_median_ms(torch, run_b), plain_ms=_median_ms(torch, run_bp),
            shape=f"E={E}")
        cargs = (hk, bk, pattern.hidx, pattern.bidx, pattern.k, pattern.n)
        vk, bvk = assemble.assemble_gather(*cargs)
        vp, bvp = assemble.assemble_gather_plain(*cargs)
        errs = [_errors(vk, vp), _errors(bvk, bvp)]
        results[("C", tag)] = dict(
            abs=max(e[0] for e in errs), rel=max(e[1] for e in errs),
            ms=_median_ms(torch, lambda: assemble.assemble_gather(*cargs)),
            plain_ms=_median_ms(
                torch, lambda: assemble.assemble_gather_plain(*cargs)),
            shape=f"N={pattern.n} K={pattern.k} mh={pattern.hidx.shape[0]}")
        gen = torch.Generator(device=dev).manual_seed(0)
        r = np.random.default_rng(0)      # the probe's random block-ELL
        probe_nb = torch.as_tensor(
            r.integers(0, 3500, (10, 3500)).astype(np.int32), device=dev)
        probe_vals = torch.as_tensor(r.normal(size=(10, 9, 3500)), dtype=dt,
                                     device=dev)
        for label, nb, vals in (("slice", pattern.nb, vk),
                                ("probe", probe_nb, probe_vals)):
            x = torch.randn((3, nb.shape[1]), generator=gen, device=dev,
                            dtype=dt)
            abs_e, rel_e = _errors(spmv.block_ell_spmv(nb, vals, x),
                                   spmv.block_ell_spmv_plain(nb, vals, x))
            results[("A" if label == "slice" else "A-probe", tag)] = dict(
                abs=abs_e, rel=rel_e,
                ms=_median_ms(torch, lambda: spmv.block_ell_spmv(nb, vals, x)),
                plain_ms=_median_ms(
                    torch, lambda: spmv.block_ell_spmv_plain(nb, vals, x)),
                shape=f"N={nb.shape[1]} K={nb.shape[0]}")
        del hk, bk, hp, bp, vk, vp
    torch.cuda.synchronize()
    for (kname, tag), r in sorted(results.items()):
        tol = TOL[kname[0]][tag]
        ok = r["rel"] <= tol
        print(f"phase 3 kernel {kname} {tag} {r['shape']}: max_abs_err "
              f"{r['abs']:.3e} max_rel_err {r['rel']:.3e} (tol {tol:g}) "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
              f"[{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel {kname} {tag} disagrees with its "
                                 f"plain version: {r['rel']:.3e} > {tol:g}")
    del probs["float64"]

    # -- 4. the slice on the card -------------------------------------------
    prob = probs["float32"]
    pcg = dict(pcg_iters=100, pcg_tol=0.15)
    alg = LevenbergMarquardtPCG(**pcg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_start = time.monotonic()
    state = alg.init(prob)
    pattern = alg.pattern(prob)
    st = (state["params"], state["lam"], state["ni"], state["chi2"])
    torch.cuda.synchronize()
    init_s = time.monotonic() - t_start
    lam0, chi0 = float(st[1]), float(st[3])

    def window(s, n, **kw):
        t = time.monotonic()
        out = lm_pcg_optimize_fused(prob, pattern, *s, n_iters=n, **kw)
        torch.cuda.synchronize()
        return out[:4], out[4].tolist(), time.monotonic() - t

    st, first_traj, dt_first = window(st, 10, **pcg)
    traj = list(first_traj)
    windows = [(10, dt_first)]
    for _ in range(8):
        if float(st[3]) <= 1.05 * floor:
            break
        st, t_, dt_w = window(st, 10, **pcg)
        traj += t_
        windows.append((10, dt_w))
    n_polish = 0
    for _ in range(10):
        if float(st[3]) <= 1.02 * floor:
            break
        st, t_, dt_w = window(st, 5, pcg_iters=600, pcg_tol=1e-6, warm=True)
        traj += t_
        n_polish += 1
    main_s = time.monotonic() - t_start
    counts = kernels.launch_counts()            # the main path's launches
    final = float(st[3])
    steady = [dt / n for n, dt in windows[1:]] or [windows[0][1] / 10]
    ms_first = dt_first / 10 * 1e3
    ms_steady = sorted(steady)[len(steady) // 2] * 1e3
    print(f"phase 4 slice: {N_POSES} poses {prob.static.egroups[0].count} "
          f"edges K={pattern.k} float32; init+lambda0 {init_s:.3f} s "
          f"lambda0 {lam0:.6g} chi2_0 {chi0:.1f}; first 10-iteration window "
          f"{ms_first:.2f} ms/LM iteration, later windows median "
          f"{ms_steady:.2f} ms/LM iteration ({len(windows)} windows of 10, "
          f"pcg 100 tol 0.15; {n_polish} polish windows of 5, pcg 600 tol "
          f"1e-6); total {main_s:.2f} s [{card}]")
    print("phase 4 chi2 trajectory: "
          + " ".join(f"{c:.1f}" for c in traj))
    print(f"phase 4 final chi2 {final:.1f} noise floor {floor:.1f} ratio "
          f"{final / floor:.5f} (gate 1.02)")
    if not np.isfinite(final) or final > 1.02 * floor:
        raise AssertionError(f"chi2 {final} above 1.02 x floor {floor}")

    # the same first 3 iterations with every kernel swapped for its plain
    # version (CUDA tensors, plain PyTorch ops)
    swaps = [(spmv, "block_ell_spmv", spmv.block_ell_spmv_plain),
             (edge_se2, "edge_se2_blocks", edge_se2.edge_se2_blocks_plain),
             (assemble, "assemble_gather", assemble.assemble_gather_plain)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    try:
        for mod, attr, plain in swaps:
            setattr(mod, attr, plain)
        lam_p = _lambda_init_pcg(prob, pattern, prob.params,
                                 torch.tensor(alg.tau, dtype=prob.dtype,
                                              device=dev))
        out_p = lm_pcg_optimize_fused(
            prob, pattern, prob.params, lam_p, state["ni"],
            robust_chi2(prob), n_iters=3, **pcg)
        plain_traj = out_p[4].tolist()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    if kernels.launch_counts() != counts:
        raise AssertionError("the plain-route run launched a kernel")
    np.testing.assert_allclose(first_traj[:3], plain_traj,
                               rtol=PLAIN_ROUTE_RTOL)
    np.testing.assert_allclose(float(lam_p), lam0, rtol=PLAIN_ROUTE_RTOL)
    print("phase 4 plain route: first 3 chi2 "
          + " ".join(f"{c:.2f}" for c in plain_traj) + " vs kernel route "
          + " ".join(f"{c:.2f}" for c in first_traj[:3])
          + f" (rtol {PLAIN_ROUTE_RTOL:g}) OK")
    del probs, prob, st, state, out_p

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
    for device in ("cuda", "cpu"):
        sprob = loads_g2o(text).compile(dtype=torch.float64, device=device)
        c0 = float(robust_chi2(sprob))
        _, stats = optimize(sprob, LevenbergMarquardtPCG(), iterations=5)
        runs[device] = (c0, [s["chi2"] for s in stats])
    c0, chis = runs["cuda"]
    if not (chis[-1] < c0 and all(np.isfinite(chis))):
        raise AssertionError(f".g2o run did not decrease chi2: {c0} {chis}")
    np.testing.assert_allclose(chis, runs["cpu"][1], rtol=1e-6)
    print(f"phase 5 .g2o ({len(text.splitlines())} lines) on cuda float64: "
          f"chi2 {c0:.4f} -> " + " -> ".join(f"{c:.6f}" for c in chis)
          + " (equal to the CPU run, rtol 1e-6) OK")

    # -- 6. launch counts of the main path ----------------------------------
    print("phase 6 launches in the phase-4 main path: "
          + " ".join(f"{k}={v}" for k, v in counts.items()))
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")

    rows = [("block_ell_spmv", "A", "block_ell_spmv.cu",
             "scripts/probe_pallas_gather.py:90"),
            ("edge_se2_blocks", "B", "edge_se2_blocks.cu",
             "openslam_g2o_tpu/core/sparse.py:620"),
            ("assemble_gather", "C", "assemble_gather.cu",
             "openslam_g2o_tpu/core/sparse.py:1045")]
    report = {"kernels": [
        {"name": wname, "route": "cuda",
         "source": f"openslam_g2o_torch/kernels/csrc/{src}",
         "replaces": replaces, "launches": counts[wname],
         "max_abs_err": results[(kname, "float32")]["abs"],
         "ms": results[(kname, "float32")]["ms"],
         "plain_ms": results[(kname, "float32")]["plain_ms"]}
        for wname, kname, src, replaces in rows]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
