"""Profile one 10-iteration LM window on the card: where the time goes.

    python3 -m openslam_g2o_torch.apps.profile_window [--cheby DEGREE]
                                    [--graph serpentine|sphere|ba400k]

Builds the synthetic serpentine (100,000 SE2 poses, noise 0.03 / 0.002,
float32; pcg 100, tol 0.15) or, with --graph sphere, the sphere generator's
pose spiral (200 laps of 500 = 100,000 SE3 poses, 6x6 blocks, noise 0.03 /
0.002, float32; pcg 200, tol 0.05), both through LM-PCG; or, with --graph
ba400k, the synthetic BAL problem of 900 cameras x 50,000 points x 8
observations (float32; pcg 30, tol 0.05) through the Schur solver's
implicit route (ba_ell_optimize_fused, one trial per iteration). It runs
lambda init and one warm-up window of 10 iterations, then measures the next
window three ways:

* host clock around the window, ending in torch.cuda.synchronize();
* counters: kernel launches by wrapper (kernels.launch_counts), CG
  iterations (cg_update_xr launches), matvecs, and host reads of the device
  (torch.Tensor.item wrapped for the window);
* torch.profiler (CPU + CUDA) over a repeat of the same window from the
  same state: device time by kernel, its sum (device busy) and the idle
  share 1 - busy / wall, against the profiled window's wall time and
  against the unprofiled one's (the profiler slows the host). A kernel
  launched as a programmatic dependent launch (cg_update_xr after
  spmv_dot_p) may start before the kernel ahead of it ends and wait on
  the card: its time counts only past the end of every kernel that
  started before it, so device busy is the union of the kernels' spans.

Per-phase times of one trial (LM-PCG: linearize + assemble, trial solve,
retract + chi2 + outcome; BA: linearize + build, Schur solve, candidate +
chi2 + outcome) come from CUDA events, median of 5. Prints one line per
result and the card's name and power limit; needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

N_POSES, GRID = 100000, 100
SPHERE = dict(n_laps=200, n_per_lap=500, radius=100.0,
              trans_noise=(0.03, 0.03, 0.03), rot_noise=0.002, seed=0)
BA_400K = dict(n_cams=900, n_points=50000, obs_per_point=8)
BA_PCG = dict(pcg_iters=30, pcg_tol=0.05)


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cheby", type=int, default=0,
                    help="pcg_cheby degree (0: plain Jacobi-scaled CG)")
    ap.add_argument("--graph", choices=("serpentine", "sphere", "ba400k"),
                    default="serpentine",
                    help="the SE2 serpentine (3x3 blocks), the SE3 sphere "
                         "(6x6 blocks) or the 400k-observation BAL problem")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_window: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from openslam_g2o_torch import kernels
    from openslam_g2o_torch.apps.simulator import (
        create_sphere, synthetic_bal_problem, synthetic_pose_graph_2d)
    from openslam_g2o_torch.core import algorithms as alg_mod
    from openslam_g2o_torch.core import ba_ell

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if args.graph == "ba400k":
        pcg = dict(BA_PCG)
        prob, _ = synthetic_bal_problem(**BA_400K, dtype=torch.float32)
        what = (f"{BA_400K['n_cams']} cameras x {BA_400K['n_points']} points "
                f"x {BA_400K['obs_per_point']} observations (BAL)")
    elif args.graph == "sphere":
        pcg = dict(pcg_iters=200, pcg_tol=0.05, pcg_cheby=args.cheby)
        prob = create_sphere(**SPHERE)[0].compile(dtype=torch.float32)
        what = f"{prob.static.vgroups[0].count} SE3 poses (sphere)"
    else:
        pcg = dict(pcg_iters=100, pcg_tol=0.15, pcg_cheby=args.cheby)
        prob, _ = synthetic_pose_graph_2d(
            n_poses=N_POSES, grid=GRID, trans_noise=0.03,
            rot_noise=0.002, dtype=torch.float32)
        what = f"{N_POSES} SE2 poses (serpentine)"
    ba = args.graph == "ba400k"
    alg = (ba_ell.LevenbergMarquardtSchurELL(**pcg) if ba
           else alg_mod.LevenbergMarquardtPCG(**pcg))
    state = alg.init(prob)
    pattern = alg.pattern(prob)
    st = (state["params"], state["lam"], state["ni"], state["chi2"])
    fused = (ba_ell.ba_ell_optimize_fused if ba
             else alg_mod.lm_pcg_optimize_fused)

    def window(s):
        out = fused(prob, pattern, *s, n_iters=10, **pcg)
        torch.cuda.synchronize()
        return out[:4]

    st = window(st)                           # warm-up window

    # host clock, counters and host reads of the measured window
    reads = [0]
    real_item = torch.Tensor.item

    def counting_item(self):
        reads[0] += 1
        return real_item(self)

    kernels.reset_launch_counts()
    torch.Tensor.item = counting_item
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        window(st)
        wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        torch.Tensor.item = real_item
    counts = kernels.launch_counts()
    cg_iters = counts["cg_update_xr"]
    matvecs = (counts["ba_wv"] if ba
               else counts["spmv_dot"] + counts["spmv_dot_p"]
               + counts["block_ell_spmv"])
    trials = counts["lm_outcome"] if ba else counts["damp_chol"]
    launches = sum(counts.values())
    # two kernels per call: cg_finish (non-finite count, then the flag and
    # the zeroing; one vector here) and gershgorin_bound (rows, then max)
    kernel_launches = (launches + counts["cg_finish"]
                       + counts["gershgorin_bound"])
    in_loop = sum(counts[k] for k in (
        "spmv_dot", "spmv_dot_p", "block_ell_spmv", "cg_update_xr",
        "cg_update_p",
        "dot_partials", "chebyshev_init", "chebyshev_update", "ba_wtx",
        "ba_wv", "lane_block_mv", "lane_block_mv_dot"))
    print(f"card: {card}")
    print(f"window: 10 LM iterations, "
          + ("Schur solver" if ba else f"pcg_cheby {args.cheby}")
          + f", {what} float32, pcg {pcg['pcg_iters']} tol "
          f"{pcg['pcg_tol']}: wall {wall_ms:.2f} ms "
          f"({wall_ms / 10:.3f} ms per LM iteration); {trials} "
          f"trials, {cg_iters} CG iterations, {matvecs} matvecs; "
          f"{launches} wrapper calls that launched = {kernel_launches} "
          f"hand-written kernel launches, "
          f"{in_loop / max(cg_iters, 1):.2f} per CG iteration by the CG and "
          f"preconditioner kernels; {reads[0]} host reads (.item), "
          f"{reads[0] / max(cg_iters, 1):.3f} per CG iteration")
    print("launches by wrapper: "
          + " ".join(f"{k}={v}" for k, v in counts.items() if v))

    # torch.profiler over a repeat of the same window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        window(st)
        prof_wall_ms = (time.monotonic() - t0) * 1e3
    # the device-typed events (kernels and copies); the CPU-typed ones
    # repeat their children's device time. Each counts past the end of the
    # spans that started before it (overlap: programmatic dependent launch)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    by_key, covered, overlap_us = {}, float("-inf"), 0.0
    for start, end, key in spans:
        own = max(end - max(start, covered), 0.0)
        overlap_us += end - start - own
        covered = max(covered, end)
        ms_, n_ = by_key.get(key, (0.0, 0))
        by_key[key] = (ms_ + own / 1e3, n_ + 1)
    rows = sorted(((k, ms_, n_) for k, (ms_, n_) in by_key.items()),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms <= 0:
        print("torch.profiler reported no device time", file=sys.stderr)
        return 1
    print(f"profiled window: wall {prof_wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms, idle share "
          f"{100 * (1 - busy_ms / prof_wall_ms):.1f}% of it and "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% of the unprofiled window's "
          f"{wall_ms:.2f} ms; device time per CG "
          f"iteration {busy_ms / max(cg_iters, 1) * 1e3:.1f} us, wall per "
          f"CG iteration {wall_ms / max(cg_iters, 1) * 1e3:.1f} us; "
          f"{overlap_us / 1e3:.3f} ms of kernels overlapping earlier ones")
    for key, ms, count in rows[:40]:
        print(f"  device {ms:8.3f} ms {count:6d} calls "
              f"{ms / count * 1e3:7.2f} us/call  {key[:90]}")

    # per-phase times of one trial at the window's state
    def events_ms(fn, repeats=5):
        times = []
        for _ in range(repeats):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[len(times) // 2], out

    work = prob.with_params(st[0])
    if ba:
        t_build, sys_ = events_ms(lambda: ba_ell._build(work, pattern))
        kernels.reset_launch_counts()
        t_solve, (dxT, ok, bT) = events_ms(lambda: ba_ell._solve(
            work, pattern, sys_, st[1], pcg["pcg_iters"], pcg["pcg_tol"]))
        trial_cg = kernels.launch_counts()["cg_update_xr"] // 5
        t_trial, _ = events_ms(lambda: ba_ell._trial(
            work, pattern, sys_, st[1], st[2], st[3], pcg["pcg_iters"],
            pcg["pcg_tol"]))
        print(f"one trial (CUDA events, median of 5): linearize + build "
              f"(K10) {t_build:.3f} ms; Schur solve {t_solve:.3f} ms with "
              f"{trial_cg} CG iterations; solve + candidate + chi2 + outcome "
              f"{t_trial:.3f} ms, so candidate + chi2 + outcome "
              f"{t_trial - t_solve:.3f} ms")
        return 0
    t_pre, pre = events_ms(lambda: alg_mod._pcg_precomp(work, pattern))
    kernels.reset_launch_counts()
    t_trial, (dxT, _) = events_ms(lambda: alg_mod._pcg_trial(
        work, pattern, pre, st[1], None, pcg["pcg_iters"], pcg["pcg_tol"],
        args.cheby))
    trial_cg = kernels.launch_counts()["cg_update_xr"] // 5
    t_setup, _ = events_ms(lambda: alg_mod._pcg_trial(
        work, pattern, pre, st[1], None, 0, pcg["pcg_tol"], 0))
    ok = torch.tensor(True, device=dxT[pattern.group].device)
    t_out, _ = events_ms(lambda: alg_mod._trial_outcome(
        work, pattern, pre["bT"], dxT, ok, st[1], st[2], st[3]))
    print(f"one trial (CUDA events, median of 5): linearize + assemble "
          f"{t_pre:.3f} ms; trial solve {t_trial:.3f} ms with {trial_cg} CG "
          f"iterations, of which setup and unscale without CG iterations "
          f"{t_setup:.3f} ms; retract + chi2 + outcome (K7) {t_out:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
