#!/usr/bin/env python3
"""Device time by CUDA events of the redesigned kernels for any tree of
the port, so that two trees can be timed in one run on one card.

    python3 kernel_times.py [--tree PATH]
                            [--only k15,k12,k16,sandwich,k14,lin,trial,pairs,
                                    pose,precond]
                            [--save FILE] [--against FILE]

It times the `openslam_g2o_torch` of PATH (default: this script's own
tree) with this tree's chip_smoke.py: its shapes, its `_device_ms` (CUDA
events around up to 200 calls queued behind a spin kernel, median of 5)
and its tolerances against the plain version. chip_smoke.py's phase 3
times these kernels itself; this script times a tree whose chip_smoke.py
does not, at the same shapes:

* k15: K15 `dense_assemble` on the landmark worlds of phases 4d (2D) and
  4f (3D, the 6-wide instantiation), and on the pose slots of the general
  Schur path's scenes, as schur_build passes them: 4j (ba_80k, binary
  XYZ2UV), 4k (PSI2UV), 4l (P2MC_INTRINSICS, the intrinsics hub) and 4n
  (ba_400k); at block width 9 on the 9-wide camera slots of phase 4q's
  BAL files (@bal, @bal400k) and on phase 4r's dense BAL scene (@d9); a
  whole call (zero fills, the pair launches, the finalize);
* k12: K12 `ba_schur_dense` on ba_80k and on the 4d world at (Dp, dl) =
  (3, 2), on chip_smoke's `k12_operands`, a call making every operand it
  reads (a tree that takes W's records also with them made beforehand,
  as its `_solve` calls it);
* k16: K16 on the sphere of phase 4e (100,000 poses, 149,963 edges)
  without and with Huber, on streams of the main path's width;
* sandwich: `ba_sandwich` on the pose rows of ba_80k and ba_400k and of
  each pose group of the PSI2UV and P2MC_INTRINSICS scenes (random seeded
  W, Hinv, Hcc_d; the scenes' own rows and chunks);
* k14: K14 `schur_edge_blocks` on the general Schur path's four scenes, as
  schur_build calls it (chip_smoke.k14_operands): 4j (ba_80k, binary
  XYZ2UV), 4k (PSI2UV), 4l (P2MC_INTRINSICS) and 4n (ba_400k), and at
  (Dp, dl) = (9, 3) on phase 4q's BAL files (@bal, @bal400k);
  (the 9-wide rows of k15 and k14 are skipped for a tree whose kernels
  do not take that width: its rows say so)
* lin: `problem.linearize` on the worlds of phases 4d (EDGE_SE2,
  EDGE_SE2_XY) and 4f (float64), on the 4j (ba_80k, XYZ2UV), 4k
  (PSI2UV), 4l (P2MC_INTRINSICS) and 4n (ba_400k, XYZ2UV) scenes
  (float32), on 4j and 4n once more in float64 and on 4o's 2D and SBA
  worlds (float64: the closed forms' EDGE_SE2, XYZ2UV and XYZ2UVU groups
  at 4o's sizes), as the paths call it: a tree without K17 for a type runs
  the type's torch form there (torch.func.jvp, or the analytic Jacobian
  in torch). The time per call (CUDA events around one call, median of
  5), and each edge group with a K17 wrapper in the tree by device time
  beside its bound; then every K17 type on chip_smoke.py's seeded group
  of 50,000 edges (`lin_group`, phase 3's rows), in float32 and float64.
  --save also writes the residuals, Jacobians and rho' of the scenes to
  FILE.lin.pt, and --against holds this tree's against that file's,
  relative to the largest entry of each output, to chip_smoke.py's K17
  tolerance (1e-10 float64, 2e-4 float32); the digests of every group's
  outputs (the scenes' and the seeded ones) go into FILE with the other
  sections' and are compared the same way.
* trial: one trial's outcome (candidate, dot product, robust chi2 and
  lm_outcome) on the dense route's worlds of phases 4d, 4f and 4o
  (float64, the step of LM's first trial), the dual-ELL routes of 4g and
  4h (ba_80k, ba_400k) and the general Schur path's scenes of 4j-4n
  (float32; 4m: the anchored demo scene, float64), the first trial's
  step, as the tree's trial body runs it: a tree with
  core/problem.py `lm_trial_outcome` runs K7's kernels, a tree without
  it the parent's body (apply_update / apply_update_parts and
  robust_chi2 in torch, torch.dot, lm_outcome). The time per call (CUDA
  events around one call, median of 5) and on the device (200 calls
  queued behind a spin kernel), the device kernels of one call (the
  profiler), and "retract+chi2" (apply_update_parts + robust_chi2, as
  chip_smoke.py's phase 4d split times it). --save also writes chi2_new
  and lambda_new to FILE.trial.pt, and --against holds this tree's to
  that file's, relative, to chip_smoke.py's chi2_sum tolerance (1e-12
  float64, 1e-5 float32). Then K7's chi2 wrapper alone on every edge
  group of those scenes at its stored parameters (the groups of 80,000
  and 400,000 edges of 4j-4n also in float64) and on chip_smoke.py's
  seeded group of 50,000 edges of every type under Huber (phase 3's
  rows), float32 and float64, by device time beside its bound, with the
  digest of its partials. Then the retraction alone: on each
  scene, core/problem.py `trial_candidate` at the first trial's step, by
  device time, its device kernels (the profiler) and the digests of the
  candidate and the partials; and on chip_smoke.py's seeded groups
  (`trial_vertex_group`: every vertex type's group of 50,000, and
  GROUP_ROWS: 4g's, 4p @400k's and 4l's groups), the tree's retraction
  of those groups (`trial_retract_groups` where the tree has it, else one
  per-type wrapper launch per group into the same partials), with
  digests: the same digests show a tree keeps the parent's bits.
* pairs: the kernels of LM-PCG over several vertex groups on phase 4s's
  9000-pose landmark world (chip_smoke.PAIR_WORLD, T = 34,108) and on
  phase 4f's world (rows "@3d"): K2' over every pair table and group b
  (the K17 outputs made beforehand; every launch, and for a tree with
  `pair_stream` each pass alone), K4' over every pair table at lambda 0.5
  (`PairPattern.scale`; the digests of the used slots, gathered from a
  tree that writes padded tables; timed alone), K5' as the CG step calls
  it (`PairOperator.matvec_dot`, and `matvec_dot_p` where the tree has
  it) and K8' (`row_bound`); for a tree with the used-slot layout, K5''s
  folded product with other lanes a row; then in float32 one
  unpreconditioned trial solve of 200 CG iterations (`pcg_solve`, tol 0)
  on the 9000-pose world and one with pcg_cheby 4 of 50 outer iterations
  on both worlds: wall per CG iteration unprofiled and profiled, device
  time and device kernels per CG iteration (the profiler); and the
  unpreconditioned solve on the
  one-group pose graphs of phases 4 and 4e (the 100,000-pose SE2 graph,
  the SE3 sphere) on their EllPattern and on `build_pair_pattern`'s
  tables. Skipped for a tree without kernels/pair_ell.py.
* pose: the one-group LM-PCG path of phases 4 and 4e (the 100,000-pose
  SE2 graph and the 100,000-pose SE3 sphere): `assemble_ell` (kernel B or
  K16, then C), K3, K4, `spmv_dot` and `lane_block_mv` at lambda 0.5 by
  device time, and three iterations of `lm_pcg_optimize_fused` (pcg 50,
  tol 1e-6) from lambda init, whose trajectory and parameters are
  digested too: with --against they show that a tree keeps this path's
  bits.
* precond: the block-Jacobi step of the Schur routes' PCG, z = M r
  and the partials of r . z, as the tree's pcg_solve runs it (K4's
  `lane_block_mv_dot` where the tree has it, else `lane_block_mv` and
  `dot_partials`), with torch.bmm (z alone) beside it, on the
  preconditioner blocks of the shapes the paths run: ba_400k's 900
  cameras (D = 6, phase 4h), the BAL camera at 400k (D = 9, 4p), 4l's
  intrinsics hub (D = 4) and cameras (D = 6); then one trial solve each of
  phases 4h, 4p @400k (30 CG iterations, tol 0) and 4n (pcg 250, tol
  1e-8; float32, at lambda init): CG iterations, wrapper calls and device
  kernels per CG iteration, wall (host clock around the solve) and device
  (the profiler) us per CG iteration, and the step's digest.

Float32 and float64. Each line gives the microseconds per call, the bound
(bytes over 3.35 TB/s), the error against the plain version relative to
its largest entry, and whether a second call gave the same bits. --save
writes a SHA-256 digest of every timed call's outputs to FILE (JSON);
--against reads such a file, written by another tree on the same inputs,
and prints whether each output has the same digest (the same bits).
Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import chip_smoke

SECTIONS = ("k15", "k12", "k16", "sandwich", "k14", "lin", "trial", "pairs",
            "pose", "precond")


def _digest(t):
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def _rel(got, want):
    err = float((got.double() - want.double()).abs().max())
    return err / max(float(want.double().abs().max()), 1e-300)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)), help="root of the tree to time")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated sections of " + ", ".join(SECTIONS))
    ap.add_argument("--save", help="write the outputs to this file")
    ap.add_argument("--against", help="compare the outputs with this file")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(SECTIONS):
        ap.error(f"--only takes {SECTIONS}")
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from openslam_g2o_torch.apps.simulator import (
        Simulator2D, Simulator3D, create_sphere, synthetic_bal_problem)
    from openslam_g2o_torch.core import ba as ba_general
    from openslam_g2o_torch.core import ba_ell, sparse
    from openslam_g2o_torch.core import problem as problem_mod
    from openslam_g2o_torch.core.graph import Graph
    from openslam_g2o_torch.kernels import (
        ba_coupling, ba_edge, ba_inv, ba_schur, dense_assemble, edge_se3,
        schur_general)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"kernel_times: {card}; openslam_g2o_torch from "
          f"{edge_se3.__file__.rsplit('/openslam_g2o_torch/', 1)[0]}")
    dev = torch.device("cuda")
    failed, saved = [], {}
    against = None
    if args.against:
        with open(args.against) as f:
            against = json.load(f)

    def report(name, tol_key, shape, tag, run, plain, nbytes, extra=()):
        """Check `run` against `plain`, time it and the `extra` variants
        ((description, call) pairs) of the same function, print a line."""
        got = [t.clone() for t in run()]
        rel = max(_rel(g, w) for g, w in zip(got, plain()))
        same = all(torch.equal(g, a) for g, a in zip(got, run()))
        ok = rel < chip_smoke.TOL.get(tol_key, chip_smoke.TOL_DEFAULT)[tag] \
            and same
        key = f"{name} {tag}"
        digests = [_digest(g) for g in got] if args.save or against else []
        saved[key] = digests
        bits = ""
        if against is not None and key in against:
            bits = f"; the bits of --against: {digests == against[key]}"
        if not ok:
            failed.append(key)
        del got
        times = [("", run)] + list(extra)
        line = []
        for what, fn in times:
            ms, calls, held = chip_smoke._device_ms(torch, fn)
            line.append(f"{what}{1e3 * ms:.2f} us"
                        + ("" if held else " (host-bound)")
                        + ("" if calls == 200 else f" ({calls} calls)"))
        print(f"kernel_times {name} {tag} {shape}: " + "; ".join(line)
              + f"; bound {1e6 * nbytes / chip_smoke.HBM_BYTES_PER_S:.2f} us"
              f"; max_rel_err {rel:.3e}; same bits {same}{bits}"
              + ("" if ok else " FAILED"), flush=True)

    dtypes = (torch.float32, torch.float64)
    tag_of = lambda dt: str(dt).split(".")[-1]
    geo80 = chip_smoke.bal_geometry(*chip_smoke.BA_80K)
    general = {"@psi2uv": chip_smoke.psi2uv_graph(Graph, geo80),
               "@intrinsics": chip_smoke.p2mc_intrinsics_graph(Graph, geo80)}
    # the BAL camera's files (chip_smoke.py's phases 4q and 4r), where the
    # tree's K14 and K15 take the 9-wide camera
    bal_files = {}
    wide_k14 = (9, 3) in getattr(schur_general, "DIMS", ())
    wide_k15 = getattr(dense_assemble, "MAX_DIM", 6) >= 9
    if (("k15" in only and wide_k15) or ("k14" in only and wide_k14)):
        from openslam_g2o_torch.models.bal import load_bal_problem
        bal_dir = tempfile.mkdtemp(prefix="kernel_times_bal_")
        for key, shape in (("@bal", chip_smoke.BA_80K),
                           ("@bal400k", chip_smoke.BA_400K),
                           ("@d9", chip_smoke.BAL_DENSE)):
            bal_files[key] = os.path.join(bal_dir, key[1:] + ".bal")
            chip_smoke.bal_camera_scene(bal_files[key], *shape)
    for what, ok in (("k15", wide_k15), ("k14", wide_k14)):
        if what in only and not ok:
            print(f"kernel_times {what}: the 9-wide BAL camera's rows are "
                  "skipped: this tree's kernel does not take that width")
    worlds = {}
    if only & {"k15", "k12", "lin", "trial"}:
        worlds["2d"] = Simulator2D(**chip_smoke.DENSE_WORLD).simulate(
            n_poses=chip_smoke.DENSE_POSES)[0]
    if only & {"k15", "lin", "trial"}:
        worlds["3d"] = Simulator3D(**chip_smoke.DENSE3_WORLD).simulate(
            n_poses=chip_smoke.DENSE3_POSES)[0]

    # -- K15 -----------------------------------------------------------------
    def k15(label, tag, dargs):
        groups, T, _, pattern, _ = dargs
        nbytes = chip_smoke.k15_bytes_flops(groups, pattern)[0] \
            + groups[0].resid.element_size() * (T * T + 3 * T)
        tables = [tb for tbs in pattern.pairs for tb in tbs]
        report(f"dense_assemble{label}", "dense_assemble",
               f"T={T}, {len(tables)} slot pairs, "
               f"{sum(tb.n_dest for tb in tables)} destinations, "
               f"{sum(tb.edge.numel() for tb in tables)} contributions", tag,
               lambda: dense_assemble.dense_assemble(*dargs),
               lambda: dense_assemble.dense_assemble_plain(*dargs), nbytes)

    if "k15" in only:
        for dt in dtypes:
            tag = tag_of(dt)
            for key, label in (("2d", ""), ("3d", "@d6")):
                k15(label, tag, chip_smoke.dense_world_dargs(
                    dense_assemble, problem_mod,
                    worlds[key].compile(dtype=dt)))
            scenes = (("@4j", lambda: synthetic_bal_problem(
                          *chip_smoke.BA_80K, chip_smoke.BA_OBS, dtype=dt)[0]),
                      ("@psi2uv", lambda: general["@psi2uv"].compile(
                          dtype=dt)),
                      ("@intrinsics", lambda: general["@intrinsics"].compile(
                          dtype=dt)),
                      ("@4n", lambda: synthetic_bal_problem(
                          *chip_smoke.BA_400K, chip_smoke.BA_OBS,
                          dtype=dt)[0]))
            for label, make in scenes:
                gprob = make()
                k15(label, tag, chip_smoke.pose_slot_dargs(
                    torch, dense_assemble, gprob,
                    ba_general.build_schur_pattern(gprob),
                    problem_mod.linearize(gprob)))
                del gprob
            for label, path in bal_files.items() if wide_k15 else ():
                bprob = load_bal_problem(path, dtype=dt)[0]
                if label == "@d9":
                    dargs = chip_smoke.dense_world_dargs(
                        dense_assemble, problem_mod, bprob)
                else:
                    dargs = chip_smoke.pose_slot_dargs(
                        torch, dense_assemble, bprob,
                        ba_general.build_schur_pattern(bprob),
                        problem_mod.linearize(bprob))
                k15(label, tag, dargs)
                del bprob, dargs
            torch.cuda.empty_cache()

    # -- K12 -----------------------------------------------------------------
    takes_records = "w_rec" in inspect.signature(
        ba_schur.ba_schur_dense).parameters
    if "k12" in only:
        for dt in dtypes:
            tag = tag_of(dt)
            s = torch.empty((), dtype=dt).element_size()
            for label, make in (
                    ("", lambda: synthetic_bal_problem(
                        *chip_smoke.BA_80K, chip_smoke.BA_OBS,
                        dtype=dt)[0]),
                    ("@2d", lambda: worlds["2d"].compile(dtype=dt))):
                pairs, w_lm, hinv, hcc_d = chip_smoke.k12_operands(
                    ba_ell, ba_inv, make())
                dl = int(round(hinv.shape[0] ** 0.5))
                dp, K, L, C = (w_lm.shape[0] // dl, w_lm.shape[1],
                               pairs.n_lm, pairs.n_cam)
                M, Tp = pairs.n_contrib, C * dp
                call = lambda: (ba_schur.ba_schur_dense(
                    pairs, w_lm, hinv, hcc_d),)
                extra = ()
                if takes_records:
                    w_flat = w_lm.view(dp * dl, -1)
                    w_rec = ba_schur.ba_schur_records(w_flat)
                    call = lambda: (ba_schur.ba_schur_dense(
                        pairs, w_lm, hinv, hcc_d,
                        w_rec=ba_schur.ba_schur_records(w_flat)),)
                    extra = (("W's records made beforehand ", lambda:
                              ba_schur.ba_schur_dense(pairs, w_lm, hinv,
                                                      hcc_d, w_rec=w_rec)),)
                report(f"ba_schur_dense{label}", "ba_schur_dense",
                       f"(Dp, dl) = ({dp}, {dl}) Tp={Tp} {pairs.n_dest} "
                       f"destinations {M} contributions", tag, call,
                       lambda: (ba_schur.ba_schur_dense_plain(
                           pairs, w_lm, hinv, hcc_d),),
                       s * (dp * dl * K * L + dl * dl * L + dp * dp * C
                            + Tp * Tp) + 4 * (3 * M + 3 * pairs.n_dest),
                       extra)
                del hinv, hcc_d, pairs, w_lm, call, extra
                torch.cuda.empty_cache()

    # -- K16 on the sphere ---------------------------------------------------
    if "k16" in only:
        sphere, _ = create_sphere(**chip_smoke.SPHERE)
        for dt in dtypes:
            tag = tag_of(dt)
            s = torch.empty((), dtype=dt).element_size()
            prob = sphere.compile(dtype=dt)
            ea = prob.edges["edge_se3"]
            pattern = sparse.build_ell_pattern(prob)
            N, E = pattern.n, pattern.e_total
            # the main path's stream width (a tree that does not pad has E)
            W = getattr(pattern, "e_cols", E)
            hk = torch.zeros((36, 4 * W), dtype=dt, device=dev)
            bk = torch.zeros((6, 2 * W), dtype=dt, device=dev)
            hp, bp = torch.zeros_like(hk), torch.zeros_like(bk)
            for kid, name in ((0, "edge_se3_blocks"),
                              (1, "edge_se3_blocks@huber")):
                a = (prob.params["se3"], prob.free["se3"], ea.indices[0],
                     ea.indices[1], ea.measurement, ea.information, ea.delta,
                     kid)

                def run(a=a):
                    edge_se3.edge_se3_blocks(*a, hk, bk, 0)
                    return hk, bk

                def plain(a=a):
                    edge_se3.edge_se3_blocks_plain(*a, hp, bp, 0)
                    return hp, bp

                report(name, name, f"N={N} E={E}, streams {W} columns wide",
                       tag, run, plain,
                       s * (8 * N + 44 * E + 156 * E) + 8 * E)
            del prob, hk, bk, hp, bp
        del sphere

    # -- ba_sandwich on the scenes' pose rows ---------------------------------
    def sandwich_rows(tag, dt, label, rows, dp, dl, L):
        s = torch.empty((), dtype=dt).element_size()
        gen = torch.Generator(device=dev).manual_seed(dp + L)
        M, C = rows.n_entries, rows.n_rows
        w = torch.randn((dp * dl, M), generator=gen, dtype=dt, device=dev)
        B = torch.randn((L, dl, dl), generator=gen, dtype=dt, device=dev)
        hinv = (B @ B.transpose(1, 2)).permute(1, 2, 0) \
            .reshape(dl * dl, L).contiguous()
        hcc = torch.randn((dp * dp, C), generator=gen, dtype=dt, device=dev)
        report("ba_sandwich" + label, "ba_sandwich",
               f"(Dp, dl) = ({dp}, {dl}) C={C} M={M} chunks={rows.n_chunks}",
               tag, lambda: (ba_coupling.ba_sandwich(w, rows, hinv, hcc),),
               lambda: (ba_coupling.ba_sandwich_plain(w, rows, hinv, hcc),),
               s * (dp * dl * M + dl * dl * L + 2 * dp * dp * C)
               + 4 * (M + rows.n_chunks + C + 1))

    if "sandwich" in only:
        for dt in dtypes:
            tag = tag_of(dt)
            for (nc, npts), sfx in ((chip_smoke.BA_80K, ""),
                                    (chip_smoke.BA_400K, "@400k")):
                bprob = synthetic_bal_problem(nc, npts, chip_smoke.BA_OBS,
                                              dtype=dt)[0]
                bpat = ba_ell.build_ba_ell_pattern(bprob)
                sandwich_rows(tag, dt, sfx, bpat.cam_rows, bpat.dp, bpat.dl,
                              bpat.n_lm)
                del bprob, bpat
            for sfx, graph in general.items():
                pat = ba_general.build_schur_pattern(graph.compile(dtype=dt))
                for pg in pat.pose_groups:
                    sandwich_rows(tag, dt, f"{sfx}#{pg.name}", pg.rows,
                                  pg.dim, pat.dl, pat.n_lm)
    # -- K14 on the general path's scenes -------------------------------------
    if "k14" in only:
        for dt in dtypes:
            tag = tag_of(dt)
            for label, make in (
                    ("@4j", lambda: synthetic_bal_problem(
                        *chip_smoke.BA_80K, chip_smoke.BA_OBS, dtype=dt)[0]),
                    ("@psi2uv", lambda: general["@psi2uv"].compile(dtype=dt)),
                    ("@intrinsics",
                     lambda: general["@intrinsics"].compile(dtype=dt)),
                    ("@4n", lambda: synthetic_bal_problem(
                        *chip_smoke.BA_400K, chip_smoke.BA_OBS,
                        dtype=dt)[0]),
                    *((key, lambda key=key: load_bal_problem(
                        bal_files[key], dtype=dt)[0])
                      for key in ("@bal", "@bal400k") if wide_k14)):
                gprob = make()
                new_out, run, nbytes, _, shape = chip_smoke.k14_operands(
                    torch, ba_edge, gprob,
                    ba_general.build_schur_pattern(gprob),
                    problem_mod.linearize(gprob))
                out_k, out_p = new_out(), new_out()
                report(f"schur_edge_blocks{label}", "schur_edge_blocks",
                       shape, tag,
                       lambda: run(schur_general.schur_edge_blocks, out_k),
                       lambda: run(schur_general.schur_edge_blocks_plain,
                                   out_p), nbytes)
                del gprob, out_k, out_p, run
                torch.cuda.empty_cache()

    # -- the linearizers ------------------------------------------------------
    def group_line(fn, fargs, nbytes, tag, key, shape, outs):
        """One wrapper call fn(*fargs) on one edge group: its device time
        beside the bound (`nbytes` over 3.35 TB/s), and the SHA-256
        digests of its outputs `outs` for --save / --against."""
        digests = [_digest(t) for t in outs]
        key = f"{fn.__name__} {key} {tag}"
        saved[key] = digests
        bits = ""
        if against is not None and key in against:
            bits = f"; the bits of --against: {digests == against[key]}"
        us, calls, held = chip_smoke._device_ms(
            torch, lambda fn=fn, a=fargs: fn(*a))
        bound = 1e6 * nbytes / chip_smoke.HBM_BYTES_PER_S
        print(f"kernel_times {fn.__name__} {tag} {shape}: "
              f"{1e3 * us:.2f} us" + ("" if held else " (host-bound)")
              + ("" if calls == 200 else f" ({calls} calls)")
              + f"; bound {bound:.2f} us{bits}", flush=True)

    def lin_group_line(fn, tname, largs, tag, key, shape, out):
        """group_line of a K17 wrapper: its residual, Jacobians and rho'
        (`out`, the linearization of that group)."""
        resid, jacs, rho1 = out
        group_line(fn, largs, chip_smoke.lin_bytes_flops(tname, largs)[0],
                   tag, key, shape, (resid, *jacs, rho1))

    def chi2_group_line(tname, largs, tag, key, shape):
        """group_line of K7's chi2 wrapper of `tname` on K17's arguments
        `largs` (the group at its stored parameters, as a trial at the
        candidate reads it): its partials."""
        from openslam_g2o_torch.kernels import trial
        fn = trial.chi2_of(tname)
        params, _, indices, meas, info, delta, pdata, kid = largs
        cargs = (params, indices, meas, info, delta, pdata, kid)
        group_line(fn, cargs, chip_smoke.chi2_bytes_flops(tname, largs)[0],
                   tag, key, shape, (fn(*cargs),))

    if only & {"lin", "trial"}:
        all2d = chip_smoke.world2d_all_graph(Graph, *chip_smoke.ALL2D)
        allsba = chip_smoke.sba_all_graph(Graph, *chip_smoke.ALLSBA)
    if "lin" in only:
        try:
            from openslam_g2o_torch.kernels import edge_lin
        except ImportError:                      # a tree without K17
            edge_lin = None
        lin_out, ref = {}, None
        if against is not None:
            ref = torch.load(args.against + ".lin.pt")
        for phase, dt, make in (
                ("4d", torch.float64, lambda: worlds["2d"].compile(
                    dtype=torch.float64)),
                ("4f", torch.float64, lambda: worlds["3d"].compile(
                    dtype=torch.float64)),
                ("4j", torch.float32, lambda: synthetic_bal_problem(
                    *chip_smoke.BA_80K, chip_smoke.BA_OBS,
                    dtype=torch.float32)[0]),
                ("4k", torch.float32, lambda: general["@psi2uv"].compile(
                    dtype=torch.float32)),
                ("4l", torch.float32, lambda: general["@intrinsics"].compile(
                    dtype=torch.float32)),
                ("4n", torch.float32, lambda: synthetic_bal_problem(
                    *chip_smoke.BA_400K, chip_smoke.BA_OBS,
                    dtype=torch.float32)[0]),
                # the closed forms' groups in the other dtype and at 4o
                ("4j", torch.float64, lambda: synthetic_bal_problem(
                    *chip_smoke.BA_80K, chip_smoke.BA_OBS,
                    dtype=torch.float64)[0]),
                ("4n", torch.float64, lambda: synthetic_bal_problem(
                    *chip_smoke.BA_400K, chip_smoke.BA_OBS,
                    dtype=torch.float64)[0]),
                ("4o 2D", torch.float64, lambda: all2d.compile(
                    dtype=torch.float64)),
                ("4o SBA", torch.float64, lambda: allsba.compile(
                    dtype=torch.float64))):
            tag = tag_of(dt)
            prob = make()
            lin = problem_mod.linearize(prob)
            outs = {f"{phase} {tag} {key} {i}": t.contiguous()
                    for key, (r, jacs, w) in lin.items()
                    for i, t in enumerate((r, *jacs, w))}
            lin_out.update({k: v.cpu() for k, v in outs.items()})
            ms = chip_smoke._median_ms(
                torch, lambda: problem_mod.linearize(prob), 5, 1, 1)
            agree = ""
            if ref is not None:
                tol = chip_smoke.TOL["edge_lin_se3"][tag]
                rel = max(_rel(v, ref[k].to(dev)) for k, v in outs.items())
                agree = (f"; against --against: max_rel_err {rel:.3e} (tol "
                         f"{tol:g})")
                if not rel < tol:
                    failed.append(f"linearize {phase}")
                    agree += " FAILED"
            groups = " ".join(f"{eg.key}={eg.count}"
                              for eg in prob.static.egroups)
            print(f"kernel_times linearize {phase} {tag} ({groups}): "
                  f"{ms:.3f} ms per call (CUDA events around one call, "
                  f"median of 5){agree}", flush=True)
            for eg in prob.static.egroups if edge_lin is not None else ():
                largs = chip_smoke.lin_args(prob, eg)
                fn = edge_lin.linearizer(eg.etype.name)
                if fn is None:                   # a type without K17 there
                    continue
                lin_group_line(fn, eg.etype.name, largs, tag,
                               f"{phase} {eg.key}", f"E={eg.count}",
                               lin[eg.key])
            del prob, lin, outs
            torch.cuda.empty_cache()
        # every type on chip_smoke.py's seeded group (phase 3's K17 rows)
        for dt in dtypes if edge_lin is not None else ():
            tag = tag_of(dt)
            for tname in chip_smoke.LIN_VALUE_OPS:
                fn = edge_lin.linearizer(tname)
                if fn is None:
                    continue
                largs = chip_smoke.lin_group(
                    torch, tname, chip_smoke.LIN_GROUP_EDGES, dt, dev)
                lin_group_line(fn, tname, largs, tag, f"seeded {tname}",
                               f"E={chip_smoke.LIN_GROUP_EDGES} seeded group",
                               fn(*largs))
                del largs
        if args.save:
            torch.save(lin_out, args.save + ".lin.pt")
    # -- K7: one trial's outcome --------------------------------------------
    def trial_section():
        from torch.profiler import ProfilerActivity, profile
        from openslam_g2o_torch.core import algorithms as alg_mod
        from openslam_g2o_torch.core.solvers import solve_dense_cholesky
        from openslam_g2o_torch.kernels import retract_chi2
        has_k7 = hasattr(problem_mod, "lm_trial_outcome")
        out, ref = {}, None
        if against is not None:
            ref = torch.load(args.against + ".trial.pt")
        bal = lambda shape: synthetic_bal_problem(
            *shape, chip_smoke.BA_OBS, dtype=torch.float32)[0]
        f32 = lambda g: lambda: g.compile(dtype=torch.float32)
        f64 = lambda make, *a: lambda: make(Graph, *a).compile(
            dtype=torch.float64)
        cases = (
            ("4d", lambda: worlds["2d"].compile(dtype=torch.float64),
             "dense"),
            ("4f", lambda: worlds["3d"].compile(dtype=torch.float64),
             "dense"),
            ("4g", lambda: bal(chip_smoke.BA_80K), "ell"),
            ("4h", lambda: bal(chip_smoke.BA_400K), "ell"),
            ("4j", lambda: bal(chip_smoke.BA_80K), "general"),
            ("4k", f32(general["@psi2uv"]), "general"),
            ("4l", f32(general["@intrinsics"]), "general"),
            ("4m", f64(chip_smoke.anchored_demo_graph), "general"),
            ("4n", lambda: bal(chip_smoke.BA_400K), "general"),
            ("4o 2D", f64(chip_smoke.world2d_all_graph, *chip_smoke.ALL2D),
             "dense"),
            ("4o 3D", f64(chip_smoke.world3d_all_graph, *chip_smoke.ALL3D),
             "dense"),
            ("4o SBA", f64(chip_smoke.sba_all_graph, *chip_smoke.ALLSBA),
             "dense"))
        for phase, make, route in cases:
            prob = make()
            tag = tag_of(prob.dtype)
            for eg in prob.static.egroups if has_k7 else ():
                chi2_group_line(eg.etype.name, chip_smoke.lin_args(prob, eg),
                                tag, f"{phase} {eg.key}", f"E={eg.count}")
            if route == "dense":
                lam = alg_mod.LevenbergMarquardt().init(prob)["lam"]
                H, b, _ = problem_mod.build_dense_system(
                    prob, pattern=dense_assemble.build_dense_pattern(prob))
                H.diagonal().add_(lam * problem_mod.tangent_masks(prob)[0])
                dx, ok = solve_dense_cholesky(H, b)
                del H
                views = lambda v: {
                    g.name: v[g.offset:g.offset + g.tangent_size].view(
                        g.count, g.tangent_dim) for g in prob.static.vgroups}
                dxp, bp = views(dx), views(b)
                parent_dot = lambda: torch.dot(dx, lam * dx + b)
            else:
                if route == "ell":
                    alg = ba_ell.LevenbergMarquardtSchurELL(
                        **chip_smoke.BA_PCG)
                    lam = alg.init(prob)["lam"]
                    pat = alg.pattern(prob)
                    dxT, ok, bT = ba_ell._solve(
                        prob, pat, ba_ell._build(prob, pat), lam,
                        chip_smoke.BA_PCG["pcg_iters"],
                        chip_smoke.BA_PCG["pcg_tol"])
                else:
                    alg = ba_general.LevenbergMarquardtSchur()
                    lam = alg.init(prob)["lam"]
                    dxT, ok, bT = ba_general._solve(
                        prob, ba_general.schur_build(
                            prob, pattern=alg.pattern(prob)), lam, 250, 1e-8)
                dxp = {k: v.T for k, v in dxT.items()}
                bp = {k: v.T for k, v in bT.items()}
                parent_dot = lambda: sum(
                    torch.dot(d.reshape(-1), (lam * d + bT[k]).reshape(-1))
                    for k, d in dxT.items())
            ni = torch.tensor(2.0, dtype=prob.dtype, device=dev)
            chi = problem_mod.robust_chi2(prob)
            if has_k7:
                outcome = lambda: problem_mod.lm_trial_outcome(
                    prob, dxp, bp, ok, lam, ni, chi)
            else:                          # the parent's trial body
                def outcome():
                    cand = problem_mod.apply_update_parts(prob, dxp)
                    chi_new, _, accept, lam_n, ni_n, retry = \
                        retract_chi2.lm_outcome(
                            problem_mod.robust_chi2(prob, cand).reshape(1),
                            parent_dot().reshape(1), ok, lam, ni, chi)
                    return cand, chi_new, accept, lam_n, ni_n, retry
            res = outcome()
            got = torch.stack([res[1], res[3]]).double().cpu()
            out[f"{phase} {tag}"] = got
            ms = chip_smoke._median_ms(torch, outcome, 5, 1, 1)
            rc_ms = chip_smoke._median_ms(
                torch, lambda: problem_mod.robust_chi2(
                    prob, problem_mod.apply_update_parts(prob, dxp)), 5, 1, 1)
            dev_ms, calls, held = chip_smoke._device_ms(torch, outcome)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                outcome()
                torch.cuda.synchronize()
            n_kernels = sum(
                e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
            agree = ""
            if ref is not None and f"{phase} {tag}" in ref:
                tol = chip_smoke.TOL["chi2_sum"][tag]
                rel = _rel(got, ref[f"{phase} {tag}"])
                agree = (f"; chi2_new, lambda_new against --against: "
                         f"max_rel_err {rel:.3e} (tol {tol:g})")
                if not rel <= tol:
                    failed.append(f"trial {phase}")
                    agree += " FAILED"
            groups = (f"{len(prob.static.vgroups)} vertex groups, "
                      + " ".join(f"{eg.key}={eg.count}"
                                 for eg in prob.static.egroups))
            print(f"kernel_times trial {phase} {tag} ({route} route; "
                  f"{groups}): {'K7' if has_k7 else 'the plain trial'}: "
                  f"outcome {ms:.3f} ms per call (CUDA events around one "
                  f"call, median of 5), {1e3 * dev_ms:.1f} us on the device"
                  + ("" if held else " (host-bound)")
                  + ("" if calls == 200 else f" ({calls} calls)")
                  + f", {n_kernels} device kernels per call (profiler); "
                  f"retract+chi2 {rc_ms:.3f} ms; chi2_new "
                  f"{float(got[0]):.10g}{agree}", flush=True)
            if has_k7:
                cand_call = lambda: problem_mod.trial_candidate(
                    prob, dxp, bp, lam)
                cand, part = cand_call()
                digests = [_digest(cand[g.name])
                           for g in prob.static.vgroups] + [_digest(part)]
                key = f"trial candidate {phase} {tag}"
                saved[key] = digests
                bits = ""
                if against is not None and key in against:
                    bits = (f"; the bits of --against: "
                            f"{digests == against[key]}")
                c_us, c_calls, c_held = chip_smoke._device_ms(torch,
                                                              cand_call)
                torch.cuda.synchronize()
                t_h = time.perf_counter()
                for _ in range(20):
                    cand_call()
                host_us = (time.perf_counter() - t_h) / 20 * 1e6
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    cand_call()
                    torch.cuda.synchronize()
                c_kernels = sum(
                    e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
                print(f"kernel_times trial candidate {phase} {tag}: "
                      f"trial_candidate {1e3 * c_us:.2f} us on the device"
                      + ("" if c_held else " (host-bound)")
                      + ("" if c_calls == 200 else f" ({c_calls} calls)")
                      + f", host {host_us:.1f} us a call, {c_kernels} "
                      f"device kernels a call; partials {part.numel()}"
                      f"{bits}", flush=True)
                del cand, part
            del prob, dxp, bp, ok, res
            torch.cuda.empty_cache()
        # K7's chi2 of the groups of 80,000 and 400,000 edges in float64
        # too, and every type on chip_smoke.py's seeded group (phase 3's
        # rows, Huber) in both dtypes
        for phase, make in (
                ("4j", lambda: synthetic_bal_problem(
                    *chip_smoke.BA_80K, chip_smoke.BA_OBS,
                    dtype=torch.float64)[0]),
                ("4k", lambda: general["@psi2uv"].compile(
                    dtype=torch.float64)),
                ("4l", lambda: general["@intrinsics"].compile(
                    dtype=torch.float64)),
                ("4n", lambda: synthetic_bal_problem(
                    *chip_smoke.BA_400K, chip_smoke.BA_OBS,
                    dtype=torch.float64)[0])) if has_k7 else ():
            prob = make()
            for eg in prob.static.egroups:
                chi2_group_line(eg.etype.name, chip_smoke.lin_args(prob, eg),
                                "float64", f"{phase} {eg.key}",
                                f"E={eg.count}")
            del prob
            torch.cuda.empty_cache()
        for dt in dtypes if has_k7 else ():
            for tname in chip_smoke.LIN_VALUE_OPS:
                largs = chip_smoke.lin_group(
                    torch, tname, chip_smoke.TRIAL_GROUP, dt, dev,
                    kernel_id=1, seed=9)
                chi2_group_line(tname, largs, tag_of(dt), f"seeded {tname}",
                                f"E={chip_smoke.TRIAL_GROUP} seeded group, "
                                "Huber")
                del largs
        # the retraction alone on seeded groups: every vertex type's group
        # of TRIAL_GROUP and the groups of GROUP_ROWS
        from openslam_g2o_torch.kernels import trial
        grouped = hasattr(trial, "trial_retract_groups")
        for dt in dtypes if has_k7 else ():
            tag = tag_of(dt)
            # the vertex types: RETRACT_IDS, or a parent tree's per-type
            # table
            specs = [(f"@{v}", ((v, chip_smoke.TRIAL_GROUP),))
                     for v in (trial.RETRACT_IDS if grouped
                               else trial.RETRACTIONS)]
            specs += [(k.replace("trial_retract_groups", ""), spec)
                      for k, (_, spec) in chip_smoke.GROUP_ROWS.items()]
            for label, spec in specs:
                gr = []
                off = 0
                for i, (v, n) in enumerate(spec):
                    x, dx, b, free, lam_g = chip_smoke.trial_vertex_group(
                        torch, v, n, dt, dev,
                        seed=9 if len(spec) == 1 else 11 + i)
                    gr.append((v, x, dx, free, b, off))
                    off += trial.partial_count(n, dev)
                part = torch.empty(off, dtype=dt, device=dev)
                if grouped:
                    groups = [trial.RetractGroup(*g) for g in gr]
                    run = lambda g_=groups, p_=part, l_=lam_g: (
                        *trial.trial_retract_groups(g_, l_, p_), p_)
                else:
                    def run(g_=gr, p_=part, l_=lam_g):
                        return (*(trial.retraction(v)(
                            x, dx, free, b, l_, p_[o:o + trial.partial_count(
                                x.shape[0], dev)])[0]
                            for v, x, dx, free, b, o in g_), p_)
                outs = run()
                digests = [_digest(t) for t in outs]
                key = f"retract seeded{label} {tag}"
                saved[key] = digests
                bits = ""
                if against is not None and key in against:
                    bits = (f"; the bits of --against: "
                            f"{digests == against[key]}")
                nbytes = sum(chip_smoke.trial_bytes_flops(v, x, dx)[0]
                             for v, x, dx, _, _, _ in gr)
                us, calls, held = chip_smoke._device_ms(torch, run)
                print(f"kernel_times retract seeded{label} {tag} (" + " + "
                      .join(f"{n} {v}" for v, n in spec) + "): "
                      + ("trial_retract_groups" if grouped else
                         f"{len(spec)} per-type launches")
                      + f" {1e3 * us:.2f} us"
                      + ("" if held else " (host-bound)")
                      + ("" if calls == 200 else f" ({calls} calls)")
                      + f"; bound {1e6 * nbytes / chip_smoke.HBM_BYTES_PER_S:.2f}"
                      f" us{bits}", flush=True)
                del gr, part, outs
            torch.cuda.empty_cache()
        if args.save:
            torch.save(out, args.save + ".trial.pt")

    if "trial" in only:
        trial_section()
    # -- K2', K4', K5', K8' ------------------------------------------------
    def pairs_section():
        try:
            from openslam_g2o_torch.kernels import damp_chol, pair_ell
        except ImportError:
            print("kernel_times pairs: skipped: this tree has no pair "
                  "kernels")
            return
        two_pass = hasattr(pair_ell, "pair_stream")
        world_s = Simulator2D(**chip_smoke.PAIR_WORLD).simulate(
            n_poses=chip_smoke.PAIR_POSES)[0]

        def used_order(pt, sv):
            """A scaled table in the used-slot layout [Dr*Dc, U] (a tree
            whose K4' writes [K, Dr*Dc, N]: its used slots gathered), so
            that both trees' digests compare."""
            if sv.dim() == 2:
                return sv
            cnt = pt.cnt.long()
            rows = torch.repeat_interleave(
                torch.arange(cnt.shape[0], device=dev), cnt)
            start = torch.cumsum(cnt, 0) - cnt
            slots = torch.arange(rows.shape[0], device=dev) - start[rows]
            return sv[slots, :, rows].T.contiguous()

        def scaled(prob, pat, dt):
            values, bT = sparse.assemble_ell(prob, pat)
            lam = torch.tensor(0.5, dtype=dt, device=dev)
            linv, extra, bhat = {}, {}, {}
            for g, v in pat.diag_values(values).items():
                linv[g], _, bhat[g], extra[g] = damp_chol.damp_chol(
                    v, prob.free[g], bT[g], lam)
            return values, bT, linv, extra, bhat, pat.scale(values, linv,
                                                            extra)

        world3 = Simulator3D(**chip_smoke.DENSE3_WORLD).simulate(
            n_poses=chip_smoke.DENSE3_POSES)[0]
        for sfx, world_p, dt in ((sfx_, w_, d_) for sfx_, w_ in (
                ("", world_s), ("@3d", world3)) for d_ in dtypes):
            tag = tag_of(dt)
            s_ = torch.empty((), dtype=dt).element_size()
            prob = world_p.compile(dtype=dt)
            pat = sparse.build_ell_pattern(prob)
            if two_pass:
                lin = sparse.pair_linearize(prob)
                srcs, bsrcs = sparse.pair_sources(prob, pat, lin)
                stream = pair_ell.pair_stream(pat.plan, lin)

                def asm():
                    return pair_ell.pair_assemble(
                        pat.plan, pair_ell.pair_stream(pat.plan, lin))

                def asm_plain():
                    return pair_ell.pair_assemble_plain(
                        pat.plan, pair_ell.pair_stream_plain(pat.plan, lin))

                asm_extra = [
                    ("pass 1 (pair_stream) ",
                     lambda: pair_ell.pair_stream(pat.plan, lin)),
                    ("pass 2 (pair_sum) ",
                     lambda: pair_ell.pair_assemble(pat.plan, stream))]
            else:
                srcs, bsrcs = sparse.pair_sources(prob, pat)
                tables = ([(pt.table, src)
                           for pt, src in zip(pat.pairs, srcs)]
                          + [(pat.b_tables[g], bsrcs[g])
                             for g in pat.groups])

                def asm():
                    return [pair_ell.pair_assemble(src, tb)
                            for tb, src in tables]

                def asm_plain():
                    return [pair_ell.pair_assemble_plain(src, tb)
                            for tb, src in tables]

                asm_extra = []
            n_contrib = sum(so.resid.shape[0]
                            for src in [*srcs, *bsrcs.values()]
                            for so in src)
            # the bytes of chip_smoke.py's bound_ms for the same calls
            # (K5''s partials: one a block of 256 threads, ~T / 64)
            work = chip_smoke.pair_work(pat, srcs, bsrcs, s_,
                                        prob.static.total_dim // 64)
            report(f"pair_assemble{sfx}", "pair_assemble",
                   f"{len(pat.pairs)} tables + {len(pat.groups)} b, "
                   f"{n_contrib} contributions, every launch", tag, asm,
                   asm_plain, work["pair_assemble"][0], extra=asm_extra)
            values, bT, linv, extra, bhat, svals = scaled(prob, pat, dt)
            report(f"pair_scale{sfx}", "pair_scale",
                   f"{len(pat.pairs)} pairs (the used slots' bits; "
                   "timed: K4' alone)", tag,
                   lambda: [used_order(pt, sv) for pt, sv in zip(
                       pat.pairs, pat.scale(values, linv, extra))],
                   lambda: [used_order(pt, pair_ell.pair_scale_plain(
                       pt.nb, pt.rowptr if two_pass else pt.cnt, v,
                       linv[pt.rg], linv[pt.cg],
                       extra[pt.rg] if pt.square else None))
                       for pt, v in zip(pat.pairs, values)],
                   work["pair_scale"][0],
                   extra=[("K4' alone ",
                           lambda: pat.scale(values, linv, extra))])
            op = pat.operator(svals)
            gen = torch.Generator(device=dev).manual_seed(3)
            xT = {g: torch.randn((pat.widths[g], pat.counts[g]),
                                 generator=gen, dtype=dt, device=dev)
                  for g in pat.groups}
            if two_pass:
                x = pat.flatten(xT)
                r = torch.randn_like(x)
                lay_plain = pair_ell.FlatLayout.__new__(pair_ell.FlatLayout)
                lay_plain.__dict__.update(op.layout.__dict__)
                lay_plain.on_card = False
                plain_y = lambda: [pair_ell.pair_spmv_plain(lay_plain, x)]
                plain_hi = lambda: [pair_ell.pair_gershgorin_plain(
                    lay_plain)]
                dot = lambda: [op.matvec_dot(x)[0]]
                scal = torch.zeros(10, dtype=dt, device=dev)
                scal[9] = 0.37
                p_new = torch.empty_like(x)
                extra_t = [("K5' alone ", lambda: op.matvec_dot(x)),
                           ("pair_spmv_dot_p ", lambda: op.matvec_dot_p(
                               scal, x, r, p_new))]
            else:
                # this tree's vectors are lane-major: compare in the
                # change's vertex-major order
                dot = lambda: [torch.cat([op.matvec_dot(xT)[0][g].T.reshape(
                    -1) for g in pat.groups])]
                extra_t = [("K5' alone ", lambda: op.matvec_dot(xT))]
                plain_y = lambda: [torch.cat([pair_ell.pair_spmv_plain(
                    *pat.row_operands(g, svals, xT), pat.widths[g])
                    .T.reshape(-1) for g in pat.groups])]
                plain_hi = lambda: [pair_ell.pair_gershgorin_plain(
                    pat.bound_rows(svals))]
            report(f"pair_spmv_dot{sfx}", "pair_spmv_dot",
                   f"T={prob.static.total_dim}, {len(pat.groups)} row groups "
                   "as the CG step calls it", tag,
                   lambda: [torch.cat([t.reshape(-1) for t in dot()])],
                   plain_y, work["pair_spmv_dot"][0], extra=extra_t)
            report(f"pair_gershgorin{sfx}", "pair_gershgorin", "", tag,
                   lambda: [pat.row_bound(svals)], plain_hi,
                   work["pair_gershgorin"][0])
            # the sweep sets the lanes alone, as this tree's flat_shape
            # gives them (not the (lanes, split) of an earlier form)
            if two_pass and isinstance(
                    pair_ell.flat_shape(op.layout.groups)[0], int):
                shape_sweep(f"{sfx} {tag}", pat, svals, x, r, scal)
            if dt == torch.float32:
                for cheby in ((0, 4) if sfx == "" else (4,)):
                    cg_loop(f"pairs{sfx} {tag}"
                            + (f" pcg_cheby {cheby}" if cheby else ""),
                            prob, pat, op, bhat,
                            iters=50 if cheby else 200, cheby=cheby)
            del prob, pat, srcs, bsrcs, values, bT, svals, op
            torch.cuda.empty_cache()
        # the pair path on a one-group pose graph against EllPattern's
        from openslam_g2o_torch.apps.simulator import synthetic_pose_graph_2d
        sphere = create_sphere(**chip_smoke.SPHERE)[0]
        for label, prob in (
                ("se2 100k", synthetic_pose_graph_2d(
                    chip_smoke.N_POSES, grid=chip_smoke.GRID,
                    trans_noise=0.03, rot_noise=0.002,
                    dtype=torch.float32)[0]),
                ("se3 sphere", sphere.compile(dtype=torch.float32))):
            for kind, pat in (("EllPattern", sparse.build_ell_pattern(prob)),
                              ("PairPattern",
                               sparse.build_pair_pattern(prob))):
                _, _, _, _, bhat, svals = scaled(prob, pat, torch.float32)
                cg_loop(f"one-group {label} {kind}", prob, pat,
                        pat.operator(svals), bhat)
                del pat, svals, bhat
            del prob
            torch.cuda.empty_cache()

    def shape_sweep(what, pat, svals, x, r, scal):
        """K5''s folded product (pair_spmv_dot_p) with other lanes a row
        (kernels/pair_ell.py flat_shape): device us beside the path's
        shape, and the largest difference from its product relative to its
        largest entry."""
        from openslam_g2o_torch.kernels import pair_ell
        p_new = torch.empty_like(x)
        ref = pat.operator(svals)
        y0 = ref.matvec_dot_p(scal, x, r, p_new)[0].clone()
        saved = pair_ell.flat_shape
        variants = [("path", None)]
        for lanes in (1, 4, 8, 16, 32):
            variants.append((f"lanes {lanes}", [lanes]))
        for lanes in (4, 8, 16):
            variants.append((f"lanes {lanes}, 32", [lanes, 32]))
        line = []
        for label, lanes in variants:
            try:
                if lanes is not None:
                    pair_ell.flat_shape = lambda groups: (
                        lanes + [lanes[-1]] * len(groups))[:len(groups)]
                lay = pat.flat_layout(svals)
            finally:
                pair_ell.flat_shape = saved
            fn = lambda: pair_ell.pair_spmv_dot_p(lay, scal, x, r, p_new)
            y = fn()[0]
            rel = _rel(y, y0)
            ms, _, held = chip_smoke._device_ms(torch, fn)
            line.append(f"{label} (lanes {lay.lanes}) {1e3 * ms:.2f} us"
                        + ("" if held else " (host-bound)")
                        + f" ({rel:.1e})")
            del lay
        print(f"kernel_times pair_spmv_dot_p shapes{what}: "
              + "; ".join(line), flush=True)

    def cg_loop(what, prob, pat, op, bhat, iters=200, cheby=0):
        """One trial solve of `iters` CG iterations (tol 0, so it never
        stops early), as _pcg_trial runs it: unpreconditioned, or with
        pcg_cheby's degree-`cheby` polynomial bracketed by K8''s bound
        (then `iters` counts outer iterations): wall per CG iteration
        unprofiled (median of 3) and profiled, device time and device
        kernels per CG iteration (the profiler), and its x's digest."""
        from openslam_g2o_torch.core import solvers
        from torch.profiler import ProfilerActivity, profile
        if cheby:
            hi = pat.row_bound(op.values)
            pre = solvers.make_chebyshev_precond(op, hi * 0.02, hi, cheby)
            solve = lambda: solvers.pcg_solve(op, bhat, precond=pre,
                                              max_iter=iters, tol=0.0,
                                              unroll=1, norm="precond")
        else:
            solve = lambda: solvers.pcg_solve(op, bhat, max_iter=iters,
                                              tol=0.0, unroll=2,
                                              norm="precond")
        solve()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            x, _ = solve()
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e6 / iters)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve()
            torch.cuda.synchronize()
        wall_p = (time.monotonic() - t0) * 1e6 / iters
        rows = [(e.self_device_time_total, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy = sum(r[0] for r in rows) / iters
        kern = sum(r[1] for r in rows
                   if not r[2].startswith(("Memcpy", "Memset"))) / iters
        key = f"cg {what}"
        digests = [_digest(torch.cat([x[g].reshape(-1) for g in x]))]
        saved[key] = digests
        bits = ""
        if against is not None and key in against:
            bits = f"; the bits of --against: {digests == against[key]}"
        print(f"kernel_times {key}: {iters} CG iterations: wall "
              + "/".join(f"{w:.1f}" for w in sorted(walls))
              + f" us a CG iteration (unprofiled), {wall_p:.1f} profiled; "
              f"device {busy:.2f} us and {kern:.3f} kernels a CG iteration; "
              + "; ".join(f"{k_[:32]} {us / n_:.2f} us x {n_}"
                          for us, n_, k_ in sorted(rows, reverse=True)[:5])
              + bits, flush=True)

    if "pairs" in only:
        pairs_section()

    # -- the preconditioner step of the Schur routes' PCG (K4) ---------------
    def precond_section():
        from torch.profiler import ProfilerActivity, profile
        from openslam_g2o_torch import kernels as kernels_mod
        from openslam_g2o_torch.kernels import cg_step, jacobi_scale
        from openslam_g2o_torch.models.bal import load_bal_problem
        fused = hasattr(jacobi_scale, "lane_block_mv_dot")
        bal_dir = tempfile.mkdtemp(prefix="kernel_times_precond_")
        bal400 = os.path.join(bal_dir, "bal400k.bal")
        chip_smoke.bal_camera_scene(bal400, *chip_smoke.BA_400K)

        def step_line(label, tag, mats, r):
            D, N = r.shape
            if fused:
                run = lambda: jacobi_scale.lane_block_mv_dot(mats, r)
            else:
                def run():
                    z = jacobi_scale.lane_block_mv(mats, r)
                    return z, cg_step.dot_partials(r, z)
            m_b = mats.view(D, D, N).permute(2, 0, 1).contiguous()
            r_b = r.T.contiguous()[:, :, None]
            z, part = run()
            zp = jacobi_scale.lane_block_mv_plain(mats, r)
            rel = max(_rel(z, zp),
                      _rel(part.sum(), cg_step.dot_partials_plain(r, zp)))
            tol = chip_smoke.TOL_DEFAULT[tag]
            z2, part2 = run()
            same = torch.equal(z, z2) and torch.equal(part, part2)
            key = f"precond step {label} {tag}"
            digests = [_digest(z), _digest(part)]
            saved[key] = digests
            bits = ""
            if against is not None and key in against:
                bits = f"; the bits of --against: {digests == against[key]}"
            if not (rel <= tol and same):
                failed.append(key)
            times = {("lane_block_mv_dot" if fused else
                      "lane_block_mv + dot_partials"): run,
                     "torch.bmm (z alone)": lambda: torch.bmm(m_b, r_b)}
            line = []
            for what, fn in times.items():
                ms, calls, held = chip_smoke._device_ms(torch, fn)
                line.append(f"{what} {1e3 * ms:.2f} us"
                            + ("" if held else " (host-bound)")
                            + ("" if calls == 200 else f" ({calls} calls)"))
            nbytes = r.element_size() * ((D * D + 2 * D) * N
                                         + -(-D * N // 1024))
            print(f"kernel_times precond step {label} {tag} D={D} N={N}: "
                  + "; ".join(line) + f"; bound "
                  f"{1e6 * nbytes / chip_smoke.HBM_BYTES_PER_S:.2f} us; "
                  f"max_rel_err {rel:.3e}; same bits {same}{bits}"
                  + ("" if rel <= tol and same else " FAILED"), flush=True)

        def solve_line(label, prob, solve, n_groups):
            solve()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                solve()
                torch.cuda.synchronize()
                walls.append(time.monotonic() - t0)
            before = kernels_mod.launch_counts()
            dx = solve()[0]
            after = kernels_mod.launch_counts()
            calls = {k: v - before[k] for k, v in after.items()
                     if v != before[k]}
            iters = calls.get("cg_update_xr", 0) // n_groups
            # a profile can lose its device records (PERF.md §7): up to
            # three tries
            for _ in range(3):
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    solve()
                    torch.cuda.synchronize()
                rows = [(e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and e.self_device_time_total > 0]
                if rows:
                    break
            busy = sum(r_[0] for r_ in rows)
            kern = sum(r_[1] for r_ in rows
                       if not r_[2].startswith(("Memcpy", "Memset")))
            key = f"precond solve {label}"
            digests = [_digest(torch.cat([v.reshape(-1)
                                          for v in dx.values()]))]
            saved[key] = digests
            bits = ""
            if against is not None and key in against:
                bits = f"; the bits of --against: {digests == against[key]}"
            it = max(iters, 1)
            print(f"kernel_times precond solve {label}: {iters} CG "
                  f"iterations, {n_groups} pose group(s); a CG iteration: "
                  f"{sum(calls.values()) / it:.2f} wrapper calls ("
                  + " ".join(f"{k}={v}" for k, v in sorted(calls.items()))
                  + f" in the solve), {kern / it:.2f} device kernels, "
                  f"device {busy / it:.2f} us, wall "
                  + "/".join(f"{1e6 * w / it:.1f}" for w in sorted(walls))
                  + " us (host clock around the solve, synchronized)"
                  + bits, flush=True)

        for dt in dtypes:
            tag = tag_of(dt)
            # the implicit dual-ELL route's preconditioner blocks
            for label, make in (
                    ("@400k", lambda: synthetic_bal_problem(
                        *chip_smoke.BA_400K, chip_smoke.BA_OBS,
                        dtype=dt)[0]),
                    ("@bal400k", lambda: load_bal_problem(bal400,
                                                          dtype=dt)[0])):
                prob = make()
                pat = ba_ell.build_ba_ell_pattern(prob)
                sys_ = ba_ell._build(prob, pat)
                lam = torch.tensor(1e-3, dtype=dt, device=dev)
                _, hinv, _ = ba_inv.ba_block_inv(
                    sys_["Hll"], ba_inv.LANDMARK,
                    prob.free[pat.lm_name], lam, b=sys_["b_l"])
                hcc_d = ba_inv.ba_block_inv(
                    sys_["Hcc"], ba_inv.CAMERA, prob.free[pat.cam_name], lam,
                    want_inv=False)[0]
                binv = ba_inv.ba_block_inv(ba_coupling.ba_sandwich(
                    sys_["W_cam"], pat.cam_rows, hinv, hcc_d))[1]
                gen = torch.Generator(device=dev).manual_seed(3)
                r = torch.randn((pat.dp, pat.n_cam), generator=gen,
                                dtype=dt, device=dev)
                step_line(label, tag, binv, r)
                if dt == torch.float32:
                    # at lambda init; BA_PCG's tolerance ends CG after two
                    # iterations there, so the loop runs its 30 to tol 0
                    alg = ba_ell.LevenbergMarquardtSchurELL(
                        **chip_smoke.BA_PCG)
                    lam0 = alg.init(prob)["lam"]
                    solve_line(
                        {"@400k": "4h", "@bal400k": "4p @400k"}[label],
                        prob, lambda: ba_ell._solve(
                            prob, pat, sys_, lam0,
                            chip_smoke.BA_PCG["pcg_iters"], 0.0), 1)
                del prob, pat, sys_, hinv, hcc_d, binv
                torch.cuda.empty_cache()
            # the general path: 4l's pose groups, and 4n's solve
            lprob = general["@intrinsics"].compile(dtype=dt)
            lsys = ba_general.schur_build(lprob)
            lpat = lsys["pattern"]
            hinv = ba_inv.ba_block_inv(lsys["Hll"], ba_inv.LANDMARK,
                                       lprob.free[lpat.lm_name],
                                       torch.tensor(1e-3, dtype=dt,
                                                    device=dev),
                                       b=lsys["b_l"])[1]
            hpp = lsys["Hpp"][lpat.perm[:, None], lpat.perm[None, :]]
            hpp.diagonal().add_(1e-3)
            for pg in lpat.pose_groups:
                blk = ba_coupling.ba_sandwich(
                    lsys["W_pose"][pg.name], pg.rows, hinv,
                    ba_general.diag_blocks(hpp, pg))
                binv = ba_inv.ba_block_inv(blk)[1]
                gen = torch.Generator(device=dev).manual_seed(4)
                r = torch.randn((pg.dim, pg.count), generator=gen,
                                dtype=dt, device=dev)
                step_line(f"@4l {pg.name}", tag, binv, r)
            del lprob, lsys, lpat, hinv, hpp
            if dt == torch.float32:
                nprob = synthetic_bal_problem(
                    *chip_smoke.BA_400K, chip_smoke.BA_OBS, dtype=dt)[0]
                alg = ba_general.LevenbergMarquardtSchur()
                lam0 = alg.init(nprob)["lam"]
                nsys = ba_general.schur_build(nprob,
                                              pattern=alg.pattern(nprob))
                solve_line("4n", nprob, lambda: ba_general._solve(
                    nprob, nsys, lam0, 250, 1e-8), 1)
                del nprob, nsys
            torch.cuda.empty_cache()
        shutil.rmtree(bal_dir, ignore_errors=True)

    if "precond" in only:
        precond_section()
    # -- the one-group LM-PCG path (kernels B / K16, C, A, K3, K4, K6, K7) --
    def pose_section():
        from openslam_g2o_torch.apps.simulator import synthetic_pose_graph_2d
        from openslam_g2o_torch.core import algorithms
        from openslam_g2o_torch.kernels import (
            cg_step, damp_chol, jacobi_scale)
        sphere = create_sphere(**chip_smoke.SPHERE)[0]
        for label, make in (
                ("se2", lambda dt: synthetic_pose_graph_2d(
                    chip_smoke.N_POSES, grid=chip_smoke.GRID,
                    trans_noise=0.03, rot_noise=0.002, dtype=dt)[0]),
                ("se3", lambda dt: sphere.compile(dtype=dt))):
            for dt in dtypes:
                tag = tag_of(dt)
                prob = make(dt)
                pat = sparse.build_ell_pattern(prob)
                values, bT = sparse.assemble_ell(prob, pat)
                g = pat.group
                lam = torch.tensor(0.5, dtype=dt, device=dev)
                free, b = prob.free[g], bT[g]
                # (against itself: its kernels' rows are chip_smoke.py's)
                asm = lambda: (lambda o: [o[0], o[1][g]])(
                    sparse.assemble_ell(prob, pat))
                report(f"pose assemble_ell {label}", "assemble_gather",
                       f"N={pat.n} K={pat.k}", tag, asm, asm,
                       values.element_size() * values.numel())
                report(f"pose damp_chol {label}", "damp_chol", f"N={pat.n}",
                       tag, lambda: list(damp_chol.damp_chol(
                           values, free, b, lam)),
                       lambda: list(damp_chol.damp_chol_plain(
                           values, free, b, lam)),
                       values.element_size() * 3 * b.numel() * b.shape[0])
                linv, lchol, bhat, extra = damp_chol.damp_chol(
                    values, free, b, lam)
                report(f"pose jacobi_scale {label}", "jacobi_scale",
                       f"N={pat.n} K={pat.k}", tag,
                       lambda: [jacobi_scale.jacobi_scale(
                           pat.nb, values, linv, extra)],
                       lambda: [jacobi_scale.jacobi_scale_plain(
                           pat.nb, values, linv, extra)],
                       2 * values.element_size() * values.numel())
                sv = jacobi_scale.jacobi_scale(pat.nb, values, linv, extra)
                report(f"pose spmv_dot {label}", "spmv_dot",
                       f"N={pat.n} K={pat.k}", tag,
                       lambda: [t.sum() if t.dim() == 1 else t for t in
                                cg_step.spmv_dot(pat.nb, sv, bhat)],
                       lambda: list(cg_step.spmv_dot_plain(pat.nb, sv, bhat)),
                       sv.element_size() * sv.numel())
                report(f"pose lane_block_mv {label}", "lane_block_mv",
                       f"N={pat.n}", tag,
                       lambda: [jacobi_scale.lane_block_mv(linv, bhat, True)],
                       lambda: [jacobi_scale.lane_block_mv_plain(
                           linv, bhat, True)], 3 * bhat.element_size()
                       * bhat.numel())
                # three LM iterations of the whole path, digested
                alg = algorithms.LevenbergMarquardtPCG(pcg_iters=50,
                                                       pcg_tol=1e-6)
                state = alg.init(prob)
                out = algorithms.lm_pcg_optimize_fused(
                    prob, alg.pattern(prob), state["params"], state["lam"],
                    state["ni"], state["chi2"], n_iters=3, pcg_iters=50,
                    pcg_tol=1e-6)
                key = f"pose lm_pcg_optimize_fused {label} {tag}"
                digests = [_digest(out[4]), _digest(out[0][g])]
                saved[key] = digests
                bits = ""
                if against is not None and key in against:
                    bits = f"; the bits of --against: {digests == against[key]}"
                print(f"kernel_times {key}: chi2 "
                      + " ".join(f"{c!r}" for c in out[4].tolist()) + bits,
                      flush=True)
                del prob, pat, values, bT, sv, out
                torch.cuda.empty_cache()

    if "pose" in only:
        pose_section()
    if args.save:
        with open(args.save, "w") as f:
            json.dump(saved, f, indent=0)
    if bal_files:
        shutil.rmtree(os.path.dirname(next(iter(bal_files.values()))),
                      ignore_errors=True)
    if failed:
        print("kernel_times: FAILED " + ", ".join(failed))
        return 1
    print("kernel_times: every kernel within its tolerance, the same bits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
