#!/usr/bin/env python3
"""Device time by CUDA events of K16 `edge_se3_blocks` and K13
`ba_sandwich` for any tree of the port, so that two trees can be timed in
one session on one card.

    python3 kernel_times.py [--tree PATH]

It times the `openslam_g2o_torch` of PATH (default: this script's own
tree) with this tree's chip_smoke.py: its shapes, its `_device_ms` (CUDA
events around up to 200 calls queued behind a spin kernel, median of 5)
and its tolerances against the plain version. chip_smoke.py's phase 3
times both kernels itself; this script times a tree whose chip_smoke.py
does not, at the same shapes: K16 on the sphere of phase 4e (100,000
poses, 149,963 edges) without and with Huber, on streams of the main
path's width, and `ba_sandwich` on the pose rows of ba_80k and ba_400k and
of each pose group of the PSI2UV and P2MC_INTRINSICS scenes (random
seeded W, Hinv, Hcc_d; the scenes' own rows and chunks). Float32 and
float64. Each line gives the microseconds per call, the bound (bytes over
3.35 TB/s), the error against the plain version relative to its largest
entry, and whether a second call gave the same bits. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import chip_smoke


def _rel(got, want):
    err = float((got.double() - want.double()).abs().max())
    return err / max(float(want.double().abs().max()), 1e-300)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)), help="root of the tree to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from openslam_g2o_torch.apps.simulator import (
        create_sphere, synthetic_bal_problem)
    from openslam_g2o_torch.core import ba as ba_general
    from openslam_g2o_torch.core import ba_ell, sparse
    from openslam_g2o_torch.core.graph import Graph
    from openslam_g2o_torch.kernels import ba_coupling, edge_se3

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"kernel_times: {card}; openslam_g2o_torch from "
          f"{edge_se3.__file__.rsplit('/openslam_g2o_torch/', 1)[0]}")
    dev = torch.device("cuda")
    failed = []

    def report(name, tol_key, shape, tag, run, plain, nbytes):
        got = [t.clone() for t in run()]
        rel = max(_rel(g, w) for g, w in zip(got, plain()))
        same = all(torch.equal(g, a) for g, a in zip(got, run()))
        ok = rel < chip_smoke.TOL[tol_key][tag] and same
        if not ok:
            failed.append(f"{name} {tag}")
        ms, calls, held = chip_smoke._device_ms(torch, run)
        print(f"kernel_times {name} {tag} {shape}: {1e3 * ms:.2f} us"
              + ("" if held else " (host-bound)")
              + ("" if calls == 200 else f" ({calls} calls)")
              + f"; bound {1e6 * nbytes / chip_smoke.HBM_BYTES_PER_S:.2f} us"
              f"; max_rel_err {rel:.3e}; same bits {same}"
              + ("" if ok else " FAILED"), flush=True)

    # -- K16 on the sphere --------------------------------------------------
    sphere, _ = create_sphere(**chip_smoke.SPHERE)
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
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

            report(name, name, f"N={N} E={E}, streams {W} columns wide", tag,
                   run, plain, s * (8 * N + 44 * E + 156 * E) + 8 * E)
        del prob, hk, bk, hp, bp
    del sphere

    # -- ba_sandwich on the scenes' pose rows -------------------------------
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

    geo80 = chip_smoke.bal_geometry(*chip_smoke.BA_80K)
    general = {"@psi2uv": chip_smoke.psi2uv_graph(Graph, geo80),
               "@intrinsics": chip_smoke.p2mc_intrinsics_graph(Graph, geo80)}
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
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
                sandwich_rows(tag, dt, f"{sfx}#{pg.name}", pg.rows, pg.dim,
                              pat.dl, pat.n_lm)
    if failed:
        print("kernel_times: FAILED " + ", ".join(failed))
        return 1
    print("kernel_times: every kernel within its tolerance, the same bits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
