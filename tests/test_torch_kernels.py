"""Kernel wrappers: argument checks and CPU dispatch (run everywhere), and
each CUDA kernel against its plain version on the card (skipped without a
GPU; run them there with `python -m pytest tests/test_torch_kernels.py`).

On the card, relative to the largest |plain| entry: kernels A and C and
the trial-solve kernels to 1e-12 (float64) and 2e-5 (float32), since they
sum a few products in another order and contract multiply-adds to FMA;
kernel B to 1e-11 and 1e-4, since its pose differences cancel (coordinates
of ~10-100 against residuals of ~0.03), so an FMA or a last-ulp sin/cos
difference moves the residual by an ulp of the coordinate; the closed-form
Cholesky of K3 to the same 1e-11 and 1e-4, since it subtracts squares and
divides by the result. The lane gather copies values and must be exact.
"""

import numpy as np
import pytest
import torch

from openslam_g2o_torch import kernels
from openslam_g2o_torch.apps.simulator import synthetic_pose_graph_2d
from openslam_g2o_torch.core import algorithms, sparse
from openslam_g2o_torch.core import solvers
from openslam_g2o_torch.apps.simulator import Simulator2D
from openslam_g2o_torch.core import problem as problem_mod
from openslam_g2o_torch.kernels import (
    cg_step, chebyshev, damp_chol, dense_assemble, gather, jacobi_scale,
    retract_chi2)
from openslam_g2o_torch.kernels.assemble import (
    assemble_gather, assemble_gather_plain)
from openslam_g2o_torch.kernels.edge_se2 import (
    edge_se2_blocks, edge_se2_blocks_plain)
from openslam_g2o_torch.kernels.spmv import (
    block_ell_spmv, block_ell_spmv_plain)

torch.set_num_threads(1)

TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
TOL_B = {torch.float64: 1e-11, torch.float32: 1e-4}


def _small_system(dtype=torch.float64, device="cpu", n=300):
    prob, _ = synthetic_pose_graph_2d(n_poses=n, grid=10, dtype=dtype,
                                      device=device)
    return prob, sparse.build_ell_pattern(prob)


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    prob, pattern = _small_system()
    kernels.reset_launch_counts()
    values, bT = sparse.assemble_ell(prob, pattern)
    y = sparse.ell_matvec_lane(pattern, values, bT)["se2"]
    torch.testing.assert_close(
        y, block_ell_spmv_plain(pattern.nb, values, bT["se2"]))
    algorithms.optimize(prob, algorithms.LevenbergMarquardtPCG(
        pcg_iters=10, pcg_cheby=2), iterations=1)
    counts = kernels.launch_counts()
    assert {"block_ell_spmv", "edge_se2_blocks", "assemble_gather",
            "damp_chol", "jacobi_scale", "spmv_dot", "cg_update_xr",
            "cg_update_p", "gershgorin_bound", "chebyshev_update",
            "lane_gather", "retract_chi2", "lm_outcome",
            "dense_assemble"} <= set(counts)
    assert set(counts.values()) == {0}


def test_wrappers_reject_bad_arguments():
    prob, pattern = _small_system()
    values, bT = sparse.assemble_ell(prob, pattern)
    x = bT["se2"]
    with pytest.raises(ValueError, match="int32"):
        block_ell_spmv(pattern.nb.long(), values, x)
    with pytest.raises(ValueError, match="dtype"):
        block_ell_spmv(pattern.nb, values, x.float())
    with pytest.raises(ValueError, match="shape"):
        block_ell_spmv(pattern.nb, values, x[:2])
    with pytest.raises(ValueError, match="contiguous"):
        block_ell_spmv(pattern.nb, values, x.t().contiguous().t())
    hblk, bblk = sparse.edge_blocks(prob, pattern)
    ea = prob.edges["edge_se2"]
    args = (prob.params["se2"], prob.free["se2"], ea.indices[0],
            ea.indices[1], ea.measurement, ea.information, ea.delta)
    with pytest.raises(ValueError, match="robust kernel"):
        edge_se2_blocks(*args, 99, hblk, bblk, 0)
    with pytest.raises(ValueError, match="fit"):     # past the padding
        edge_se2_blocks(*args, 0, hblk, bblk,
                        pattern.e_cols - pattern.e_total + 1)
    with pytest.raises(ValueError, match="hidx"):
        assemble_gather(hblk, bblk, pattern.hidx[:, :-1], pattern.bidx,
                        pattern.k, pattern.n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _scal_rel(sk, sp):
    """The CG scalar buffers slot by slot: the pd/continue flags must be
    equal, and the result is the largest error of a scalar relative to its
    own plain value (rz, r2 and b2 dwarf alpha, beta and the flags)."""
    flags = [cg_step.PD, cg_step.CONT, cg_step.PD_NEXT]
    assert torch.equal(sk[flags], sp[flags]), (sk.tolist(), sp.tolist())
    return max(_rel(a, b) for a, b in zip(sk.unbind(), sp.unbind()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_on_gpu(cuda, dtype):
    prob, pattern = _small_system(dtype, cuda, n=5000)
    kernels.reset_launch_counts()
    hblk, bblk = sparse.edge_blocks(prob, pattern)
    ph = torch.empty_like(hblk)
    pb = torch.empty_like(bblk)
    ea = prob.edges["edge_se2"]
    edge_se2_blocks_plain(prob.params["se2"], prob.free["se2"], ea.indices[0],
                          ea.indices[1], ea.measurement, ea.information,
                          ea.delta, 0, ph, pb, 0)
    # the written columns: on the card each block of the streams is
    # pattern.e_cols wide, its padding never written nor read
    E, W = pattern.e_total, pattern.e_cols
    cols = lambda t, m: t.view(t.shape[0], m, W)[:, :, :E]
    assert _rel(cols(hblk, 4), cols(ph, 4)) < TOL_B[dtype]
    assert _rel(cols(bblk, 2), cols(pb, 2)) < TOL_B[dtype]
    values, b = assemble_gather(hblk, bblk, pattern.hidx, pattern.bidx,
                                pattern.k, pattern.n)
    pv, pbv = assemble_gather_plain(hblk, bblk, pattern.hidx, pattern.bidx,
                                    pattern.k, pattern.n)
    assert _rel(values, pv) < TOL[dtype] and _rel(b, pbv) < TOL[dtype]
    x = torch.randn((3, pattern.n), dtype=dtype, device=cuda)
    y = block_ell_spmv(pattern.nb, values, x)
    assert _rel(y, block_ell_spmv_plain(pattern.nb, values, x)) < TOL[dtype]
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched == {"block_ell_spmv": 1, "edge_se2_blocks": 1,
                        "assemble_gather": 1}


def test_robust_kernel_ids_match_plain_on_gpu(cuda):
    """Kernel B's rho' for every robust kernel id, on residuals that reach
    both branches of the piecewise kernels."""
    prob, pattern = _small_system(torch.float64, cuda, n=2000)
    ea = prob.edges["edge_se2"]
    params = prob.params["se2"] + 0.3 * torch.randn_like(prob.params["se2"])
    delta = torch.rand_like(ea.delta) * 2.0 + 0.05
    args = (params, prob.free["se2"], ea.indices[0], ea.indices[1],
            ea.measurement, ea.information, delta)
    for kid in range(11):
        h1, b1 = (torch.empty((9, 4 * pattern.e_total), dtype=torch.float64,
                              device=cuda),
                  torch.empty((3, 2 * pattern.e_total), dtype=torch.float64,
                              device=cuda))
        h2, b2 = torch.empty_like(h1), torch.empty_like(b1)
        edge_se2_blocks(*args, kid, h1, b1, 0)
        edge_se2_blocks_plain(*args, kid, h2, b2, 0)
        assert _rel(h1, h2) < TOL_B[torch.float64], kid
        assert _rel(b1, b2) < TOL_B[torch.float64], kid


def test_spmv_probe_shape_on_gpu(cuda):
    N, K = 3500, 10
    rng = np.random.default_rng(0)
    nb = torch.as_tensor(rng.integers(0, N, (K, N)).astype(np.int32),
                         device=cuda)
    values = torch.as_tensor(rng.normal(size=(K, 9, N)), device=cuda)
    x = torch.as_tensor(rng.normal(size=(3, N)), device=cuda)
    assert _rel(block_ell_spmv(nb, values, x),
                block_ell_spmv_plain(nb, values, x)) < 1e-12


def _scaled(cuda, dtype, n=5000):
    prob, pattern = _small_system(dtype, cuda, n=n)
    values, bT = sparse.assemble_ell(prob, pattern)
    lam = torch.tensor(0.7, dtype=dtype, device=cuda)
    return prob, pattern, values, bT["se2"], lam


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trial_kernels_match_plain_on_gpu(cuda, dtype):
    """K3 and K4 (and the block application) on a 5000-pose system."""
    prob, pattern, values, b, lam = _scaled(cuda, dtype)
    free = prob.free["se2"]
    kernels.reset_launch_counts()
    got = damp_chol.damp_chol(values, free, b, lam)
    want = damp_chol.damp_chol_plain(values, free, b, lam)
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL_B[dtype]
    linv, lchol, _, extra = got
    assert not linv[[1, 2, 5]].any() and not lchol[[1, 2, 5]].any()
    S = jacobi_scale.jacobi_scale(pattern.nb, values, linv, extra)
    assert _rel(S, jacobi_scale.jacobi_scale_plain(pattern.nb, values, linv,
                                                   extra)) < TOL[dtype]
    x = torch.randn((3, pattern.n), dtype=dtype, device=cuda)
    for transpose in (False, True):
        assert _rel(jacobi_scale.lane_block_mv(lchol, x, transpose),
                    jacobi_scale.lane_block_mv_plain(lchol, x, transpose)
                    ) < TOL[dtype]
    hi = chebyshev.gershgorin_bound(S)
    assert _rel(hi, chebyshev.gershgorin_bound_plain(S)) < TOL[dtype]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["damp_chol"], counts["jacobi_scale"],
            counts["lane_block_mv"], counts["gershgorin_bound"]) == (1, 1, 2,
                                                                     1)


def test_trial_kernels_nan_cases_on_gpu(cuda):
    """A non-SPD block gives NaN factors in that row only; a NaN factor in
    row 0 leaves every padding slot exactly zero."""
    prob, pattern, values, b, lam = _scaled(cuda, torch.float64, n=2000)
    free = prob.free["se2"]
    bad = values.clone()
    bad[0, 0, 7] = -1.0e6
    got = damp_chol.damp_chol(bad, free, b, lam)
    want = damp_chol.damp_chol_plain(bad, free, b, lam)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
    nan_rows = torch.isnan(got[0]).any(dim=0).nonzero().flatten().tolist()
    assert nan_rows == [7]
    linv, _, _, extra = damp_chol.damp_chol(values, free, b, lam)
    linv[:, 0] = float("nan")
    S = jacobi_scale.jacobi_scale(pattern.nb, values, linv, extra)
    Sp = jacobi_scale.jacobi_scale_plain(pattern.nb, values, linv, extra)
    assert torch.equal(torch.isnan(S), torch.isnan(Sp))
    pad = (values == 0).all(dim=1)
    pad[0] = False
    assert int(pad.sum()) > 0 and not S.permute(0, 2, 1)[pad].any()
    assert torch.isnan(S[0, :, 0]).all()
    assert torch.isnan(chebyshev.gershgorin_bound(S))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cg_step_kernels_match_plain_on_gpu(cuda, dtype):
    """One hand-driven CG iteration, kernel route and plain route side by
    side from the same state, then the vector kernels of the Chebyshev
    preconditioner."""
    prob, pattern, values, b, lam = _scaled(cuda, dtype)
    linv, _, bhat, extra = damp_chol.damp_chol(values, prob.free["se2"], b,
                                               lam)
    S = jacobi_scale.jacobi_scale(pattern.nb, values, linv, extra)
    tol = TOL[dtype]
    x0 = 0.1 * torch.randn_like(bhat)
    hx = block_ell_spmv(pattern.nb, S, x0)
    rk, pk, rr_k, bb_k = cg_step.cg_residual(bhat, hx)
    rp, pp, rr_p, bb_p = cg_step.cg_residual_plain(bhat, hx)
    assert _rel(rk, rp) < tol and torch.equal(rk, pk)
    assert _rel(rr_k.sum(), rr_p) < tol and _rel(bb_k.sum(), bb_p) < tol
    sk, sp = cg_step.new_scalars(rk), cg_step.new_scalars(rk)
    cg_step.cg_start(sk, rr_k, rr_k, bb_k, 0.15, True)
    cg_step.cg_start_plain(sp, rr_p, rr_p, bb_p, 0.15, True)
    assert _scal_rel(sk, sp) < tol
    hp_k, pap_k = cg_step.spmv_dot(pattern.nb, S, pk)
    hp_p, pap_p = cg_step.spmv_dot_plain(pattern.nb, S, pp)
    assert _rel(hp_k, hp_p) < tol and _rel(pap_k.sum(), pap_p) < tol
    xk, xp = x0.clone(), x0.clone()
    rr_k = cg_step.cg_update_xr(sk, pap_k, xk, rk, pk, hp_k)
    rr_p = cg_step.cg_update_xr_plain(sp, pap_p, xp, rp, pp, hp_p)
    assert _rel(xk, xp) < tol and _rel(rk, rp) < tol
    assert _rel(rr_k.sum(), rr_p) < tol and _scal_rel(sk, sp) < tol
    cg_step.cg_update_p(sk, rr_k, rr_k, rk, pk, True)
    cg_step.cg_update_p_plain(sp, rr_p, rr_p, rp, pp, True)
    assert _rel(pk, pp) < tol and _scal_rel(sk, sp) < tol
    assert float(sk[cg_step.PD]) == 1.0 and float(sk[cg_step.CONT]) == 1.0
    assert _rel(cg_step.dot_partials(rk, pk).sum(),
                cg_step.dot_partials_plain(rk, pk)) < tol
    ok = cg_step.cg_finish(sk, [xk])
    assert ok.dtype == torch.bool and bool(ok) and xk.any()
    xk[2, 11] = float("nan")
    assert not bool(cg_step.cg_finish(sk, [xk])) and not xk.any()

    # converged with pd on: the next cg_update_p clears the continue flag
    for fn, sc, r_, p_ in ((cg_step.cg_update_p, sk, rk, pk),
                           (cg_step.cg_update_p_plain, sp, rp, pp)):
        sc[cg_step.THRESH] = 1e30
        rr = cg_step.dot_partials(r_, r_)
        fn(sc, rr, rr, r_, p_, True)
        assert float(sc[cg_step.PD]) == 1.0 and float(sc[cg_step.CONT]) == 0.0
    assert _scal_rel(sk, sp) < tol

    hi = chebyshev.gershgorin_bound(S)
    ck = chebyshev.chebyshev_coeffs(hi * 0.02, hi, 4)
    assert _rel(ck, chebyshev.chebyshev_coeffs_plain(hi * 0.02, hi, 4)) < tol
    dk, zk = chebyshev.chebyshev_init(ck, rk)
    dp, zp = chebyshev.chebyshev_init_plain(ck, rk)
    assert _rel(dk, dp) < tol and torch.equal(dk, zk)
    sz = block_ell_spmv(pattern.nb, S, zk)
    chebyshev.chebyshev_update(ck, 0, rk, sz, dk, zk)
    chebyshev.chebyshev_update_plain(ck, 0, rk, sz, dp, zp)
    assert _rel(dk, dp) < tol and _rel(zk, zp) < tol


@pytest.mark.parametrize("curvature", ["negative", "nan"])
def test_cg_step_kernels_sticky_pd_on_gpu(cuda, curvature):
    """p . hp <= 0 or NaN turns pd off for good: alpha 0, x and r stay, the
    continue flag clears, and a later positive curvature does not bring pd
    back; r2 <= thresh at the start clears the continue flag alone."""
    n = 3 * 5000
    gen = torch.Generator(device=cuda).manual_seed(3)
    vec = lambda: torch.randn(n, generator=gen, device=cuda,
                              dtype=torch.float64)
    x0, r0, p0, hp = vec(), vec(), vec(), vec()
    rr, bb = cg_step.dot_partials(r0, r0), cg_step.dot_partials(x0, x0)
    pap = cg_step.dot_partials(p0, p0)                  # positive
    bad_pap = -pap if curvature == "negative" else pap.clone()
    if curvature == "nan":
        bad_pap[-1] = float("nan")
    out = {}
    for route, start, xr, up in (
            ("kernel", cg_step.cg_start, cg_step.cg_update_xr,
             cg_step.cg_update_p),
            ("plain", cg_step.cg_start_plain, cg_step.cg_update_xr_plain,
             cg_step.cg_update_p_plain)):
        sc = cg_step.new_scalars(r0)
        start(sc, rr, rr, rr, 2.0, True)            # r2 = b2 <= 4 b2
        assert float(sc[cg_step.PD]) == 1.0 and float(sc[cg_step.CONT]) == 0.0
        start(sc, rr, rr, bb, 1e-6, True)
        assert float(sc[cg_step.CONT]) == 1.0
        x, r, p = x0.clone(), r0.clone(), p0.clone()
        xr(sc, bad_pap, x, r, p, hp)
        assert torch.equal(x, x0) and torch.equal(r, r0)
        assert float(sc[cg_step.PD_NEXT]) == 0.0
        assert float(sc[cg_step.ALPHA]) == 0.0
        up(sc, rr, rr, r, p, True)
        assert float(sc[cg_step.PD]) == 0.0 and float(sc[cg_step.CONT]) == 0.0
        xr(sc, pap, x, r, p, hp)                        # pd stays off
        assert float(sc[cg_step.PD_NEXT]) == 0.0 and torch.equal(x, x0)
        out[route] = (sc, p)
    assert _scal_rel(out["kernel"][0], out["plain"][0]) < 1e-12
    assert _rel(out["kernel"][1], out["plain"][1]) < 1e-12


@pytest.mark.parametrize("cheby", [0, 4])
def test_pcg_solve_on_gpu_matches_cpu(cuda, cheby):
    """The whole solve through the kernels against the same solve on the
    CPU (plain versions), float64: equal CG iteration counts, x to 1e-9."""
    prob, pattern, values, b, lam = _scaled(cuda, torch.float64, n=2000)
    linv, _, bhat, extra = damp_chol.damp_chol(values, prob.free["se2"], b,
                                               lam)
    S = jacobi_scale.jacobi_scale(pattern.nb, values, linv, extra)

    def solve(device):
        import dataclasses
        pat = dataclasses.replace(pattern, nb=pattern.nb.to(device))
        op = sparse.EllOperator(pat, S.to(device))
        pre = None
        if cheby:
            hi = chebyshev.gershgorin_bound(S.to(device))
            pre = solvers.make_chebyshev_precond(op, hi * 0.02, hi, cheby)
        kernels.reset_launch_counts()
        x, ok = solvers.pcg_solve(op, {"se2": bhat.to(device)}, precond=pre,
                                  max_iter=40, tol=1e-8,
                                  unroll=1 if cheby else 2, norm="precond")
        return x["se2"].cpu(), bool(ok), kernels.launch_counts()

    xg, okg, cg_counts = solve(cuda)
    xc, okc, cpu_counts = solve("cpu")
    assert okg and okc
    assert set(cpu_counts.values()) == {0}
    if cheby:       # the three-launch step
        assert cg_counts["cg_update_xr"] == cg_counts["cg_update_p"] > 2
        assert cg_counts["spmv_dot"] == cg_counts["cg_update_xr"]
        assert cg_counts["spmv_dot_p"] == 0
    else:           # two launches: the first iteration on spmv_dot
        assert cg_counts["cg_update_xr"] > 2 and cg_counts["cg_update_p"] == 0
        assert cg_counts["spmv_dot"] == 1
        assert cg_counts["spmv_dot_p"] == cg_counts["cg_update_xr"] - 1
    assert _rel(xg, xc) < 1e-9


@pytest.mark.parametrize("D", [3, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_dot_p_equals_three_launch_step_on_gpu(cuda, dtype, D):
    """The fused spmv_dot_p from the scalars of cg_update_xr with an
    arrival counter, against cg_update_xr + cg_update_p (z = r) + spmv_dot
    from the same state: the same scalars, p and H p and the same partials
    bit for bit, close to the plain version, the same bits twice, and the
    counter back at zero."""
    if D == 3:
        prob, pattern, values, b, lam = _scaled(cuda, dtype)
        free = prob.free["se2"]
    else:
        prob, pattern = _sphere(dtype, cuda)
        values, bT = sparse.assemble_ell(prob, pattern)
        b, lam, free = bT["se3"], torch.tensor(
            0.7, dtype=dtype, device=cuda), prob.free["se3"]
    linv, _, bhat, extra = damp_chol.damp_chol(values, free, b, lam)
    S = jacobi_scale.jacobi_scale(pattern.nb, values, linv, extra)
    r0, p0, rr0, bb0 = cg_step.cg_residual(bhat, torch.zeros_like(bhat))
    scal0 = cg_step.new_scalars(r0)
    cg_step.cg_start(scal0, rr0, rr0, bb0, 1e-6, True)
    hp0, pap0 = cg_step.spmv_dot(pattern.nb, S, p0)
    arrivals = torch.zeros(1, dtype=torch.int32, device=cuda)
    st = {}
    for route in ("fused", "three"):
        x, r, p, sc = (torch.zeros_like(bhat), r0.clone(), p0.clone(),
                       scal0.clone())
        rr = cg_step.cg_update_xr(sc, pap0, x, r, p, hp0,
                                  arrivals if route == "fused" else None)
        if route == "three":
            cg_step.cg_update_p(sc, rr, rr, r, p, True)
        st[route] = (x, r, p, sc)
    assert not arrivals.any()
    x, r, p, sc = st["fused"]
    assert torch.equal(sc, st["three"][3]) and torch.equal(x, st["three"][0])
    p_new = torch.full_like(p, float("nan"))
    hp, part = cg_step.spmv_dot_p(pattern.nb, S, sc, p, r, p_new)
    hp_t, part_t = cg_step.spmv_dot(pattern.nb, S, st["three"][2])
    assert torch.equal(p_new, st["three"][2])
    assert torch.equal(hp, hp_t) and torch.equal(part, part_t)
    again = torch.empty_like(p)
    assert all(torch.equal(a, b_) for a, b_ in zip(
        cg_step.spmv_dot_p(pattern.nb, S, sc, p, r, again), (hp, part)))
    assert torch.equal(again, p_new)
    want = cg_step.spmv_dot_p_plain(pattern.nb, S, sc, p, r,
                                    torch.empty_like(p))
    assert _rel(hp, want[0]) < TOL[dtype]
    assert _rel(part.sum(), want[1]) < TOL[dtype]


def test_lm_pcg_two_launches_per_cg_iteration_on_gpu(cuda, monkeypatch):
    """LM-PCG without a preconditioner: 2 launches per CG iteration
    (spmv_dot_p or, in each solve's first iteration, spmv_dot; and
    cg_update_xr) and no cg_update_p, against the three-launch step (the
    operator's fused form taken away): one launch fewer per CG iteration,
    the same CG iterations and the same chi2 bit for bit, SE2 and SE3."""
    runs = {}
    for graph in ("se2", "se3"):
        prob = (_small_system(torch.float32, cuda, n=3000)[0]
                if graph == "se2" else _sphere(torch.float32, cuda)[0])
        for route in ("two", "three"):
            with monkeypatch.context() as m:
                if route == "three":
                    m.delattr(sparse.EllOperator, "matvec_dot_p")
                kernels.reset_launch_counts()
                _, stats = algorithms.optimize(
                    prob, algorithms.LevenbergMarquardtPCG(pcg_iters=50,
                                                           pcg_tol=1e-3),
                    iterations=4)
                torch.cuda.synchronize()
            counts = kernels.launch_counts()
            cg_iters = counts["cg_update_xr"]
            per_cg = (counts["spmv_dot"] + counts["spmv_dot_p"]
                      + counts["cg_update_xr"] + counts["cg_update_p"]
                      + counts["dot_partials"]) / cg_iters
            runs[graph, route] = ([s_["chi2"] for s_ in stats], cg_iters,
                                  per_cg, counts)
        two, three = runs[graph, "two"], runs[graph, "three"]
        assert two[0] == three[0] and two[1] == three[1] > 10
        assert three[3]["spmv_dot_p"] == 0 and three[2] == 3.0
        assert two[3]["cg_update_p"] == 0
        solves = two[3]["cg_finish"]
        assert two[3]["spmv_dot"] == solves
        assert two[3]["spmv_dot_p"] == cg_iters - solves
        assert two[2] == 2.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lane_gather_probe_shape_on_gpu(cuda, dtype):
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(8, 3500)), dtype=dtype, device=cuda)
    idx = torch.as_tensor(rng.integers(0, 3500, (8, 35000)).astype(np.int32),
                          device=cuda)
    out = gather.lane_gather(x, idx)
    assert torch.equal(out, gather.lane_gather_plain(x, idx))


# ---------------------------------------------------------------------------
# K7 (retract + chi2 + outcome) and K15 (dense assembly)
# ---------------------------------------------------------------------------

def _k7_inputs(cuda, dtype, n=5000, kernel_id=0):
    prob, pattern, values, b, lam = _scaled(cuda, dtype, n=n)
    ea = prob.edges["edge_se2"]
    gen = torch.Generator(device=cuda).manual_seed(1)
    dxT = 0.05 * torch.randn((3, n), generator=gen, device=cuda, dtype=dtype)
    delta = torch.rand(ea.delta.shape, generator=gen, device=cuda,
                       dtype=dtype) * 2.0 + 0.05
    groups = [(ea.indices[0], ea.indices[1], ea.measurement, ea.information,
               delta, kernel_id)]
    return prob, (prob.params["se2"], dxT, prob.free["se2"], b, lam, groups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_retract_chi2_matches_plain_on_gpu(cuda, dtype):
    """Candidate, dot and chi2 sums for every robust kernel id; the residual
    cancels coordinates as kernel B's does, hence its tolerance."""
    for kid in range(11):
        prob, args = _k7_inputs(cuda, dtype, kernel_id=kid)
        kernels.reset_launch_counts()
        cand, part_dot, part_chi = retract_chi2.retract_chi2(*args)
        pc, pd, pchi = retract_chi2.retract_chi2_plain(*args)
        assert kernels.launch_counts()["retract_chi2"] == 1
        assert _rel(cand, pc) < TOL[dtype], kid
        assert _rel(part_dot.sum(), pd.sum()) < TOL[dtype], kid
        assert _rel(part_chi.sum(), pchi.sum()) < TOL_B[dtype], kid
        again = retract_chi2.retract_chi2(*args)
        assert all(torch.equal(a, b) for a, b in
                   zip(again, (cand, part_dot, part_chi)))


def _outcome_equal(got, want, tol):
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.bool:
            assert bool(g) == bool(w), i
        elif torch.isfinite(w):
            assert _rel(g, w) < tol, i
        else:
            assert float(g) == float(w) or (torch.isnan(g) and torch.isnan(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lm_outcome_matches_plain_on_gpu(cuda, dtype):
    prob, args = _k7_inputs(cuda, dtype)
    _, part_dot, part_chi = retract_chi2.retract_chi2(*args)
    t = lambda v: torch.tensor(v, dtype=dtype, device=cuda)
    true, false = (torch.tensor(v, device=cuda) for v in (True, False))
    chi = float(part_chi.sum())
    nan_chi = part_chi.clone()
    nan_chi[-1] = float("nan")
    cases = [(part_chi, part_dot, true, t(0.3), t(2.0), t(chi * 1.5)),
             (part_chi, part_dot, true, t(0.3), t(4.0), t(chi * 0.5)),
             (part_chi, part_dot, false, t(0.3), t(2.0), t(chi * 1.5)),
             (nan_chi, part_dot, true, t(0.3), t(8.0), t(chi * 1.5)),
             (part_chi, -part_dot, true, t(0.3), t(2.0), t(chi * 1.5))]
    kernels.reset_launch_counts()
    for i, case in enumerate(cases):
        got = retract_chi2.lm_outcome(*case)
        want = retract_chi2.lm_outcome_plain(*case)
        _outcome_equal(got, want, TOL[dtype])
        if i in (2, 3):
            assert float(got[0]) == float("inf") and float(got[1]) == -1.0
            assert not bool(got[2]) and bool(got[5])
    assert kernels.launch_counts()["lm_outcome"] == len(cases)
    # the same chi2 drop over the two signs of the model's decrease: one of
    # the two trials is accepted
    assert (bool(retract_chi2.lm_outcome(*cases[0])[2])
            != bool(retract_chi2.lm_outcome(*cases[4])[2]))


def test_nan_step_on_gpu_is_a_retry(cuda):
    prob, (x, dxT, free, b, lam, groups) = _k7_inputs(cuda, torch.float64)
    dxT = dxT.clone()
    dxT[2, 11] = float("nan")
    _, part_dot, part_chi = retract_chi2.retract_chi2(x, dxT, free, b, lam,
                                                      groups)
    assert not torch.isfinite(part_chi.sum())
    two = torch.tensor(2.0, dtype=torch.float64, device=cuda)
    got = retract_chi2.lm_outcome(part_chi, part_dot,
                                  torch.tensor(True, device=cuda), lam, two,
                                  two)
    assert float(got[0]) == float("inf") and float(got[1]) == -1.0
    assert not bool(got[2]) and bool(got[5])
    assert float(got[3]) == float(lam) * 2.0 and float(got[4]) == 4.0


def _dense_inputs(prob):
    pattern = dense_assemble.build_dense_pattern(prob)
    lin = problem_mod.linearize(prob)
    groups = [dense_assemble.EdgeBlocks(
        lin[eg.key][0].contiguous(), lin[eg.key][1], lin[eg.key][2],
        prob.edges[eg.key].information, pattern.offsets[i])
        for i, eg in enumerate(prob.static.egroups)]
    return groups, pattern, problem_mod.tangent_masks(prob)[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bearing", [False, True])
def test_dense_assemble_matches_plain_on_gpu(cuda, dtype, bearing):
    """K15 on a landmark world (3x3, 3x2 and 2x2 blocks; 1-wide residuals
    with bearing_only) against the plain scatter, and twice for the same
    bits."""
    g, _ = Simulator2D(n_landmarks=60, seed=2, world_size=15.0).simulate(
        200, bearing_only=bearing)
    g.add_edge("edge_se2_prior", (5,), g.vertices[5].params, np.eye(3) * 50)
    g.add_edge("edge_se2", (9, 3), [0.1, 0.2, 0.3], np.eye(3) * 20)
    g.add_edge("edge_se2", (3, 9), [-0.1, -0.2, -0.3], np.eye(3) * 30)
    g.vertices[17].fixed = True
    prob = g.compile(dtype=dtype, device=cuda)
    groups, pattern, fixed_t = _dense_inputs(prob)
    T = prob.static.total_dim
    kernels.reset_launch_counts()
    for add_fixed in (True, False):
        H, b, raw = dense_assemble.dense_assemble(groups, T, fixed_t, pattern,
                                                  add_fixed)
        pH, pb, praw = dense_assemble.dense_assemble_plain(
            groups, T, fixed_t, None, add_fixed)
        assert _rel(H, pH) < TOL[dtype] and _rel(b, pb) < TOL[dtype]
        assert _rel(raw, praw) < TOL[dtype]
        H2, b2, raw2 = dense_assemble.dense_assemble(groups, T, fixed_t,
                                                     pattern, add_fixed)
        assert torch.equal(H, H2) and torch.equal(b, b2)
        assert torch.equal(raw, raw2)
        fixed = fixed_t.bool()
        assert (H.diagonal()[fixed] == (1.0 if add_fixed else 0.0)).all()
    assert kernels.launch_counts()["dense_assemble"] == 4
    with pytest.raises(ValueError, match="DensePattern"):
        dense_assemble.dense_assemble(groups, T, fixed_t, None)


@pytest.mark.parametrize("algorithm", ["lm", "gn"])
def test_dense_route_on_gpu_matches_cpu(cuda, algorithm):
    """The dense GN/LM route through K15 and the outcome kernel against the
    same run on the CPU (plain versions), float64: chi2 to 1e-9."""
    g, _ = Simulator2D(n_landmarks=40, seed=4, world_size=12.0).simulate(120)
    make = {"lm": algorithms.LevenbergMarquardt,
            "gn": algorithms.GaussNewton}[algorithm]
    runs = {}
    for device in (cuda, "cpu"):
        prob = g.compile(device=device)
        kernels.reset_launch_counts()
        _, stats = algorithms.optimize(prob, make(), iterations=4)
        runs[str(device)] = ([s["chi2"] for s in stats],
                             kernels.launch_counts())
    chi_g, counts_g = runs["cuda"]
    chi_c, counts_c = runs["cpu"]
    np.testing.assert_allclose(chi_g, chi_c, rtol=1e-9)
    assert set(counts_c.values()) == {0}
    assert counts_g["dense_assemble"] >= 4
    if algorithm == "lm":
        assert counts_g["lm_outcome"] >= 4


# ---------------------------------------------------------------------------
# SE3: K16, K7 for SE3 and the 6x6 instantiations
# ---------------------------------------------------------------------------

def _sphere(dtype, device, kernel="None"):
    from openslam_g2o_torch.apps.simulator import create_sphere
    g, _ = create_sphere(n_laps=20, n_per_lap=60, radius=12.0,
                         trans_noise=(0.03, 0.03, 0.03), rot_noise=0.002,
                         seed=2)
    for e in g.edges[::3]:
        e.kernel, e.kernel_delta = kernel, 0.5
    g.vertices[40].fixed = True
    prob = g.compile(dtype=dtype, device=device)
    p = prob.params["se3"].clone()
    p[5:300:7, 3:] *= -1.0                      # stored with q_w < 0
    p[9:300:11, 3:] *= 1.0005                   # unit only to "rounding"
    return prob.with_params({"se3": p}), sparse.build_ell_pattern(prob)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["None", "Huber", "Cauchy",
                                    "ScaleDelta:DCS"])
def test_edge_se3_blocks_match_plain_on_gpu(cuda, dtype, kernel):
    """K16 against its plain version (a torch.func.jvp over the model's
    error). float32 with a robust kernel: rho' carries the residual's
    cancellation error into every block, hence 2e-3."""
    from openslam_g2o_torch.kernels import edge_se3
    prob, pattern = _sphere(dtype, cuda, kernel)
    E = pattern.e_total
    streams = [(torch.empty((36, 4 * E), dtype=dtype, device=cuda),
                torch.empty((6, 2 * E), dtype=dtype, device=cuda))
               for _ in range(2)]
    kernels.reset_launch_counts()
    for eg in prob.static.egroups:
        ea = prob.edges[eg.key]
        args = (prob.params["se3"], prob.free["se3"], ea.indices[0],
                ea.indices[1], ea.measurement, ea.information, ea.delta,
                eg.kernel_id)
        edge_se3.edge_se3_blocks(*args, *streams[0], pattern.col0[eg.key])
        edge_se3.edge_se3_blocks_plain(*args, *streams[1],
                                       pattern.col0[eg.key])
    assert (kernels.launch_counts()["edge_se3_blocks"]
            == len(prob.static.egroups))
    tol = {torch.float64: 1e-10,
           torch.float32: 2e-4 if kernel == "None" else 2e-3}[dtype]
    assert _rel(streams[0][0], streams[1][0]) < tol
    assert _rel(streams[0][1], streams[1][1]) < tol
    again = (torch.empty_like(streams[0][0]), torch.empty_like(streams[0][1]))
    for eg in prob.static.egroups:
        ea = prob.edges[eg.key]
        edge_se3.edge_se3_blocks(
            prob.params["se3"], prob.free["se3"], ea.indices[0],
            ea.indices[1], ea.measurement, ea.information, ea.delta,
            eg.kernel_id, *again, pattern.col0[eg.key])
    assert torch.equal(again[0], streams[0][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_6x6_chain_matches_plain_on_gpu(cuda, dtype):
    """Kernels C, K3, K4, A, spmv_dot and the Gershgorin bound at D = 6 on
    one sphere, each against its plain version on the same CUDA tensors."""
    prob, pattern = _sphere(dtype, cuda)
    hblk, bblk = sparse.edge_blocks(prob, pattern)
    cargs = (hblk, bblk, pattern.hidx, pattern.bidx, pattern.k, pattern.n)
    values, b = assemble_gather(*cargs)
    pv, pb = assemble_gather_plain(*cargs)
    assert values.shape == (pattern.k, 36, pattern.n)
    assert torch.equal(values, pv) and torch.equal(b, pb)
    free = prob.free["se3"]
    lam = torch.tensor(0.3, dtype=dtype, device=cuda)
    out = damp_chol.damp_chol(values, free, b, lam)
    want = damp_chol.damp_chol_plain(values, free, b, lam)
    for got, ref in zip(out, want):
        assert _rel(got, ref) < TOL_B[dtype]
    linv, lchol, bhat, extra = out
    upper = [6 * a + c for a in range(6) for c in range(a + 1, 6)]
    assert not linv[upper].any() and not lchol[upper].any()
    scaled = jacobi_scale.jacobi_scale(pattern.nb, values, linv, extra)
    assert _rel(scaled, jacobi_scale.jacobi_scale_plain(
        pattern.nb, values, linv, extra)) < TOL_B[dtype]
    x = torch.randn((6, pattern.n), dtype=dtype, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    assert _rel(block_ell_spmv(pattern.nb, scaled, x),
                block_ell_spmv_plain(pattern.nb, scaled, x)) < TOL[dtype]
    hp, partials = cg_step.spmv_dot(pattern.nb, scaled, x)
    php, pdot = cg_step.spmv_dot_plain(pattern.nb, scaled, x)
    assert _rel(hp, php) < TOL[dtype]
    assert _rel(partials.sum(), pdot.sum()) < TOL[dtype]
    for transpose in (False, True):
        assert _rel(jacobi_scale.lane_block_mv(lchol, x, transpose),
                    jacobi_scale.lane_block_mv_plain(lchol, x, transpose)) \
            < TOL_B[dtype]
    assert _rel(chebyshev.gershgorin_bound(scaled),
                chebyshev.gershgorin_bound_plain(scaled)) < TOL[dtype]
    # NaN cases: a non-SPD 6x6 block, and a NaN factor of row 0 that must
    # not reach the padding
    bad = values.clone()
    bad[0, 14, 7] = -1e9
    nan_k = damp_chol.damp_chol(bad, free, b, lam)
    nan_p = damp_chol.damp_chol_plain(bad, free, b, lam)
    for got, ref in zip(nan_k, nan_p):
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.isnan(nan_k[0][:, 7]).any()
    assert not torch.isnan(nan_k[0][:, :7]).any()
    bad_linv = linv.clone()
    bad_linv[:, 0] = float("nan")
    s_nan = jacobi_scale.jacobi_scale(pattern.nb, values, bad_linv, extra)
    pad = (values == 0).all(dim=1)
    pad[0] = False
    assert int(pad.sum()) > 0 and not s_nan.permute(0, 2, 1)[pad].any()
    assert torch.equal(torch.isnan(s_nan), torch.isnan(
        jacobi_scale.jacobi_scale_plain(pattern.nb, values, bad_linv, extra)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_se3_retract_and_chi2_match_plain_on_gpu(cuda, dtype):
    prob, pattern = _sphere(dtype, cuda, "Huber")
    _, bT = sparse.assemble_ell(prob, pattern)
    gen = torch.Generator(device=cuda).manual_seed(3)
    dxT = 0.01 * torch.randn((6, pattern.n), dtype=dtype, device=cuda,
                             generator=gen)
    lam = torch.tensor(0.2, dtype=dtype, device=cuda)
    args = (prob.params["se3"], dxT, prob.free["se3"], bT["se3"], lam)
    kernels.reset_launch_counts()
    cand, part_dot = retract_chi2.retract_se3(*args)
    pcand, pdot = retract_chi2.retract_se3_plain(*args)
    assert _rel(cand, pcand) < TOL[dtype]
    assert _rel(part_dot.sum(), pdot.sum()) < TOL[dtype]
    for eg in prob.static.egroups:
        ea = prob.edges[eg.key]
        e_args = (cand, ea.indices[0], ea.indices[1], ea.measurement,
                  ea.information, ea.delta, eg.kernel_id)
        assert _rel(retract_chi2.se3_edge_chi2(*e_args).sum(),
                    retract_chi2.se3_edge_chi2_plain(*e_args).sum()) \
            < TOL_B[dtype]
    counts = kernels.launch_counts()
    assert counts["retract_se3"] == 1
    assert counts["se3_edge_chi2"] == len(prob.static.egroups) == 2
    assert torch.equal(retract_chi2.retract_se3(*args)[0], cand)
    dxT[3, 9] = float("nan")
    nan_cand, nan_dot = retract_chi2.retract_se3(*args)
    assert torch.isnan(nan_cand[9]).any() and torch.isnan(nan_dot.sum())


@pytest.mark.parametrize("cheby", [0, 4])
def test_sphere_lm_pcg_on_gpu_matches_cpu(cuda, cheby):
    """The SE3 LM-PCG path through every 6x6 kernel against the same run
    on the CPU (plain versions), float64: chi2 to 1e-8."""
    runs = {}
    for device in (cuda, "cpu"):
        prob, _ = _sphere(torch.float64, device)
        kernels.reset_launch_counts()
        _, stats = algorithms.optimize(
            prob, algorithms.LevenbergMarquardtPCG(pcg_iters=60,
                                                   pcg_tol=1e-6,
                                                   pcg_cheby=cheby),
            iterations=4)
        runs[str(device)] = ([s["chi2"] for s in stats],
                             kernels.launch_counts())
    chi_g, counts_g = runs["cuda"]
    chi_c, counts_c = runs["cpu"]
    np.testing.assert_allclose(chi_g, chi_c, rtol=1e-8)
    assert set(counts_c.values()) == {0}
    for name in ("edge_se3_blocks", "assemble_gather", "damp_chol",
                 "jacobi_scale", "lane_block_mv", "spmv_dot", "retract_se3",
                 "se3_edge_chi2", "lm_outcome"):
        assert counts_g[name] >= 4, name
    assert counts_g["edge_se2_blocks"] == counts_g["retract_chi2"] == 0
    assert (counts_g["gershgorin_bound"] > 0) == (cheby > 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_assemble_6_wide_matches_plain_on_gpu(cuda, dtype):
    """K15 at block width 6 on a 3D landmark world (6x6, 6x3 and 3x3
    blocks, 6- and 3-wide residuals) against the plain scatter, twice for
    the same bits; and the dense LM route on it against the CPU."""
    from openslam_g2o_torch.apps.simulator import Simulator3D
    g, _ = Simulator3D(n_landmarks=80, seed=2).simulate(150)
    g.vertices[17].fixed = True
    prob = g.compile(dtype=dtype, device=cuda)
    groups, pattern, fixed_t = _dense_inputs(prob)
    T = prob.static.total_dim
    H, b, raw = dense_assemble.dense_assemble(groups, T, fixed_t, pattern)
    pH, pb, praw = dense_assemble.dense_assemble_plain(groups, T, fixed_t)
    assert _rel(H, pH) < TOL[dtype] and _rel(b, pb) < TOL[dtype]
    assert _rel(raw, praw) < TOL[dtype]
    H2, b2, _ = dense_assemble.dense_assemble(groups, T, fixed_t, pattern)
    assert torch.equal(H, H2) and torch.equal(b, b2)
    if dtype == torch.float64:
        _, gpu_stats = algorithms.optimize(prob, iterations=4)
        _, cpu_stats = algorithms.optimize(g.compile(device="cpu"),
                                           iterations=4)
        np.testing.assert_allclose([s["chi2"] for s in gpu_stats],
                                   [s["chi2"] for s in cpu_stats], rtol=1e-9)


# K15 on lists at the chunk edges: a destination of 1, 63, 64 (one whole
# chunk), 65, 128, 129 and 80,000 contributions (1,250 chunks, the general
# path's shared-intrinsics hub)
K15_LISTS = (1, 63, 64, 65, 128, 129, 80000)


def _k15_group(D, DS, DT, dtype, device, seed=0):
    """One edge group of two slots whose vertex pair (2i, 2i + 1) has
    K15_LISTS[i] edges, in a shuffled edge order. Where the slots are one
    width they name one vertex set: every fifth edge of a pair runs the
    other way round (flag 1) and vertex 2i has K15_LISTS[i] // 4 edges to
    itself (flag 2). Random Jacobians, residuals, rho' in [0.5, 1] and SPD
    information, from numpy. Returns (EdgeBlocks, total_dim)."""
    rng = np.random.default_rng(seed)
    same = DS == DT
    a_parts, b_parts = [], []
    for i, n in enumerate(K15_LISTS):
        a, b = np.full(n, 2 * i), np.full(n, 2 * i + 1)
        if same:
            flip = np.arange(n) % 5 == 4
            a[flip], b[flip] = 2 * i + 1, 2 * i
            a = np.concatenate([a, np.full(n // 4, 2 * i)])
            b = np.concatenate([b, np.full(n // 4, 2 * i)])
        a_parts.append(a)
        b_parts.append(b)
    perm = rng.permutation(sum(len(a) for a in a_parts))
    a, b = np.concatenate(a_parts)[perm], np.concatenate(b_parts)[perm]
    nv = 2 * len(K15_LISTS)
    if same:
        off_a, off_b, total = a * DS, b * DS, nv * DS
    else:
        off_a, off_b, total = a * DS, nv * DS + b * DT, nv * (DS + DT)
    E = len(a)
    L = rng.normal(size=(E, D, D))
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=device)
    group = dense_assemble.EdgeBlocks(
        t(rng.normal(size=(E, D))),
        (t(rng.normal(size=(E, D, DS))), t(rng.normal(size=(E, D, DT)))),
        t(rng.uniform(0.5, 1.0, E)), t(L @ L.transpose(0, 2, 1)
                                       + D * np.eye(D)),
        (i32(off_a), i32(off_b)))
    return group, total


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("widths", [(2, 3, 3), (3, 3, 3), (6, 6, 6),
                                    (2, 6, 4), (2, 4, 4), (2, 3, 9),
                                    (2, 9, 9), (9, 9, 9)])
def test_dense_pair_on_chunk_edges_on_gpu(cuda, dtype, widths):
    """K15's pair kernel (D, Ds, Dt) = widths on the K15_LISTS
    destinations (the 9-wide ones on the kMaxD = 9 tier: the BAL camera's
    9 x 9 and its 3 x 9 point pair), flags 0, 1 and 2 where the slots are
    one width, against
    the plain version of the same values in float64, every destination
    block and b segment relative to its own largest entry (TOL: the
    80,000-contribution hub would hide the short lists' errors behind a
    global scale); twice for the same bits, and the arrival counters back
    at zero."""
    D, DS, DT = widths
    group, T = _k15_group(D, DS, DT, dtype, cuda)
    tables = dense_assemble.pair_tables(group.offsets, T, cuda)
    pattern = dense_assemble.DensePattern(T, [group.offsets], [tables])
    flags = torch.cat([tb.flag for tb in tables]).unique().tolist()
    assert flags == ([0, 1, 2] if DS == DT else [0])
    fixed_t = torch.zeros(T, dtype=dtype, device=cuda)
    H, b, raw = dense_assemble.dense_assemble([group], T, fixed_t, pattern,
                                              False)
    g64 = dense_assemble.EdgeBlocks(
        group.resid.double(), tuple(j.double() for j in group.jacs),
        group.rho1.double(), group.info.double(), group.offsets)
    pH, pb, _ = dense_assemble.dense_assemble_plain([g64], T,
                                                    fixed_t.double(), None,
                                                    False)
    for tb in tables:
        ws, wt = group.jacs[tb.s].shape[2], group.jacs[tb.t].shape[2]
        for p, q in zip(tb.dest_p.tolist(), tb.dest_q.tolist()):
            assert _rel(H[p:p + ws, q:q + wt], pH[p:p + ws, q:q + wt]) \
                < TOL[dtype], (tb.s, tb.t, p, q)
            assert torch.equal(H[q:q + wt, p:p + ws],
                               H[p:p + ws, q:q + wt].T) or p == q
            if tb.s == tb.t:
                assert _rel(b[p:p + ws], pb[p:p + ws]) < TOL[dtype]
    assert _rel(raw, pH.diagonal()) < TOL[dtype]
    H2, b2, raw2 = dense_assemble.dense_assemble([group], T, fixed_t,
                                                 pattern, False)
    assert torch.equal(H, H2) and torch.equal(b, b2)
    assert torch.equal(raw, raw2)
    assert not any(bool(tb.arrivals.any()) for tb in tables)


# -- the Schur BA kernels (K10-K13) -------------------------------------------
#
# Tolerances relative to the largest |plain| entry: the edge blocks and the
# owner sums as kernel B (1e-11 / 1e-4: the pixel residual cancels a
# projection of a few hundred pixels); everything downstream of a block
# inverse or of the Schur difference Hcc - W Hinv W^T, which cancels most of
# Hcc, to 1e-10 / 1e-4.
TOL_BA = {torch.float64: 1e-10, torch.float32: 1e-4}


def _inv_tol(blocks, dtype):
    """TOL_BA, or cond x eps of the worst-conditioned finite block where
    that is larger (the first-order bound of a block inverse)."""
    D = int(round(blocks.shape[0] ** 0.5))
    mats = blocks.double().view(D, D, -1).permute(2, 0, 1)
    mats = mats[torch.isfinite(mats).all(dim=2).all(dim=1)]
    cond = float(torch.linalg.cond(mats).max()) if len(mats) else 0.0
    return max(TOL_BA[dtype], cond * torch.finfo(dtype).eps)


def _assert_same_nonfinite(got, want, tol):
    """NaN and +-inf in the same places, the finite entries to tol of the
    largest finite |entry|."""
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf) and torch.equal(got[inf],
                                                                want[inf])
    fin = torch.isfinite(want)
    if fin.any():
        err = float((got[fin] - want[fin]).abs().max())
        assert err <= tol * max(float(want[fin].abs().max()), 1e-300)


@pytest.mark.parametrize("D", [2, 3, 4, 6, 9])
def test_block_inverse_of_overflowing_blocks_on_gpu(cuda, D):
    """K11 in float32 on blocks whose products overflow (entries 1e20
    beside unit blocks): inf and NaN in the places where the plain version
    has them (an FMA would turn inf - inf into a finite value), the finite
    entries to TOL_BA or cond x eps. The blocks are Gaussian; at D = 9
    they are B B^T + I, the symmetric positive definite blocks K11
    inverts there (the camera blocks of the BAL solve): the formula has no
    pivoting, so on a general 9x9 block its rounding grows past the
    first-order bound cond x eps in both versions."""
    from openslam_g2o_torch.kernels import ba_inv
    gen = torch.Generator(device=cuda).manual_seed(D)
    N = 4096
    A = torch.randn((D * D, N), generator=gen, device=cuda)
    if D == 9:
        B = A.T.reshape(N, D, D)
        A = (B @ B.transpose(1, 2) + torch.eye(D, device=cuda)).reshape(
            N, D * D).T
    scale = torch.where(torch.arange(N, device=cuda) % 2 == 0, 1e20, 1.0)
    A = (A * scale[None]).contiguous()
    got = ba_inv.ba_block_inv(A)[1]
    want = ba_inv.ba_block_inv_plain(A)[1]
    assert int(torch.isnan(want).sum()) > 0
    _assert_same_nonfinite(got, want, _inv_tol(A[:, 1::2], torch.float32))


def _ba_problem(device, dtype, n_cams=40, n_points=1500, huber=True):
    from openslam_g2o_torch.apps.simulator import synthetic_bal_problem
    from openslam_g2o_torch.core import robust
    prob, _ = synthetic_bal_problem(n_cams=n_cams, n_points=n_points,
                                    dtype=dtype, device=device)
    prob.free["sba_point_xyz"][7] = 0.0          # a fixed landmark
    if huber:
        import dataclasses
        eg = prob.static.egroups[0]
        prob = dataclasses.replace(prob, static=dataclasses.replace(
            prob.static, egroups=(dataclasses.replace(
                eg, kernel_id=robust.kernel_id("Huber")),)))
        prob.edges[eg.key].delta.fill_(2.0)
    return prob


def _ba_system(prob):
    from openslam_g2o_torch.core import ba_ell
    pattern = ba_ell.build_ba_ell_pattern(prob)
    return pattern, ba_ell._build(prob, pattern)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ba_edge_kernels_match_plain_on_gpu(cuda, dtype):
    """K10: the fused XYZ2UV entry (Huber, a fixed landmark), the generic
    entry at every instantiation, and the owner sums, twice for the same
    bits."""
    from openslam_g2o_torch.kernels import ba_edge
    prob = _ba_problem(cuda, dtype)
    pattern, _ = _ba_system(prob)
    ea = prob.edges["edge_project_xyz2uv"]
    E = ea.delta.shape[0]
    kernels.reset_launch_counts()
    args = (prob.params["sba_point_xyz"], prob.params["se3_expmap"],
            ea.indices[0], ea.indices[1], ea.measurement, ea.information,
            ea.delta, ea.pdata[0], prob.free["sba_point_xyz"],
            prob.free["se3_expmap"], 1)
    got = ba_edge.EdgeStreams.empty(E, 6, 3, dtype, cuda, pattern.cam_pos)
    want = ba_edge.EdgeStreams.empty(E, 6, 3, dtype, cuda, pattern.cam_pos)
    ba_edge.ba_xyz2uv_blocks(*args, got, 0)
    ba_edge.ba_xyz2uv_blocks_plain(*args, want, 0)
    for a, b in zip(got.tensors(), want.tensors()):
        assert _rel(a, b) < TOL_B[dtype]
    sums = ba_edge.ba_lm_sums(got, pattern.lm_edge)
    for a, b in zip(sums, ba_edge.ba_lm_sums_plain(got, pattern.lm_edge)):
        assert _rel(a, b) < TOL[dtype]
    csum = ba_edge.ba_cam_sums(got, pattern.cam_rows)
    again = ba_edge.ba_cam_sums(got, pattern.cam_rows)
    for a, b, c in zip(csum, ba_edge.ba_cam_sums_plain(
            got, pattern.cam_rows), again):
        assert _rel(a, b) < TOL[dtype] and torch.equal(a, c)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for dp, dl in ba_edge.BLOCK_DIMS:
        for R in (1, 2, 3):
            rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,
                                         device=cuda)
            gargs = (rnd(300, R), rnd(300, R, dl), rnd(300, R, dp),
                     rnd(300).abs(), rnd(300, R, R))
            pos = torch.randperm(310, generator=gen, device=cuda).int()
            g2 = ba_edge.EdgeStreams.empty(310, dp, dl, dtype, cuda, pos)
            w2 = ba_edge.EdgeStreams.empty(310, dp, dl, dtype, cuda, pos)
            ba_edge.ba_edge_blocks(*gargs, g2, 10)
            ba_edge.ba_edge_blocks_plain(*gargs, w2, 10)
            for a, b in zip(g2.lane_major(), w2.lane_major()):
                assert _rel(a[:, 10:], b[:, 10:]) < TOL[dtype]
            # W lane-major is the records' W
            assert torch.equal(g2.w[:, 10:], g2.lane_major()[2][:, 10:])
            # the padding of every written record is zero
            pad = g2.rec[pos[10:].long(), dp * dp + dp + dp * dl:]
            assert not pad.any()
    counts = kernels.launch_counts()
    assert counts["ba_xyz2uv_blocks"] == 1
    assert counts["ba_edge_blocks"] == 3 * len(ba_edge.BLOCK_DIMS)
    assert counts["ba_lm_sums"] == 1 and counts["ba_cam_sums"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [2, 3, 4, 6, 9])
def test_ba_block_inv_matches_plain_on_gpu(cuda, dtype, D):
    """K11 in its three modes, with an indefinite block (finite values in
    the same places) and a fixed block."""
    from openslam_g2o_torch.kernels import ba_inv
    gen = torch.Generator(device=cuda).manual_seed(D)
    N = 5000
    B = torch.randn((N, D, D), generator=gen, dtype=dtype, device=cuda)
    A = B @ B.transpose(1, 2) + 0.5 * torch.eye(D, dtype=dtype, device=cuda)
    A[3] = -A[3]                                     # indefinite
    A = A.permute(1, 2, 0).reshape(D * D, N).contiguous()
    free = torch.ones(N, dtype=dtype, device=cuda)
    free[11] = 0.0
    lam = torch.tensor(0.3, dtype=dtype, device=cuda)
    b = torch.randn((D, N), generator=gen, dtype=dtype, device=cuda)
    for mode, kw in ((ba_inv.PLAIN, {}),
                     (ba_inv.LANDMARK, dict(free=free, lam=lam, b=b)),
                     (ba_inv.CAMERA, dict(free=free, lam=lam))):
        got = ba_inv.ba_block_inv(A, mode, **kw)
        want = ba_inv.ba_block_inv_plain(A, mode, **kw)
        for g_, w_ in zip(got, want):
            assert (g_ is None) == (w_ is None)
            if g_ is not None:
                assert torch.equal(torch.isfinite(g_), torch.isfinite(w_))
                assert _rel(g_, w_) < TOL_BA[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ba_coupling_and_schur_kernels_match_plain_on_gpu(cuda, dtype):
    """K13 (W^T x with the landmark solve, W v with and without the dot,
    the sandwich) and K12 (S with and without a base) on a BAL system."""
    from openslam_g2o_torch.kernels import ba_coupling, ba_inv, ba_schur
    prob = _ba_problem(cuda, dtype)
    pattern, sys = _ba_system(prob)
    lam = torch.tensor(1e-2, dtype=dtype, device=cuda)
    fl, fc = prob.free["sba_point_xyz"], prob.free["se3_expmap"]
    _, hinv, hib = ba_inv.ba_block_inv(sys["Hll"], ba_inv.LANDMARK, fl, lam,
                                       b=sys["b_l"])
    hcc_d, _, _ = ba_inv.ba_block_inv(sys["Hcc"], ba_inv.CAMERA, fc, lam,
                                      want_inv=False)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((6, pattern.n_cam), generator=gen, dtype=dtype,
                    device=cuda)
    for kw in ({}, dict(hinv=hinv), dict(hinv=hinv, b=sys["b_l"], free=fl)):
        assert _rel(ba_coupling.ba_wtx(sys["W_lm"], pattern.lm_cam, x, **kw),
                    ba_coupling.ba_wtx_plain(sys["W_lm"], pattern.lm_cam, x,
                                             **kw)) < TOL_BA[dtype]
    wv_args = (sys["W_cam"], pattern.cam_rows, hib)
    for kw in (dict(base=sys["b_p"], free=fc),
               dict(hcc_d=hcc_d, x=x, extra=x.flip(0).contiguous(),
                    want_dot=True)):
        got = ba_coupling.ba_wv(*wv_args, **kw)
        want = ba_coupling.ba_wv_plain(*wv_args, **kw)
        if kw.get("want_dot"):
            assert _rel(got[1].sum(), want[1].sum()) < TOL_BA[dtype]
            got, want = got[0], want[0]
        assert _rel(got, want) < TOL_BA[dtype]
    sw = ba_coupling.ba_sandwich(sys["W_cam"], pattern.cam_rows, hinv,
                                 hcc_d)
    assert _rel(sw, ba_coupling.ba_sandwich_plain(
        sys["W_cam"], pattern.cam_rows, hinv, hcc_d)) < TOL_BA[dtype]
    pairs = pattern.schur_pairs()
    base = torch.randn((6 * pattern.n_cam,) * 2, generator=gen, dtype=dtype,
                       device=cuda)
    w_rec = ba_schur.ba_schur_records(sys["W_lm"].view(18, -1))
    for b_ in (None, base):
        S = ba_schur.ba_schur_dense(pairs, sys["W_lm"], hinv, hcc_d, b_,
                                    w_rec=w_rec)
        Sp = ba_schur.ba_schur_dense_plain(pairs, sys["W_lm"], hinv, hcc_d,
                                           b_)
        assert _rel(S, Sp) < TOL_BA[dtype]
        S2 = ba_schur.ba_schur_dense(pairs, sys["W_lm"], hinv, hcc_d, b_,
                                     w_rec=w_rec)
        assert torch.equal(S, S2)
    # the mirrored writes make S symmetric to the bit outside the diagonal
    # blocks (Hcc_d, summed per edge, is symmetric only to rounding)
    S = ba_schur.ba_schur_dense(pairs, sys["W_lm"], hinv, hcc_d, w_rec=w_rec)
    cam = torch.arange(S.shape[0], device=cuda) // 6
    off = cam[:, None] != cam[None, :]
    assert torch.equal(S[off], S.T[off])


# K12 on camera pairs that share 1, 31, 32 (a warp's lanes), 33 and 300
# landmarks, each landmark seen by exactly its pair; one camera sees none
K12_SHARED = (1, 31, 32, 33, 300)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims", [(6, 3), (3, 2), (9, 3)])
def test_ba_schur_on_lane_edges_on_gpu(cuda, dtype, dims):
    """K12 at (Dp, dl) = dims on destinations of 0, 1, 31, 32, 33 and 300
    contributions (the pairs and their cameras' diagonal blocks; slot
    order shuffled per landmark), random W, SPD Hinv and Hcc_d, without
    and with a base, against the plain version (TOL_BA); twice for the
    same bits; the record copy against its plain version, exactly."""
    from openslam_g2o_torch.kernels import ba_schur
    dp, dl = dims
    rng = np.random.default_rng(dp)
    cams = [(2 * i, 2 * i + 1) for i, n in enumerate(K12_SHARED)
            for _ in range(n)]
    lm_cam = np.array(cams).T.copy()                      # [2, L]
    L, C = lm_cam.shape[1], 2 * len(K12_SHARED) + 1
    swap = rng.random(L) < 0.5
    lm_cam[:, swap] = lm_cam[::-1, swap]
    pairs = ba_schur.build_schur_pairs(lm_cam, C, cuda)
    counts = sorted(set(np.diff(pairs.ptr.cpu().numpy()).tolist()))
    assert counts == [0] + list(K12_SHARED)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                  device=cuda)
    B = rng.normal(size=(L, dl, dl))
    hinv = t((B @ B.transpose(0, 2, 1) + np.eye(dl)).transpose(1, 2, 0)
             .reshape(dl * dl, L))
    w_lm = t(rng.normal(size=(dp * dl, 2, L)))
    hcc_d = t(rng.normal(size=(dp * dp, C)))
    base = t(rng.normal(size=(dp * C, dp * C)))
    w_rec = ba_schur.ba_schur_records(w_lm.view(dp * dl, -1))
    for x in (w_lm.view(dp * dl, -1), hinv):
        assert torch.equal(ba_schur.ba_schur_records(x),
                           ba_schur.ba_schur_records_plain(x))
    for b_ in (None, base):
        S = ba_schur.ba_schur_dense(pairs, w_lm, hinv, hcc_d, b_,
                                    w_rec=w_rec)
        Sp = ba_schur.ba_schur_dense_plain(pairs, w_lm, hinv, hcc_d, b_)
        assert _rel(S, Sp) < TOL_BA[dtype]
        assert torch.equal(S, ba_schur.ba_schur_dense(
            pairs, w_lm, hinv, hcc_d, b_, w_rec=w_rec))


@pytest.mark.parametrize("dense", [True, False])
def test_ba_schur_lm_on_gpu_matches_cpu(cuda, dense, monkeypatch):
    """LevenbergMarquardtSchurELL on the card against the same run on the
    CPU (plain versions), float64, on both routes: chi2 to 1e-9."""
    from openslam_g2o_torch.core import ba_ell
    if not dense:
        monkeypatch.setattr(ba_ell, "_DENSE_SCHUR_MAX_TP", -1)
    runs = {}
    for device in (cuda, "cpu"):
        prob = _ba_problem(device, torch.float64, n_cams=24, n_points=600)
        kernels.reset_launch_counts()
        _, stats = algorithms.optimize(
            prob, ba_ell.LevenbergMarquardtSchurELL(pcg_iters=40,
                                                    pcg_tol=1e-6),
            iterations=5)
        runs[str(device)] = ([s["chi2"] for s in stats],
                             kernels.launch_counts())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-9)
    counts = runs["cuda"][1]
    used = ("ba_xyz2uv_blocks", "ba_lm_sums", "ba_cam_sums", "ba_block_inv",
            "ba_wtx", "ba_wv") + (("ba_schur_dense",) if dense
                                  else ("ba_sandwich", "lane_block_mv_dot"))
    assert all(counts[k] > 0 for k in used), counts
    assert (counts["ba_schur_dense"] > 0) == dense
    assert not any(runs["cpu"][1].values())


def _general_scene(device, dtype, kind):
    """chip_smoke.py's anchored (PSI2UV, every point's first edge on one
    camera twice) or shared-intrinsics (two pose groups, the intrinsics
    vertex seeing every edge) scene on a small BAL geometry."""
    import chip_smoke
    from openslam_g2o_torch.core.graph import Graph
    geo = chip_smoke.bal_geometry(12, 400)
    build = {"psi2uv": chip_smoke.psi2uv_graph,
             "intrinsics": chip_smoke.p2mc_intrinsics_graph}[kind]
    return build(Graph, geo).compile(dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["psi2uv", "intrinsics"])
def test_schur_general_kernels_match_plain_on_gpu(cuda, dtype, kind):
    """K14 (the edge blocks into both W layouts) and what the general path
    runs of K10, K11, K13 and K4 (landmark sums without W, ba_wtx chained
    over the pose groups at (6, 3) and (4, 3), W v with the dot and the
    reduced right-hand side and the preconditioner blocks over the pose
    CSR lists, the 6x6 and 4x4 block inverses on raw blocks that overflow
    float32 and on well-scaled ones, lane_block_mv_dot at D = 4), each against
    its plain version on the same inputs; the chunked products twice for
    the same bits."""
    from openslam_g2o_torch.core import ba
    from openslam_g2o_torch.kernels import (
        ba_coupling, ba_edge, ba_inv, jacobi_scale, schur_general)
    prob = _general_scene(cuda, dtype, kind)
    pat = ba.build_schur_pattern(prob)
    lin = problem_mod.linearize(prob)
    dl, L = pat.dl, pat.n_lm
    W_k, W_p = {}, {}
    for out, fn in ((W_k, schur_general.schur_edge_blocks),
                    (W_p, schur_general.schur_edge_blocks_plain)):
        st = ba_edge.LandmarkStreams(
            torch.zeros((dl * dl, pat.n_lm_edges), dtype=dtype, device=cuda),
            torch.zeros((dl, pat.n_lm_edges), dtype=dtype, device=cuda))
        wl = {pg.name: torch.zeros((pg.dim * dl,) + tuple(pg.lm_pose.shape),
                                   dtype=dtype, device=cuda)
              for pg in pat.pose_groups}
        wp = {pg.name: torch.zeros((pg.dim * dl, pg.n_entries), dtype=dtype,
                                   device=cuda) for pg in pat.pose_groups}
        for le in pat.lm_edges:
            resid, jacs, rho1 = lin[le.egkey]
            ea = prob.edges[le.egkey]
            first = True
            for ce in (c for c in pat.cross if c.egkey == le.egkey):
                fn(resid.contiguous(), jacs[le.lm_slot].contiguous(),
                   jacs[ce.slot].contiguous(), rho1.contiguous(),
                   ea.information, st.hll if first else None,
                   st.bl if first else None, le.offset, wl[ce.group],
                   ce.lm_pos, wp[ce.group], ce.pose_pos, ce.lm_order,
                   ce.pose_order)
                first = False
        out.update(st=st, wl=wl, wp=wp)
    for a, b in zip((W_k["st"].hll, W_k["st"].bl, *W_k["wl"].values(),
                     *W_k["wp"].values()),
                    (W_p["st"].hll, W_p["st"].bl, *W_p["wl"].values(),
                     *W_p["wp"].values())):
        assert _rel(a, b) < TOL_BA[dtype]
    Hll, b_l, none = ba_edge.ba_lm_sums(W_k["st"], pat.lm_edge, with_w=False)
    assert none is None
    want = ba_edge.ba_lm_sums_plain(W_k["st"], pat.lm_edge, with_w=False)
    assert _rel(Hll, want[0]) < TOL_BA[dtype]
    assert _rel(b_l, want[1]) < TOL_BA[dtype]
    sys = ba.schur_build(prob, lin=lin, pattern=pat)
    lam = torch.tensor(1e-2, dtype=dtype, device=cuda)
    fl = prob.free[pat.lm_name]
    _, hinv, hib = ba_inv.ba_block_inv(sys["Hll"], ba_inv.LANDMARK, fl, lam,
                                       b=sys["b_l"])
    gen = torch.Generator(device=cuda).manual_seed(4)
    xs = {pg.name: torch.randn((pg.dim, pg.count), generator=gen,
                               dtype=dtype, device=cuda)
          for pg in pat.pose_groups}
    u_k = u_p = None
    for i, pg in enumerate(pat.pose_groups):
        kw = (dict(hinv=hinv, b=sys["b_l"], free=fl)
              if i == len(pat.pose_groups) - 1 else {})
        args = (sys["W_lm"][pg.name], pg.lm_pose, xs[pg.name])
        u_k = ba_coupling.ba_wtx(*args, acc=u_k, **kw)
        u_p = ba_coupling.ba_wtx_plain(*args, acc=u_p, **kw)
        assert _rel(u_k, u_p) < TOL_BA[dtype]
    Tp = pat.pose_dim
    hpp = torch.randn((Tp, Tp), generator=gen, dtype=dtype, device=cuda)
    for pg in pat.pose_groups:
        wargs = (sys["W_pose"][pg.name], pg.rows, hib)
        for kw in (dict(base=xs[pg.name].flip(0).contiguous()),
                   dict(extra=xs[pg.name].flip(1).contiguous(),
                        x=xs[pg.name], free=prob.free[pg.name],
                        want_dot=True)):
            got = ba_coupling.ba_wv(*wargs, **kw)
            again = ba_coupling.ba_wv(*wargs, **kw)
            want = ba_coupling.ba_wv_plain(*wargs, **kw)
            if kw.get("want_dot"):
                assert _rel(got[1].sum(), want[1].sum()) < TOL_BA[dtype]
                assert torch.equal(got[1], again[1])
                got, again, want = got[0], again[0], want[0]
            assert _rel(got, want) < TOL_BA[dtype]
            assert torch.equal(got, again)
        sargs = (sys["W_pose"][pg.name], pg.rows, hinv,
                 ba.diag_blocks(hpp, pg))
        blocks = ba_coupling.ba_sandwich(*sargs)
        assert _rel(blocks, ba_coupling.ba_sandwich_plain(*sargs)) \
            < TOL_BA[dtype]
        assert torch.equal(blocks, ba_coupling.ba_sandwich(*sargs))
        # the raw blocks span 1e-1 to 1e8, and in float32 the products of
        # their inverse overflow: the kernel must give inf and NaN where
        # the plain version does
        _assert_same_nonfinite(ba_inv.ba_block_inv(blocks)[1],
                               ba_inv.ba_block_inv_plain(blocks)[1],
                               _inv_tol(blocks, dtype))
        # well-scaled SPD blocks from them
        spd = blocks.view(pg.dim, pg.dim, -1).permute(2, 0, 1)
        spd = spd / spd.abs().amax(dim=(1, 2), keepdim=True)
        spd = spd @ spd.transpose(1, 2) \
            + torch.eye(pg.dim, dtype=dtype, device=cuda)
        spd = spd.permute(1, 2, 0).reshape(pg.dim * pg.dim, -1).contiguous()
        binv = ba_inv.ba_block_inv(spd)[1]
        assert _rel(binv, ba_inv.ba_block_inv_plain(spd)[1]) < TOL_BA[dtype]
        z, part = jacobi_scale.lane_block_mv_dot(binv, xs[pg.name])
        zp, pp = jacobi_scale.lane_block_mv_dot_plain(binv, xs[pg.name])
        assert _rel(z, zp) < TOL_BA[dtype]
        assert _rel(part.sum(), pp.sum()) < TOL_BA[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_schur_products_on_a_pose_row_of_degree_80000_on_gpu(cuda, dtype):
    """One pose vertex with 80,000 W entries beside short rows (the shared
    intrinsics vertex of the chip's scene): W v and the preconditioner
    blocks against their plain versions, and the same bits twice."""
    from openslam_g2o_torch.kernels import ba_coupling
    rng = np.random.default_rng(1)
    counts = [3, 80000, 0, 700]
    L, dp, dl = 10000, 4, 3
    M = sum(counts)
    rows = ba_coupling.build_pose_rows(counts, rng.integers(0, L, M), cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn((dp * dl, M), generator=gen, dtype=dtype, device=cuda)
    v = torch.randn((dl, L), generator=gen, dtype=dtype, device=cuda)
    x = torch.randn((dp, len(counts)), generator=gen, dtype=dtype,
                    device=cuda)
    B = torch.randn((L, dl, dl), generator=gen, dtype=dtype, device=cuda)
    hinv = (B @ B.transpose(1, 2)).permute(1, 2, 0).reshape(dl * dl, L) \
        .contiguous()
    hcc = torch.randn((dp * dp, len(counts)), generator=gen, dtype=dtype,
                      device=cuda)
    got = ba_coupling.ba_wv(w, rows, v, extra=x, x=x, want_dot=True)
    want = ba_coupling.ba_wv_plain(w, rows, v, extra=x, x=x, want_dot=True)
    assert _rel(got[0], want[0]) < TOL_BA[dtype]
    assert _rel(got[1], want[1]) < TOL_BA[dtype]
    again = ba_coupling.ba_wv(w, rows, v, extra=x, x=x, want_dot=True)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    s_k = ba_coupling.ba_sandwich(w, rows, hinv, hcc)
    assert _rel(s_k, ba_coupling.ba_sandwich_plain(w, rows, hinv, hcc)) \
        < TOL_BA[dtype]
    assert torch.equal(s_k, ba_coupling.ba_sandwich(w, rows, hinv, hcc))


def _lm_slot_table(trap, L, rng, device):
    """[K, L] int32 observation ids (-1 on padding) for one trap of the
    tiled landmark sums, and the number of observations: a shuffled
    observation order, padding slots with a landmark that has none valid,
    K = 1, and K = 12 (more than one chunk of 8 slots)."""
    K = {"k1": 1, "k12": 12}.get(trap, 8)
    deg = np.full(L, K)
    if trap in ("padding", "k12"):
        deg = rng.integers(0, K + 1, L)
        deg[[0, 5]] = (K, 0)
    n = int(deg.sum())
    obs = np.arange(n) if trap == "padding" else rng.permutation(n)
    table = -np.ones((K, L), np.int32)
    start = np.concatenate([[0], np.cumsum(deg)])
    for l in range(L):
        table[:deg[l], l] = obs[start[l]:start[l + 1]]
    return torch.as_tensor(table, device=device), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("trap", ["shuffled", "padding", "k1", "k12"])
def test_ba_lm_sums_on_traps_on_gpu(cuda, dtype, trap):
    """K10's tiled landmark sums on the traps of a tile and a chunk of
    slots, at both instantiations, with and without W: Hll and b_l equal
    to the bit to a loop over the valid slots in slot order (the order of
    the kernel they replace) and close to the plain version, W_lm a copy
    of the plain version's (zeros on padding, exact), the same bits twice,
    one launch per call."""
    from openslam_g2o_torch.kernels import ba_edge
    rng = np.random.default_rng(len(trap))
    L = 1000 + 7                   # a ragged last tile
    lm_edge, E = _lm_slot_table(trap, L, rng, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    pos = torch.randperm(E, generator=gen, device=cuda).int()
    for dp, dl in ba_edge.BLOCK_DIMS:
        st = ba_edge.EdgeStreams.empty(E, dp, dl, dtype, cuda, pos)
        for t in st.tensors():
            t.copy_(torch.randn(t.shape, generator=gen, dtype=dtype,
                                device=cuda))
        for with_w in (True, False):
            arg = st if with_w else ba_edge.LandmarkStreams(st.hll, st.bl)
            before = ba_edge.ba_lm_sums.launches
            got = ba_edge.ba_lm_sums(arg, lm_edge, with_w=with_w)
            again = ba_edge.ba_lm_sums(arg, lm_edge, with_w=with_w)
            assert ba_edge.ba_lm_sums.launches == before + 2
            want = ba_edge.ba_lm_sums_plain(arg, lm_edge, with_w)
            seq = [torch.zeros((r, L), dtype=dtype, device=cuda)
                   for r in (dl * dl, dl)]
            for k in range(lm_edge.shape[0]):
                ok = lm_edge[k] >= 0
                idx = lm_edge[k].clamp_min(0).long()
                for acc, src in zip(seq, (st.hll, st.bl)):
                    acc[:, ok] = acc[:, ok] + src[:, idx][:, ok]
            for a, b, c in zip(got[:2], seq, again[:2]):
                assert torch.equal(a, b) and torch.equal(a, c)
            for a, b in zip(got[:2], want[:2]):
                assert _rel(a, b) < TOL[dtype]
            if with_w:
                assert torch.equal(got[2], want[2])
                assert torch.equal(got[2], again[2])
            else:
                assert got[2] is None
            if trap in ("padding", "k12"):
                assert not got[0][:, 5].any() and not got[1][:, 5].any()


def _device_launches(fn, name, calls=10):
    """Kernels whose name holds `name` per call of fn on the card, to the
    nearest integer: torch.profiler over `calls` calls, after a fill kernel
    that takes the first record of the session (a record can go missing)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return round(sum(e.count for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and name in e.key) / calls)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims", [(6, 3), (4, 3), (3, 2), (9, 3)])
def test_ba_wv_one_launch_on_chunk_traps_on_gpu(cuda, dtype, dims):
    """K13's W v in one launch at vertex degrees 0, 1, 255, 256, 257 and
    80,000 (the chunk edges and the hub vertex), landmark ids in a random
    order: against the plain version (S x with the dot, and the reduced
    right-hand side with free), the same bits over two successive calls on
    one PoseRows (the arrival counters are back at zero after each), and
    one kernel launch per call."""
    from openslam_g2o_torch.kernels import ba_coupling
    dp, dl = dims
    rng = np.random.default_rng(dp)
    counts = [0, 1, 255, 256, 257, 3, 80000, 0, 40]
    L, M, N = 20000, sum(counts), len(counts)
    rows = ba_coupling.build_pose_rows(counts, rng.integers(0, L, M), cuda)
    gen = torch.Generator(device=cuda).manual_seed(dp)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype, device=cuda)
    w, v, x = rnd(dp * dl, M), rnd(dl, L), rnd(dp, N)
    free = (torch.rand(N, generator=gen, device=cuda) > 0.3).to(dtype)
    for kw in (dict(hcc_d=rnd(dp * dp, N), x=x, extra=rnd(dp, N),
                    want_dot=True),
               dict(base=rnd(dp, N), free=free)):
        got = ba_coupling.ba_wv(w, rows, v, **kw)
        assert not rows.arrivals.any()
        again = ba_coupling.ba_wv(w, rows, v, **kw)
        assert not rows.arrivals.any()
        want = ba_coupling.ba_wv_plain(w, rows, v, **kw)
        if not kw.get("want_dot"):
            got, again, want = (got,), (again,), (want,)
        for a, b, c in zip(got, want, again):
            assert _rel(a, b) < TOL_BA[dtype] and torch.equal(a, c)
        assert _device_launches(lambda: ba_coupling.ba_wv(w, rows, v, **kw),
                                "ba_wv") == 1
    assert not rows.arrivals.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims", [(6, 3), (4, 3), (3, 2), (9, 3)])
def test_ba_sandwich_one_launch_on_chunk_traps_on_gpu(cuda, dtype, dims):
    """K13's preconditioner blocks in one launch at vertex degrees 0 (an
    empty vertex), 1, 255, 256, 257 (one and two chunks) and 80,000 (a hub
    of 313 chunks), landmark ids in a random order: against the plain
    version; the same bits over two
    back-to-back calls and over calls between `ba_wv` calls on the same
    PoseRows (the arrival counters they share are back at zero after each);
    one kernel launch per call."""
    from openslam_g2o_torch.kernels import ba_coupling
    dp, dl = dims
    rng = np.random.default_rng(10 + dp)
    counts = [0, 1, 255, 256, 257, 3, 80000, 0, 40]
    L, M, N = 20000, sum(counts), len(counts)
    rows = ba_coupling.build_pose_rows(counts, rng.integers(0, L, M), cuda)
    assert int(rows.row_chunk[7] - rows.row_chunk[6]) == 313
    gen = torch.Generator(device=cuda).manual_seed(dp)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype, device=cuda)
    w, v, hcc = rnd(dp * dl, M), rnd(dl, L), rnd(dp * dp, N)
    B = rnd(L, dl, dl)
    hinv = (B @ B.transpose(1, 2)).permute(1, 2, 0).reshape(dl * dl, L) \
        .contiguous()
    want = ba_coupling.ba_sandwich_plain(w, rows, hinv, hcc)
    call = lambda: ba_coupling.ba_sandwich(w, rows, hinv, hcc)
    got = call()
    assert not rows.arrivals.any()
    assert _rel(got, want) < TOL_BA[dtype]
    assert torch.equal(got, call()) and not rows.arrivals.any()
    y = ba_coupling.ba_wv(w, rows, v)
    assert torch.equal(got, call()) and not rows.arrivals.any()
    assert torch.equal(y, ba_coupling.ba_wv(w, rows, v))
    assert not rows.arrivals.any()
    assert _device_launches(call, "ba_sandwich") == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_edges", [1, 31, 33, 95, 700])
def test_edge_se3_blocks_ragged_groups_on_gpu(cuda, dtype, n_edges):
    """K16 on edge groups whose sizes are not multiples of its 32-edge
    block: the sphere's edges in a seeded random order cut into two groups
    sharing one stream (n_edges edges, then the rest with Huber at col0 =
    n_edges), a fixed vertex and the stored-quaternion traps of _sphere,
    against the plain version. Each group's blocks are held at that group's
    own limit (2e-4 without a robust kernel, 2e-3 with Huber, in float32)
    relative to the group's own columns; the gradients relative to the
    whole stream's largest entry, as in the whole-sphere test (the odometry
    edges' residuals are zero up to rounding, so a group of them alone
    holds only float32 noise); the same bits on a repeat."""
    from openslam_g2o_torch.kernels import edge_se3
    prob, _ = _sphere(dtype, cuda)
    ea = prob.edges[prob.static.egroups[0].key]
    E = ea.indices[0].shape[0]
    order = torch.as_tensor(np.random.default_rng(7).permutation(E),
                            device=cuda)
    take = lambda t, a, b: t[order[a:b]].contiguous()
    groups = [(0, n_edges, 0), (n_edges, E, 1)]
    assert n_edges % 32 and (E - n_edges) % 32
    free = prob.free["se3"]
    assert not bool(free.all())                 # vertex 40 is fixed
    args = lambda a, b, kid: (
        prob.params["se3"], free, take(ea.indices[0], a, b),
        take(ea.indices[1], a, b), take(ea.measurement, a, b),
        take(ea.information, a, b), take(ea.delta, a, b), kid)
    plain = (torch.zeros((36, 4 * E), dtype=dtype, device=cuda),
             torch.zeros((6, 2 * E), dtype=dtype, device=cuda))
    for a, b, kid in groups:
        edge_se3.edge_se3_blocks_plain(*args(a, b, kid), *plain, a)
    outs = []
    for _ in range(2):
        out = (torch.full_like(plain[0], float("nan")),
               torch.full_like(plain[1], float("nan")))
        for a, b, kid in groups:
            edge_se3.edge_se3_blocks(*args(a, b, kid), *out, a)
        outs.append(out)
    cols = lambda t, a, b: t.view(36, 4, E)[:, :, a:b]
    for a, b, kid in groups:
        tol = {torch.float64: 1e-10,
               torch.float32: 2e-4 if kid == 0 else 2e-3}[dtype]
        assert _rel(cols(outs[0][0], a, b), cols(plain[0], a, b)) < tol, kid
    assert _rel(outs[0][1], plain[1]) < {torch.float64: 1e-10,
                                         torch.float32: 2e-3}[dtype]
    assert all(torch.equal(x, y) for x, y in zip(*outs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims", [(6, 3), (3, 2), (9, 3)])
def test_ba_cam_sums_on_degree_traps_on_gpu(cuda, dtype, dims):
    """K10's chunked camera sums at camera degrees 0, 1, 255, 256, 257
    (the chunk edges), 1768 (the 400k shape's hub, 7 chunks) and 5000, on
    random records: Hcc and b_p close to the plain version (zeros for a
    camera without observations) and, for a camera of one chunk, equal
    to the bit to one 128-thread block per camera (a strided loop and a
    shuffle tree), W_cam a copy of the records' W (exact),
    the same bits over two successive calls on one PoseRows (the arrival
    counters back at zero after each), and one kernel launch per call."""
    from openslam_g2o_torch.kernels import ba_coupling, ba_edge
    dp, dl = dims
    counts = [0, 1, 255, 256, 257, 3, 1768, 0, 40, 5000]
    E = sum(counts)
    rng = np.random.default_rng(dp)
    rows = ba_coupling.build_pose_rows(counts, rng.integers(0, 50, E), cuda)
    gen = torch.Generator(device=cuda).manual_seed(dp)
    pos = torch.randperm(E, generator=gen, device=cuda).int()
    st = ba_edge.EdgeStreams.empty(E, dp, dl, dtype, cuda, pos)
    for t in st.tensors():
        t.copy_(torch.randn(t.shape, generator=gen, dtype=dtype,
                            device=cuda))
    before = ba_edge.ba_cam_sums.launches
    got = ba_edge.ba_cam_sums(st, rows)
    assert not rows.arrivals.any()
    again = ba_edge.ba_cam_sums(st, rows)
    assert not rows.arrivals.any()
    assert ba_edge.ba_cam_sums.launches == before + 2
    want = ba_edge.ba_cam_sums_plain(st, rows)
    for a, b, c in zip(got[:2], want[:2], again[:2]):
        assert _rel(a, b) < TOL[dtype] and torch.equal(a, c)
        assert not a[:, [0, 7]].any()
    assert torch.equal(got[2], want[2]) and torch.equal(got[2], again[2])
    # a camera of one chunk: the bits of a 128-thread block per camera
    # with a strided loop and a shuffle tree (the kernel before the chunks)
    sums = torch.cat(got[:2]).T
    start = 0
    for cam, d in enumerate(counts):
        if d <= 256:
            x = torch.zeros((256, dp * dp + dp), dtype=dtype, device=cuda)
            x[:d] = st.rec[start:start + d, :dp * dp + dp]
            y = (torch.zeros_like(x[:128]) + x[:128]) + x[128:]
            y = y.view(4, 32, -1).clone()
            for o in (16, 8, 4, 2, 1):
                y[:, :o] = y[:, :o] + y[:, o:2 * o]
            ref = ((y[0, 0] + y[1, 0]) + y[2, 0]) + y[3, 0]
            assert torch.equal(sums[cam], ref), cam
        start += d
    assert _device_launches(lambda: ba_edge.ba_cam_sums(st, rows),
                            "ba_cam_sums") == 1
    assert not rows.arrivals.any()


@pytest.mark.parametrize("kind", ["psi2uv", "intrinsics"])
def test_general_schur_lm_on_gpu_matches_cpu(cuda, kind):
    """LevenbergMarquardtSchur on the card against the same run on the CPU
    (plain versions), float64: chi2 to 1e-9, and every kernel of the path
    launched."""
    from openslam_g2o_torch.core import ba
    runs = {}
    for device in (cuda, "cpu"):
        prob = _general_scene(device, torch.float64, kind)
        kernels.reset_launch_counts()
        _, stats = algorithms.optimize(prob, ba.LevenbergMarquardtSchur(
            pcg_iters=60), iterations=5)
        runs[str(device)] = ([s["chi2"] for s in stats],
                             kernels.launch_counts())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-9)
    counts = runs["cuda"][1]
    used = ("schur_edge_blocks", "ba_wv", "ba_sandwich", "ba_lm_sums",
            "ba_block_inv", "ba_wtx", "lane_block_mv_dot", "dense_assemble",
            "cg_update_xr", "lm_outcome")
    assert all(counts[k] > 0 for k in used), counts
    assert not any(runs["cpu"][1].values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 5, 4099, 300_000, 600_001])
@pytest.mark.parametrize("offset", [0, 1])
def test_cg_update_xr_share_and_tails_on_gpu(cuda, dtype, n, offset):
    """cg_update_xr (2048 values a block, the partial sums in one warp)
    against its plain version on vectors with a ragged tail and on views at
    an odd offset, with and without the finish; its partials number
    xr_blocks(n); the two-launch step equals the three-launch step bit for
    bit and repeats its bits; the counter ends at zero."""
    gen = torch.Generator(device=cuda).manual_seed(n + offset)
    vec = lambda: torch.randn(n + offset, generator=gen, dtype=dtype,
                              device=cuda)[offset:]
    x0, r0, p0, hp0 = vec(), vec(), vec(), vec()
    pap = torch.rand(391, generator=gen, dtype=dtype, device=cuda)
    scal0 = torch.zeros(cg_step.N_SCALARS, dtype=dtype, device=cuda)
    scal0[cg_step.RZ], scal0[cg_step.PD] = 2.5, 1.0
    scal0[cg_step.THRESH] = 1e-3
    arrivals = torch.zeros(1, dtype=torch.int32, device=cuda)
    tol = TOL[dtype]
    out = {}
    for route, kw in (("two", dict(arrivals=arrivals)), ("three", {}),
                      ("again", dict(arrivals=arrivals))):
        x, r, sc = x0.clone(), r0.clone(), scal0.clone()
        if offset:                       # keep the odd alignment
            x = torch.empty(n + 1, dtype=dtype, device=cuda)[1:].copy_(x0)
            r = torch.empty(n + 1, dtype=dtype, device=cuda)[1:].copy_(r0)
        part = cg_step.cg_update_xr(sc, pap, x, r, p0, hp0, **kw)
        assert part.numel() == cg_step.xr_blocks(n)
        if route == "three":
            cg_step.cg_update_p(sc, part, part, r, p0.clone(), True)
        out[route] = (x, r, sc)
    assert not arrivals.any()
    for route in ("three", "again"):
        assert all(torch.equal(a, b) for a, b in zip(out[route],
                                                     out["two"])), route
    xp, rp, sp = x0.clone(), r0.clone(), scal0.clone()
    cg_step.cg_update_xr_plain(sp, pap, xp, rp, p0, hp0,
                               torch.zeros(1, dtype=torch.int32))
    x, r, sc = out["two"]
    assert _rel(x, xp) < tol and _rel(r, rp) < tol and _scal_rel(sc, sp) < tol


def _wtx_group(gen, dp, dl, K, L, C, dtype, device):
    """W_lm, slot table and x of one pose group: a third of the slots
    padding (W there NaN, which the kernel must not read into the sum)."""
    cam = torch.randint(0, C, (K, L), generator=gen, dtype=torch.int32,
                        device=device)
    cam[torch.rand((K, L), generator=gen, device=device) < 0.3] = -1
    w = torch.randn((dp * dl, K, L), generator=gen, dtype=dtype,
                    device=device)
    w[:, cam < 0] = float("nan")
    x = torch.randn((dp, C), generator=gen, dtype=dtype, device=device)
    return w, cam, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [1, 3, 8, 13])
@pytest.mark.parametrize("dims", [((6, 3),), ((4, 3),), ((3, 2),),
                                  ((9, 3),), ((9, 3), (4, 3)),
                                  ((4, 3), (6, 3)), ((6, 3), (4, 3)),
                                  ((6, 3), (6, 3)), ((3, 2), (3, 2)),
                                  ((4, 3), (6, 3), (6, 3))])
def test_ba_wtx_groups_match_plain_on_gpu(cuda, dtype, K, dims):
    """ba_wtx over one to three pose groups (a lane per landmark, a warp
    per slot, the warps' sums in a fixed order): K slots from 1 to 13 (more
    than the eight warps), padding slots, L not a multiple of a block's 32
    landmarks, and acc, b, free and Hinv each present and absent, against
    the plain version; one launch, the bits twice the same."""
    from openslam_g2o_torch.kernels import ba_coupling
    gen = torch.Generator(device=cuda).manual_seed(K)
    L, dl = 1037, dims[0][1]
    gs = [_wtx_group(gen, dp, dl, K + i, L, 7 + i, dtype, cuda)
          for i, (dp, _) in enumerate(dims)]
    W, cams, xs = (list(t) for t in zip(*gs))
    W0 = [torch.nan_to_num(w, nan=0.0) for w in W]
    extra = dict(hinv=torch.randn((dl * dl, L), generator=gen, dtype=dtype,
                                  device=cuda),
                 b=torch.randn((dl, L), generator=gen, dtype=dtype,
                               device=cuda),
                 free=(torch.rand(L, generator=gen, device=cuda) < 0.7)
                 .to(dtype),
                 acc=torch.randn((dl, L), generator=gen, dtype=dtype,
                                 device=cuda))
    for mask in range(16):
        kw = {k: v for i, (k, v) in enumerate(extra.items())
              if mask >> i & 1}
        before = ba_coupling.ba_wtx.launches
        got = ba_coupling.ba_wtx(W, cams, xs, **kw)
        assert ba_coupling.ba_wtx.launches - before == 1
        want = ba_coupling.ba_wtx_plain(W0, cams, xs, **kw)
        assert torch.isfinite(got).all()
        assert _rel(got, want) < TOL_BA[dtype]
        assert torch.equal(got, ba_coupling.ba_wtx(W, cams, xs, **kw))


@pytest.mark.parametrize("D", [3, 6])
def test_two_launch_steps_equal_three_launch_steps_on_gpu(cuda, D):
    """Thirty CG iterations of two launches (spmv_dot_p, then cg_update_xr
    with its finish), as pcg_solve runs them, against thirty of three
    (spmv_dot, cg_update_xr, cg_update_p): the same x, r and scalars bit
    for bit. cg_update_xr is a programmatic dependent launch in both, so a
    read of p or hp before the product wrote it would show here."""
    if D == 3:
        prob, pattern, values, b, lam = _scaled(cuda, torch.float32)
        free = prob.free["se2"]
    else:
        prob, pattern = _sphere(torch.float32, cuda)
        values, bT = sparse.assemble_ell(prob, pattern)
        b, lam, free = bT["se3"], torch.tensor(
            0.7, dtype=torch.float32, device=cuda), prob.free["se3"]
    linv, _, bhat, extra = damp_chol.damp_chol(values, free, b, lam)
    S = jacobi_scale.jacobi_scale(pattern.nb, values, linv, extra)
    r0, p0, rr0, bb0 = cg_step.cg_residual(bhat, torch.zeros_like(bhat))
    scal0 = cg_step.new_scalars(r0)
    cg_step.cg_start(scal0, rr0, rr0, bb0, 1e-9, True)
    arrivals = torch.zeros(1, dtype=torch.int32, device=cuda)
    x, r, p, sc = torch.zeros_like(bhat), r0.clone(), p0.clone(), \
        scal0.clone()
    hp, pap = cg_step.spmv_dot(pattern.nb, S, p)
    cg_step.cg_update_xr(sc, pap, x, r, p, hp, arrivals)
    q = torch.empty_like(p)
    for _ in range(30):
        hp, pap = cg_step.spmv_dot_p(pattern.nb, S, sc, p, r, q)
        cg_step.cg_update_xr(sc, pap, x, r, q, hp, arrivals)
        p, q = q, p
    two = (x, r, sc)
    x, r, p, sc = torch.zeros_like(bhat), r0.clone(), p0.clone(), \
        scal0.clone()
    for _ in range(31):
        hp, pap = cg_step.spmv_dot(pattern.nb, S, p)
        rr = cg_step.cg_update_xr(sc, pap, x, r, p, hp)
        cg_step.cg_update_p(sc, rr, rr, r, p, False)
    assert all(torch.equal(a, b_) for a, b_ in zip(two, (x, r, sc)))
    assert not arrivals.any() and torch.isfinite(x).all()


def _lin_scene(cuda, dtype, kind):
    """A scene for K17: a small Simulator3D world (EDGE_SE3:QUAT and
    EDGE_SE3_TRACKXYZ, pose 0 fixed; some quaternions stored with q_w < 0,
    some 5e-4 off unit), a small Simulator2D world (EDGE_SE2, EDGE_SE2_XY),
    _general_scene's anchored PSI2UV or shared-intrinsics scene (camera 0
    fixed), or one of chip_smoke.py's phase-4o worlds or its BAL camera
    graph, small, with a fixed vertex in every slot
    (chip_smoke.fix_one_per_slot)."""
    import chip_smoke
    from openslam_g2o_torch.core.graph import Graph
    if kind in ("psi2uv", "intrinsics"):
        return _general_scene(cuda, dtype, kind)
    if kind == "bal":
        g = chip_smoke.bal_camera_graph(Graph, 12, 200, seed=3)
        return chip_smoke.fix_one_per_slot(g).compile(dtype=dtype,
                                                      device=cuda)
    if kind == "2d":
        g, _ = Simulator2D(n_landmarks=40, seed=2).simulate(120)
        return g.compile(dtype=dtype, device=cuda)
    if kind in ("world2d", "world3d", "sba"):
        g = {"world2d": lambda: chip_smoke.world2d_all_graph(
                 Graph, 120, 90, seed=3, prior_every=8),
             "world3d": lambda: chip_smoke.world3d_all_graph(
                 Graph, 80, 60, seed=3),
             "sba": lambda: chip_smoke.sba_all_graph(Graph, 40, 90,
                                                     seed=3)}[kind]()
        return chip_smoke.fix_one_per_slot(g).compile(dtype=dtype,
                                                      device=cuda)
    from openslam_g2o_torch.apps.simulator import Simulator3D
    g, _ = Simulator3D(world_size=12.0, n_landmarks=60, seed=1).simulate(80)
    prob = g.compile(dtype=dtype, device=cuda)
    p = prob.params["se3"].clone()
    p[5::7, 3:] *= -1.0
    p[9::11, 3:] *= 1.0005
    return prob.with_params({**prob.params, "se3": p})


def _lin_matches_plain(fn, tname, args, dtype, what):
    """One K17 wrapper call against its plain version: one launch,
    residual, Jacobians and rho' relative to the largest plain entry to
    1e-10 (float64) and 2e-4 (float32; 2e-3 with a robust kernel, whose
    rho' carries the float32 residual's cancellation error), fixed
    columns exactly zero, and a second call gives the same bits."""
    from openslam_g2o_torch.kernels import edge_lin
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    want = edge_lin.linearize_plain(tname, *args)
    flat = lambda o: (o[0], *o[1], o[2])
    tol = {torch.float64: 1e-10,
           torch.float32: 2e-4 if args[-1] == 0 else 2e-3}[dtype]
    for g_, w_ in zip(flat(got), flat(want), strict=True):
        assert g_.shape == w_.shape
        assert _rel(g_, w_) < tol, what
    params, free, indices = args[:3]
    for s in range(len(params)):
        fixed = free[s][indices[s].long()] == 0
        assert (got[1][s][fixed] == 0).all(), what
    assert all(torch.equal(a, b_) for a, b_ in zip(flat(fn(*args)),
                                                   flat(got))), what


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["3d", "psi2uv", "intrinsics", "2d",
                                  "world2d", "world3d", "sba", "bal"])
def test_edge_lin_kernels_match_plain_on_gpu(cuda, dtype, kind):
    """K17 against its plain version (the model's error and torch.func.jvp
    through the retractions, or the closed form) on every edge group of the
    scene, without a robust kernel and with Huber and Cauchy (delta 0.5),
    fixed vertices included (_lin_matches_plain), as K16."""
    from openslam_g2o_torch.kernels import edge_lin
    prob = _lin_scene(cuda, dtype, kind)
    for kid in (0, 1, 3):
        for eg in prob.static.egroups:
            fn = edge_lin.linearizer(eg.etype.name)
            assert fn is not None, eg.key
            ea = prob.edges[eg.key]
            args = (tuple(prob.params[g] for g in eg.slots),
                    tuple(prob.free[g] for g in eg.slots), ea.indices,
                    ea.measurement, ea.information,
                    torch.full_like(ea.delta, 0.5), ea.pdata, kid)
            _lin_matches_plain(fn, eg.etype.name, args, dtype, (eg.key, kid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_lin_every_type_on_seeded_groups_on_gpu(cuda, dtype):
    """Every LINEARIZERS type on chip_smoke.py's seeded group (`lin_group`:
    3,000 edges, every 7th vertex fixed, angles over [-pi, pi), so bearings
    cross the cut), with no robust kernel, Huber and Cauchy
    (_lin_matches_plain)."""
    import chip_smoke
    from openslam_g2o_torch.kernels import edge_lin
    for tname in edge_lin.LINEARIZERS:
        for kid in (0, 1, 3):
            args = chip_smoke.lin_group(torch, tname, 3000, dtype, cuda,
                                        kernel_id=kid, seed=5)
            _lin_matches_plain(edge_lin.linearizer(tname), tname, args,
                               dtype, (tname, kid))


def test_edge_lin_serves_linearize_group_on_gpu(cuda):
    """On CUDA tensors `linearize_group` launches K17 for every type of the
    scenes (all 24 built-in types between them) and no other kernel; an
    edge group of a type registered at run time keeps the jvp route on the
    card."""
    from openslam_g2o_torch.core import registry
    from openslam_g2o_torch.core.graph import Graph
    from openslam_g2o_torch.kernels import edge_lin
    kernels.reset_launch_counts()
    seen = set()
    for kind in ("3d", "psi2uv", "intrinsics", "2d", "world2d", "world3d",
                 "sba", "bal"):
        prob = _lin_scene(cuda, torch.float32, kind)
        seen |= {eg.etype.name for eg in prob.static.egroups}
        problem_mod.linearize(prob)
    counts = kernels.launch_counts()
    assert seen == set(edge_lin.LINEARIZERS)
    assert {k for k, v in counts.items() if v} == set(
        edge_lin.LINEARIZERS.values())
    name = "test_runtime_range_xy_gpu"
    if name not in registry._EDGE_TYPES:
        registry.register_edge_type(registry.EdgeType(
            name=name, tag="TEST_RUNTIME_RANGE_XY_GPU",
            vertex_types=("se2", "point_xy"), error_dim=1,
            measurement_dim=1,
            error=lambda vp, meas, pdata: torch.sqrt(
                ((vp[1] - vp[0][..., :2]) ** 2).sum(-1, keepdim=True))
            - meas))
    g = Graph()
    g.add_vertex(0, "se2", [0.0, 0.0, 0.3], fixed=True)
    g.add_vertex(1, "point_xy", [3.0, 4.0])
    g.add_edge(name, (0, 1), [4.0], np.eye(1))
    prob = g.compile(dtype=torch.float32, device=cuda)
    kernels.reset_launch_counts()
    lin = problem_mod.linearize(prob)
    assert not any(kernels.launch_counts().values())
    assert all(torch.isfinite(lin[k][0]).all() for k in lin)


# ---------------------------------------------------------------------------
# K7 on the dense and Schur routes: kernels/trial.py (csrc/trial.cu)
# ---------------------------------------------------------------------------

# a vertex type -> an edge type whose seeded group (chip_smoke.lin_group)
# holds a table of it
_TRIAL_VERTEX_OF = {"se2": "edge_se2", "point_xy": "edge_se2_xy",
                    "se3": "edge_se3", "point_xyz": "edge_se3_xyz",
                    "se3_expmap": "edge_se3_expmap",
                    "sba_point_xyz": "edge_project_xyz2uv",
                    "cam": "edge_sba_cam",
                    "intrinsics": "edge_project_p2mc_intrinsics",
                    "bal_camera": "edge_project_bal"}
# relative tolerance of the summed chi2 and dot, and of the candidate
# (relative to its largest entry)
TOL_K7 = {torch.float64: 1e-12, torch.float32: 1e-5}


def _trial_vertex_group(vname, dtype, device, seed=5):
    """A seeded vertex group of `vname` (every 7th fixed), quaternions of
    every third stored 3% off unit norm, SE2 angles stepped across +-pi;
    the step and gradient as lane-major [D, N] tables seen transposed, b
    of dx's sign (so that the dot has no cancellation)."""
    import chip_smoke
    from openslam_g2o_torch.core import registry
    tname = _TRIAL_VERTEX_OF[vname]
    args = chip_smoke.lin_group(torch, tname, 4000, torch.float64, "cpu",
                                seed=seed)
    s = registry.edge_type(tname).vertex_types.index(vname)
    x, free = args[0][s].clone(), args[1][s].clone()
    N, D = x.shape[0], registry.vertex_type(vname).tangent_dim
    gen = torch.Generator().manual_seed(seed)
    dx = 0.05 * torch.randn(D, N, generator=gen, dtype=torch.float64)
    b = dx.sign() * torch.rand(D, N, generator=gen, dtype=torch.float64)
    if vname in ("se3", "se3_expmap", "cam"):
        x[1::3, 3:7] *= 1.03
    if vname == "se2":
        x[1::4, 2], dx[2, 1::4] = np.pi - 0.01, 0.05
        x[2::4, 2], dx[2, 2::4] = -np.pi + 0.01, -0.05
    to = lambda t: t.to(device=device, dtype=dtype).contiguous()
    return to(x), to(free), to(dx), to(b)


def _retract_alone(vname, x, dx, free, b=None, lam=None, plain=False):
    """One vertex group's retraction through trial_retract_groups (or its
    plain version) on its own: (cand, its partials, or None without b)."""
    from openslam_g2o_torch.kernels import trial
    out = None if b is None else torch.empty(
        trial.partial_count(x.shape[0], x.device), dtype=x.dtype,
        device=x.device)
    fn = (trial.trial_retract_groups_plain if plain
          else trial.trial_retract_groups)
    cand, = fn([trial.RetractGroup(vname, x, dx, free, b)], lam, out)
    return cand, out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("vname", list(_TRIAL_VERTEX_OF))
def test_trial_retract_matches_plain_on_gpu(cuda, dtype, vname):
    """K7's retraction of each vertex type (trial_retract_groups over that
    group alone) against its plain version: the candidate (relative to its
    largest entry) and the summed dot partials, one launch, the same bits
    twice, and without b the same candidate."""
    from openslam_g2o_torch.kernels import trial
    x, free, dxT, bT = _trial_vertex_group(vname, dtype, cuda)
    lam = torch.tensor(0.7, dtype=dtype, device=cuda)
    fn = trial.trial_retract_groups
    before = fn.launches
    cand, part = _retract_alone(vname, x, dxT.T, free, bT.T, lam)
    assert fn.launches == before + 1
    assert part.shape == (trial.partial_count(x.shape[0], x.device),)
    want_c, want_p = _retract_alone(vname, x, dxT.T, free, bT.T, lam,
                                    plain=True)
    assert _rel(cand, want_c) < TOL_K7[dtype], vname
    assert _rel(part.sum(), want_p.sum()) < TOL_K7[dtype], vname
    cand2, part2 = _retract_alone(vname, x, dxT.T, free, bT.T, lam)
    assert torch.equal(cand2, cand) and torch.equal(part2, part)
    cand3, none = _retract_alone(vname, x, dxT.T.contiguous(), free)
    assert none is None and torch.equal(cand3, cand)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trial_retract_groups_gives_the_per_group_bits_on_gpu(cuda, dtype):
    """K7's trial_retract_groups against each group launched on its own
    (as the per-type kernels it replaced ran): every vertex type's group
    (seeded, 4,000 vertices and a 1-vertex and a 300-vertex group of each,
    the step and gradient transposed lane-major views, as the Schur routes pass them, and views
    of one flat vector, as the dense route does), the candidates and the
    partials at each group's offset bit for bit; 28 groups in four
    launches; without b the same candidates; and against the plain
    version to TOL_K7."""
    from openslam_g2o_torch.kernels import trial
    lam = torch.tensor(0.7, dtype=dtype, device=cuda)
    groups, want, offset = [], [], 0
    for i, vname in enumerate(trial.RETRACT_IDS):
        x, free, dxT, bT = _trial_vertex_group(vname, dtype, cuda, seed=i)
        D, N = dxT.shape
        m = min(300, N)
        flat = torch.cat([dxT.T.reshape(-1), bT.T.reshape(-1)])
        for n, dx, b in ((N, dxT.T, bT.T),
                         (1, flat[:D].view(1, D), flat[D * N:D * N + D]
                          .view(1, D)),
                         (m, flat[:m * D].view(m, D),
                          flat[D * N:D * N + m * D].view(m, D))):
            g = trial.RetractGroup(vname, x[:n].contiguous(), dx,
                                   free[:n].contiguous(), b, offset)
            groups.append(g)
            want.append(_retract_alone(vname, g.x, dx, g.free, b, lam))
            offset += trial.partial_count(n, x.device)
    groups.append(groups[0]._replace(offset=offset))
    want.append(want[0])
    offset += want[0][1].numel()
    out = torch.full((offset,), float("nan"), dtype=dtype, device=cuda)
    before = trial.trial_retract_groups.launches
    cands = trial.trial_retract_groups(groups, lam, out)
    assert trial.trial_retract_groups.launches == before + 4
    for g, cand, (wc, wp) in zip(groups, cands, want):
        assert torch.equal(cand, wc), g.vname
        assert torch.equal(out[g.offset:g.offset + wp.numel()], wp), g.vname
    plain_c = trial.trial_retract_groups_plain(
        groups, lam, torch.zeros_like(out))
    for g, cand, pc in zip(groups, cands, plain_c):
        assert _rel(cand, pc) < TOL_K7[dtype], g.vname
    out2 = torch.empty_like(out)
    again = trial.trial_retract_groups(groups, lam, out2)
    assert torch.equal(out2, out)
    assert all(torch.equal(a, c) for a, c in zip(again, cands))
    bare = trial.trial_retract_groups([g._replace(b=None) for g in groups])
    assert all(torch.equal(a, c) for a, c in zip(bare, cands))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trial_candidate_launches_once_on_gpu(cuda, dtype):
    """core/problem.py trial_candidate on the shared-intrinsics scene (three
    vertex groups): one trial_retract_groups launch, and the bits of each
    group launched on its own, laid end to end."""
    from openslam_g2o_torch.kernels import trial
    prob = _general_scene(cuda, dtype, "intrinsics")
    gen = torch.Generator().manual_seed(3)
    dx, b = {}, {}
    for g in prob.static.vgroups:
        dx[g.name] = (0.01 * torch.randn(g.tangent_dim, g.count,
                                         generator=gen, dtype=torch.float64)
                      ).to(cuda, dtype).T
        b[g.name] = torch.randn(g.tangent_dim, g.count, generator=gen,
                                dtype=torch.float64).to(cuda, dtype).T
    lam = torch.tensor(0.3, dtype=dtype, device=cuda)
    kernels.reset_launch_counts()
    cand, part = problem_mod.trial_candidate(prob, dx, b, lam)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {"trial_retract_groups": 1}, counts
    want_c, want_p = {}, []
    for g in prob.static.vgroups:
        want_c[g.name], p = _retract_alone(
            g.vtype.name, prob.params[g.name], dx[g.name],
            prob.free[g.name], b[g.name], lam)
        want_p.append(p)
    assert torch.equal(part, torch.cat(want_p))
    for k in want_c:
        assert torch.equal(cand[k], want_c[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [2, 3, 4, 6, 9])
def test_lane_block_mv_dot_gives_the_pair_bits_on_gpu(cuda, dtype, D):
    """K4's lane_block_mv_dot against the two launches it replaces,
    lane_block_mv then dot_partials: z and the partials bit for bit (at
    D = 4 and 9, where lane_block_mv is not built, the partials against
    dot_partials of its own z), twice; and against the plain versions to
    TOL."""
    gen = torch.Generator().manual_seed(D)
    for N in (1, 900, 100_003):
        M = torch.randn(D * D, N, generator=gen, dtype=torch.float64).to(
            cuda, dtype)
        r = torch.randn(D, N, generator=gen, dtype=torch.float64).to(
            cuda, dtype)
        before = jacobi_scale.lane_block_mv_dot.launches
        z, part = jacobi_scale.lane_block_mv_dot(M, r)
        assert jacobi_scale.lane_block_mv_dot.launches == before + 1
        z_row = (jacobi_scale.lane_block_mv(M, r)
                 if D in jacobi_scale.MV_WIDTHS else z)
        assert torch.equal(z, z_row)
        assert torch.equal(part, cg_step.dot_partials(r, z_row))
        zp, pp = jacobi_scale.lane_block_mv_dot_plain(M, r)
        assert _rel(z, zp) < TOL[dtype]
        assert _rel(part.sum(), pp.sum()) < TOL[dtype] * D
        z2, part2 = jacobi_scale.lane_block_mv_dot(M, r)
        assert torch.equal(z2, z) and torch.equal(part2, part)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trial_chi2_every_type_matches_plain_on_gpu(cuda, dtype):
    """K7's chi2 of every edge type on chip_smoke.py's seeded group
    (`lin_group`: 3,000 edges, every 7th vertex fixed), without a robust
    kernel, with Huber and with Cauchy: the summed partials against the
    plain version, one launch, the same bits twice; chi2_sum of them
    against torch's sum."""
    import chip_smoke
    from openslam_g2o_torch.kernels import trial
    for tname in trial.CHI2:
        for kid in (0, 1, 3):
            params, _, indices, meas, info, delta, pdata, _ = \
                chip_smoke.lin_group(torch, tname, 3000, dtype, cuda,
                                     kernel_id=kid, seed=5)
            args = (params, indices, meas, info, delta, pdata, kid)
            fn = trial.chi2_of(tname)
            before = fn.launches
            part = fn(*args)
            assert fn.launches == before + 1
            assert part.shape == (trial.partial_count(3000, meas.device),)
            want = getattr(trial, fn.__name__ + "_plain")(*args)
            assert _rel(part.sum(), want.sum()) < TOL_K7[dtype], (tname, kid)
            assert torch.equal(fn(*args), part), (tname, kid)
            total = trial.chi2_sum(part)
            assert total.dim() == 0
            assert _rel(total, part.sum()) < TOL_K7[dtype]


def test_trial_chi2_sum_is_lm_outcomes_sum_on_gpu(cuda):
    """chi2_sum gives the bits of the chi2 that lm_outcome forms from the
    same partials, so a route's init chi2 and a trial's compare alike."""
    from openslam_g2o_torch.kernels import trial
    gen = torch.Generator().manual_seed(3)
    part = torch.rand(1237, generator=gen, dtype=torch.float64).to(cuda)
    dot = torch.ones(3, dtype=torch.float64, device=cuda)
    one = lambda v: torch.tensor(v, dtype=torch.float64, device=cuda)
    chi_new = retract_chi2.lm_outcome(
        part, dot, torch.tensor(True, device=cuda), one(1.0), one(2.0),
        one(1e9))[0]
    assert torch.equal(trial.chi2_sum(part), chi_new)


@pytest.mark.parametrize("route", ["lm", "gn", "ell", "general"])
def test_trial_routes_on_gpu_never_reach_the_plain_trial(cuda, route,
                                                         monkeypatch):
    """The dense LM and GN on a small 2D world, LevenbergMarquardtSchurELL
    on a small BAL problem and LevenbergMarquardtSchur on the PSI2UV scene,
    float64 on the card: no built-in type reaches the plain retraction or
    chi2 (both raise here), K7 launches for every vertex and edge group,
    and the chi2 trajectory equals the CPU run's to rtol 1e-9."""
    from openslam_g2o_torch.core import ba, ba_ell
    from openslam_g2o_torch.kernels import trial
    if route in ("lm", "gn"):
        g, _ = Simulator2D(n_landmarks=40, seed=4, world_size=12.0) \
            .simulate(120)
        make = lambda dev: g.compile(device=dev)
        alg = {"lm": algorithms.LevenbergMarquardt,
               "gn": algorithms.GaussNewton}[route]
    elif route == "ell":
        make = lambda dev: _ba_problem(dev, torch.float64, n_cams=24,
                                       n_points=600)
        alg = lambda: ba_ell.LevenbergMarquardtSchurELL(pcg_iters=40,
                                                        pcg_tol=1e-6)
    else:
        make = lambda dev: _general_scene(dev, torch.float64, "psi2uv")
        alg = lambda: ba.LevenbergMarquardtSchur(pcg_iters=60)
    runs = {}
    for device in ("cpu", cuda):
        prob = make(device)
        if device != "cpu":
            def refuse(*a, **k):
                raise AssertionError("the plain trial ran on the card")
            monkeypatch.setattr(trial, "retract_plain", refuse)
            monkeypatch.setattr(trial, "chi2_plain", refuse)
        kernels.reset_launch_counts()
        _, stats = algorithms.optimize(prob, alg(), iterations=4)
        runs[str(device)] = ([s["chi2"] for s in stats],
                             kernels.launch_counts(), prob)
    chi_g, counts, prob = runs["cuda"]
    np.testing.assert_allclose(chi_g, runs["cpu"][0], rtol=1e-9)
    assert set(runs["cpu"][1].values()) == {0}
    by_type = trial.trial_retract_groups.launches_by_type
    for g_ in prob.static.vgroups:
        assert by_type[g_.vtype.name] >= 4, g_.name
    for eg in prob.static.egroups:
        assert counts[trial.CHI2[eg.etype.name]] >= 4, eg.key
    assert counts["chi2_sum"] >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trial_kernels_give_the_lm_pcg_k7_bits_on_gpu(cuda, dtype):
    """K7's trial kernels of VERTEX_SE2 / EDGE_SE2 and VERTEX_SE3:QUAT /
    EDGE_SE3:QUAT give the bits of the LM-PCG path's own K7 kernels
    (retract_chi2, retract_se3 + se3_edge_chi2) on the same inputs: the
    candidate, the dot partials and the chi2 partials."""
    from openslam_g2o_torch.apps.simulator import create_sphere
    from openslam_g2o_torch.kernels import trial
    gen = torch.Generator().manual_seed(1)
    lam = torch.tensor(0.3, dtype=dtype, device=cuda)
    prob, _ = synthetic_pose_graph_2d(n_poses=5000, grid=50, dtype=dtype,
                                      device=cuda)
    sphere, _ = create_sphere(n_laps=20, n_per_lap=50, radius=20.0, seed=1)
    for prob_, g in ((prob, "se2"), (sphere.compile(dtype=dtype,
                                                    device=cuda), "se3")):
        x, free = prob_.params[g], prob_.free[g]
        D, N = (3 if g == "se2" else 6), x.shape[0]
        dxT = (0.01 * torch.randn(D, N, generator=gen,
                                  dtype=torch.float64)).to(cuda, dtype)
        bT = torch.randn(D, N, generator=gen, dtype=torch.float64).to(
            cuda, dtype)
        ea = prob_.edges["edge_" + g]
        if g == "se2":
            want = retract_chi2.retract_chi2(
                x, dxT, free, bT, lam, [(ea.indices[0], ea.indices[1],
                                         ea.measurement, ea.information,
                                         ea.delta, 0)])
        else:
            cand, part = retract_chi2.retract_se3(x, dxT, free, bT, lam)
            want = (cand, part, retract_chi2.se3_edge_chi2(
                cand, ea.indices[0], ea.indices[1], ea.measurement,
                ea.information, ea.delta, 0))
        cand, part = _retract_alone(g, x, dxT.T, free, bT.T, lam)
        chi = trial.chi2_of("edge_" + g)(
            (cand, cand), ea.indices, ea.measurement, ea.information,
            ea.delta, (), 0)
        for got, w in zip((cand, part, chi), want, strict=True):
            assert torch.equal(got, w), g


def _k14_case(device, dtype, R, dp, dl, E, seed, runs=False):
    """Seeded inputs of one K14 call: a group of E edges with residual width
    R at (Dp, dl), its landmark-major positions spread over K x L slots
    and its pose-major positions over M > E columns (both distinct):
    scattered over 4 E + 100 columns, or (runs) in runs of 8 consecutive
    columns, 8 edges in a row, as an anchor slot's are."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                                   device=device)
    A = t(E, R, R)
    L = max(E // 3, 1)
    K = -(-E // L) + 1
    M = 8 * (E // 8 + 2) if runs else 4 * E + 100
    e = np.arange(E)
    pose_pos = (8 * rng.permutation(M // 8)[e // 8] + e % 8 if runs
                else rng.permutation(M)[:E])
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return dict(resid=t(E, R), jl=t(E, R, dl), jp=t(E, R, dp),
                rho1=t(E).abs(), info=A @ A.transpose(1, 2),
                lm_pos=i32(rng.permutation(K * L)[:E]),
                pose_pos=i32(pose_pos), K=K, L=L, M=M)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R", [1, 2, 3])
@pytest.mark.parametrize("dims", [(6, 3), (4, 3), (3, 2), (9, 3)])
@pytest.mark.parametrize("runs", [False, True])
def test_schur_edge_blocks_tile_edges_on_gpu(cuda, dtype, R, dims, runs):
    """K14 (the staged tile kernel and the pose-order pass) against its
    plain version at every residual width and (Dp, dl), pose positions
    scattered or in runs, for group sizes around its tile of 128 edges
    and the 400,000 edges of ba_400k: each output written
    (Hll_e and b_l,e beside W, W alone, Hll_e and b_l,e alone), nothing
    past it touched, and the same bits three times. At (9, 3), the BAL
    camera, a 3-wide residual is refused (schur_general.MAX_RESIDUAL_AT)
    and launches nothing."""
    from openslam_g2o_torch.kernels import schur_general
    dp, dl = dims
    if R > schur_general.MAX_RESIDUAL_AT.get(dims, schur_general.MAX_RESIDUAL):
        c = _k14_case(cuda, dtype, R, dp, dl, 33, seed=R)
        idx = torch.arange(33, dtype=torch.int32, device=cuda)
        before = schur_general.schur_edge_blocks.launches
        with pytest.raises(NotImplementedError, match="residual width"):
            schur_general.schur_edge_blocks(
                c["resid"], c["jl"], c["jp"], c["rho1"], c["info"],
                torch.zeros((dl * dl, 33), dtype=dtype, device=cuda),
                torch.zeros((dl, 33), dtype=dtype, device=cuda), 0,
                torch.zeros((dp * dl, c["K"], c["L"]), dtype=dtype,
                            device=cuda), c["lm_pos"],
                torch.zeros((dp * dl, c["M"]), dtype=dtype, device=cuda),
                c["pose_pos"], idx, idx)
        assert schur_general.schur_edge_blocks.launches == before
        return
    for E in (1, 31, 33, 129, 400000):
        c = _k14_case(cuda, dtype, R, dp, dl, E, seed=E + R, runs=runs)
        off = 7
        orders = tuple(
            torch.as_tensor(o, dtype=torch.int32, device=cuda)
            for o in schur_general.edge_orders(c["lm_pos"].cpu().numpy(),
                                               c["pose_pos"].cpu().numpy()))

        def outs():
            nan = float("nan")
            return (torch.full((dl * dl, E + 10), nan, dtype=dtype,
                               device=cuda),
                    torch.full((dl, E + 10), nan, dtype=dtype, device=cuda),
                    torch.full((dp * dl, c["K"], c["L"]), nan, dtype=dtype,
                               device=cuda),
                    torch.full((dp * dl, c["M"]), nan, dtype=dtype,
                               device=cuda))
        args = (c["resid"], c["jl"], c["jp"], c["rho1"], c["info"])
        want = outs()
        schur_general.schur_edge_blocks_plain(
            *args, want[0], want[1], off, want[2], c["lm_pos"], want[3],
            c["pose_pos"])
        seen = []
        for _ in range(3):
            got = outs()
            before = schur_general.schur_edge_blocks.launches
            schur_general.schur_edge_blocks(
                *args, got[0], got[1], off, got[2], c["lm_pos"], got[3],
                c["pose_pos"], *orders)
            assert schur_general.schur_edge_blocks.launches == before + 1
            for g_, w_ in zip(got, want):
                # NaN where nothing is written, in both
                assert torch.equal(torch.isnan(g_), torch.isnan(w_))
                assert _rel(g_.nan_to_num(), w_.nan_to_num()) < TOL_BA[dtype]
            seen.append(got)
        for again in seen[1:]:
            for a, b in zip(seen[0], again):
                assert torch.equal(a.nan_to_num(), b.nan_to_num())
        # W alone (a second pose slot), then Hll_e and b_l,e alone (a
        # landmark edge without a pose slot): the same values
        w_only = outs()
        schur_general.schur_edge_blocks(
            *args, None, None, off, w_only[2], c["lm_pos"], w_only[3],
            c["pose_pos"], *orders)
        assert torch.isnan(w_only[0]).all() and torch.isnan(w_only[1]).all()
        for k in (2, 3):
            assert torch.equal(w_only[k].nan_to_num(), seen[0][k].nan_to_num())
        h_only = outs()
        schur_general.schur_edge_blocks(
            c["resid"], c["jl"], None, c["rho1"], c["info"], h_only[0],
            h_only[1], off)
        assert torch.isnan(h_only[2]).all() and torch.isnan(h_only[3]).all()
        for k in (0, 1):
            assert torch.equal(h_only[k].nan_to_num(), seen[0][k].nan_to_num())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["psi2uv", "intrinsics"])
def test_schur_edge_blocks_two_entries_and_hub_on_gpu(cuda, dtype, kind):
    """K14 as schur_build calls it on chip_smoke.py's ternary scenes at the
    ba_80k geometry: PSI2UV (two W entries an edge, in one pose group,
    both written into one landmark-major and one pose-major table) and
    P2MC_INTRINSICS (two pose groups, the intrinsics vertex's CSR list of
    80,000 entries), against the plain version and twice for the same
    bits."""
    import chip_smoke
    from openslam_g2o_torch.core import ba
    from openslam_g2o_torch.core.graph import Graph
    from openslam_g2o_torch.kernels import ba_edge, schur_general
    geo = chip_smoke.bal_geometry(*chip_smoke.BA_80K)
    build_ = {"psi2uv": chip_smoke.psi2uv_graph,
              "intrinsics": chip_smoke.p2mc_intrinsics_graph}[kind]
    prob = build_(Graph, geo).compile(dtype=dtype, device=cuda)
    pat = ba.build_schur_pattern(prob)
    new_out, run, *_ = chip_smoke.k14_operands(
        torch, ba_edge, prob, pat, problem_mod.linearize(prob))
    got = run(schur_general.schur_edge_blocks, new_out())
    again = run(schur_general.schur_edge_blocks, new_out())
    want = run(schur_general.schur_edge_blocks_plain, new_out())
    for g_, a_, w_ in zip(got, again, want, strict=True):
        assert _rel(g_, w_) < TOL_BA[dtype]
        assert torch.equal(g_, a_)
    if kind == "intrinsics":
        hub = next(pg for pg in pat.pose_groups if pg.count == 1)
        assert hub.n_entries == pat.n_lm_edges


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k14_and_k15_on_the_bal_camera_on_gpu(cuda, dtype, tmp_path):
    """K14 at (Dp, dl) = (9, 3) and K15 at block width 9 on a BAL file of
    chip_smoke.py's phase-4p kind (30 cameras, 3000 points, 24,000
    observations), as schur_build calls them (the landmark blocks and W;
    Hpp on the 9-wide camera slots) and as the dense route calls K15 (the
    3 x 3, 3 x 9 and 9 x 9 pairs and the unit diagonal of camera 0),
    against their plain versions (TOL_BA, TOL) and twice for the same
    bits."""
    import chip_smoke
    from openslam_g2o_torch.core import ba
    from openslam_g2o_torch.kernels import ba_edge, schur_general
    from openslam_g2o_torch.models.bal import load_bal_problem
    path = str(tmp_path / "scene.bal")
    chip_smoke.bal_camera_scene(path, 30, 3000)
    prob, _ = load_bal_problem(path, dtype=dtype, device=cuda)
    pat = ba.build_schur_pattern(prob)
    assert [(pg.dim, pg.count) for pg in pat.pose_groups] == [(9, 30)]
    lin = problem_mod.linearize(prob)
    new_out, run, *_ = chip_smoke.k14_operands(torch, ba_edge, prob, pat,
                                               lin)
    kernels.reset_launch_counts()
    got = run(schur_general.schur_edge_blocks, new_out())
    again = run(schur_general.schur_edge_blocks, new_out())
    assert kernels.launch_counts()["schur_edge_blocks"] == 2
    want = run(schur_general.schur_edge_blocks_plain, new_out())
    for g_, a_, w_ in zip(got, again, want, strict=True):
        assert _rel(g_, w_) < TOL_BA[dtype]
        assert torch.equal(g_, a_)
    for dargs in (chip_smoke.pose_slot_dargs(torch, dense_assemble, prob,
                                             pat, lin),
                  chip_smoke.dense_world_dargs(dense_assemble, problem_mod,
                                               prob)):
        H, b, raw = dense_assemble.dense_assemble(*dargs)
        pH, pb, praw = dense_assemble.dense_assemble_plain(*dargs)
        assert _rel(H, pH) < TOL[dtype] and _rel(b, pb) < TOL[dtype]
        assert _rel(raw, praw) < TOL[dtype]
        H2, b2, raw2 = dense_assemble.dense_assemble(*dargs)
        assert torch.equal(H, H2) and torch.equal(b, b2)
        assert torch.equal(raw, raw2)
        assert not any(bool(tb.arrivals.any())
                       for tbs in dargs[3].pairs for tb in tbs)
    fixed = dargs[2].bool()
    assert int(fixed.sum()) == 9 and (H.diagonal()[fixed] == 1.0).all()


@pytest.mark.parametrize("route", ["general", "lm", "gn"])
def test_bal_camera_routes_on_gpu_match_cpu(cuda, route):
    """The general Schur path (LevenbergMarquardtSchur) and the dense LM
    and GN on a BAL graph (chip_smoke.bal_camera_graph, 8 cameras, 60
    points, cameras 0 and 2 fixed) on the card against the same run on the
    CPU (plain versions), float64: chi2 to 1e-9, K14 and K15 launched."""
    import chip_smoke
    from openslam_g2o_torch.core import ba
    from openslam_g2o_torch.core.graph import Graph
    g = chip_smoke.bal_camera_graph(Graph, 8, 60)
    g.vertices[2].fixed = True
    make = {"general": lambda: ba.LevenbergMarquardtSchur(pcg_iters=60),
            "lm": algorithms.LevenbergMarquardt,
            "gn": algorithms.GaussNewton}[route]
    runs = {}
    for device in (cuda, "cpu"):
        kernels.reset_launch_counts()
        _, stats = algorithms.optimize(
            g.compile(dtype=torch.float64, device=device), make(),
            iterations=4)
        runs[str(device)] = ([s["chi2"] for s in stats],
                             kernels.launch_counts())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-9)
    counts = runs["cuda"][1]
    assert counts["dense_assemble"] >= 4
    if route == "general":
        assert counts["schur_edge_blocks"] >= 4 and counts["ba_wv"] > 0
    assert not any(runs["cpu"][1].values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_lin_forward_types_at_tile_edges_on_gpu(cuda, dtype):
    """Every forward-mode K17 type on seeded groups of 1, 31, 33, 63 and 65
    edges (a tile of 32 edges and two tiles, less one and one more), with
    and without a robust kernel, against its plain version
    (_lin_matches_plain)."""
    import chip_smoke
    from openslam_g2o_torch.core import registry
    from openslam_g2o_torch.kernels import edge_lin
    forward = [t for t in edge_lin.LINEARIZERS
               if registry.edge_type(t).jacobian is None]
    assert len(forward) == 21            # with EDGE_PROJECT_BAL
    for tname in forward:
        for E in (1, 31, 33, 63, 65):
            for kid in (0, 1):
                args = chip_smoke.lin_group(torch, tname, E, dtype, cuda,
                                            kernel_id=kid, seed=E)
                _lin_matches_plain(edge_lin.linearizer(tname), tname, args,
                                   dtype, (tname, E, kid))


def _ptrs(seq, n):
    """The data pointers of `seq`, padded with None to n (a C entry's
    unused slots)."""
    return [t.data_ptr() for t in seq] + [None] * (n - len(seq))


def _lin_padded(tname, args, pad=37):
    """One launch of K17's C entry for `tname` on the wrapper arguments
    `args`, as the wrapper makes it, into outputs `pad` rows longer than
    the group and prefilled with NaN: (resid, jacs, rho1) of E + pad
    rows."""
    from openslam_g2o_torch.core import registry
    from openslam_g2o_torch.kernels import build, edge_lin
    params, free, indices, meas, info, delta, pdata, kid = args
    E, D = meas.shape[0], info.shape[1]
    nan = lambda *shape: torch.full(shape, float("nan"), dtype=meas.dtype,
                                    device=meas.device)
    resid, rho1 = nan(E + pad, D), nan(E + pad)
    jacs = tuple(nan(E + pad, D, registry.vertex_type(n).tangent_dim)
                 for n in registry.edge_type(tname).vertex_types)
    slots = [p for s in zip(_ptrs(params, 3), _ptrs(free, 3),
                            _ptrs(indices, 3)) for p in s]
    build.launch("g2o_" + edge_lin.LINEARIZERS[tname], meas, *slots,
                 meas.data_ptr(), info.data_ptr(), delta.data_ptr(),
                 *_ptrs(pdata, 2), int(kid), resid.data_ptr(),
                 *_ptrs(jacs, 3), rho1.data_ptr(), E)
    return resid, jacs, rho1


# group sizes around the tiles of the thread-per-edge kernels over K17's
# functors (a one-warp tile of 32 edges and one of 128 for the closed
# forms, 256 for the trial chi2) and the paths' 80,000 and 400,000 edges
TILE_EDGE_SIZES = (1, 31, 32, 33, 127, 128, 129, 255, 256, 257, 80000,
                   400000)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_lin_closed_forms_at_tile_edges_on_gpu(cuda, dtype):
    """K17's closed forms (EDGE_SE2, XYZ2UV, XYZ2UVU) on seeded groups of
    TILE_EDGE_SIZES edges under Huber: against the plain version
    (_lin_matches_plain); launched into outputs prefilled with NaN past E,
    nothing is written past E, and three runs give the wrapper's bits."""
    import chip_smoke
    from openslam_g2o_torch.core import registry
    from openslam_g2o_torch.kernels import edge_lin
    closed = [t for t in edge_lin.LINEARIZERS
              if registry.edge_type(t).jacobian is not None]
    assert closed == ["edge_se2", "edge_project_xyz2uv",
                      "edge_project_xyz2uvu"]
    flat = lambda o: (o[0], *o[1], o[2])
    for tname in closed:
        for E in TILE_EDGE_SIZES:
            args = chip_smoke.lin_group(torch, tname, E, dtype, cuda,
                                        kernel_id=1, seed=E)
            fn = edge_lin.linearizer(tname)
            _lin_matches_plain(fn, tname, args, dtype, (tname, E))
            want = flat(fn(*args))
            for _ in range(3):
                got = flat(_lin_padded(tname, args))
                for g_, w_ in zip(got, want, strict=True):
                    assert torch.equal(g_[:E], w_), (tname, E)
                    assert torch.isnan(g_[E:]).all(), (tname, E)
            del args, want, got
        torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trial_chi2_at_tile_edges_on_gpu(cuda, dtype):
    """K7's chi2 of every edge type on seeded groups of TILE_EDGE_SIZES
    edges under Huber: trial.partial_count(E) = ceil(E / 256) partials,
    one a tile of 256 edges, each with the bits of a launch on its tile's
    edges alone (the first, a middle and the last tile); a launch into a
    buffer prefilled with NaN writes nothing past them; their sum against
    the plain version (TOL_K7); chi2_sum gives the sum lm_outcome takes of
    them; three runs give the same bits."""
    import chip_smoke
    from openslam_g2o_torch.kernels import build, trial
    one = lambda v: torch.tensor(v, dtype=dtype, device=cuda)
    for tname in trial.CHI2:
        fn = trial.chi2_of(tname)
        plain = getattr(trial, fn.__name__ + "_plain")
        for E in TILE_EDGE_SIZES:
            params, _, indices, meas, info, delta, pdata, _ = \
                chip_smoke.lin_group(torch, tname, E, dtype, cuda,
                                     kernel_id=1, seed=E)
            args = (params, indices, meas, info, delta, pdata, 1)
            n = trial.partial_count(E, meas.device)
            assert n == (E + 255) // 256
            part = fn(*args)
            assert part.shape == (n,)
            for _ in range(2):
                assert torch.equal(fn(*args), part), (tname, E)
            padded = torch.full((n + 5,), float("nan"), dtype=dtype,
                                device=cuda)
            slots = [p for s in zip(_ptrs(params, 3), _ptrs(indices, 3))
                     for p in s]
            build.launch("g2o_" + trial.CHI2[tname], meas, *slots,
                         meas.data_ptr(), info.data_ptr(), delta.data_ptr(),
                         *_ptrs(pdata, 2), 1, padded.data_ptr(), E)
            assert torch.equal(padded[:n], part), (tname, E)
            assert torch.isnan(padded[n:]).all(), (tname, E)
            for b in sorted({0, n // 2, n - 1}):
                sl = slice(256 * b, min(256 * (b + 1), E))
                alone = fn(params, tuple(i[sl] for i in indices), meas[sl],
                           info[sl], delta[sl], tuple(p[sl] for p in pdata),
                           1)
                assert alone.shape == (1,)
                assert torch.equal(alone[0], part[b]), (tname, E, b)
            assert _rel(part.sum(), plain(*args).sum()) < TOL_K7[dtype], \
                (tname, E)
            chi_new = retract_chi2.lm_outcome(
                part, torch.ones(1, dtype=dtype, device=cuda),
                torch.tensor(True, device=cuda), one(1.0), one(2.0),
                one(1e30))[0]
            assert torch.equal(trial.chi2_sum(part), chi_new), (tname, E)
            del params, indices, meas, info, delta, pdata, args, part
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The BAL camera (models/bal.py): every kernel of its path at (Dp, dl) =
# (9, 3) and D = 9
# ---------------------------------------------------------------------------

def _bal_scene(device, dtype, n_cams=40, n_points=1500):
    """chip_smoke.py's phase-4p scene (bal_camera_scene) at a small size,
    read by load_bal_problem."""
    import os
    import tempfile
    import chip_smoke
    from openslam_g2o_torch.models.bal import load_bal_problem
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scene.bal")
        chip_smoke.bal_camera_scene(path, n_cams, n_points)
        return load_bal_problem(path, dtype=dtype, device=device)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bal_kernels_match_plain_on_gpu(cuda, dtype):
    """Each kernel of the BAL path against its plain version on the card:
    K17's EDGE_PROJECT_BAL (2e-4 / 1e-10, _lin_matches_plain), K7's chi2
    (TOL_K7, or within chip_smoke.CHI2_WITNESS_TOL of the plain version in
    float64 on the same values) and VERTEX_CAMERA_BAL retraction, K10's
    generic entry and owner sums at (9, 3), K11 at D = 9 (camera damping,
    the preconditioner blocks' inverse), K13's W^T x, W v and sandwich, K12
    and K4 at D = 9 (TOL_BA; the inverse to cond x eps); the owner sums,
    W^T x, W v and S twice for the same bits."""
    import chip_smoke
    from openslam_g2o_torch.core import ba_ell
    from openslam_g2o_torch.kernels import (
        ba_coupling, ba_edge, ba_inv, ba_schur, edge_lin, trial)
    prob = _bal_scene(cuda, dtype)
    eg = prob.static.egroups[0]
    ea = prob.edges[eg.key]
    kernels.reset_launch_counts()
    for kid in (0, 1):
        largs = (tuple(prob.params[g] for g in eg.slots),
                 tuple(prob.free[g] for g in eg.slots), ea.indices,
                 ea.measurement, ea.information, ea.delta, ea.pdata, kid)
        _lin_matches_plain(edge_lin.edge_lin_bal, eg.etype.name, largs,
                           dtype, kid)
        cargs = (largs[0], ea.indices, ea.measurement, ea.information,
                 ea.delta, ea.pdata, kid)
        part = trial.trial_chi2_bal(*cargs)
        want = trial.trial_chi2_bal_plain(*cargs).sum()
        err = _rel(part.sum(), want)
        if err >= TOL_K7[dtype]:
            wide = tuple(p.double() for p in largs[0])
            ref = trial.trial_chi2_bal_plain(
                wide, ea.indices, ea.measurement.double(),
                ea.information.double(), ea.delta.double(), (), kid).sum()
            assert _rel(part.sum(), ref) < chip_smoke.CHI2_WITNESS_TOL
        assert torch.equal(trial.trial_chi2_bal(*cargs), part)
    x, free, dx, b = _trial_vertex_group("bal_camera", dtype, cuda)
    lam = torch.tensor(0.7, dtype=dtype, device=cuda)
    cand, dot = _retract_alone("bal_camera", x, dx.T, free, b.T, lam)
    cand_p, dot_p = _retract_alone("bal_camera", x, dx.T, free, b.T, lam,
                                   plain=True)
    assert _rel(cand, cand_p) < TOL_K7[dtype]
    assert _rel(dot.sum(), dot_p.sum()) < TOL_K7[dtype]
    # K10 at (9, 3) on the scene's own linearization
    pattern = ba_ell.build_ba_ell_pattern(prob)
    assert (pattern.dp, pattern.dl) == (9, 3)
    resid, jacs, rho1 = problem_mod.linearize_group(prob, eg)
    gargs = (resid.contiguous(), jacs[0].contiguous(), jacs[1].contiguous(),
             rho1.contiguous(), ea.information)
    E = resid.shape[0]
    got = ba_edge.EdgeStreams.empty(E, 9, 3, dtype, cuda, pattern.cam_pos)
    want = ba_edge.EdgeStreams.empty(E, 9, 3, dtype, cuda, pattern.cam_pos)
    ba_edge.ba_edge_blocks(*gargs, got, 0)
    ba_edge.ba_edge_blocks_plain(*gargs, want, 0)
    for a, b_ in zip(got.lane_major(), want.lane_major()):
        assert _rel(a, b_) < TOL[dtype]
    assert not got.rec[:, 81 + 9 + 27:].any()
    sums = ba_edge.ba_lm_sums(got, pattern.lm_edge)
    for a, b_, c in zip(sums, ba_edge.ba_lm_sums_plain(got, pattern.lm_edge),
                        ba_edge.ba_lm_sums(got, pattern.lm_edge)):
        assert _rel(a, b_) < TOL[dtype] and torch.equal(a, c)
    csum = ba_edge.ba_cam_sums(got, pattern.cam_rows)
    for a, b_, c in zip(csum, ba_edge.ba_cam_sums_plain(got,
                                                        pattern.cam_rows),
                        ba_edge.ba_cam_sums(got, pattern.cam_rows)):
        assert _rel(a, b_) < TOL[dtype] and torch.equal(a, c)
    Hll, b_l, W_lm = sums
    Hcc, b_p, W_cam = csum
    # K11: the landmarks at D = 3, the cameras' damping at D = 9
    lam = 1e-3 * Hll[0].abs().max()
    fl, fc = prob.free["sba_point_xyz"], prob.free["bal_camera"]
    _, hinv, hib = ba_inv.ba_block_inv(Hll, ba_inv.LANDMARK, fl, lam, b=b_l)
    hcc_d = ba_inv.ba_block_inv(Hcc, ba_inv.CAMERA, fc, lam,
                                want_inv=False)[0]
    assert torch.equal(hcc_d, ba_inv.ba_block_inv_plain(
        Hcc, ba_inv.CAMERA, fc, lam, want_inv=False)[0])
    C = pattern.n_cam
    gen = torch.Generator(device=cuda).manual_seed(9)
    xc = torch.randn((9, C), generator=gen, dtype=dtype, device=cuda)
    for kw in ({}, dict(hinv=hinv), dict(hinv=hinv, b=b_l, free=fl)):
        y = ba_coupling.ba_wtx(W_lm, pattern.lm_cam, xc, **kw)
        assert _rel(y, ba_coupling.ba_wtx_plain(W_lm, pattern.lm_cam, xc,
                                                **kw)) < TOL_BA[dtype]
        assert torch.equal(y, ba_coupling.ba_wtx(W_lm, pattern.lm_cam, xc,
                                                 **kw))
    v = ba_coupling.ba_wtx(W_lm, pattern.lm_cam, xc, hinv=hinv)
    for kw in (dict(base=b_p, free=fc),
               dict(hcc_d=hcc_d, x=xc, want_dot=True)):
        y = ba_coupling.ba_wv(W_cam, pattern.cam_rows, hib if "base" in kw
                              else v, **kw)
        yp = ba_coupling.ba_wv_plain(W_cam, pattern.cam_rows, hib
                                     if "base" in kw else v, **kw)
        if kw.get("want_dot"):
            assert _rel(y[1].sum(), yp[1].sum()) < TOL_BA[dtype]
            y, yp = y[0], yp[0]
        assert _rel(y, yp) < TOL_BA[dtype]
    sw = ba_coupling.ba_sandwich(W_cam, pattern.cam_rows, hinv, hcc_d)
    assert _rel(sw, ba_coupling.ba_sandwich_plain(
        W_cam, pattern.cam_rows, hinv, hcc_d)) < TOL_BA[dtype]
    # K11 at D = 9 on the preconditioner blocks, K4 at D = 9 applying them
    sinv = ba_inv.ba_block_inv(sw)[1]
    assert _rel(sinv, ba_inv.ba_block_inv_plain(sw)[1]) < _inv_tol(sw,
                                                                   dtype)
    y, part = jacobi_scale.lane_block_mv_dot(sinv, xc)
    yp, pp = jacobi_scale.lane_block_mv_dot_plain(sinv, xc)
    assert _rel(y, yp) < TOL[dtype]
    assert _rel(part.sum(), pp.sum()) < TOL[dtype] * 9
    # K12 at (9, 3), its records of 27 values
    pairs = pattern.schur_pairs()
    w_rec = ba_schur.ba_schur_records(W_lm.view(27, -1))
    assert torch.equal(w_rec, ba_schur.ba_schur_records_plain(
        W_lm.view(27, -1)))
    S = ba_schur.ba_schur_dense(pairs, W_lm, hinv, hcc_d, w_rec=w_rec)
    assert _rel(S, ba_schur.ba_schur_dense_plain(pairs, W_lm, hinv,
                                                 hcc_d)) < TOL_BA[dtype]
    assert torch.equal(S, ba_schur.ba_schur_dense(pairs, W_lm, hinv, hcc_d,
                                                  w_rec=w_rec))
    counts = kernels.launch_counts()
    for k in ("edge_lin_bal", "trial_chi2_bal", "trial_retract_groups",
              "ba_edge_blocks", "ba_lm_sums", "ba_cam_sums", "ba_block_inv",
              "ba_wtx", "ba_wv", "ba_sandwich", "lane_block_mv_dot",
              "ba_schur_dense", "ba_schur_records"):
        assert counts[k] > 0, k
    assert ba_inv.ba_block_inv.launches_by_width[9] >= 2
    assert jacobi_scale.lane_block_mv_dot.launches_by_width[9] == 1
    assert trial.trial_retract_groups.launches_by_type["bal_camera"] == 1


@pytest.mark.parametrize("dense", [True, False])
def test_bal_lm_on_gpu_matches_cpu(cuda, dense, monkeypatch):
    """LevenbergMarquardtSchurELL on a BAL file on the card against the same
    run on the CPU (plain versions), float64, on both routes: chi2 to 1e-9;
    K17 and K7 serve the BAL types (the generic linearization and the
    plain trial are not reached on the card)."""
    from openslam_g2o_torch.core import ba_ell
    from openslam_g2o_torch.kernels import trial
    if not dense:
        monkeypatch.setattr(ba_ell, "_DENSE_SCHUR_MAX_TP", -1)
    runs = {}
    for device in ("cpu", cuda):
        prob = _bal_scene(device, torch.float64, n_cams=24, n_points=600)
        if device != "cpu":
            def refuse(*a, **k):
                raise AssertionError("a plain route ran on the card")
            monkeypatch.setattr(trial, "retract_plain", refuse)
            monkeypatch.setattr(trial, "chi2_plain", refuse)
            monkeypatch.setattr(problem_mod, "linearize_edges", refuse)
        kernels.reset_launch_counts()
        _, stats = algorithms.optimize(
            prob, ba_ell.LevenbergMarquardtSchurELL(pcg_iters=40,
                                                    pcg_tol=1e-6),
            iterations=5)
        runs[str(device)] = ([s["chi2"] for s in stats],
                             kernels.launch_counts())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-9)
    counts = runs["cuda"][1]
    used = ("edge_lin_bal", "trial_chi2_bal", "trial_retract_groups",
            "ba_edge_blocks", "ba_lm_sums", "ba_cam_sums", "ba_block_inv",
            "ba_wtx", "ba_wv") + (("ba_schur_dense",) if dense
                                  else ("ba_sandwich", "lane_block_mv_dot"))
    assert all(counts[k] > 0 for k in used), counts
    assert trial.trial_retract_groups.launches_by_type["bal_camera"] > 0
    assert (counts["ba_schur_dense"] > 0) == dense
    assert not any(runs["cpu"][1].values())


# -- LM-PCG over several vertex groups: the pair kernels ---------------------

def _pair_world(kind, dtype, device):
    """A landmark world small enough for the CPU plain versions, with hubs:
    2D landmarks seen by up to ~100 poses (several PAIR_CHUNK chunks), or
    the 3D world's (6, 6), (6, 3), (3, 6), (3, 3) pairs."""
    from openslam_g2o_torch.apps.simulator import Simulator3D
    if kind == "2d":
        g, _ = Simulator2D(world_size=12.0, n_landmarks=40, seed=3).simulate(
            300)
    else:
        g, _ = Simulator3D(n_landmarks=60, seed=3).simulate(80)
    prob = g.compile(dtype=dtype, device=device)
    return prob, sparse.build_ell_pattern(prob)


@pytest.mark.parametrize("kind", ["2d", "3d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_kernels_match_plain_on_gpu(cuda, kind, dtype):
    """K2' (both passes: the stream, then the values of every pair and b of
    every group), K4' (a NaN factor; the used-slot layout), K5' in its
    three forms (one launch over every row group; the folded direction)
    and K8' against their plain versions at every (Dr, Dc) of the world,
    each run twice for the same bits; K3 and K4's lane_block_mv at every
    group width."""
    from openslam_g2o_torch.kernels import pair_ell
    prob, pat = _pair_world(kind, dtype, cuda)
    assert isinstance(pat, sparse.PairPattern)
    widths = {(p.dr, p.dc) for p in pat.pairs}
    assert widths == ({(3, 3), (3, 2), (2, 3), (2, 2)} if kind == "2d"
                      else {(6, 6), (6, 3), (3, 6), (3, 3)})
    if kind == "2d":                    # a landmark of several chunks
        hub = pat.pairs[pat.square["point_xy"]].table
        assert int(torch.diff(hub.ptr).max()) > pair_ell.PAIR_CHUNK
    tol = TOL[dtype] * 10
    kernels.reset_launch_counts()
    plan = pat.plan
    lin = sparse.pair_linearize(prob)
    stream = pair_ell.pair_stream(plan, lin)
    assert torch.equal(stream, pair_ell.pair_stream(plan, lin))
    assert _rel(stream[:plan.stream_len],
                pair_ell.pair_stream_plain(plan, lin)) < tol
    outs = pair_ell.pair_assemble(plan, stream)
    again = pair_ell.pair_assemble(plan, stream)
    plain = pair_ell.pair_assemble_plain(plan, stream[:plan.stream_len])
    for o, a, p in zip(outs, again, plain):
        assert torch.equal(o, a)
        assert _rel(o, p) < tol
    n = len(pat.pairs)
    values, bT = outs[:n], dict(zip(pat.groups, outs[n:]))
    lam = torch.tensor(0.1, dtype=dtype, device=cuda)
    linv, extra = {}, {}
    for g, i in pat.square.items():
        out = damp_chol.damp_chol(values[i], prob.free[g], bT[g], lam)
        ref = damp_chol.damp_chol_plain(values[i], prob.free[g], bT[g], lam)
        for a, b in zip(out, ref):
            assert _rel(a, b) < TOL_B[dtype]
        linv[g], extra[g] = out[0], out[3]
        x = torch.randn((pat.widths[g], pat.counts[g]), dtype=dtype,
                        device=cuda)
        for tr in (False, True):
            assert _rel(jacobi_scale.lane_block_mv(linv[g], x, tr),
                        jacobi_scale.lane_block_mv_plain(linv[g], x, tr)) \
                < TOL_B[dtype]
    # a NaN factor on row 1 of the first group spreads only where it is read
    g0 = pat.groups[0]
    bad = {**linv, g0: linv[g0].clone()}
    bad[g0][:, 1] = float("nan")
    for pt, v in zip(pat.pairs, values):
        ext = extra[pt.rg] if pt.square else None
        for fac in (linv, bad):
            s = pair_ell.pair_scale(pt.nb, pt.rowptr, v, fac[pt.rg],
                                    fac[pt.cg], ext, pt.used)
            p = pair_ell.pair_scale_plain(pt.nb, pt.rowptr, v, fac[pt.rg],
                                          fac[pt.cg], ext)
            assert s.shape == (pt.dr * pt.dc, pt.used)
            assert torch.equal(torch.isnan(s), torch.isnan(p))
            again = pair_ell.pair_scale(pt.nb, pt.rowptr, v, fac[pt.rg],
                                        fac[pt.cg], ext, pt.used)
            assert torch.equal(s.view(torch.uint8), again.view(torch.uint8))
            fin = torch.isfinite(p)
            assert _rel(s[fin], p[fin]) < TOL_B[dtype]
            # an all-zero slot without damping stays an exact zero
            rows, slots = pair_ell.used_slots(pt.rowptr)
            zero = (v == 0).all(dim=1)[slots, rows]
            if pt.square:
                zero &= slots != 0
            assert (s[:, zero] == 0).all()
    svals = pat.scale(values, linv, extra)
    lay = pat.flat_layout(svals)
    flat = pair_ell.FlatLayout.__new__(pair_ell.FlatLayout)
    flat.__dict__.update(lay.__dict__)
    flat.on_card = False                       # the plain versions on it
    x = torch.randn(lay.n, dtype=dtype, device=cuda)
    r = torch.randn(lay.n, dtype=dtype, device=cuda)
    y = pair_ell.pair_spmv(lay, x)
    assert torch.equal(y, pair_ell.pair_spmv(lay, x))
    assert _rel(y, pair_ell.pair_spmv_plain(flat, x)) < tol
    yd, part = pair_ell.pair_spmv_dot(lay, x)
    assert torch.equal(yd, y) and part.shape == (lay.blocks,)
    assert _rel(part.sum(), torch.dot(x, y)) < tol
    scal = torch.zeros(cg_step.N_SCALARS, dtype=dtype, device=cuda)
    scal[cg_step.BETA] = 0.37
    p_new = torch.empty_like(x)
    yp, part = pair_ell.pair_spmv_dot_p(lay, scal, x, r, p_new)
    assert _rel(p_new, scal[cg_step.BETA] * x + r) < tol
    assert _rel(yp, pair_ell.pair_spmv_plain(flat, p_new)) < tol
    assert _rel(part.sum(), torch.dot(p_new, yp)) < tol
    yp2, part2 = pair_ell.pair_spmv_dot_p(lay, scal, x, r,
                                          torch.empty_like(x))
    assert torch.equal(yp2, yp) and torch.equal(part2, part)
    hi = pair_ell.pair_gershgorin(lay)
    assert torch.equal(hi, pair_ell.pair_gershgorin(lay))
    assert _rel(hi, pair_ell.pair_gershgorin_plain(flat)) < tol
    counts = kernels.launch_counts()
    for k in ("pair_stream", "pair_assemble", "pair_scale", "pair_spmv",
              "pair_spmv_dot", "pair_spmv_dot_p", "pair_gershgorin",
              "damp_chol", "lane_block_mv"):
        assert counts[k] > 0, k
    if kind == "2d":
        assert damp_chol.damp_chol.launches_by_width[2] >= 1
        assert jacobi_scale.lane_block_mv.launches_by_width[2] >= 2


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_pair_flat_shapes_on_gpu(cuda, kind, monkeypatch):
    """K5' and K8' give the same products with every team shape (1, 4 and
    32 lanes a row), and the same bits over one launch a row group."""
    from openslam_g2o_torch.kernels import pair_ell
    prob, pat = _pair_world(kind, torch.float64, cuda)
    values, bT = sparse.assemble_pairs(prob, pat)
    lam = torch.tensor(0.1, dtype=torch.float64, device=cuda)
    linv, extra = {}, {}
    for g, i in pat.square.items():
        linv[g], _, _, extra[g] = damp_chol.damp_chol(
            values[i], prob.free[g], bT[g], lam)
    svals = pat.scale(values, linv, extra)
    ref = pat.flat_layout(svals)
    assert len(ref.launches) == 1
    x = torch.randn(ref.n, dtype=torch.float64, device=cuda)
    y0, hi0 = pair_ell.pair_spmv(ref, x), pair_ell.pair_gershgorin(ref)
    for lanes in (1, 4, 32):
        monkeypatch.setattr(pair_ell, "flat_shape",
                            lambda groups: [lanes] * len(groups))
        lay = pat.flat_layout(svals)
        assert _rel(pair_ell.pair_spmv(lay, x), y0) < 1e-13
        assert _rel(pair_ell.pair_gershgorin(lay), hi0) < 1e-13
    monkeypatch.undo()
    monkeypatch.setattr(pair_ell, "MAX_GROUPS", 1)
    lay = pat.flat_layout(svals)
    assert len(lay.launches) == len(pat.groups) and lay.blocks == ref.blocks
    r = torch.randn_like(x)
    scal = torch.zeros(10, dtype=torch.float64, device=cuda)
    scal[9] = 0.37
    p1, p2 = torch.empty_like(x), torch.empty_like(x)
    kernels.reset_launch_counts()
    y1, part1 = pair_ell.pair_spmv_dot_p(ref, scal, x, r, p1)
    y2, part2 = pair_ell.pair_spmv_dot_p(lay, scal, x, r, p2)
    assert pair_ell.pair_spmv_dot_p.launches == 1 + len(pat.groups)
    assert torch.equal(y1, y2) and torch.equal(p1, p2)
    assert torch.equal(part1, part2)
    assert torch.equal(pair_ell.pair_spmv(lay, x), y0)
    assert torch.equal(pair_ell.pair_gershgorin(lay), hi0)


@pytest.mark.parametrize("cheby", [0, 4])
def test_pair_lm_pcg_on_gpu_matches_cpu(cuda, cheby, monkeypatch):
    """LM-PCG over several vertex groups on the card against the same run
    on the CPU (plain versions), float64: chi2 to 1e-9; the pair kernels,
    K3 / K4 at D = 2, K17 and K7 launch, no plain route is reached."""
    from openslam_g2o_torch.kernels import trial
    runs = {}
    for device in ("cpu", cuda):
        g, _ = Simulator2D(world_size=12.0, n_landmarks=40, seed=3).simulate(
            300)
        prob = g.compile(dtype=torch.float64, device=device)
        if device != "cpu":
            def refuse(*a, **k):
                raise AssertionError("a plain route ran on the card")
            monkeypatch.setattr(trial, "retract_plain", refuse)
            monkeypatch.setattr(trial, "chi2_plain", refuse)
            monkeypatch.setattr(problem_mod, "linearize_edges", refuse)
        kernels.reset_launch_counts()
        _, stats = algorithms.optimize(prob, algorithms.LevenbergMarquardtPCG(
            pcg_iters=200, pcg_tol=1e-10, pcg_cheby=cheby), iterations=5)
        runs[str(device)] = ([s["chi2"] for s in stats],
                             kernels.launch_counts())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-9)
    counts = runs["cuda"][1]
    used = ("pair_stream", "pair_assemble", "pair_scale", "pair_spmv",
            "pair_spmv_dot", "damp_chol", "lane_block_mv", "cg_update_xr",
            "edge_lin_se2", "edge_lin_se2_xy", "trial_retract_groups",
            "trial_chi2_se2", "trial_chi2_se2_xy", "lm_outcome") + (
        ("pair_gershgorin", "chebyshev_update", "cg_update_p") if cheby
        else ("pair_spmv_dot_p",))
    assert all(counts[k] > 0 for k in used), counts
    by_type = trial.trial_retract_groups.launches_by_type
    assert by_type["se2"] == by_type["point_xy"] == counts[
        "trial_retract_groups"] > 0
    assert counts["spmv_dot"] == counts["spmv_dot_p"] == 0
    if not cheby:        # the two-launch step: one cg_update_xr a product
        assert counts["cg_update_p"] == 0
        assert counts["cg_update_xr"] == (counts["pair_spmv_dot"]
                                          + counts["pair_spmv_dot_p"])
    assert not any(runs["cpu"][1].values())
