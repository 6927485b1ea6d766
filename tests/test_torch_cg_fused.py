"""The two-launch CG step (kernels/cg_step.py `spmv_dot_p` and
`cg_update_xr` with an arrival counter; core/solvers.py `pcg_solve` without
a preconditioner on an operator that offers `matvec_dot_p`) on its plain
versions, float64 on the CPU.

* One step against the three-call sequence `cg_update_xr`, `cg_update_p`
  (z = r), `spmv_dot` from the same state, at block widths 3 and 6 in both
  dtypes: the scalar buffer, x, r, the next direction, H p and the partial
  sums bit for bit (the same operations on the same values); and where
  p . hp < 0 or NaN turns pd off, in both dtypes.
* `pcg_solve` on an `EllOperator` (the Jacobi-scaled damped system of a
  200-pose serpentine, 3x3 blocks) against JAX `pcg_solve`
  (openslam_g2o_tpu/core/solvers.py:213) on the same matrix, at the
  tolerances of tests/test_torch_cg_step.py: the same ok, the same number of
  matvecs (CG iterations) and x to rtol 1e-10 of the largest |x| (the same
  float64 recurrence; the matvecs sum in another order). Cases: unroll 1
  and 2 under both stop norms, a warm start, an indefinite system (pd goes
  off and stays off: ok False, x zero), a zero right-hand side (no
  iteration) and a spare p buffer filled with NaN (the first iteration
  must not read it); the warm start and the indefinite system also at
  unroll 1 under the true norm. The port's solve must take the two-launch
  form: one `matvec_dot` (the first iteration) and `matvec_dot_p` for the
  others.
* The SE2 and SE3 LM-PCG chi2 trajectories (`lm_pcg_optimize_fused`, 5
  iterations) against JAX at rtol 1e-8 (as tests/test_torch_lm_pcg.py),
  and equal bit for bit to the port's own three-launch run (the operator's
  fused form taken away).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.apps import simulator as jsim
from openslam_g2o_tpu.core import algorithms as jalg
from openslam_g2o_tpu.core import solvers as jsolvers
from openslam_g2o_tpu.core.problem import robust_chi2 as j_robust_chi2
from openslam_g2o_tpu.core.sparse import build_ell_pattern as j_pattern

from openslam_g2o_torch.apps import simulator as tsim
from openslam_g2o_torch.core import algorithms as talg
from openslam_g2o_torch.core import solvers as tsolvers
from openslam_g2o_torch.core import sparse as tsparse
from openslam_g2o_torch.kernels import cg_step, damp_chol, jacobi_scale
from tests.test_torch_assembly import ell_to_dense

torch.set_num_threads(1)

RTOL = 1e-10


def _scaled(prob, lam=0.7):
    """(pattern, Jacobi-scaled damped values, scaled rhs) of a pose graph
    at its start."""
    pattern = tsparse.build_ell_pattern(prob)
    values, bT = tsparse.assemble_ell(prob, pattern)
    g = pattern.group
    lam = torch.tensor(lam, dtype=prob.dtype)
    linv, _, bhat, extra = damp_chol.damp_chol(values, prob.free[g], bT[g],
                                               lam)
    return pattern, jacobi_scale.jacobi_scale(pattern.nb, values, linv,
                                              extra), bhat


def _serpentine(dtype=torch.float64):
    return tsim.synthetic_pose_graph_2d(n_poses=200, grid=10, dtype=dtype,
                                        device="cpu")[0]


def _sphere(dtype=torch.float64):
    return tsim.create_sphere(n_laps=6, n_per_lap=20, radius=15.0,
                              seed=3)[0].compile(dtype=dtype, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [3, 6])
def test_fused_plain_step_equals_three_call_sequence(D, dtype):
    prob = _serpentine(dtype) if D == 3 else _sphere(dtype)
    pattern, S, bhat = _scaled(prob)
    r0, p0, rr0, bb0 = cg_step.cg_residual(bhat, torch.zeros_like(bhat))
    scal0 = cg_step.new_scalars(r0)
    cg_step.cg_start(scal0, rr0, rr0, bb0, 1e-6, True)
    hp0, pap0 = cg_step.spmv_dot(pattern.nb, S, p0)
    arrivals = torch.zeros(1, dtype=torch.int32)
    out = {}
    for route in ("two", "three"):
        x, r, p, sc = (torch.zeros_like(bhat), r0.clone(), p0.clone(),
                       scal0.clone())
        rr = cg_step.cg_update_xr(sc, pap0, x, r, p, hp0,
                                  arrivals if route == "two" else None)
        if route == "three":
            cg_step.cg_update_p(sc, rr, rr, r, p, True)
            hp, part = cg_step.spmv_dot(pattern.nb, S, p)
            p_next = p
        else:
            p_next = torch.full_like(p, float("nan"))
            hp, part = cg_step.spmv_dot_p(pattern.nb, S, sc, p, r, p_next)
        out[route] = (sc, x, r, p_next, hp, part)
    for a, b in zip(out["two"], out["three"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert float(out["two"][0][cg_step.CONT]) == 1.0
    assert float(out["two"][0][cg_step.BETA]) > 0.0
    with pytest.raises(ValueError, match="another buffer"):
        cg_step.spmv_dot_p(pattern.nb, S, out["two"][0], p0, r0, p0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("curvature", ["negative", "nan"])
def test_fused_plain_step_turns_pd_off_as_the_three_call_sequence(
        curvature, dtype):
    """p . hp < 0 or NaN in the step: both forms keep x and r, store pd 0,
    alpha 0 and the continue flag 0, the same scalar buffer bit for bit,
    and the counter ends at zero."""
    pattern, S, bhat = _scaled(_serpentine(dtype))
    r0, p0, rr0, bb0 = cg_step.cg_residual(bhat, torch.zeros_like(bhat))
    scal0 = cg_step.new_scalars(r0)
    cg_step.cg_start(scal0, rr0, rr0, bb0, 1e-6, True)
    hp0, pap0 = cg_step.spmv_dot(pattern.nb, S, p0)
    pap0 = -pap0 if curvature == "negative" else pap0 * float("nan")
    arrivals = torch.zeros(1, dtype=torch.int32)
    out = {}
    for route in ("two", "three"):
        x, r, p, sc = (torch.zeros_like(bhat), r0.clone(), p0.clone(),
                       scal0.clone())
        rr = cg_step.cg_update_xr(sc, pap0, x, r, p, hp0,
                                  arrivals if route == "two" else None)
        if route == "three":
            cg_step.cg_update_p(sc, rr, rr, r, p, True)
        out[route] = (sc, x, r)
    for a, b in zip(out["two"], out["three"]):
        assert torch.equal(a, b)
    sc, x, r = out["two"]
    assert not x.any() and torch.equal(r, r0) and not arrivals.any()
    for slot in (cg_step.PD, cg_step.PD_NEXT, cg_step.ALPHA, cg_step.CONT):
        assert float(sc[slot]) == 0.0


class _CountingOperator(tsparse.EllOperator):
    """EllOperator that counts its calls by form."""

    def __init__(self, *a):
        super().__init__(*a)
        self.calls = {"matvec": 0, "matvec_dot": 0, "matvec_dot_p": 0}

    def __call__(self, xT):
        self.calls["matvec"] += 1
        return super().__call__(xT)

    def matvec_dot(self, pT):
        self.calls["matvec_dot"] += 1
        return super().matvec_dot(pT)

    def matvec_dot_p(self, *a):
        self.calls["matvec_dot_p"] += 1
        return super().matvec_dot_p(*a)


@pytest.fixture(scope="module")
def system():
    pattern, S, bhat = _scaled(_serpentine())
    return pattern, S, bhat, ell_to_dense(pattern.nb, S)


CASES = {
    "unroll1-precond": dict(unroll=1, norm="precond"),
    "unroll2-precond": dict(unroll=2, norm="precond"),
    "unroll1-true": dict(unroll=1, norm="true"),
    "unroll2-true": dict(unroll=2, norm="true"),
    "warm": dict(unroll=2, norm="precond"),
    "indefinite": dict(unroll=2, norm="precond"),
    "zero-rhs": dict(unroll=2, norm="precond"),
    "nan-spare": dict(unroll=2, norm="precond"),
    "warm-unroll1": dict(unroll=1, norm="true"),
    "indefinite-unroll1": dict(unroll=1, norm="true"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pcg_solve_on_ell_operator_matches_jax(system, case, monkeypatch):
    pattern, S, bhat, dense = system
    kw = dict(CASES[case], max_iter=60, tol=1e-9)
    S, b = S.clone(), bhat.clone()
    if case.startswith("indefinite"):
        diag = S[0].view(3, 3, -1)
        for a in range(3):
            diag[a, a] -= 1.5                # negative curvature
        dense = ell_to_dense(pattern.nb, S)
    if case == "zero-rhs":
        b.zero_()
    if case == "nan-spare":
        monkeypatch.setattr(tsolvers, "_spare",
                            lambda v: torch.full_like(v, float("nan")))
    N = b.shape[1]
    x0 = None
    if case.startswith("warm"):
        x0 = np.linalg.solve(dense, b.T.reshape(-1).numpy()).reshape(N, 3).T
        x0 = x0 + 1e-6 * np.random.default_rng(4).normal(size=x0.shape)
    counts = [0]

    def bump():
        counts[0] += 1

    def jmv(xT):
        jax.debug.callback(bump)
        return {"se2": (jnp.asarray(dense) @ xT["se2"].T.reshape(-1))
                .reshape(N, 3).T}

    jx, jok = jsolvers.pcg_solve(
        jmv, {"se2": jnp.asarray(b.numpy())},
        x0=None if x0 is None else {"se2": jnp.asarray(x0)}, **kw)
    jax.block_until_ready(jx)
    jax.effects_barrier()
    op = _CountingOperator(pattern, S)
    tx, tok = tsolvers.pcg_solve(
        op, {"se2": b}, x0=None if x0 is None else {
            "se2": torch.as_tensor(x0)}, **kw)
    jx = np.asarray(jx["se2"])
    assert bool(tok) == bool(jok)
    iters = op.calls["matvec_dot"] + op.calls["matvec_dot_p"]
    assert op.calls["matvec"] + iters == counts[0]
    if iters:                                  # the two-launch form
        assert op.calls["matvec_dot"] == 1
    np.testing.assert_allclose(tx["se2"].numpy(), jx, rtol=RTOL,
                               atol=RTOL * max(np.abs(jx).max(), 1e-300))
    assert torch.isfinite(tx["se2"]).all()
    if case.startswith("indefinite"):
        assert not bool(tok) and not tx["se2"].any() and iters < 40
    elif case == "zero-rhs":
        assert bool(tok) and not tx["se2"].any() and iters == 0
    else:
        assert bool(tok) and iters > 2
        if case.startswith("warm"):
            assert iters < 40


def _trajectory(prob, jprob, cheby=0):
    jpat = j_pattern(jprob)
    jlam = jalg._lambda_init_pcg(jprob, jpat, jprob.params,
                                 jnp.asarray(1e-5, jnp.float64))
    jout = jalg.lm_pcg_optimize_fused(
        jprob, jpat, jprob.params, jlam, jnp.asarray(2.0, jnp.float64),
        j_robust_chi2(jprob), n_iters=5, pcg_iters=60, pcg_tol=1e-6)
    alg = talg.LevenbergMarquardtPCG()
    state = alg.init(prob)
    tout = talg.lm_pcg_optimize_fused(
        prob, alg.pattern(prob), state["params"], state["lam"], state["ni"],
        state["chi2"], n_iters=5, pcg_iters=60, pcg_tol=1e-6)
    return np.asarray(jout[4]), tout[4]


@pytest.mark.parametrize("graph", ["se2", "se3"])
def test_lm_pcg_chi2_trajectory_unchanged(graph, monkeypatch):
    if graph == "se2":
        kw = dict(n_poses=300, grid=10)
        prob = tsim.synthetic_pose_graph_2d(**kw, device="cpu")[0]
        jprob = jsim.synthetic_pose_graph_2d(**kw)[0]
    else:
        kw = dict(n_laps=8, n_per_lap=25, radius=20.0, seed=1)
        prob = tsim.create_sphere(**kw)[0].compile(dtype=torch.float64,
                                                    device="cpu")
        jprob = jsim.create_sphere(**kw)[0].compile(dtype=jnp.float64)
    calls = [0]
    fused = tsparse.EllOperator.matvec_dot_p

    def spy(self, *a):
        calls[0] += 1
        return fused(self, *a)

    monkeypatch.setattr(tsparse.EllOperator, "matvec_dot_p", spy)
    jtraj, two = _trajectory(prob, jprob)
    assert calls[0] > 10                       # the two-launch form ran
    np.testing.assert_allclose(two.numpy(), jtraj, rtol=1e-8)
    monkeypatch.delattr(tsparse.EllOperator, "matvec_dot_p")
    _, three = _trajectory(prob, jprob)
    assert torch.equal(two, three)
