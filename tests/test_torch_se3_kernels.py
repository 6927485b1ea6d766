"""Plain versions of the SE3 kernels and of the 6x6 instantiations against
the JAX package, float64 on the CPU: K16 (`edge_se3_blocks`), kernel C, K3
(`damp_chol`), K4 (`jacobi_scale`, `lane_block_mv`), kernel A / `spmv_dot`,
`gershgorin_bound` and K7 for SE3 (`retract_se3`, `se3_edge_chi2`).

One SE3 pose graph is built through the JAX Graph API and carried into the
port with interop.problem_from_numpy: a 30-pose helix with closures, a full
6x6 information matrix, two fixed vertices, stored quaternions with q_w < 0
and with |q| = 1.0005, a repeated and a reversed edge and one vertex without
edges. Robust kernels are set per case.

Tolerances: rtol 1e-10 for what passes through the forward-mode Jacobian
(jacfwd in JAX, a jvp in the port: the same float64 operations under another
rule set), 1e-12 for the rest, each with an absolute floor of that many
times the largest reference entry for values that cancel to ~0.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.core import algorithms as jalg
from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core import robust as jrobust
from openslam_g2o_tpu.core import solvers as jsolvers
from openslam_g2o_tpu.core import sparse as jsparse
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.utils import np_lie

from openslam_g2o_torch.core import algorithms as talg
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core import robust as trobust
from openslam_g2o_torch.core import solvers as tsolvers
from openslam_g2o_torch.core import sparse as tsparse
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import edge_se3, retract_chi2
from openslam_g2o_torch.kernels.chebyshev import gershgorin_bound
from openslam_g2o_torch.kernels.cg_step import spmv_dot
from openslam_g2o_torch.kernels.damp_chol import damp_chol, damp_chol_plain
from openslam_g2o_torch.kernels.jacobi_scale import (
    jacobi_scale, lane_block_mv)
from openslam_g2o_torch.kernels.spmv import block_ell_spmv

torch.set_num_threads(1)

RTOL_JAC = 1e-10
RTOL = 1e-12
N_POSES = 30


def _small_quat(rng, scale):
    v = rng.normal(0, scale, 3)
    return np.array([*v, np.sqrt(1 - v @ v)])


def build_graph(Graph, kernel="None", delta=1.0, seed=5, n=N_POSES):
    """The same SE3 pose graph through either package's Graph API; `kernel`
    is the robust kernel of the closure edges."""
    rng = np.random.default_rng(seed)
    g = Graph()
    step = np.concatenate([[1.0, 0.0, 0.1], _small_quat(rng, 0.1)])
    gt = [np.array([0, 0, 0, 0, 0, 0, 1.0])]
    for _ in range(n - 1):
        gt.append(np_lie.se3_compose(gt[-1], step))
    for i, p in enumerate(gt):
        noisy = np_lie.se3_compose(p, np.concatenate(
            [rng.normal(0, 0.05, 3), _small_quat(rng, 0.02)]))
        if i % 3 == 1:
            noisy[3:] *= -1.0
        if i % 4 == 2:
            noisy[3:] *= 1.0005
        g.add_vertex(i, "se3", noisy, fixed=i in (0, 13))
    g.add_vertex(n, "se3", [5.0, 5.0, 1.0, 0.0, 0.0, 0.0, 1.0])   # no edges
    M = rng.normal(size=(6, 6))
    info = M @ M.T + np.diag([400.0, 400.0, 400.0, 2500.0, 2500.0, 2500.0])
    rel = lambda i, j: np_lie.se3_compose(np_lie.se3_inverse(gt[i]), gt[j])
    noise = lambda: np.concatenate([rng.normal(0, 0.02, 3),
                                    _small_quat(rng, 0.01)])
    for i in range(n - 1):
        g.add_edge("edge_se3", (i, i + 1),
                   np_lie.se3_compose(rel(i, i + 1), noise()), info)
    for i in range(0, n - 7, 3):
        z = np_lie.se3_compose(rel(i, i + 7), noise())
        if i % 6 == 0:
            z[:3] += np.array([0.8, -0.5, 0.3])        # outlier: robust tail
        g.add_edge("edge_se3", (i, i + 7), z, info, kernel=kernel,
                   kernel_delta=delta)
    g.add_edge("edge_se3", (3, 4), rel(3, 4), info)          # repeated pair
    g.add_edge("edge_se3", (9, 2), rel(9, 2), 2 * info)      # reversed
    return g


def _pair(kernel="None", delta=1.0):
    jprob = build_graph(JGraph, kernel, delta).compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    return jprob, tprob


@pytest.fixture(scope="module")
def system():
    jprob, tprob = _pair("Huber", 1.0)
    pattern = tsparse.build_ell_pattern(tprob)
    values, bT = tsparse.assemble_ell(tprob, pattern)
    return jprob, tprob, pattern, values, bT


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def ell_to_dense(nb, values, D=6):
    """Expand block-ELL (nb [K, N], values [K, D*D, N]) to dense [DN, DN]."""
    nb, values = np.asarray(nb), np.asarray(values)
    K, N = nb.shape
    H = np.zeros((D * N, D * N))
    rows = np.arange(N)
    for k in range(K):
        for a in range(D):
            for c in range(D):
                np.add.at(H, (D * rows + a, D * nb[k] + c),
                          values[k, D * a + c])
    return H


# ---------------------------------------------------------------------------
# K16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", jrobust.kernel_names())
def test_edge_se3_blocks_match_jax(kernel):
    """Every edge's four J_s^T rho' Omega J_t blocks and two gradients
    against JAX's linearize + _edge_blocks, for every robust kernel (the
    closures carry it; the odometry group has none) and with fixed
    vertices, read back from the stream columns."""
    jprob, tprob = _pair(kernel, 0.7)
    blocks, bvecs = jsparse._edge_blocks(jprob, jproblem.linearize(jprob))
    pattern = tsparse.build_ell_pattern(tprob)
    assert pattern.d == 6
    hblk, bblk = tsparse.edge_blocks(tprob, pattern)
    assert hblk.shape == (36, 4 * pattern.e_cols)
    assert bblk.shape == (6, 2 * pattern.e_cols)
    E = pattern.e_cols
    assert len(tprob.static.egroups) == (1 if kernel == "None" else 2)
    for eg in tprob.static.egroups:
        assert eg.kernel_id == trobust.kernel_id(
            kernel if "#" in eg.key else "None")
        c0, n = pattern.col0[eg.key], eg.count
        for s in range(2):
            _close(bblk[:, s * E + c0:s * E + c0 + n].T,
                   bvecs[(eg.key, s)], RTOL_JAC)
            for t in range(2):
                q = 2 * s + t
                got = hblk[:, q * E + c0:q * E + c0 + n].T.reshape(n, 6, 6)
                _close(got, blocks[(eg.key, s, t)], RTOL_JAC)
    # the columns of the fixed vertices 0 and 13 are zero: so are the
    # blocks and gradients of their slots
    ea = tprob.edges["edge_se3"]
    fixed_i = tprob.free["se3"][ea.indices[0].long()] == 0
    assert fixed_i.any()
    c0 = pattern.col0["edge_se3"]
    cols = c0 + torch.nonzero(fixed_i)[:, 0]
    assert not hblk[:, cols].any() and not bblk[:, cols].any()


def test_edge_se3_blocks_wrapper_checks_arguments(system):
    _, tprob, pattern, _, _ = system
    ea = tprob.edges["edge_se3"]
    E = pattern.e_total
    hblk = torch.empty((36, 4 * E), dtype=torch.float64)
    bblk = torch.empty((6, 2 * E), dtype=torch.float64)
    args = [tprob.params["se3"], tprob.free["se3"], ea.indices[0],
            ea.indices[1], ea.measurement, ea.information, ea.delta, 0,
            hblk, bblk, 0]
    edge_se3.edge_se3_blocks(*args)
    assert edge_se3.edge_se3_blocks.launches == 0
    bad = list(args)
    bad[0] = tprob.params["se3"][:, :3].contiguous()
    with pytest.raises(ValueError, match=r"\[N, 7\]"):
        edge_se3.edge_se3_blocks(*bad)
    bad = list(args)
    bad[8] = torch.empty((9, 4 * E), dtype=torch.float64)
    with pytest.raises(ValueError, match="hblk"):
        edge_se3.edge_se3_blocks(*bad)
    bad = list(args)
    bad[7] = 99
    with pytest.raises(ValueError, match="robust kernel"):
        edge_se3.edge_se3_blocks(*bad)
    bad = list(args)
    bad[10] = E
    with pytest.raises(ValueError, match="does not fit"):
        edge_se3.edge_se3_blocks(*bad)


# ---------------------------------------------------------------------------
# kernel C, kernel A, lambda init
# ---------------------------------------------------------------------------

def test_assembled_ell_matches_dense_system(system):
    jprob, tprob, pattern, values, bT = system
    H, b, _ = jproblem.build_dense_system(jprob, add_fixed_diag=False)
    assert values.shape == (pattern.k, 36, pattern.n)
    _close(ell_to_dense(pattern.nb, values), H, RTOL_JAC)
    _close(bT["se3"].T.reshape(-1), b, RTOL_JAC)
    v2, b2 = tsparse.assemble_ell(tprob, pattern)
    assert torch.equal(values, v2) and torch.equal(bT["se3"], b2["se3"])
    # slot 0 is the row's own block, also for the vertex without edges
    np.testing.assert_array_equal(pattern.nb[0].numpy(),
                                  np.arange(pattern.n))
    assert not values[:, :, N_POSES].any()


def test_spmv_and_spmv_dot_match_dense(system):
    _, _, pattern, values, _ = system
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(6, pattern.n)))
    want = ell_to_dense(pattern.nb, values) @ x.T.reshape(-1).numpy()
    y = block_ell_spmv(pattern.nb, values, x)
    _close(y.T.reshape(-1), want)
    hp, partials = spmv_dot(pattern.nb, values, x)
    assert torch.equal(hp, y)
    _close(partials.sum(), float((x * y).sum()))
    op = tsparse.EllOperator(pattern, values)
    assert torch.equal(op.split(op(op.flatten({"se3": x})))["se3"], y)
    with pytest.raises(ValueError, match="block width|D"):
        block_ell_spmv(pattern.nb, values, x[:4].contiguous())


def test_lambda_init_matches_jax(system):
    jprob, tprob, pattern, _, _ = system
    jl = jalg._lambda_init_pcg(jprob, jsparse.build_ell_pattern(jprob),
                               jprob.params, jnp.asarray(1e-5, jnp.float64))
    tl = talg._lambda_init_pcg(tprob, pattern, tprob.params,
                               torch.tensor(1e-5, dtype=torch.float64))
    _close(tl, jl, RTOL_JAC)


# ---------------------------------------------------------------------------
# K3 and K4 at D = 6
# ---------------------------------------------------------------------------

def _random_diag_system(seed, n=50, k=3, D=6):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, D, D))
    A = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(D)
    values = rng.normal(size=(k, D * D, n))
    values[0] = A.reshape(n, D * D).T
    free = np.ones(n)
    free[[0, 11]] = 0.0
    return values, A, free, rng.normal(size=(D, n))


def _lane(blocks):
    blocks = np.asarray(blocks)
    D = blocks.shape[-1]
    return blocks.transpose(1, 2, 0).reshape(D * D, -1)


@pytest.mark.parametrize("D", [4, 5, 6])
def test_batched_chol_match_jax_beyond_the_closed_form(D):
    """D > 3: JAX factors with jnp.linalg.cholesky, the port with the same
    scalar recurrence as for D <= 3."""
    rng = np.random.default_rng(D)
    M = rng.normal(size=(40, D, D))
    A = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(D)
    _close(tsolvers.batched_chol_inv_lower(torch.as_tensor(A)),
           jsolvers.batched_chol_inv_lower(jnp.asarray(A)), 1e-11)
    L = tsolvers.batched_chol_lower(torch.as_tensor(A)).numpy()
    _close(L, jsolvers.batched_chol_lower(jnp.asarray(A)), 1e-11)
    _close(L @ L.transpose(0, 2, 1), A)
    assert not np.triu(L, 1).any()


@pytest.mark.parametrize("seed,lam", [(0, 1e-3), (1, 0.7), (2, 250.0)])
def test_damp_chol_6x6_matches_jax_factors(seed, lam):
    values, A, free, b = _random_diag_system(seed)
    extra = lam * free + (1.0 - free)
    damped = jnp.asarray(A + extra[:, None, None] * np.eye(6))
    linv, lchol, bhat, extra_t = damp_chol(
        torch.as_tensor(values), torch.as_tensor(free), torch.as_tensor(b),
        torch.tensor(lam, dtype=torch.float64))
    assert linv.shape == lchol.shape == (36, 50) and bhat.shape == (6, 50)
    jlinv = np.asarray(jsolvers.batched_chol_inv_lower(damped))
    _close(linv, _lane(jlinv), 1e-11)
    _close(lchol, _lane(jsolvers.batched_chol_lower(damped)), 1e-11)
    _close(extra_t, extra)
    _close(bhat, np.einsum("nab,bn->an", jlinv, b), 1e-11)
    assert extra_t[0] == 1.0 and extra_t[11] == 1.0 and extra_t[1] == lam
    upper = [6 * a + c for a in range(6) for c in range(a + 1, 6)]
    assert not linv[upper].any() and not lchol[upper].any()


def test_damp_chol_non_spd_6x6_block_fails_in_both_packages():
    """A negative pivot in the middle of a 6x6 block: jnp.linalg.cholesky
    marks the whole block NaN, the port's recurrence the entries from the
    bad pivot on. Both give a NaN factor and a NaN bhat for that block and
    finite ones elsewhere, which is all the LM retry reads."""
    values, A, free, b = _random_diag_system(3)
    A[5, 2, 2] = -50.0
    values[0, :, 5] = A[5].reshape(36)
    lam = 1e-3
    extra = lam * free + (1.0 - free)
    damped = jnp.asarray(A + extra[:, None, None] * np.eye(6))
    jlinv = _lane(jsolvers.batched_chol_inv_lower(damped))
    linv, lchol, bhat, _ = damp_chol(
        torch.as_tensor(values), torch.as_tensor(free), torch.as_tensor(b),
        torch.tensor(lam, dtype=torch.float64))
    assert np.isnan(jlinv[:, 5]).all()
    nan_at = torch.isnan(lchol[:, 5]).view(6, 6)
    assert not nan_at[:2].any() and nan_at[2, 2] and nan_at[5, 2:].all()
    assert torch.isnan(linv[:, 5]).any() and torch.isnan(bhat[:, 5]).any()
    ok = np.arange(values.shape[2]) != 5
    _close(linv[:, ok], jlinv[:, ok], 1e-11)
    assert torch.isfinite(bhat[:, ok]).all()
    assert np.isfinite(jlinv[:, ok]).all()


def test_damp_chol_wrapper_dispatches_on_the_block_width():
    values, _, free, b = _random_diag_system(4)
    args = (torch.as_tensor(values), torch.as_tensor(free),
            torch.as_tensor(b))
    lam = torch.tensor(0.5, dtype=torch.float64)
    for got, want in zip(damp_chol(*args, lam), damp_chol_plain(*args, lam)):
        assert torch.equal(got, want)
    assert damp_chol.launches == 0
    with pytest.raises(ValueError, match="block width"):
        damp_chol(args[0], args[1], args[2][:5].contiguous(), lam)
    with pytest.raises(ValueError, match="shape"):
        damp_chol(args[0][:, :9].contiguous(), args[1], args[2], lam)


@pytest.mark.parametrize("lam", [0.3, 40.0])
def test_scaled_6x6_system_matches_jax_hot_route(system, lam):
    """The scaled operator and right-hand side against JAX's trial pipeline
    (hot_add_diag, hot_scale_jacobi, hot_split and the hot matvec, as
    `_pcg_trial` composes them): equal action on the identity columns, i.e.
    equal dense matrices; and the Gershgorin bound."""
    jprob, tprob, pattern, values, bT = system
    jpat = jsparse.build_ell_pattern(jprob)
    pre = jalg._pcg_precomp(jprob, jpat)
    free = jprob.free["se3"]
    jextra = {"se3": lam * free + (1.0 - free)}
    damped = jsparse.hot_add_diag(jprob, jpat, pre["hot"], jextra,
                                  self_maskT=pre["self_maskT"])
    dblocks = (pre["diag_blocks"]["se3"]
               + jextra["se3"][:, None, None] * jnp.eye(6)[None])
    jlinv = jsolvers.batched_chol_inv_lower(dblocks)
    svals = jsparse.hot_scale_jacobi(jprob, jpat, damped, {"se3": jlinv},
                                     nbT=pre["nbT"])
    split = jsparse.hot_split(jprob, jpat, svals)
    N = pattern.n
    eye = np.eye(6 * N)
    jS = np.stack([
        np.asarray(jsparse.ell_matvec_lane_kmajor_hot(
            jprob, jpat, split,
            {"se3": jnp.asarray(eye[c].reshape(N, 6).T)})["se3"]).T.reshape(-1)
        for c in range(6 * N)], axis=1)

    linv, lchol, bhat, extra = damp_chol(
        values, tprob.free["se3"], bT["se3"],
        torch.tensor(lam, dtype=torch.float64))
    scaled = jacobi_scale(pattern.nb, values, linv, extra)
    S = ell_to_dense(pattern.nb, scaled)
    # the vertex without edges: no slot at all in the JAX pattern (scaled
    # block 0), a diagonal slot in the port's (scaled block I)
    lone = slice(6 * N_POSES, 6 * (N_POSES + 1))
    assert not jS[lone, lone].any()
    np.testing.assert_allclose(S[lone, lone], np.eye(6), atol=1e-15)
    jS[lone, lone] = np.eye(6)
    _close(S, jS, RTOL_JAC)
    for n in range(N):
        np.testing.assert_allclose(S[6 * n:6 * n + 6, 6 * n:6 * n + 6],
                                   np.eye(6), atol=1e-10)
    _close(bhat, jsparse.lane_block_mv(
        {"se3": jnp.moveaxis(jlinv, 0, -1)}, pre["bT"])["se3"], RTOL_JAC)
    hi = float(gershgorin_bound(scaled))
    _close(hi, float(jsparse.hot_gershgorin_bound(jprob, jpat, svals)),
           RTOL_JAC)
    assert hi >= np.linalg.eigvalsh(S).max()
    # L^T and L^-T around the solve undo each other
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(6, N)))
    back = lane_block_mv(linv, lane_block_mv(lchol, x, True), True)
    _close(back, x, 1e-11)


def test_jacobi_scale_6x6_padding_stays_zero_with_nan_factor(system):
    _, tprob, pattern, values, bT = system
    linv, _, _, extra = damp_chol(values, tprob.free["se3"], bT["se3"],
                                  torch.tensor(0.3, dtype=torch.float64))
    linv = linv.clone()
    linv[:, 0] = float("nan")
    S = jacobi_scale(pattern.nb, values, linv, extra)
    pad = (values == 0).all(dim=1)
    pad[0] = False
    assert int(pad.sum()) > 0
    assert not S.permute(0, 2, 1)[pad].any()
    assert torch.isnan(S[0, :, 0]).all()
    touches0 = ((pattern.nb == 0) & ~pad)
    touches0[0] |= torch.arange(pattern.n) == 0
    assert torch.equal(torch.isnan(S).any(dim=1), touches0)


@pytest.mark.parametrize("transpose", [False, True])
def test_lane_block_mv_6x6_matches_jax(transpose):
    rng = np.random.default_rng(9)
    M = rng.normal(size=(6, 6, 70))
    x = rng.normal(size=(6, 70))
    ref = jsparse.lane_block_mv({"v": jnp.asarray(M)}, {"v": jnp.asarray(x)},
                                transpose=transpose)["v"]
    got = lane_block_mv(torch.as_tensor(M.reshape(36, 70)),
                        torch.as_tensor(x), transpose)
    _close(got, ref)
    with pytest.raises(ValueError, match="lane_block_mv"):
        lane_block_mv(torch.as_tensor(M.reshape(36, 70)),
                      torch.as_tensor(x[:3].copy()), transpose)


# ---------------------------------------------------------------------------
# K7 for SE3
# ---------------------------------------------------------------------------

def test_retract_se3_and_chi2_match_jax(system):
    jprob, tprob, pattern, _, bT = system
    rng = np.random.default_rng(4)
    dx = rng.normal(scale=0.05, size=(pattern.n, 6))
    lam = 0.37
    jcand = jproblem.apply_update_parts(jprob, {"se3": jnp.asarray(dx)})
    cand, part_dot = retract_chi2.retract_se3(
        tprob.params["se3"], torch.as_tensor(dx.T.copy()), tprob.free["se3"],
        bT["se3"], torch.tensor(lam, dtype=torch.float64))
    _close(cand, jcand["se3"])
    # the fixed vertices stay (up to the renormalization of 1.0005 |q|)
    np.testing.assert_array_equal(cand[0, :3].numpy(),
                                  tprob.params["se3"][0, :3].numpy())
    b = bT["se3"].numpy()
    _close(part_dot.sum(), float((dx.T * (lam * dx.T + b)).sum()))
    parts = [retract_chi2.se3_edge_chi2(
        cand, *_edge_args(tprob, eg)) for eg in tprob.static.egroups]
    _close(torch.cat(parts).sum(), float(jproblem.robust_chi2(jprob, jcand)))
    assert retract_chi2.retract_se3.launches == 0
    assert retract_chi2.se3_edge_chi2.launches == 0


def _edge_args(prob, eg):
    ea = prob.edges[eg.key]
    return (ea.indices[0], ea.indices[1], ea.measurement, ea.information,
            ea.delta, eg.kernel_id)


def test_nan_step_survives_the_sums(system):
    _, tprob, pattern, _, bT = system
    dx = torch.zeros((6, pattern.n), dtype=torch.float64)
    dx[4, 7] = float("nan")
    cand, part_dot = retract_chi2.retract_se3(
        tprob.params["se3"], dx, tprob.free["se3"], bT["se3"],
        torch.tensor(1.0, dtype=torch.float64))
    assert torch.isnan(cand[7]).any() and torch.isfinite(cand[8]).all()
    assert torch.isnan(part_dot.sum())
    chi = torch.cat([retract_chi2.se3_edge_chi2(cand, *_edge_args(tprob, eg))
                     for eg in tprob.static.egroups]).sum()
    assert torch.isnan(chi)
    out = retract_chi2.lm_outcome(
        chi.reshape(1), part_dot, torch.tensor(True),
        torch.tensor(1.0, dtype=torch.float64),
        torch.tensor(2.0, dtype=torch.float64),
        torch.tensor(10.0, dtype=torch.float64))
    assert float(out[0]) == float("inf") and float(out[1]) == -1.0
    assert not bool(out[2]) and bool(out[5]) and float(out[3]) == 2.0


def test_trial_outcome_dispatches_on_the_vertex_group(system):
    """`_trial_outcome` serves SE3 through retract_se3 + se3_edge_chi2, and
    the graphs the one-group pattern does not cover (landmarks, an
    EDGE_SE3_PRIOR) get the pair tables of LM-PCG over several vertex
    groups."""
    _, tprob, pattern, _, bT = system
    dxT = {"se3": torch.zeros((6, pattern.n), dtype=torch.float64)}
    chi0 = tproblem.robust_chi2(tprob)
    cand, chi_new, accept, _, _, retry = talg._trial_outcome(
        tprob, pattern, bT, dxT, torch.tensor(True),
        torch.tensor(1.0, dtype=torch.float64),
        torch.tensor(2.0, dtype=torch.float64), chi0)
    assert cand["se3"].shape == (pattern.n, 7)
    # a zero step only renormalizes the stored quaternions
    np.testing.assert_allclose(float(chi_new), float(chi0), rtol=1e-3)
    from openslam_g2o_torch.apps.simulator import Simulator3D
    world = Simulator3D(n_landmarks=10, seed=0).simulate(12)[0]
    wpat = tsparse.build_ell_pattern(world.compile(device="cpu"))
    assert isinstance(wpat, tsparse.PairPattern)
    assert [(p.rg, p.cg, p.dr, p.dc) for p in wpat.pairs] == [
        ("se3", "se3", 6, 6), ("se3", "point_xyz", 6, 3),
        ("point_xyz", "se3", 3, 6), ("point_xyz", "point_xyz", 3, 3)]
    g = TGraph()
    g.add_parameter(0, "se3_offset", [0, 0, 0, 0, 0, 0, 1])
    g.add_vertex(0, "se3", [0, 0, 0, 0, 0, 0, 1], fixed=True)
    g.add_edge("edge_se3_prior", (0,), [0, 0, 0, 0, 0, 0, 1], np.eye(6),
               param_ids=[0])
    gprob = g.compile(device="cpu")
    gpat = tsparse.build_ell_pattern(gprob)
    assert isinstance(gpat, tsparse.PairPattern)
    assert [(p.rg, p.cg, p.k) for p in gpat.pairs] == [("se3", "se3", 1)]
    cand, chi_new, *_ = talg._trial_outcome(
        gprob, gpat, {"se3": torch.zeros((6, 1), dtype=torch.float64)},
        {"se3": torch.zeros((6, 1), dtype=torch.float64)},
        torch.tensor(True), torch.tensor(1.0, dtype=torch.float64),
        torch.tensor(2.0, dtype=torch.float64),
        tproblem.robust_chi2(gprob))
    assert cand["se3"].shape == (1, 7) and float(chi_new) == 0.0
