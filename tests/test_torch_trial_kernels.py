"""Plain versions of the trial-solve kernels K3 (`damp_chol`) and K4
(`jacobi_scale`, `lane_block_mv`) against the JAX package, float64 on CPU.

Inputs come from numpy seeds or from the 41-vertex test graph of
tests/test_torch_assembly.py (two fixed vertices, one vertex without
edges). Tolerances: rtol 1e-12 against JAX (the same closed-form float64
arithmetic; only the order of a few sums differs) with an absolute floor of
1e-12 times the largest reference entry for values that cancel to ~0.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.core import algorithms as jalg
from openslam_g2o_tpu.core import solvers as jsolvers
from openslam_g2o_tpu.core import sparse as jsparse

from openslam_g2o_torch.core import sparse as tsparse
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels.chebyshev import gershgorin_bound
from openslam_g2o_torch.kernels.damp_chol import damp_chol, damp_chol_plain
from openslam_g2o_torch.kernels.jacobi_scale import (
    jacobi_scale, lane_block_mv)
from tests.test_torch_assembly import ell_to_dense, make_jax_graph

torch.set_num_threads(1)

RTOL = 1e-12


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _random_diag_system(seed, n=60, k=3):
    """values [k, 9, n] with SPD diagonal blocks in slot 0, a free mask
    with fixed vertices, b [3, n]."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, 3, 3))
    A = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(3)
    values = rng.normal(size=(k, 9, n))
    values[0] = A.reshape(n, 9).T
    free = np.ones(n)
    free[[0, 11]] = 0.0
    return values, A, free, rng.normal(size=(3, n))


def _lane(blocks):
    """[N, 3, 3] numpy -> lane-major [9, N]."""
    return np.asarray(blocks).transpose(1, 2, 0).reshape(9, -1)


@pytest.mark.parametrize("seed,lam", [(0, 1e-3), (1, 0.7), (2, 250.0)])
def test_damp_chol_matches_jax_factors(seed, lam):
    values, A, free, b = _random_diag_system(seed)
    extra = lam * free + (1.0 - free)
    damped = jnp.asarray(A + extra[:, None, None] * np.eye(3))
    linv, lchol, bhat, extra_t = damp_chol(
        torch.as_tensor(values), torch.as_tensor(free), torch.as_tensor(b),
        torch.tensor(lam, dtype=torch.float64))
    jlinv = np.asarray(jsolvers.batched_chol_inv_lower(damped))
    _close(linv, _lane(jlinv))
    _close(lchol, _lane(jsolvers.batched_chol_lower(damped)))
    _close(extra_t, extra)
    _close(bhat, np.einsum("nab,bn->an", jlinv, b))
    # a fixed vertex is damped by exactly 1, whatever lambda is
    assert extra_t[0] == 1.0 and extra_t[11] == 1.0 and extra_t[1] == lam
    # the strictly upper entries are exact zeros
    assert not linv[[1, 2, 5]].any() and not lchol[[1, 2, 5]].any()


def test_damp_chol_non_spd_block_gives_nan_in_both_packages():
    values, A, free, b = _random_diag_system(3)
    values[0, :, 5] = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0],
                                [0.0, 0.0, 1.0]]).reshape(9)
    A[5] = values[0, :, 5].reshape(3, 3)
    lam = 1e-3
    extra = lam * free + (1.0 - free)
    damped = jnp.asarray(A + extra[:, None, None] * np.eye(3))
    jlinv = _lane(jsolvers.batched_chol_inv_lower(damped))
    jl = _lane(jsolvers.batched_chol_lower(damped))
    linv, lchol, bhat, _ = damp_chol(
        torch.as_tensor(values), torch.as_tensor(free), torch.as_tensor(b),
        torch.tensor(lam, dtype=torch.float64))
    assert np.isnan(jlinv[:, 5]).any() and np.isnan(jl[:, 5]).any()
    np.testing.assert_array_equal(np.isnan(linv.numpy()), np.isnan(jlinv))
    np.testing.assert_array_equal(np.isnan(lchol.numpy()), np.isnan(jl))
    assert torch.isnan(bhat[:, 5]).any()
    ok = np.arange(values.shape[2]) != 5
    _close(linv[:, ok], jlinv[:, ok])
    assert torch.isfinite(bhat[:, ok]).all()


def test_damp_chol_wrapper_checks_and_cpu_dispatch():
    values, _, free, b = _random_diag_system(4)
    args = (torch.as_tensor(values), torch.as_tensor(free),
            torch.as_tensor(b))
    lam = torch.tensor(0.5, dtype=torch.float64)
    for got, want in zip(damp_chol(*args, lam), damp_chol_plain(*args, lam)):
        assert torch.equal(got, want)
    assert damp_chol.launches == 0
    with pytest.raises(ValueError, match="0-dim"):
        damp_chol(*args, torch.tensor([0.5], dtype=torch.float64))
    with pytest.raises(ValueError, match="dtype"):
        damp_chol(*args, torch.tensor(0.5, dtype=torch.float32))
    with pytest.raises(ValueError, match="shape"):
        damp_chol(args[0], args[1], args[2][:2], lam)


@pytest.fixture(scope="module")
def system():
    jprob = make_jax_graph().compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    pattern = tsparse.build_ell_pattern(tprob)
    values, bT = tsparse.assemble_ell(tprob, pattern)
    return jprob, tprob, pattern, values, bT


@pytest.mark.parametrize("lam", [0.3, 40.0])
def test_jacobi_scale_matches_dense(system, lam):
    """S = Linv (H + diag(extra)) Linv^T computed densely, with unit
    diagonal blocks."""
    _, tprob, pattern, values, bT = system
    linv, _, _, extra = damp_chol(values, tprob.free["se2"], bT["se2"],
                                  torch.tensor(lam, dtype=torch.float64))
    S = ell_to_dense(pattern.nb, jacobi_scale(pattern.nb, values, linv,
                                              extra))
    N = pattern.n
    Hd = ell_to_dense(pattern.nb, values) + np.diag(
        np.repeat(extra.numpy(), 3))
    L = np.zeros((3 * N, 3 * N))
    for n in range(N):
        L[3 * n:3 * n + 3, 3 * n:3 * n + 3] = linv[:, n].view(3, 3).numpy()
    ref = L @ Hd @ L.T
    _close(S, ref)
    for n in range(N):
        np.testing.assert_allclose(S[3 * n:3 * n + 3, 3 * n:3 * n + 3],
                                   np.eye(3), atol=1e-12)


@pytest.mark.parametrize("lam", [0.3, 40.0])
def test_scaled_system_matches_jax_hot_route(system, lam):
    """The scaled operator and right-hand side against JAX's trial
    pipeline (hot_add_diag, hot_scale_jacobi, hot_split and the hot
    matvec, as `_pcg_trial` composes them): equal action on the identity
    columns, i.e. equal dense matrices."""
    jprob, tprob, pattern, values, bT = system
    jpat = jsparse.build_ell_pattern(jprob)
    pre = jalg._pcg_precomp(jprob, jpat)
    free = jprob.free["se2"]
    jextra = {"se2": lam * free + (1.0 - free)}
    damped = jsparse.hot_add_diag(jprob, jpat, pre["hot"], jextra,
                                  self_maskT=pre["self_maskT"])
    dblocks = (pre["diag_blocks"]["se2"]
               + jextra["se2"][:, None, None] * jnp.eye(3)[None])
    jlinv = jsolvers.batched_chol_inv_lower(dblocks)
    svals = jsparse.hot_scale_jacobi(jprob, jpat, damped, {"se2": jlinv},
                                     nbT=pre["nbT"])
    split = jsparse.hot_split(jprob, jpat, svals)
    N = pattern.n
    eye = np.eye(3 * N)
    jS = np.stack([
        np.asarray(jsparse.ell_matvec_lane_kmajor_hot(
            jprob, jpat, split,
            {"se2": jnp.asarray(eye[c].reshape(N, 3).T)})["se2"]).T.reshape(-1)
        for c in range(3 * N)], axis=1)

    linv, _, bhat, extra = damp_chol(values, tprob.free["se2"], bT["se2"],
                                     torch.tensor(lam, dtype=torch.float64))
    S = ell_to_dense(pattern.nb, jacobi_scale(pattern.nb, values, linv,
                                              extra))
    # vertex 40 has no edge: the JAX pattern gives it no slot at all (its
    # scaled block is 0), the port's gives every row a diagonal slot, so
    # the damping lands and the scaled block is the identity
    lone = slice(3 * 40, 3 * 41)
    assert not jS[lone, lone].any()
    np.testing.assert_allclose(S[lone, lone], np.eye(3), atol=1e-15)
    jS[lone, lone] = np.eye(3)
    _close(S, jS)
    jbhat = jsparse.lane_block_mv({"se2": jnp.moveaxis(jlinv, 0, -1)},
                                  pre["bT"])["se2"]
    _close(bhat, jbhat)
    hi = float(gershgorin_bound(
        jacobi_scale(pattern.nb, values, linv, extra)))
    _close(hi, float(jsparse.hot_gershgorin_bound(jprob, jpat, svals)))
    assert hi >= np.linalg.eigvalsh(S).max()


def test_jacobi_scale_padding_stays_zero_with_nan_factor(system):
    """A NaN factor in row 0 (the column every padding slot points at) must
    not leak into the padding: those slots stay exactly zero, the slots
    that really touch vertex 0 become NaN."""
    _, tprob, pattern, values, bT = system
    linv, _, _, extra = damp_chol(values, tprob.free["se2"], bT["se2"],
                                  torch.tensor(0.3, dtype=torch.float64))
    linv = linv.clone()
    linv[:, 0] = float("nan")
    S = jacobi_scale(pattern.nb, values, linv, extra)
    pad = (values == 0).all(dim=1)
    pad[0] = False
    assert int(pad.sum()) > 0
    assert not S.permute(0, 2, 1)[pad].any()
    assert torch.isnan(S[0, :, 0]).all()
    rows = torch.arange(pattern.n)
    touches0 = ((pattern.nb == 0) & ~pad)
    touches0[0] |= rows == 0
    assert torch.equal(torch.isnan(S).any(dim=1), touches0)


@pytest.mark.parametrize("transpose", [False, True])
def test_lane_block_mv_matches_jax(transpose):
    rng = np.random.default_rng(9)
    M = rng.normal(size=(3, 3, 70))
    x = rng.normal(size=(3, 70))
    ref = jsparse.lane_block_mv({"v": jnp.asarray(M)}, {"v": jnp.asarray(x)},
                                transpose=transpose)["v"]
    got = lane_block_mv(torch.as_tensor(M.reshape(9, 70)),
                        torch.as_tensor(x), transpose)
    _close(got, ref)
    got_dict = tsparse.lane_block_mv({"v": torch.as_tensor(M.reshape(9, 70))},
                                     {"v": torch.as_tensor(x)},
                                     transpose=transpose)["v"]
    assert torch.equal(got, got_dict)
