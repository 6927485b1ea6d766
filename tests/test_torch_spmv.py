"""Kernel A's plain version (block-ELL SpMV) against dense H @ x, against
JAX `ell_matvec_lane` on the same problem, and against the formula of the
TPU probe kernel `spmv_kernel` (scripts/probe_pallas_gather.py:77-97) at
its shape N=3500, K=10. The probe is not imported: it runs Pallas at
import time.

Tolerances: float64 rtol 1e-12 relative to the largest |y| (sums of a few
products in another order); float32 1e-5 relative (K*3 = 30 products
summed in another order than the numpy float64 reference).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core import sparse as jsparse

from openslam_g2o_torch.core import sparse as tsparse
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels.spmv import block_ell_spmv
from tests.test_torch_assembly import make_jax_graph

torch.set_num_threads(1)


def _rel_err(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def system():
    jprob = make_jax_graph().compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    pattern = tsparse.build_ell_pattern(tprob)
    values, _ = tsparse.assemble_ell(tprob, pattern)
    x = np.random.default_rng(7).normal(size=(3, pattern.n))
    return jprob, tprob, pattern, values, x


def test_spmv_matches_dense(system):
    jprob, _, pattern, values, x = system
    H, _, _ = jproblem.build_dense_system(jprob, add_fixed_diag=False)
    ref = (np.asarray(H) @ x.T.reshape(-1)).reshape(-1, 3).T
    y = tsparse.ell_matvec_lane(pattern, values,
                                {"se2": torch.as_tensor(x)})["se2"]
    assert _rel_err(y, ref) < 1e-12


def test_spmv_matches_jax_ell_matvec_lane(system):
    jprob, _, pattern, values, x = system
    jpat = jsparse.build_ell_pattern(jprob)
    jvalues, _ = jsparse.assemble_ell(jprob, jpat, jproblem.linearize(jprob))
    ref = jsparse.ell_matvec_lane(jprob, jpat, jvalues,
                                  {"se2": jnp.asarray(x)})["se2"]
    y = block_ell_spmv(pattern.nb, values, torch.as_tensor(x))
    assert _rel_err(y, ref) < 1e-12


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_spmv_matches_probe_formula(dtype, tol):
    """y[s, n] = sum_k sum_t V[s*3+t, n, k] * x[t, nb[n, k]] with the
    probe's [9, N, K] values and [N, K] neighbours, re-laid into the port's
    [K, 9, N] / [K, N] layout."""
    N, K = 3500, 10
    rng = np.random.default_rng(0)
    nb = rng.integers(0, N, size=(N, K)).astype(np.int32)
    V = rng.normal(size=(9, N, K))
    x = rng.normal(size=(3, N))
    xg = x[:, nb.reshape(-1)].reshape(3, N, K)
    ref = (V.reshape(3, 3, N, K) * xg[None]).sum(axis=(1, 3))
    y = block_ell_spmv(torch.as_tensor(np.ascontiguousarray(nb.T)),
                       torch.as_tensor(V.transpose(2, 0, 1).copy(),
                                       dtype=dtype),
                       torch.as_tensor(x, dtype=dtype))
    assert y.dtype == dtype and y.shape == (3, N)
    assert _rel_err(y, ref) < tol


def test_padding_slots_contribute_nothing():
    """A padding slot (column 0, zero block) adds nothing to its row."""
    nb = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)   # row 1 padded
    values = torch.zeros((2, 9, 2), dtype=torch.float64)
    values[0, :, 0] = torch.arange(1.0, 10.0)
    values[0, :, 1] = 2 * torch.arange(1.0, 10.0)
    values[1, :, 0] = 1.0
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], dtype=torch.float64)
    y = block_ell_spmv(nb, values, x)
    B = torch.arange(1.0, 10.0, dtype=torch.float64).view(3, 3)
    torch.testing.assert_close(y[:, 0], B @ x[:, 0] + torch.ones(3, 3,
                               dtype=torch.float64) @ x[:, 1])
    torch.testing.assert_close(y[:, 1], 2 * B @ x[:, 1])
