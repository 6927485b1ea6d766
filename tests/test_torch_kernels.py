"""Kernel wrappers: argument checks and CPU dispatch (run everywhere), and
each CUDA kernel against its plain version on the card (skipped without a
GPU; run them there with `python -m pytest tests/test_torch_kernels.py`).

On the card, relative to the largest |plain| entry: kernels A and C to
1e-12 (float64) and 2e-5 (float32), since they sum a few products in
another order and contract multiply-adds to FMA; kernel B to 1e-11 and
1e-4, since its pose differences cancel (coordinates of ~10-100 against
residuals of ~0.03), so an FMA or a last-ulp sin/cos difference moves the
residual by an ulp of the coordinate.
"""
import numpy as np
import pytest
import torch

from openslam_g2o_torch import kernels
from openslam_g2o_torch.apps.simulator import synthetic_pose_graph_2d
from openslam_g2o_torch.core import sparse
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
    assert kernels.launch_counts() == {"block_ell_spmv": 0,
                                       "edge_se2_blocks": 0,
                                       "assemble_gather": 0}


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
    with pytest.raises(ValueError, match="fit"):
        edge_se2_blocks(*args, 0, hblk, bblk, 5)
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
    assert _rel(hblk, ph) < TOL_B[dtype] and _rel(bblk, pb) < TOL_B[dtype]
    values, b = assemble_gather(hblk, bblk, pattern.hidx, pattern.bidx,
                                pattern.k, pattern.n)
    pv, pbv = assemble_gather_plain(hblk, bblk, pattern.hidx, pattern.bidx,
                                    pattern.k, pattern.n)
    assert _rel(values, pv) < TOL[dtype] and _rel(b, pbv) < TOL[dtype]
    x = torch.randn((3, pattern.n), dtype=dtype, device=cuda)
    y = block_ell_spmv(pattern.nb, values, x)
    assert _rel(y, block_ell_spmv_plain(pattern.nb, values, x)) < TOL[dtype]
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"block_ell_spmv": 1,
                                       "edge_se2_blocks": 1,
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
