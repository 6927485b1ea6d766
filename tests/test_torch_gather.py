"""The lane gather's plain version against the numpy reference of the TPU
probe (scripts/probe_pallas_gather.py:63, `xT[:, nb.reshape(-1)]`), on the
probe's data and shape (R = 8, N = 3500, M = 35000), and the probe's own
comparison: an SpMV composed of the gather and a multiply-sum equals the
fused block-ELL SpMV. The probe is not imported: it runs Pallas at import
time. A gather copies values, so the comparison is exact; the composed
SpMV sums K*3 = 30 products in another order (1e-12 in float64, 1e-5 in
float32, relative to the largest |y|).
"""
import numpy as np
import pytest
import torch

from openslam_g2o_torch.kernels.gather import lane_gather
from openslam_g2o_torch.kernels.spmv import block_ell_spmv

torch.set_num_threads(1)

N, K = 3500, 10


def _probe_data():
    rng = np.random.default_rng(0)
    nb = rng.integers(0, N, size=(N, K)).astype(np.int32)
    xT = rng.normal(size=(8, N)).astype(np.float32)
    idx = np.broadcast_to(nb.reshape(1, -1), (8, N * K)).copy()
    V = rng.normal(size=(9, N, K)).astype(np.float32)
    return nb, xT, idx, V


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lane_gather_matches_probe_reference(dtype):
    nb, xT, idx, _ = _probe_data()
    out = lane_gather(torch.as_tensor(xT, dtype=dtype), torch.as_tensor(idx))
    assert out.shape == (8, N * K) and out.dtype == dtype
    ref = xT[:, nb.reshape(-1)]
    np.testing.assert_array_equal(out.numpy(), ref.astype(out.numpy().dtype))


def test_lane_gather_rows_use_their_own_indices():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 40))
    idx = rng.integers(0, 40, size=(5, 90)).astype(np.int32)
    out = lane_gather(torch.as_tensor(x), torch.as_tensor(idx))
    np.testing.assert_array_equal(out.numpy(),
                                  np.take_along_axis(x, idx, axis=1))
    assert lane_gather.launches == 0          # CPU tensors: the plain version


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_gather_composed_spmv_matches_fused(dtype, tol):
    nb, xT, idx, V = _probe_data()
    x = torch.as_tensor(xT, dtype=dtype)
    Vt = torch.as_tensor(V, dtype=dtype)
    xg = lane_gather(x, torch.as_tensor(idx))[:3].view(3, N, K)
    y_gather = (Vt.view(3, 3, N, K) * xg[None]).sum(dim=(1, 3))
    y_fused = block_ell_spmv(torch.as_tensor(nb.T.copy()),
                             Vt.permute(2, 0, 1).contiguous(),
                             x[:3].contiguous())
    err = (y_gather - y_fused).abs().max() / y_fused.abs().max()
    assert float(err) < tol


def test_lane_gather_rejects_bad_arguments():
    x = torch.zeros((2, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match="int32"):
        lane_gather(x, torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\[R, M\]"):
        lane_gather(x, torch.zeros((3, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        lane_gather(x.t().contiguous().t(),
                    torch.zeros((2, 3), dtype=torch.int32))
