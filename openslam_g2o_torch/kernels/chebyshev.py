"""K8: the Gershgorin spectral bound and the Chebyshev polynomial
preconditioner's scalar and vector work (csrc/chebyshev.cu).

Replaces `hot_gershgorin_bound` / `ell_gershgorin_bound`
(openslam_g2o_tpu/core/sparse.py:1270-1289, :787-817) and the body of
`make_chebyshev_precond` (core/solvers.py:167-210; Saad, Iterative Methods
for Sparse Linear Systems, Alg. 12.1). core/solvers.py composes these
wrappers with the matvec. The bound, the bracket and the recurrence
coefficients stay on the device:

    coef[0] = theta = (hi + lo) / 2
    coef[1 + 2j], coef[2 + 2j] = rho_{j+1} rho_j, 2 rho_{j+1} / delta
    with delta = max((hi - lo) / 2, 1e-12), sigma1 = theta / delta,
    rho_0 = 1 / sigma1, rho_{j+1} = 1 / (2 sigma1 - rho_j)
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    block_width, check_tensors, check_vectors, launch_device, require)
from openslam_g2o_torch.kernels.cg_step import ROW_BLOCK


# -- gershgorin_bound ---------------------------------------------------------

def gershgorin_bound_plain(values):
    K, DD, N = values.shape
    D = block_width("gershgorin_bound", DD)
    rowsum = values.abs().view(K, D, D, N).sum(dim=(0, 2))        # [D, N]
    hi = torch.maximum(torch.zeros((), dtype=values.dtype,
                                   device=values.device), rowsum.max())
    return torch.clamp_min(hi, 1e-3)


def gershgorin_bound(values):
    """max(max_{a, n} sum_{k, c} |values[k, D a + c, n]|, 1e-3): an upper
    bound of lambda_max of the block-ELL matrix (values [K, D*D, N], D = 3
    or 6), as a 0-dim tensor that stays on the device. A NaN entry gives
    NaN. Two launches (row sums and one maximum per block, then the maximum
    of those), counted as one call."""
    require(values.dim() == 3 and values.shape[2] > 0,
            f"gershgorin_bound: values must be [K, D*D, N > 0], got "
            f"{tuple(values.shape)}")
    D = block_width("gershgorin_bound", values.shape[1])
    check_tensors("gershgorin_bound", values.device, values.dtype,
                  {"values": values}, {})
    if not launch_device("gershgorin_bound", values.device):
        return gershgorin_bound_plain(values)
    K, _, N = values.shape
    partials = torch.empty((N + ROW_BLOCK - 1) // ROW_BLOCK,
                           dtype=values.dtype, device=values.device)
    hi = torch.empty((), dtype=values.dtype, device=values.device)
    build.launch("g2o_gershgorin", values, values.data_ptr(),
                 partials.data_ptr(), hi.data_ptr(), N, K, D)
    gershgorin_bound.launches += 1
    return hi


gershgorin_bound.launches = 0


# -- chebyshev_coeffs ---------------------------------------------------------

def chebyshev_coeffs_plain(lo, hi, degree):
    theta = (hi + lo) * 0.5
    delta = torch.clamp_min((hi - lo) * 0.5, 1e-12)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    coef = [theta]
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        coef += [rho_new * rho, 2.0 * rho_new / delta]
        rho = rho_new
    return torch.stack(coef)


def chebyshev_coeffs(lo, hi, degree):
    """The coefficient array [2 degree - 1] (layout in the module docstring)
    from the bracket lo, hi, two 0-dim tensors read on the device."""
    require(lo.dim() == 0 and hi.dim() == 0,
            "chebyshev_coeffs: lo and hi must be 0-dim tensors")
    require(degree >= 1, f"chebyshev_coeffs: degree {degree} < 1")
    check_tensors("chebyshev_coeffs", hi.device, hi.dtype,
                  {"lo": lo, "hi": hi}, {})
    if not launch_device("chebyshev_coeffs", hi.device):
        return chebyshev_coeffs_plain(lo, hi, degree)
    coef = torch.empty(2 * degree - 1, dtype=hi.dtype, device=hi.device)
    build.launch("g2o_chebyshev_coeffs", hi, lo.data_ptr(), hi.data_ptr(),
                 int(degree), coef.data_ptr())
    chebyshev_coeffs.launches += 1
    return coef


chebyshev_coeffs.launches = 0


# -- chebyshev_init / chebyshev_update ----------------------------------------

def chebyshev_init_plain(coef, r):
    d = r / coef[0]
    return d, d.clone()


def chebyshev_init(coef, r):
    """(d, z) with d = r / theta and z a separate copy of d."""
    check_tensors("chebyshev_init", r.device, r.dtype,
                  {"coef": coef, "r": r}, {})
    require(coef.dim() == 1 and coef.numel() >= 1,
            "chebyshev_init: coef must be a 1-d coefficient array")
    if not launch_device("chebyshev_init", r.device):
        return chebyshev_init_plain(coef, r)
    d, z = torch.empty_like(r), torch.empty_like(r)
    build.launch("g2o_chebyshev_init", r, coef.data_ptr(), r.data_ptr(),
                 d.data_ptr(), z.data_ptr(), r.numel())
    chebyshev_init.launches += 1
    return d, z


chebyshev_init.launches = 0


def chebyshev_update_plain(coef, pair, r, sz, d, z):
    d.copy_(coef[1 + 2 * pair] * d + coef[2 + 2 * pair] * (r - sz))
    z.add_(d)


def chebyshev_update(coef, pair, r, sz, d, z):
    """d = c1 d + c2 (r - sz); z += d, in place, with (c1, c2) the
    coefficient pair `pair` and sz = S z."""
    check_vectors("chebyshev_update", r, r=r, sz=sz, d=d, z=z)
    check_tensors("chebyshev_update", r.device, r.dtype, {"coef": coef}, {})
    if not (coef.dim() == 1 and 0 <= pair and 2 + 2 * pair < coef.numel()):
        raise ValueError(f"chebyshev_update: pair {pair} outside the "
                         "coefficient array")
    if not launch_device("chebyshev_update", r.device):
        return chebyshev_update_plain(coef, pair, r, sz, d, z)
    build.launch("g2o_chebyshev_update", r, coef.data_ptr(), int(pair),
                 r.data_ptr(), sz.data_ptr(), d.data_ptr(), z.data_ptr(),
                 r.numel())
    chebyshev_update.launches += 1


chebyshev_update.launches = 0
