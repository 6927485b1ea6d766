"""Parity of the port's SE2 ops, EDGE_SE2 error/Jacobian and robust kernels
with the JAX package, on identical random float64 inputs (numpy, seeded).

Tolerance: rtol 1e-12 (atol 1e-12 for values near zero). Both sides run the
same float64 operations in the same order; only libm's sin/cos and the
order of a few 3-term sums may differ, which costs a few ulp.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.core import robust as jrobust
from openslam_g2o_tpu.models import slam2d as jslam2d
from openslam_g2o_tpu.ops import lie as jlie

from openslam_g2o_torch.core import robust as trobust
from openslam_g2o_torch.models import slam2d as tslam2d
from openslam_g2o_torch.ops import lie as tlie

torch.set_num_threads(1)

RTOL = ATOL = 1e-12


def _rand_se2(rng, n):
    v = rng.uniform(-3, 3, size=(n, 3))
    v[:, 2] = rng.uniform(-np.pi, np.pi, size=n)
    # angles on and next to the wrap boundary
    edge = np.array([np.pi, -np.pi, np.pi - 1e-12, -np.pi + 1e-12,
                     np.nextafter(np.pi, 0), 3 * np.pi, -3 * np.pi, 0.0])
    v[:len(edge), 2] = edge
    return v


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def test_normalize_angle_floor_formula(rng):
    th = np.concatenate([rng.uniform(-20, 20, 500),
                         [np.pi, -np.pi, 3 * np.pi, -3 * np.pi, 0.0,
                          np.pi + 1e-15, -np.pi - 1e-15]])
    _close(tlie.normalize_angle(torch.as_tensor(th)),
           jlie.normalize_angle(jnp.asarray(th)))
    # the floor form wraps to [-pi, pi): +pi maps to -pi exactly, where
    # atan2(sin, cos) could land on either end
    for th0 in (np.pi, -np.pi):
        assert float(tlie.normalize_angle(
            torch.tensor(th0, dtype=torch.float64))) == -np.pi


@pytest.mark.parametrize("op", ["compose", "inverse", "apply", "retract",
                                "error"])
def test_se2_ops_match_jax(rng, op):
    a, b, c = (_rand_se2(rng, 300) for _ in range(3))
    ta, tb, tc = (torch.as_tensor(x) for x in (a, b, c))
    ja, jb, jc = (jnp.asarray(x) for x in (a, b, c))
    if op == "compose":
        _close(tlie.se2_compose(ta, tb), jax.vmap(jlie.se2_compose)(ja, jb))
    elif op == "inverse":
        _close(tlie.se2_inverse(ta), jax.vmap(jlie.se2_inverse)(ja))
    elif op == "apply":
        _close(tlie.se2_apply(ta, tb[:, :2]),
               jax.vmap(jlie.se2_apply)(ja, jb[:, :2]))
    elif op == "retract":
        _close(tlie.se2_retract(ta, tb), jax.vmap(jlie.se2_retract)(ja, jb))
    else:
        _close(tlie.se2_error(ta, tb, tc),
               jax.vmap(jlie.se2_error)(ja, jb, jc))


def test_edge_se2_error_and_jacobian_match_jax(rng):
    xi, xj, z = (_rand_se2(rng, 300) for _ in range(3))
    t = [torch.as_tensor(x) for x in (xi, xj, z)]
    j = [jnp.asarray(x) for x in (xi, xj, z)]
    _close(tslam2d._edge_se2_error((t[0], t[1]), t[2], ()),
           jax.vmap(lambda a, b, m: jslam2d._edge_se2_error((a, b), m, ()))(
               *j))
    tji, tjj = tslam2d._edge_se2_jacobian((t[0], t[1]), t[2], ())
    jji, jjj = jax.vmap(
        lambda a, b, m: jslam2d._edge_se2_jacobian((a, b), m, ()))(*j)
    _close(tji, jji)
    _close(tjj, jjj)


def test_analytic_jacobian_matches_jacfwd(rng):
    """Counterpart of tests/test_jacobians.py: the analytic EDGE_SE2
    Jacobian equals torch.func.jacfwd of the residual as a function of the
    tangent increments (1e-10: both exact up to rounding)."""
    xi, xj, z = (torch.as_tensor(_rand_se2(rng, 50)[8:]) for _ in range(3))

    def resid(di, dj, a, b, m):
        return tslam2d._edge_se2_error(
            (tlie.se2_retract(a, di), tlie.se2_retract(b, dj)), m, ())

    zeros = torch.zeros(3, dtype=torch.float64)
    jac = torch.func.vmap(torch.func.jacfwd(resid, argnums=(0, 1)),
                          in_dims=(None, None, 0, 0, 0))
    ad_i, ad_j = jac(zeros, zeros, xi, xj, z)
    an_i, an_j = tslam2d._edge_se2_jacobian((xi, xj), z, ())
    torch.testing.assert_close(an_i, ad_i, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(an_j, ad_j, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", list(jrobust.ROBUST_KERNELS))
def test_robust_kernels_match_jax(rng, name):
    kid = jrobust.kernel_id(name)
    assert trobust.kernel_id(name) == kid
    delta = rng.uniform(0.3, 3.0, 400)
    e2 = rng.uniform(0, 12, 400)
    e2[:4] = [0.0, 1e-40, delta[2] ** 2, delta[3] ** 2 * (1 + 1e-12)]
    out_t = trobust.robustify(kid, torch.as_tensor(e2), torch.as_tensor(delta))
    out_j = jrobust.robustify(kid, jnp.asarray(e2), jnp.asarray(delta))
    for t, j in zip(out_t, out_j):
        _close(t, j)

