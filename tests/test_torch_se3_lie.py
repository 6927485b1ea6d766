"""The port's quaternion / SO3 / SE3 manifold functions
(openslam_g2o_torch/ops/lie.py) against openslam_g2o_tpu/ops/lie.py, float64 on
the CPU, and the port's numpy copy of utils/np_lie.py against the original.

Inputs come from numpy seeds: random unit quaternions, some with q_w < 0,
rotation vectors down to |omega| = 1e-9 (the Taylor branches) and up to
pi - 1e-9, rotation matrices of every Shepperd branch. The JAX functions are
unbatched and vmapped; the port's are batched on the last axis. Tolerance:
rtol 1e-12 with an absolute floor of 1e-12 (the same float64 operations in
the same order; only library sin/cos/atan2 may differ in the last ulp).
Forward-mode derivatives at the guarded points are finite in both.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.ops import lie as jlie
from openslam_g2o_tpu.utils import np_lie as jnp_lie

from openslam_g2o_torch.ops import lie as tlie
from openslam_g2o_torch.utils import np_lie as tnp_lie

torch.set_num_threads(1)

N = 40


def _quats(rng, n=N):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[::3, 3] = -np.abs(q[::3, 3])             # q_w < 0 on every third
    q[1::3, 3] = np.abs(q[1::3, 3])
    return q


def _poses(rng, n=N):
    return np.concatenate([rng.normal(scale=5.0, size=(n, 3)), _quats(rng, n)],
                          axis=1)


def _omegas(rng, n=N):
    """Rotation vectors: generic, tiny (Taylor branch), zero, near pi."""
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    angle = rng.uniform(0.1, 3.0, size=n)
    angle[:6] = [0.0, 1e-9, 1e-7, 1e-4, np.pi - 1e-9, np.pi - 1e-4]
    return w * angle[:, None]


def _check(jfn, tfn, *args, rtol=1e-12, atol=1e-12):
    want = np.asarray(jax.vmap(jfn)(*[jnp.asarray(a) for a in args]))
    got = tfn(*[torch.tensor(np.asarray(a)) for a in args]).numpy()
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


CASES = {
    "quat_mul": lambda r: (_quats(r), _quats(r)),
    "quat_conj": lambda r: (_quats(r),),
    "quat_normalize": lambda r: (_quats(r) * r.uniform(0.5, 2.0, (N, 1)),),
    "quat_normalize_positive": lambda r: (_quats(r) * 1.7,),
    "quat_rotate": lambda r: (_quats(r), r.normal(size=(N, 3))),
    "quat_to_matrix": lambda r: (_quats(r),),
    "quat_from_compact": lambda r: (np.concatenate(
        [r.normal(scale=0.3, size=(N - 2, 3)),
         [[0.0, 0.0, 0.0], [0.9, 0.9, 0.9]]]),),     # |v| > 1: clamped
    "quat_to_compact": lambda r: (_quats(r) * 1.3,),
    "se3_compose": lambda r: (_poses(r), _poses(r)),
    "se3_inverse": lambda r: (_poses(r),),
    "se3_apply": lambda r: (_poses(r), r.normal(size=(N, 3))),
    "se3_from_mqt": lambda r: (r.normal(scale=0.3, size=(N, 6)),),
    "se3_retract_mqt": lambda r: (_poses(r),
                                  r.normal(scale=0.2, size=(N, 6))),
    "se3_error_mqt": lambda r: (_poses(r), _poses(r), _poses(r)),
    "skew": lambda r: (r.normal(size=(N, 3)),),
    "so3_exp": lambda r: (_omegas(r),),
    "so3_log": lambda r: (_quats(r),),
    "se3_exp": lambda r: (np.concatenate([_omegas(r),
                                          r.normal(size=(N, 3))], axis=1),),
    "se3_log": lambda r: (_poses(r),),
    "se3_retract_expmap_left": lambda r: (
        _poses(r), np.concatenate([_omegas(r), r.normal(size=(N, 3))],
                                  axis=1)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_jax(name):
    args = CASES[name](np.random.default_rng(sorted(CASES).index(name)))
    _check(getattr(jlie, name), getattr(tlie, name), *args)


def test_identities_and_terms():
    assert torch.equal(tlie.quat_identity(torch.float64),
                       torch.tensor(np.asarray(jlie.quat_identity(jnp.float64))))
    assert torch.equal(tlie.se3_identity(torch.float64),
                       torch.tensor(np.asarray(jlie.se3_identity(jnp.float64))))
    theta2 = np.array([0.0, 1e-12, 1e-10, 0.99e-10, 1e-4, 1.0, 9.0])
    want = jax.vmap(jlie._so3_left_jacobian_terms)(jnp.asarray(theta2))
    got = tlie._so3_left_jacobian_terms(torch.as_tensor(theta2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_so3_log_of_exp_near_zero_and_pi():
    """log(exp(omega)) = omega through both guarded branches."""
    w = _omegas(np.random.default_rng(5))
    back = tlie.so3_log(tlie.so3_exp(torch.as_tensor(w))).numpy()
    np.testing.assert_allclose(back, w, rtol=1e-6, atol=1e-15)
    _check(lambda o: jlie.so3_log(jlie.so3_exp(o)),
           lambda o: tlie.so3_log(tlie.so3_exp(o)), w)


def test_matrix_to_quat_every_branch():
    """Rotations by ~pi about x, y and z take the three trace-free
    branches; a generic one the trace branch."""
    rng = np.random.default_rng(6)
    axes = np.concatenate([np.eye(3), rng.normal(size=(5, 3))])
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.array([3.1, 3.1, 3.1, 0.3, 1.0, 2.0, 2.9, 3.14])
    q = np.concatenate([axes * np.sin(angles / 2)[:, None],
                        np.cos(angles / 2)[:, None]], axis=1)
    R = np.asarray(jax.vmap(jlie.quat_to_matrix)(jnp.asarray(q)))
    traces = np.trace(R, axis1=1, axis2=2)
    assert (traces < 0).sum() >= 3 and (traces > 0).any()
    _check(jlie.matrix_to_quat, tlie.matrix_to_quat, R)
    back = tlie.matrix_to_quat(torch.as_tensor(R)).numpy()
    sign = np.sign((back * q).sum(axis=1, keepdims=True))
    np.testing.assert_allclose(back * sign, q, atol=1e-12)


@pytest.mark.parametrize("name", ["so3_exp", "se3_exp", "so3_log", "se3_log",
                                  "quat_from_compact", "matrix_to_quat"])
def test_forward_derivative_is_finite_at_the_guards(name):
    """The guarded square roots keep the forward-mode derivative finite at
    omega = 0, at the identity quaternion and at v = 0, and equal to
    jax.jacfwd's."""
    point = {"so3_exp": np.zeros(3), "se3_exp": np.zeros(6),
             "so3_log": np.array([0.0, 0.0, 0.0, 1.0]),
             "se3_log": np.array([1.0, 2.0, 3.0, 0.0, 0.0, 0.0, 1.0]),
             "quat_from_compact": np.zeros(3),
             "matrix_to_quat": np.eye(3)}[name]
    want = np.asarray(jax.jacfwd(getattr(jlie, name))(jnp.asarray(point)))
    got = torch.func.jacfwd(getattr(tlie, name))(torch.as_tensor(point))
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_broadcasts_over_leading_axes():
    rng = np.random.default_rng(8)
    a = torch.as_tensor(_poses(rng, 12).reshape(3, 4, 7))
    b = torch.as_tensor(_poses(rng, 4))
    out = tlie.se3_compose(a, b)
    assert out.shape == (3, 4, 7)
    assert torch.equal(out[1], tlie.se3_compose(a[1], b))


NP_CASES = {
    "quat_mul": lambda r: (_quats(r, 1)[0], _quats(r, 1)[0]),
    "quat_conj": lambda r: (_quats(r, 1)[0],),
    "quat_rotate": lambda r: (_quats(r, 1)[0], r.normal(size=3)),
    "se3_compose": lambda r: (_poses(r, 1)[0], _poses(r, 1)[0]),
    "se3_inverse": lambda r: (_poses(r, 1)[0],),
    "se3_apply": lambda r: (_poses(r, 1)[0], r.normal(size=3)),
}


@pytest.mark.parametrize("name", sorted(NP_CASES))
def test_numpy_copy_equals_the_original_to_the_bit(name):
    """The port's np_lie writes the cross product out; the generators rely
    on it giving np.cross's bits."""
    for seed in range(20):
        args = NP_CASES[name](np.random.default_rng(seed))
        np.testing.assert_array_equal(getattr(tnp_lie, name)(*args),
                                      getattr(jnp_lie, name)(*args))
