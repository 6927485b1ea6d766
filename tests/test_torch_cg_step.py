"""The stepwise CG of the port (core/solvers.py `pcg_solve` on the plain
versions of kernels/cg_step.py) against JAX `pcg_solve`, float64 on CPU.

Systems are dense matrices drawn from numpy seeds, applied to dicts of two
groups so that the multi-group bookkeeping of the partial sums runs. Cases:
an SPD system, an indefinite one (sticky pd: ok False and x zeroed), a zero
right-hand side, a warm start, and a preconditioner, each with unroll 1
and 2 and both stop norms. The same iterate and the same ok are required:
rtol 1e-10 relative to the largest |x| (the same float64 recurrence; dots
and matvecs sum in another order, which passes through at most 60
iterations), and equal numbers of matvecs, i.e. of CG iterations.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.core import solvers as jsolvers

from openslam_g2o_torch.core import solvers as tsolvers
from openslam_g2o_torch.kernels import cg_step

torch.set_num_threads(1)

NA, NB = 3 * 14, 3 * 9            # two groups, lane-major [3, n]


def _spd(seed, n=NA + NB, cond=50.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eig = np.geomspace(1.0, cond, n)
    return (Q * eig) @ Q.T, rng.normal(size=n)


def _split(v, lib):
    return {"a": lib(v[:NA].reshape(3, -1)), "b": lib(v[NA:].reshape(3, -1))}


def _join(d):
    return np.concatenate([np.asarray(d["a"]).reshape(-1),
                           np.asarray(d["b"]).reshape(-1)])


def _run_both(S, b, x0=None, Minv=None, **kw):
    counts = {"jax": 0, "torch": 0}

    def bump():
        counts["jax"] += 1

    Sj, St = jnp.asarray(S), torch.as_tensor(S)

    def jmv(x):
        jax.debug.callback(bump)
        return _split(Sj @ jnp.concatenate([x["a"].reshape(-1),
                                            x["b"].reshape(-1)]), lambda a: a)

    def tmv(x):
        counts["torch"] += 1
        return _split(St @ torch.cat([x["a"].reshape(-1),
                                      x["b"].reshape(-1)]), lambda a: a)

    jpre = tpre = None
    if Minv is not None:
        Mj, Mt = jnp.asarray(Minv), torch.as_tensor(Minv)
        jpre = lambda r: _split(Mj @ jnp.concatenate(
            [r["a"].reshape(-1), r["b"].reshape(-1)]), lambda a: a)
        tpre = lambda r: _split(Mt @ torch.cat(
            [r["a"].reshape(-1), r["b"].reshape(-1)]), lambda a: a)
    jx0 = None if x0 is None else _split(x0, jnp.asarray)
    tx0 = None if x0 is None else _split(x0, torch.as_tensor)
    jx, jok = jsolvers.pcg_solve(jmv, _split(b, jnp.asarray), precond=jpre,
                                 x0=jx0, **kw)
    jax.block_until_ready(jx)
    jax.effects_barrier()
    tb = _split(b, torch.as_tensor)
    tx, tok = tsolvers.pcg_solve(tmv, tb, precond=tpre, x0=tx0, **kw)
    assert tok.dtype == torch.bool and tok.dim() == 0
    np.testing.assert_array_equal(_join(tb), b)        # b is not modified
    if x0 is not None:
        np.testing.assert_array_equal(_join(tx0), x0)  # nor is x0
    return _join(jx), bool(jok), _join(tx), bool(tok), counts


def _same(jx, jok, tx, tok, counts):
    assert tok == jok
    assert counts["torch"] == counts["jax"]
    np.testing.assert_allclose(tx, jx, rtol=1e-10,
                               atol=1e-10 * max(np.abs(jx).max(), 1e-300))


@pytest.mark.parametrize("norm", ["precond", "true"])
@pytest.mark.parametrize("unroll", [1, 2])
@pytest.mark.parametrize("max_iter,tol", [(60, 1e-9), (7, 0.15)])
def test_spd_system(unroll, norm, max_iter, tol):
    S, b = _spd(0)
    jx, jok, tx, tok, counts = _run_both(S, b, max_iter=max_iter, tol=tol,
                                         unroll=unroll, norm=norm)
    _same(jx, jok, tx, tok, counts)
    assert tok and counts["torch"] > 2
    if max_iter == 60:
        np.testing.assert_allclose(S @ tx, b, atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("unroll", [1, 2])
def test_indefinite_system_fails_sticky(unroll):
    """A negative curvature direction: pd turns false and stays false, the
    loop ends at the next stop test, ok is False and x is zeroed."""
    S, b = _spd(1)
    S = S - 30.0 * np.eye(len(b))
    jx, jok, tx, tok, counts = _run_both(S, b, max_iter=60, tol=1e-10,
                                         unroll=unroll, norm="precond")
    _same(jx, jok, tx, tok, counts)
    assert not tok and not tx.any() and not jx.any()
    assert counts["torch"] < 40


@pytest.mark.parametrize("unroll", [1, 2])
def test_zero_right_hand_side(unroll):
    S, b = _spd(2)
    jx, jok, tx, tok, counts = _run_both(S, np.zeros_like(b), max_iter=20,
                                         tol=1e-8, unroll=unroll,
                                         norm="precond")
    _same(jx, jok, tx, tok, counts)
    assert tok and not tx.any()
    assert counts["torch"] == 1               # the initial residual only


@pytest.mark.parametrize("unroll", [1, 2])
def test_warm_start(unroll):
    S, b = _spd(3)
    x0 = np.linalg.solve(S, b) + 1e-3 * np.random.default_rng(4).normal(
        size=len(b))
    cold = _run_both(S, b, max_iter=60, tol=1e-6, unroll=unroll,
                     norm="precond")
    warm = _run_both(S, b, x0=x0, max_iter=60, tol=1e-6, unroll=unroll,
                     norm="precond")
    _same(*warm)
    assert warm[3] and warm[4]["torch"] < cold[4]["torch"]


@pytest.mark.parametrize("norm", ["precond", "true"])
@pytest.mark.parametrize("unroll", [1, 2])
def test_preconditioner(unroll, norm):
    S, b = _spd(5, cond=20.0)
    rng = np.random.default_rng(6)
    D = np.diag(rng.uniform(0.5, 6.0, len(b)))
    S = D @ S @ D                             # badly scaled rows
    Minv = np.diag(1.0 / np.diag(S))          # Jacobi
    plain = _run_both(S, b, max_iter=60, tol=1e-8, unroll=unroll, norm=norm)
    pre = _run_both(S, b, Minv=Minv, max_iter=60, tol=1e-8, unroll=unroll,
                    norm=norm)
    _same(*pre)
    assert pre[3] and pre[4]["torch"] < plain[4]["torch"]


def test_scalar_buffer_after_one_step():
    """The device-side scalars of one hand-driven step: alpha, beta, rz, r2,
    pd and the continue flag against their definitions."""
    S, b = _spd(7, n=30)
    St, bt = torch.as_tensor(S), torch.as_tensor(b)
    r, p, part_rr, part_bb = cg_step.cg_residual(bt, torch.zeros_like(bt))
    scal = cg_step.new_scalars(r)
    cg_step.cg_start(scal, part_rr, part_rr, part_bb, 1e-3, True)
    assert float(scal[cg_step.RZ]) == pytest.approx(b @ b, rel=1e-14)
    assert float(scal[cg_step.THRESH]) == pytest.approx(1e-6 * (b @ b),
                                                        rel=1e-14)
    assert float(scal[cg_step.CONT]) == 1.0 and float(scal[cg_step.PD]) == 1.0
    x = torch.zeros_like(bt)
    hp = St @ p
    part_pap = cg_step.dot_partials(p, hp)
    alpha = (b @ b) / (b @ S @ b)
    part_rr = cg_step.cg_update_xr(scal, part_pap, x, r, p, hp)
    assert float(scal[cg_step.ALPHA]) == pytest.approx(alpha, rel=1e-13)
    np.testing.assert_allclose(x.numpy(), alpha * b, rtol=1e-13)
    r_ref = b - alpha * (S @ b)
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=1e-12,
                               atol=1e-13 * np.abs(b).max())
    cg_step.cg_update_p(scal, part_rr, part_rr, r, p, True)
    beta = (r_ref @ r_ref) / (b @ b)
    assert float(scal[cg_step.BETA]) == pytest.approx(beta, rel=1e-11)
    assert float(scal[cg_step.RZ]) == pytest.approx(r_ref @ r_ref, rel=1e-11)
    np.testing.assert_allclose(p.numpy(), r_ref + beta * b, rtol=1e-11,
                               atol=1e-13 * np.abs(b).max())
    assert float(scal[cg_step.PD]) == 1.0
    ok = cg_step.cg_finish(scal, [x])
    assert bool(ok) and x.any()
    x[3] = float("inf")
    assert not bool(cg_step.cg_finish(scal, [x])) and not x.any()


@pytest.mark.parametrize("n,blocks", [
    (300_000, 147), (600_000, 293), (0, 1), (1, 1), (2048, 1), (2049, 2),
    (4096, 2), (100_000, 49), (5_400, 3), (600_001, 293)])
def test_update_xr_share_is_fixed(n, blocks):
    """cg_update_xr's r . r partials on the card number one per block of
    XR_SHARE (2048) values, whatever the card: the serpentine's 3 x 100,000
    values give 147 partials (293 before, one per 1024 values), which its
    finishing block and cg_update_p re-reduce."""
    assert cg_step.XR_SHARE == 2048
    assert cg_step.xr_blocks(n) == blocks


def test_update_xr_checks_its_counter():
    S, b = _spd(3, n=30)
    bt = torch.as_tensor(b)
    r, p, part_rr, part_bb = cg_step.cg_residual(bt, torch.zeros_like(bt))
    hp = torch.as_tensor(S) @ p
    pap = cg_step.dot_partials(p, hp)
    scal = cg_step.new_scalars(r)
    cg_step.cg_start(scal, part_rr, part_rr, part_bb, 1e-3, True)
    x, r_ = torch.zeros_like(bt), r.clone()
    arrivals = torch.zeros(1, dtype=torch.int32)
    cg_step.cg_update_xr(scal, pap, x, r_, p, hp, arrivals)
    assert not arrivals.any()
    with pytest.raises(ValueError, match="one counter"):
        cg_step.cg_update_xr(scal, pap, x, r_, p, hp,
                             torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        cg_step.cg_update_xr(scal, pap, x, r_, p, hp,
                             torch.zeros(1, dtype=torch.int64))
