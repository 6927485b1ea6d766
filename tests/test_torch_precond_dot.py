"""K4's `lane_block_mv_dot` (kernels/jacobi_scale.py: the block-Jacobi step
z = M r of the Schur routes' preconditioned CG and the partial sums of
r . z in one launch) and its `BlockJacobi` preconditioner
(core/solvers.py), float64 on the CPU (the plain versions).

* `lane_block_mv_dot` against `lane_block_mv_plain` + cg_step's
  `dot_partials_plain` at D = 2, 3, 4, 6, 9 in both dtypes: the same bits
  (the plain version is that composition), and against numpy to 1e-12 /
  1e-5 of the largest entry;
* `pcg_solve` with `BlockJacobi` against the same solve with the plain
  closure it replaced (the block product per group, then `dot_partials`):
  the same x and ok, bit for bit, on both Schur routes;
* the dual-ELL implicit `_solve` on a small BAL camera scene (D = 9) and
  on the synthetic SE3:EXPMAP BAL problem (D = 6) against JAX's `_solve`,
  rtol 1e-10 of the largest entry (20 CG iterations each way, so both run
  the same iterations; the JAX test of the route, test_torch_ba_kernels.py,
  allows 1e-8 after 30);
* the general path's `schur_solve` on the shared-intrinsics scene (two
  pose groups: D = 4 and 6) against JAX: the step to 1e-6 after CG to tol
  1e-12 (tests/test_torch_schur_general.py's bound; the scene's reduced
  system amplifies rounding, see the test), b to 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scenes
from openslam_g2o_tpu.apps.simulator import synthetic_bal_problem as j_bal
from openslam_g2o_tpu.core import ba as jba
from openslam_g2o_tpu.core import ba_ell as jba_ell
from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core.graph import Graph as JGraph

from openslam_g2o_torch import kernels
from openslam_g2o_torch.core import ba as tba
from openslam_g2o_torch.core import ba_ell as tba_ell
from openslam_g2o_torch.core import solvers
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import cg_step, jacobi_scale
from tests.test_torch_bal import bal_camera_jax_problem

torch.set_num_threads(1)

RTOL = 1e-10
# CG iterations of the solves held against JAX: with pcg_tol below reach,
# both packages run exactly this many
CG_ITERS = 20
TOL_MV = {torch.float64: 1e-12, torch.float32: 1e-5}


def _close(t, j, rtol=RTOL):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    scale = max(float(np.abs(j).max()), 1e-300)
    assert t.shape == j.shape
    assert float(np.abs(t - j).max()) <= rtol * scale, \
        float(np.abs(t - j).max()) / scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", list(jacobi_scale.MV_DOT_WIDTHS))
def test_lane_block_mv_dot_is_block_mv_then_dot(D, dtype):
    rng = np.random.default_rng(D)
    N = 1500
    M = rng.normal(size=(D, D, N))
    r = rng.normal(size=(D, N))
    Mt = torch.as_tensor(M.reshape(D * D, N), dtype=dtype)
    rt = torch.as_tensor(r, dtype=dtype)
    kernels.reset_launch_counts()
    z, part = jacobi_scale.lane_block_mv_dot(Mt, rt)
    z_ref = jacobi_scale.lane_block_mv_plain(Mt, rt)
    assert torch.equal(z, z_ref)
    assert torch.equal(part, cg_step.dot_partials_plain(rt, z_ref))
    want = np.einsum("abn,bn->an", M, r)
    _close(z, want.astype(z.numpy().dtype), TOL_MV[dtype])
    _close(part.sum().reshape(()), np.sum(r * want), TOL_MV[dtype])
    assert set(kernels.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="lane_block_mv_dot"):
        jacobi_scale.lane_block_mv_dot(Mt[:, :-1], rt)
    with pytest.raises(ValueError, match="lane_block_mv_dot"):
        jacobi_scale.lane_block_mv_dot(Mt, rt.T.contiguous().T)


def test_lane_block_mv_dot_refuses_an_unserved_width():
    M = torch.zeros(25, 10, dtype=torch.float64)
    with pytest.raises(ValueError, match="D in"):
        jacobi_scale.lane_block_mv_dot(M, torch.zeros(5, 10,
                                                      dtype=torch.float64))


def test_block_jacobi_applies_and_dots_per_group():
    rng = np.random.default_rng(3)
    tables, r = {}, {}
    for name, D, N in (("a", 4, 1), ("b", 6, 37), ("c", 9, 5)):
        tables[name] = torch.as_tensor(rng.normal(size=(D * D, N)))
        r[name] = torch.as_tensor(rng.normal(size=(D, N)))
    pre = solvers.BlockJacobi(tables)
    z, part = pre.apply_dot(r)
    assert list(z) == list(r)
    for k in r:
        assert torch.equal(z[k], jacobi_scale.lane_block_mv_plain(tables[k],
                                                                  r[k]))
    assert torch.equal(part, torch.cat(
        [cg_step.dot_partials(r[k], z[k]) for k in r]))


def _closure(tables):
    """The preconditioner as the Schur routes had it before BlockJacobi: a
    plain function, which pcg_solve follows by dot_partials per group (the
    widths 4 and 9 are lane_block_mv_dot's alone, so z is the plain
    version's, which is what lane_block_mv ran on CPU tensors)."""
    return lambda r: {k: jacobi_scale.lane_block_mv_plain(tables[k], v)
                      for k, v in r.items()}


def _bal_pair(kind):
    if kind == "bal_camera":
        jprob = bal_camera_jax_problem()
    else:
        jprob, _ = j_bal(n_cams=24, n_points=400, dtype=jnp.float64)
    return jprob, problem_from_numpy(**problem_arrays(jprob), device="cpu")


def _intrinsics_pair():
    jprob = scenes.p2mc_intrinsics_graph(
        JGraph, scenes.bal_geometry(10, 120)).compile(dtype=jnp.float64)
    return jprob, problem_from_numpy(**problem_arrays(jprob), device="cpu")


@pytest.mark.parametrize("route", ["ell_bal_camera", "ell_expmap",
                                   "general"])
def test_pcg_with_block_jacobi_equals_the_closure(route, monkeypatch):
    """Each Schur route's solve with BlockJacobi (apply_dot) and with the
    plain closure: the same step and ok, bit for bit (on the CPU both run
    lane_block_mv_plain and torch.dot; on the card the kernel's partials
    carry dot_partials' bits, tests/test_torch_kernels.py)."""
    lam = torch.tensor(0.5, dtype=torch.float64)
    if route == "general":
        _, tprob = _intrinsics_pair()
        sys = tba.schur_build(tprob)
        run = lambda: tba._solve(tprob, sys, lam, CG_ITERS, 1e-30)
        mod = tba
    else:
        _, tprob = _bal_pair(route[len("ell_"):])
        monkeypatch.setattr(tba_ell, "_DENSE_SCHUR_MAX_TP", -1)
        pat = tba_ell.build_ba_ell_pattern(tprob)
        sys = tba_ell._build(tprob, pat)
        run = lambda: tba_ell._solve(tprob, pat, sys, lam, CG_ITERS, 1e-30)
        mod = tba_ell
    calls = []
    real = solvers.BlockJacobi

    def counting(tables):
        pre = real(tables)
        fused = pre.apply_dot
        pre.apply_dot = lambda r: calls.append(1) or fused(r)
        return pre

    monkeypatch.setattr(mod, "BlockJacobi", counting)
    dx, ok, b = run()
    # the start (r and, under the preconditioned norm, b) and every
    # iteration go through apply_dot
    assert len(calls) >= CG_ITERS + 1
    monkeypatch.setattr(mod, "BlockJacobi", _closure)
    dx2, ok2, b2 = run()
    assert bool(ok) and bool(ok2)
    assert list(dx) == list(dx2)
    for k in dx:
        assert torch.equal(dx[k], dx2[k]), k
        assert torch.equal(b[k], b2[k]), k


@pytest.mark.parametrize("kind,D", [("bal_camera", 9), ("expmap", 6)])
def test_implicit_solve_matches_jax(kind, D, monkeypatch):
    """The dual-ELL implicit route's _solve (pcg_solve with BlockJacobi at
    the camera width D) against JAX's _solve at lambda 0.5."""
    jprob, tprob = _bal_pair(kind)
    for mod in (jba_ell, tba_ell):
        monkeypatch.setattr(mod, "_DENSE_SCHUR_MAX_TP", -1)
    jpat = jba_ell.build_ba_ell_pattern(jprob)
    tpat = tba_ell.build_ba_ell_pattern(tprob)
    assert tpat.dp == D
    assert not tba_ell.dense_schur_ok(tprob, tpat)
    jdx, jok, jb = jax.jit(lambda p, pat, la: jba_ell._solve(
        p, pat, jba_ell._build(p, pat, jproblem.linearize(p)), la,
        CG_ITERS, pcg_tol=1e-30))(jprob, jpat, jnp.asarray(0.5))
    tdx, tok, tb = tba_ell._solve(
        tprob, tpat, tba_ell._build(tprob, tpat),
        torch.tensor(0.5, dtype=torch.float64), CG_ITERS, 1e-30)
    assert bool(jok) and bool(tok)
    assert set(jdx) == set(tdx)
    for k in jdx:
        _close(tdx[k], jdx[k])
        _close(tb[k], jb[k])


def test_general_solve_with_two_pose_groups_matches_jax():
    """The general path's schur_solve on the shared-intrinsics scene: two
    pose groups (VERTEX_INTRINSICS, D = 4, and VERTEX_CAM, D = 6), each
    preconditioned by its BlockJacobi table, against JAX. Its reduced
    system is ill-conditioned (the intrinsics hub couples every camera):
    after 20 iterations the two packages' rounding has grown to 3e-8 of
    the largest entry, so the step is held as
    tests/test_torch_schur_general.py holds it, solved to tol 1e-12, to
    1e-6, and b to 1e-10."""
    jprob, tprob = _intrinsics_pair()
    assert len(tba.build_schur_pattern(tprob).pose_groups) == 2
    jdx, jok, jb, _ = jba.schur_solve(jprob, jba.schur_build(jprob),
                                      jnp.asarray(1e-3), pcg_iters=500,
                                      pcg_tol=1e-12)
    tdx, tok, tb, _ = tba.schur_solve(tprob, tba.schur_build(tprob), 1e-3,
                                      pcg_iters=500, pcg_tol=1e-12)
    assert bool(jok) and bool(tok)
    _close(tdx, jdx, 1e-6)
    _close(tb, jb)
