"""The Schur BA solver's pieces (K10-K13 on their plain versions) against
the JAX package's internals, float64 on the CPU.

Problems: the all-types BA scene of test_torch_ba_types.py (three
projection groups: XYZ2UV, XYZ2UV with Huber, the stereo XYZ2UVU; pose-pose
EDGE_SE3:EXPMAP edges; camera 0 and one point fixed), a small
`synthetic_bal_problem` and a small BAL file of the 9-wide camera
(`bal_camera_jax_problem`), each built by the JAX package and carried
across with interop.problem_from_numpy.

* the pattern tables against the JAX dual-ELL tables;
* `dense_schur_ok` against the JAX predicate on both sides of each of its
  gates (the pose width, the one-hot operand, the landmark degree, the
  densified W), the JAX module constants lowered to reach them;
* `_build`: Hll, b_l, Hcc, b_p and W per observation (every product and
  sum is the same float64 arithmetic in another order) to rtol 1e-12 of the
  largest entry, Hpp_extra and b_extra likewise, on the all-types scene and
  on a BAL camera scene ((Dp, dl) = (9, 3), tests/test_torch_bal.py);
* `_inv_lane` and the damping for D = 2, 3, 6, 9, an indefinite block
  among them: 1e-12 (the same formula);
* `_solve`'s dx at a fixed lambda: the dense route to rtol 1e-9 of the
  largest entry (another Cholesky orders the factorization differently, and
  S is formed from its nonzero terms instead of the densified product); the
  implicit route with the same pcg_iters and pcg_tol to 1e-8 (CG repeats
  the JAX iteration count; its rounding grows with the iterations).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.apps.simulator import synthetic_bal_problem as j_bal
from openslam_g2o_tpu.core import ba_ell as jba
from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core.graph import Graph as JGraph

from openslam_g2o_torch.core import ba_ell as tba
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import ba_inv
from tests.test_torch_ba_types import build_ba_graph
from tests.test_torch_bal import bal_camera_jax_problem

torch.set_num_threads(1)

RTOL_BUILD = 1e-12
RTOL_DENSE = 1e-9
RTOL_IMPLICIT = 1e-8


def _close(t, j, rtol):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    scale = max(float(np.abs(j).max()), 1e-300)
    assert t.shape == j.shape
    assert float(np.abs(t - j).max()) <= rtol * scale, \
        float(np.abs(t - j).max()) / scale


def _pair(kind):
    if kind == "scene":
        jprob = build_ba_graph(JGraph).compile(dtype=jnp.float64)
    elif kind == "bal_camera":
        jprob = bal_camera_jax_problem()
    else:
        jprob, _ = j_bal(n_cams=24, n_points=400, dtype=jnp.float64)
    return jprob, problem_from_numpy(**problem_arrays(jprob), device="cpu")


@pytest.fixture(scope="module")
def scene():
    return _pair("scene")


@pytest.fixture(scope="module")
def bal():
    return _pair("bal")


def _per_obs_w(pattern_groups, W_of_group, n_rows):
    """JAX: every group's landmark-major W back to one [rows, E_total]
    array in the port's observation order (group after group)."""
    cols = []
    for pg, W in zip(pattern_groups, W_of_group):
        idx = np.asarray(pg.lm_edge_idx)             # [L, K_l]
        mask = np.asarray(pg.lm_mask) > 0
        E = int(mask.sum())
        out = np.zeros((n_rows, E))
        Wn = np.asarray(W)                           # [rows, K_l, L]
        ll, kk = np.nonzero(mask)
        out[:, idx[ll, kk]] = Wn[:, kk, ll]
        cols.append(out)
    return np.concatenate(cols, axis=1)


def test_pattern_tables_match_jax(scene):
    jprob, tprob = scene
    jpat, tpat = jba.build_ba_ell_pattern(jprob), tba.build_ba_ell_pattern(
        tprob)
    assert [pg.egkey for pg in jpat.proj] == [pg.egkey for pg in tpat.proj]
    assert list(jpat.pose_only_keys) == list(tpat.pose_only_keys) \
        == ["edge_se3_expmap"]
    lm_edge = tpat.lm_edge.numpy()
    offset = 0
    for jpg, tpg in zip(jpat.proj, tpat.proj):
        assert tpg.offset == offset and tpg.k_l == jpg.lm_edge_idx.shape[1]
        assert tpg.fused == (jpg.egkey.split("#")[0]
                             == "edge_project_xyz2uv")
        offset += tpg.count
    # each landmark's observations, group after group, in edge order
    L = tpat.n_lm
    want = [[] for _ in range(L)]
    for jpg, tpg in zip(jpat.proj, tpat.proj):
        idx, mask = np.asarray(jpg.lm_edge_idx), np.asarray(jpg.lm_mask)
        for l in range(L):
            want[l] += [tpg.offset + int(e) for e, m in zip(idx[l], mask[l])
                        if m > 0]
    for l in range(L):
        got = [int(e) for e in lm_edge[:, l] if e >= 0]
        assert got == want[l]
        assert (lm_edge[len(got):, l] == -1).all()
    li = np.concatenate([np.asarray(jprob.edges[pg.egkey].indices[pg.lm_slot])
                         for pg in jpat.proj])
    ci = np.concatenate([np.asarray(
        jprob.edges[pg.egkey].indices[pg.cam_slot]) for pg in jpat.proj])
    np.testing.assert_array_equal(
        tpat.lm_cam.numpy(), np.where(lm_edge >= 0, ci[lm_edge], -1))
    ptr, cam_edge = tpat.cam_ptr.numpy(), tpat.cam_edge.numpy()
    for c in range(tpat.n_cam):
        np.testing.assert_array_equal(cam_edge[ptr[c]:ptr[c + 1]],
                                      np.nonzero(ci == c)[0])
    np.testing.assert_array_equal(tpat.cam_lm.numpy(), li[cam_edge])


@pytest.mark.parametrize("gate,max_tp,max_bytes,k_chunk,expect", [
    ("all pass", 1536, 3e8, 512, True),
    ("pose width", 143, 3e8, 512, False),
    ("pose width, edge", 144, 3e8, 512, True),
    ("densified W", 1536, 1.3e6, 512, False),
    ("one-hot operand", 1536, 6.0e5, 512, False),
    ("landmark degree", 1536, 3e8, 3, False),
    ("landmark degree, edge", 1536, 3e8, 4, True),
])
def test_dense_schur_ok_matches_jax(bal, monkeypatch, gate, max_tp,
                                    max_bytes, k_chunk, expect):
    """The synthetic problem (Tp = 144, L = 400, C = 24, K_l = 8, float64:
    one-hot operand 614,400 bytes, densified W 1,382,400 bytes) on both
    sides of each gate."""
    jprob, tprob = bal
    for mod in (jba, tba):
        monkeypatch.setattr(mod, "_DENSE_SCHUR_MAX_TP", max_tp)
        monkeypatch.setattr(mod, "_DENSE_SCHUR_MAX_OPERAND_BYTES", max_bytes)
    monkeypatch.setattr(jba, "_K_CHUNK", k_chunk)
    monkeypatch.setattr(tba, "_DENSE_SCHUR_MAX_K", 2 * k_chunk)
    j_ok = jba.dense_schur_ok(jprob, jba.build_ba_ell_pattern(jprob))
    t_ok = tba.dense_schur_ok(tprob, tba.build_ba_ell_pattern(tprob))
    assert j_ok == t_ok == expect, gate


def _jax_build(jprob):
    jpat = jba.build_ba_ell_pattern(jprob)
    return jpat, jax.jit(lambda p, pat: jba._build(
        p, pat, jproblem.linearize(p)))(jprob, jpat)


@pytest.mark.parametrize("kind", ["scene", "bal_camera"])
def test_build_matches_jax(kind):
    """The all-types scene ((Dp, dl) = (6, 3), pose-pose edges, a fixed
    point) and a BAL camera scene ((9, 3), the generic entry over
    EDGE_PROJECT_BAL)."""
    jprob, tprob = _pair(kind)
    jpat, jsys = _jax_build(jprob)
    tpat = tba.build_ba_ell_pattern(tprob)
    tsys = tba._build(tprob, tpat)
    dl, L, dp, C = 3, tpat.n_lm, tpat.dp, tpat.n_cam
    assert dp == (9 if kind == "bal_camera" else 6)
    _close(tsys["Hll"], np.asarray(jsys["Hll"]).reshape(dl * dl, L),
           RTOL_BUILD)
    _close(tsys["b_l"], jsys["b_l"], RTOL_BUILD)
    g = jsys["groups"][tpat.cam_name]
    _close(tsys["Hcc"], np.asarray(g["Hcc"]).reshape(dp * dp, C), RTOL_BUILD)
    _close(tsys["b_p"], g["bT"], RTOL_BUILD)
    w_obs = _per_obs_w(jpat.proj, [pd["W_lm"][0] for pd in jsys["proj"]],
                       dp * dl)
    lm_edge = tpat.lm_edge.numpy()
    kk, ll = np.nonzero(lm_edge >= 0)
    t_obs = np.zeros_like(w_obs)
    t_obs[:, lm_edge[kk, ll]] = tsys["W_lm"].numpy()[:, kk, ll]
    _close(t_obs, w_obs, RTOL_BUILD)
    assert (tsys["W_lm"].numpy()[:, lm_edge < 0] == 0).all()
    _close(tsys["W_cam"], w_obs[:, tpat.cam_edge.numpy()], RTOL_BUILD)
    if kind == "bal_camera":              # no pose-pose edges
        assert tsys["Hpp_extra"] is None
        assert not np.asarray(jsys["Hpp_extra"]).any()
        return
    _close(tsys["Hpp_extra"], jsys["Hpp_extra"], RTOL_BUILD)
    _close(tsys["b_extra"], jsys["b_extra"], RTOL_BUILD)
    # the fixed point's block is zero (its columns are masked)
    assert (tsys["Hll"][:, 4] == 0).all()


@pytest.mark.parametrize("D", [2, 3, 6, 9])
def test_block_inverse_and_damping_match_jax(D):
    rng = np.random.default_rng(D)
    N = 300
    B = rng.normal(size=(N, D, D))
    A = B @ B.transpose(0, 2, 1) + 0.3 * np.eye(D)
    A[5] = -A[5]                                     # indefinite
    A[9] = B[9] + B[9].T                             # symmetric, indefinite
    lane = np.ascontiguousarray(A.transpose(1, 2, 0))   # [D, D, N]
    flat = torch.as_tensor(lane.reshape(D * D, N))
    free = np.ones(N)
    free[[2, 7]] = 0.0
    lam, b = 0.25, rng.normal(size=(D, N))
    eye = jnp.eye(D)[:, :, None]
    jl = jnp.asarray(lane)
    jfree = jnp.asarray(free)
    cases = {
        ba_inv.PLAIN: (jl, {}),
        ba_inv.LANDMARK: (jl + eye * (lam * jfree + (1.0 - jfree))[None, None],
                          dict(b=torch.as_tensor(b))),
        ba_inv.CAMERA: ((jl + lam * eye) * jfree[None, None]
                        + (1.0 - jfree[None, None]) * eye, {}),
    }
    for mode, (damped, kw) in cases.items():
        extra = {} if mode == ba_inv.PLAIN else dict(
            free=torch.as_tensor(free),
            lam=torch.tensor(lam, dtype=torch.float64))
        t_damped, t_inv, t_hib = ba_inv.ba_block_inv(flat, mode, **extra,
                                                     **kw)
        j_inv = np.asarray(jba._inv_lane(damped))
        _close(t_inv, j_inv.reshape(D * D, N), RTOL_BUILD)
        if mode == ba_inv.CAMERA:
            _close(t_damped, np.asarray(damped).reshape(D * D, N), 0.0)
        if mode == ba_inv.LANDMARK:
            _close(t_hib, np.asarray(jba._bmv_lane(jnp.asarray(j_inv),
                                                   jnp.asarray(b))),
                   RTOL_BUILD)


def _solve_both(jprob, tprob, lam, pcg_iters, pcg_tol):
    jpat = jba.build_ba_ell_pattern(jprob)
    tpat = tba.build_ba_ell_pattern(tprob)
    tsys = tba._build(tprob, tpat)
    jdx, jok, jb = jax.jit(lambda p, pat, la: jba._solve(
        p, pat, jba._build(p, pat, jproblem.linearize(p)), la, pcg_iters,
        pcg_tol=pcg_tol))(jprob, jpat, jnp.asarray(lam))
    tdx, tok, tb = tba._solve(tprob, tpat, tsys,
                              torch.tensor(lam, dtype=torch.float64),
                              pcg_iters, pcg_tol)
    assert bool(jok) and bool(tok)
    return jdx, tdx, jb, tb


@pytest.mark.parametrize("kind", ["scene", "bal", "bal_camera"])
@pytest.mark.parametrize("route", ["dense", "implicit"])
def test_solve_matches_jax(kind, route, monkeypatch):
    jprob, tprob = _pair(kind)
    if route == "implicit":
        for mod in (jba, tba):
            monkeypatch.setattr(mod, "_DENSE_SCHUR_MAX_TP", -1)
    assert jba.dense_schur_ok(jprob, jba.build_ba_ell_pattern(jprob)) \
        == tba.dense_schur_ok(tprob, tba.build_ba_ell_pattern(tprob)) \
        == (route == "dense")
    jdx, tdx, jb, tb = _solve_both(jprob, tprob, 0.5, 30, 1e-6)
    rtol = RTOL_DENSE if route == "dense" else RTOL_IMPLICIT
    assert set(jdx) == set(tdx)
    for k in jdx:
        _close(tdx[k], jdx[k], rtol)
        _close(tb[k], jb[k], RTOL_BUILD)


def test_pattern_refuses_two_pose_groups():
    """The port's Schur solver takes one pose vertex group (the JAX code
    loops over several): a landmark seen from an SE2 and an SE3 pose."""
    from openslam_g2o_torch.core.graph import Graph as TGraph
    g = TGraph()
    g.add_parameter(0, "se3_offset", [0, 0, 0, 0, 0, 0, 1.0])
    g.add_vertex(0, "se2", [0.0, 0.0, 0.0], fixed=True)
    g.add_vertex(1, "se3", [0, 0, 0, 0, 0, 0, 1.0])
    g.add_vertex(2, "point_xy", [1.0, 0.5])
    g.add_vertex(3, "point_xyz", [1.0, 0.5, 2.0])
    g.add_edge("edge_se2_xy", (0, 2), [1.0, 0.5], np.eye(2))
    g.add_edge("edge_se3_xyz", (1, 3), [1.0, 0.5, 2.0], np.eye(3),
               param_ids=[0])
    prob = g.compile(device="cpu")
    with pytest.raises(ValueError, match="one marginalized"):
        tba.build_ba_ell_pattern(prob)
    g2 = TGraph()
    g2.add_vertex(0, "se2", [0.0, 0.0, 0.0], fixed=True)
    g2.add_vertex(1, "se3_expmap", [0, 0, 0, 0, 0, 0, 1.0])
    g2.add_vertex(2, "point_xy", [1.0, 0.5])
    g2.add_edge("edge_se2_xy", (0, 2), [1.0, 0.5], np.eye(2))
    with pytest.raises(NotImplementedError, match="one pose vertex group"):
        tba.build_ba_ell_pattern(g2.compile(device="cpu"))
