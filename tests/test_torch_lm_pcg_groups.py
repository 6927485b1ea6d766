"""LM-PCG over several vertex groups (core/sparse.py `PairPattern`, the pair
kernels of kernels/pair_ell.py) against the JAX package, float64 on the CPU
(the kernels' plain versions).

Worlds, small, built through either package's API (or carried across with
interop):
* "2d": Simulator2D(n_landmarks=20, seed=0).simulate(40): se2 poses and
  point_xy landmarks, pairs (3, 3), (3, 2), (2, 3), (2, 2);
* "3d": Simulator3D(n_landmarks=20, seed=0).simulate(20): se3 and
  point_xyz, pairs (6, 6), (6, 3), (3, 6), (3, 3);
* "psi2uv": chip_smoke.py's ternary EDGE_PROJECT_PSI2UV scene on a BAL
  geometry of 10 cameras and 40 points (se3_expmap and sba_point_xyz);
* "se3_prior": one group of SE3 poses with EDGE_SE3 and an EDGE_SE3_PRIOR
  (one group, but not the EllPattern's edge type);
* "points": a point-only graph of point_xy vertices joined by an edge type
  registered at run time in both packages (x_j - x_i - z).

Tolerances: the pair tables rebuilt as dense blocks, b, the scaled system,
the matvec, the Gershgorin bound and lambda0 against JAX: rtol 1e-12 of the
largest entry; the chi2 trajectories of `optimize(..., LevenbergMarquardtPCG)`
and of `lm_pcg_optimize_fused` (pcg_cheby 0 and 4) against JAX's
LevenbergMarquardtPCG: rtol 1e-8 while an iteration gains more than 1e-10 of
chi2, with CG run to a tight tolerance (as tests/test_torch_ba_lm.py does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scenes
from openslam_g2o_tpu.apps.simulator import Simulator2D as JSim2D
from openslam_g2o_tpu.apps.simulator import Simulator3D as JSim3D
from openslam_g2o_tpu.apps.simulator import create_sphere as j_sphere
from openslam_g2o_tpu.core import algorithms as jalg
from openslam_g2o_tpu.core import registry as jregistry
from openslam_g2o_tpu.core import solvers as jsolvers
from openslam_g2o_tpu.core import sparse as jsparse
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.core.problem import linearize as j_linearize

from openslam_g2o_torch.apps.simulator import Simulator2D as TSim2D
from openslam_g2o_torch.apps.simulator import Simulator3D as TSim3D
from openslam_g2o_torch.apps.simulator import create_sphere as t_sphere
from openslam_g2o_torch.apps.simulator import synthetic_pose_graph_2d
from openslam_g2o_torch.core import algorithms as talg
from openslam_g2o_torch.core import registry as tregistry
from openslam_g2o_torch.core import sparse as tsparse
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import pair_ell
from openslam_g2o_torch.kernels._checks import PAIR_WIDTHS
from openslam_g2o_torch.kernels.damp_chol import damp_chol
from openslam_g2o_torch.kernels.jacobi_scale import lane_block_mv

torch.set_num_threads(2)

RTOL = 1e-12
TRAJ_RTOL = 1e-8
TIGHT = dict(pcg_iters=500, pcg_tol=1e-12)
POINTS_EDGE = "edge_xy_diff_groups_test"


def _register_points_edge():
    if POINTS_EDGE not in tregistry._EDGE_TYPES:
        tregistry.register_edge_type(tregistry.EdgeType(
            name=POINTS_EDGE, tag="EDGE_XY_DIFF_GROUPS_TEST",
            vertex_types=("point_xy", "point_xy"), error_dim=2,
            measurement_dim=2,
            error=lambda vp, meas, pdata: vp[1] - vp[0] - meas))
        jregistry.register_edge_type(jregistry.EdgeType(
            name=POINTS_EDGE, tag="EDGE_XY_DIFF_GROUPS_TEST",
            vertex_types=("point_xy", "point_xy"), error_dim=2,
            measurement_dim=2,
            error=lambda vp, meas, pdata: vp[1] - vp[0] - meas))


def _points_graph(Graph, n=30, seed=3):
    rng = np.random.default_rng(seed)
    truth = rng.uniform(-5, 5, size=(n, 2))
    g = Graph()
    for i, p in enumerate(truth):
        g.add_vertex(i, "point_xy", p + rng.normal(0, 0.3, 2) * (i > 0),
                     fixed=(i == 0))
    pairs = [(i, i + 1) for i in range(n - 1)] + [
        tuple(rng.choice(n, 2, replace=False)) for _ in range(2 * n)]
    for i, j in pairs:
        info = np.diag(rng.uniform(1.0, 4.0, 2))
        g.add_edge(POINTS_EDGE, (int(i), int(j)),
                   truth[j] - truth[i] + rng.normal(0, 0.05, 2), info)
    return g


def _se3_prior_graph(Graph, sphere):
    g, _ = sphere(n_laps=3, n_per_lap=8, radius=10.0, seed=2)
    g.add_parameter(0, "se3_offset", [0, 0, 0, 0, 0, 0, 1])
    g.add_edge("edge_se3_prior", (5,), [1.0, 2.0, 0.5, 0, 0, 0, 1],
               np.eye(6) * 3.0, param_ids=[0])
    return g


def _make(name):
    if name == "2d":
        return (JSim2D(n_landmarks=20, seed=0).simulate(40)[0]
                .compile(dtype=jnp.float64),
                TSim2D(n_landmarks=20, seed=0).simulate(40)[0]
                .compile(device="cpu"))
    if name == "3d":
        return (JSim3D(n_landmarks=20, seed=0).simulate(20)[0]
                .compile(dtype=jnp.float64),
                TSim3D(n_landmarks=20, seed=0).simulate(20)[0]
                .compile(device="cpu"))
    if name == "psi2uv":
        jprob = scenes.psi2uv_graph(JGraph, scenes.bal_geometry(10, 40)) \
            .compile(dtype=jnp.float64)
        return jprob, problem_from_numpy(**problem_arrays(jprob),
                                         device="cpu")
    if name == "se3_prior":
        return (_se3_prior_graph(JGraph, j_sphere).compile(dtype=jnp.float64),
                _se3_prior_graph(TGraph, t_sphere).compile(device="cpu"))
    _register_points_edge()
    return (_points_graph(JGraph).compile(dtype=jnp.float64),
            _points_graph(TGraph).compile(device="cpu"))


WORLDS = ("2d", "3d", "psi2uv", "se3_prior", "points")
_cache = {}


def world(name):
    if name not in _cache:
        _cache[name] = _make(name)
    return _cache[name]


def _close(t, j, rtol=RTOL):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=rtol * max(float(np.abs(j).max()), 1e-300))


def _dense_jax(jprob, jpat, values):
    """{(rg, cg): the pair's blocks as a dense [Nr Dr, Nc Dc] matrix}."""
    out = {}
    for pid, (rg, cg) in enumerate(jpat.pairs):
        R, C = jprob.static.vgroup(rg), jprob.static.vgroup(cg)
        dr, dc = R.tangent_dim, C.tangent_dim
        nb = np.asarray(jpat.nb_idx[pid])                  # [N, K]
        v = np.asarray(values[pid]).reshape(dr, dc, R.count, nb.shape[1])
        M = np.zeros((R.count, dr, C.count, dc))
        for k in range(nb.shape[1]):
            np.add.at(M, (np.arange(R.count), slice(None), nb[:, k]),
                      np.moveaxis(v[:, :, :, k], 2, 0))
        out[(rg, cg)] = M.reshape(R.count * dr, C.count * dc)
    return out


def _dense_torch(tpat, values):
    out = {}
    for pt, v in zip(tpat.pairs, values):
        nb = pt.nb.numpy()                                 # [K, N]
        vv = v.numpy().reshape(pt.k, pt.dr, pt.dc, pt.n)
        M = np.zeros((pt.n, pt.dr, tpat.counts[pt.cg], pt.dc))
        for k in range(pt.k):
            np.add.at(M, (np.arange(pt.n), slice(None), nb[k]),
                      np.moveaxis(vv[k], 2, 0))
        out[(pt.rg, pt.cg)] = M.reshape(pt.n * pt.dr, -1)
    return out


def _compare_pairs(jdense, tdense, rtol=RTOL):
    """Every JAX pair table equals the port's; the port's extra square
    tables (groups no edge reaches) are zero."""
    for key, jm in jdense.items():
        _close(tdense[key], jm, rtol)
    for key in set(tdense) - set(jdense):
        assert not tdense[key].any()


_systems = {}


def systems(name):
    """(jpat, JAX values, JAX b, tpat, port values, port bT) of a world,
    JAX's linearize + assemble_ell under one jit."""
    if name not in _systems:
        jprob, tprob = world(name)
        jpat = jsparse.build_ell_pattern(jprob)
        jvals, jb = jax.jit(lambda p: jsparse.assemble_ell(
            p, jpat, j_linearize(p)))(jprob)
        tpat = tsparse.build_ell_pattern(tprob)
        _systems[name] = (jpat, jvals, jb, tpat,
                          *tsparse.assemble_ell(tprob, tpat))
    return _systems[name]


# -- the pattern ------------------------------------------------------------

def test_pose_graphs_keep_the_one_group_pattern():
    """One group of SE2 or SE3 poses with only EDGE_SE2 / EDGE_SE3 edges
    keeps the EllPattern of kernels B / K16, C and A."""
    p2 = synthetic_pose_graph_2d(60, grid=6, device="cpu")[0]
    assert isinstance(tsparse.build_ell_pattern(p2), tsparse.EllPattern)
    g3, _ = t_sphere(n_laps=3, n_per_lap=8, radius=10.0, seed=2)
    assert isinstance(tsparse.build_ell_pattern(g3.compile(device="cpu")),
                      tsparse.EllPattern)


@pytest.mark.parametrize("name", WORLDS)
def test_pair_pattern_orders_pairs_as_jax(name):
    """The pair tables in the JAX package's first-seen order (then a square
    table per group no edge reaches), slot 0 of a square pair the diagonal,
    and every JAX slot present in the port's table of that row."""
    jprob, tprob = world(name)
    tpat = tsparse.build_ell_pattern(tprob)
    jpat = jsparse.build_ell_pattern(jprob)
    assert isinstance(tpat, tsparse.PairPattern)
    assert [(p.rg, p.cg) for p in tpat.pairs][:len(jpat.pairs)] \
        == list(jpat.pairs)
    for g, i in tpat.square.items():
        pt = tpat.pairs[i]
        assert pt.square and (pt.nb[0] == torch.arange(pt.n)).all()
        assert tpat.rows[g][0] <= i
    # the slots of every row: JAX's columns (its padding points at column
    # 0) are the port's
    for pid, (rg, cg) in enumerate(jpat.pairs):
        pt = tpat.pairs[pid]
        jnb = np.asarray(jpat.nb_idx[pid])                     # [N, K]
        for n in range(pt.n):
            assert set(jnb[n]) - {0} <= set(pt.nb[:, n].tolist())


def test_widths_without_an_instantiation_are_refused():
    """A vertex group of a width the pair kernels are not instantiated for
    (VERTEX_INTRINSICS, 4) is refused on either device."""
    jprob = scenes.p2mc_intrinsics_graph(
        JGraph, scenes.bal_geometry(10, 20)).compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    with pytest.raises(NotImplementedError, match="block width 4"):
        tsparse.build_ell_pattern(tprob)


@pytest.mark.parametrize("limit, match", [
    ("MAX_PAIRS", "pair tables"), ("MAX_SLOTS", "vertices"),
    ("MAX_RESIDUAL", "residual width")])
def test_pattern_limits_are_refused(limit, match, monkeypatch):
    """A graph past one of the pair kernels' limits (pair tables a row
    group, vertices an edge, residual width; ROADMAP.md §3) is refused on
    either device; the row groups and pair tables in all are not limited
    (K5' and K8' launch again)."""
    _, tprob = world("psi2uv")
    tsparse.build_pair_pattern(tprob)
    monkeypatch.setattr(pair_ell, "MAX_GROUPS", 1)
    monkeypatch.setattr(pair_ell, "MAX_TABLES", 1)
    tsparse.build_pair_pattern(tprob)
    monkeypatch.setattr(pair_ell, limit, 1)
    with pytest.raises(NotImplementedError, match=match):
        tsparse.build_pair_pattern(tprob)


def test_assembly_tables_cut_hubs_into_chunks():
    """A landmark seen by more than PAIR_CHUNK poses has a run of several
    chunks in its table's stream; walking the tables in their order (the
    two passes' sums, in numpy: each destination's run in PAIR_CHUNK
    chunks, the chunk sums added in order) gives the plain version's
    values."""
    g, _ = TSim2D(world_size=6.0, n_landmarks=3, seed=1).simulate(80)
    prob = g.compile(device="cpu")
    pat = tsparse.build_ell_pattern(prob)
    values, bT = tsparse.assemble_ell(prob, pat)
    pt = pat.pairs[pat.square["point_xy"]]
    tb = pt.table
    runs = np.diff(tb.ptr.numpy())
    assert runs.max() > pair_ell.PAIR_CHUNK
    # the padding slots own no contribution
    for p in pat.pairs:
        used = np.arange(p.k)[:, None] < p.cnt.numpy()[None]
        assert not np.diff(p.table.ptr.numpy()).reshape(p.k, p.n)[~used].any()
    # the two passes' walk: place m holds edge e of source s where
    # pos[s][e] == m
    from openslam_g2o_torch.core.problem import linearize_group
    lin = [linearize_group(prob, eg) for eg in prob.static.egroups]
    info = [prob.edges[eg.key].information for eg in prob.static.egroups]
    at = {}
    for si, pos in enumerate(tb.pos):
        for e, m in enumerate(pos.tolist()):
            at[m] = (si, e)
    assert sorted(at) == list(range(tb.n_contrib))
    ptr = tb.ptr.numpy()
    out = np.zeros((tb.n_dest, tb.entries))
    for d in range(tb.n_dest):
        p0, p1 = ptr[d], ptr[d + 1]
        tot, acc = 0.0, np.zeros(tb.entries)
        chunks = []
        for m in range(p0, p1):
            if m != p0 and (m - p0) % pair_ell.PAIR_CHUNK == 0:
                chunks.append(acc)
                acc = np.zeros(tb.entries)
            gi, s, t = pt.sources[at[m][0]]
            r, jacs, w = lin[gi]
            e = at[m][1]
            js, jt = jacs[s][e].numpy(), jacs[t][e].numpy()
            om = w[e].item() * info[gi][e].numpy()
            acc = acc + (js.T @ om @ jt).reshape(-1)
        chunks.append(acc)
        for c in chunks:
            tot = tot + c
        out[d] = tot
    got = out.reshape(pt.k, pt.n, -1).transpose(0, 2, 1)
    _close(torch.as_tensor(got), values[pat.square["point_xy"]].numpy())
    assert bT["point_xy"].shape == (2, pt.n)


# -- the assembled and scaled system ---------------------------------------

@pytest.mark.parametrize("name", WORLDS)
def test_values_and_b_match_jax(name):
    jprob, _ = world(name)
    jpat, jvals, jb, tpat, tvals, tbT = systems(name)
    _compare_pairs(_dense_jax(jprob, jpat, jvals), _dense_torch(tpat, tvals))
    for g in tpat.groups:
        _close(tbT[g].T, jb[g])


@pytest.mark.parametrize("name", WORLDS)
@pytest.mark.parametrize("lam", [1e-3, 30.0])
def test_scaled_system_matvec_and_bound_match_jax(name, lam):
    """ell_add_diag + ell_scale_jacobi, ell_matvec_lane on a seeded vector
    and ell_gershgorin_bound on the scaled system, against the pair
    kernels' plain versions composed as `_pcg_trial` composes them on a
    PairPattern (its `diag_values`, `scale`, `operator` and `row_bound`)."""
    jprob, tprob = world(name)
    jpat, jvals, _, tpat, tvals, tbT = systems(name)
    rng = np.random.default_rng(5)
    xT = {g: rng.normal(size=(tpat.widths[g], tpat.counts[g]))
          for g in tpat.groups}

    def jax_scaled(vals, lam, x):
        jextra = {g.name: lam * jprob.free[g.name] + (1.0 - jprob.free[g.name])
                  for g in jprob.static.vgroups}
        jdamped = jsparse.ell_add_diag(jprob, jpat, vals, jextra)
        jdiag = jpat.diag_blocks(jprob, vals)
        jlinv = {k: jsolvers.batched_chol_inv_lower(
            v + jextra[k][:, None, None] * jnp.eye(v.shape[-1])[None])
            for k, v in jdiag.items()}
        S = jsparse.ell_scale_jacobi(jprob, jpat, jdamped, jlinv)
        return (S, jsparse.ell_matvec_lane(jprob, jpat, S, x),
                jsparse.ell_gershgorin_bound(jprob, jpat, S))

    jS, jy, jhi = jax.jit(jax_scaled)(
        jvals, jnp.float64(lam), {k: jnp.asarray(v) for k, v in xT.items()})
    lam_t = torch.tensor(lam, dtype=torch.float64)
    linv, extra = {}, {}
    for g, v in tpat.diag_values(tvals).items():
        linv[g], _, _, extra[g] = damp_chol(v, tprob.free[g], tbT[g], lam_t)
    tS = tpat.scale(tvals, linv, extra)
    jdense = _dense_jax(jprob, jpat, jS)
    tdense = _dense_torch(tpat, [pair_ell.padded(v, pt.rowptr, pt.k)
                                 for pt, v in zip(tpat.pairs, tS)])
    for key, jm in jdense.items():
        _close(tdense[key], jm)
    ty = tsparse.ell_matvec_lane(tpat, tS, {k: torch.as_tensor(v)
                                            for k, v in xT.items()})
    for g in tpat.groups:
        _close(ty[g], jy[g])
    op = tpat.operator(tS)
    hp, part = op.matvec_dot(op.flatten({k: torch.as_tensor(v)
                                         for k, v in xT.items()}))
    hp = op.split(hp)
    dot = sum(float((torch.as_tensor(xT[g]) * hp[g]).sum())
              for g in tpat.groups)
    np.testing.assert_allclose(float(part.sum()), dot, rtol=1e-12)
    jhi = float(jhi)
    thi = float(tpat.row_bound(tS))
    # the port's square tables of groups without edges add rows of 1
    np.testing.assert_allclose(thi, max(jhi, 1.0) if len(tpat.pairs)
                               > len(jpat.pairs) else jhi, rtol=1e-12)


@pytest.mark.parametrize("name", WORLDS)
def test_lambda_init_matches_jax(name):
    jprob, tprob = world(name)
    jl = float(jalg._lambda_init_pcg(jprob, jsparse.build_ell_pattern(jprob),
                                     jprob.params, jnp.float64(1e-5)))
    tl = float(talg._lambda_init_pcg(tprob, tsparse.build_ell_pattern(tprob),
                                     tprob.params,
                                     torch.tensor(1e-5, dtype=torch.float64)))
    np.testing.assert_allclose(tl, jl, rtol=RTOL)


# -- the LM-PCG trajectories -----------------------------------------------

def _compare_traj(tchi, jchi, chi0):
    tchi, jchi = np.asarray(tchi), np.asarray(jchi)
    prev = chi0
    for i, (t, j) in enumerate(zip(tchi, jchi)):
        if prev - j <= 1e-10 * prev:       # no gain: rounding decides
            break
        np.testing.assert_allclose(t, j, rtol=TRAJ_RTOL,
                                   err_msg=f"iteration {i}")
        prev = j


_jax_traj = {}


def jax_trajectory(name, cheby):
    """JAX's LevenbergMarquardtPCG chi2 per iteration (5 iterations)."""
    key = (name, cheby)
    if key not in _jax_traj:
        jprob, _ = world(name)
        _, st = jalg.optimize(jprob, jalg.LevenbergMarquardtPCG(
            pcg_cheby=cheby, **TIGHT), iterations=5)
        _jax_traj[key] = [s["chi2"] for s in st]
    return _jax_traj[key]


@pytest.mark.parametrize("cheby", [0, 4])
@pytest.mark.parametrize("name", ["2d", "3d"])
@pytest.mark.parametrize("entry", ["optimize", "fused"])
def test_lm_pcg_trajectory_matches_jax(name, cheby, entry):
    """`optimize(prob, LevenbergMarquardtPCG(...))` and
    `_lambda_init_pcg` + `lm_pcg_optimize_fused` against JAX's
    LevenbergMarquardtPCG (one outer iteration of the fused loop is one
    `_lm_pcg_step`, as in JAX)."""
    _, tprob = world(name)
    jchi = jax_trajectory(name, cheby)
    alg = talg.LevenbergMarquardtPCG(pcg_cheby=cheby, **TIGHT)
    chi0 = float(alg.init(tprob)["chi2"])
    if entry == "optimize":
        _, st = talg.optimize(tprob, alg, iterations=5)
        tchi = [s["chi2"] for s in st]
    else:
        pat = alg.pattern(tprob)
        lam = talg._lambda_init_pcg(tprob, pat, tprob.params,
                                    torch.tensor(alg.tau,
                                                 dtype=torch.float64))
        out = talg.lm_pcg_optimize_fused(
            tprob, pat, tprob.params, lam,
            torch.tensor(2.0, dtype=torch.float64), None, n_iters=5,
            pcg_cheby=cheby, **TIGHT)
        tchi = out[4].tolist()
    assert np.all(np.diff(tchi) <= 0)
    _compare_traj(tchi, jchi, chi0)


@pytest.mark.parametrize("name", ["se3_prior", "points"])
def test_other_graphs_follow_jax(name):
    jprob, tprob = world(name)
    jchi = jax_trajectory(name, 0)
    alg = talg.LevenbergMarquardtPCG(**TIGHT)
    chi0 = float(alg.init(tprob)["chi2"])
    _, st = talg.optimize(tprob, alg, iterations=5)
    tchi = [s["chi2"] for s in st]
    assert np.all(np.diff(tchi) <= 0)
    _compare_traj(tchi, jchi, chi0)


# -- K3 and K4 at D = 2, and the wrappers' argument checks ------------------

def test_damp_chol_and_lane_block_mv_at_width_2_match_jax():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(50, 2, 2))
    A = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(2)
    values = torch.as_tensor(np.moveaxis(A, 0, -1).reshape(1, 4, 50).copy())
    free = torch.as_tensor((rng.uniform(size=50) > 0.2).astype(float))
    b = torch.as_tensor(rng.normal(size=(2, 50)))
    lam = torch.tensor(0.7, dtype=torch.float64)
    linv, lchol, bhat, extra = damp_chol(values, free, b, lam)
    ex = 0.7 * free.numpy() + (1.0 - free.numpy())
    damped = A + ex[:, None, None] * np.eye(2)
    jl = np.asarray(jsolvers.batched_chol_inv_lower(jnp.asarray(damped)))
    _close(linv, np.moveaxis(jl, 0, -1).reshape(4, 50))
    _close(lchol, np.moveaxis(np.linalg.cholesky(damped), 0, -1)
           .reshape(4, 50))
    for tr in (False, True):
        x = rng.normal(size=(2, 50))
        ref = jsparse.lane_block_mv({"v": jnp.asarray(jl.transpose(1, 2, 0))},
                                    {"v": jnp.asarray(x)}, transpose=tr)["v"]
        _close(lane_block_mv(linv, torch.as_tensor(x), tr), ref)
    _close(bhat, np.einsum("nab,bn->an", jl, b.numpy()))


def _wrapper_args():
    _, tprob = world("2d")
    pat = tsparse.build_ell_pattern(tprob)
    values, bT = tsparse.assemble_ell(tprob, pat)
    return tprob, pat, values, bT


def test_pair_assemble_checks_its_arguments():
    tprob, pat, _, _ = _wrapper_args()
    plan = pat.plan
    lin = tsparse.pair_linearize(tprob)
    r, jacs, w, info = lin[0]
    with pytest.raises(ValueError, match="Jacobians of slots"):
        pair_ell.pair_stream(plan, [(r, [jacs[0], jacs[0][:, :, :2]], w,
                                     info)] + lin[1:])
    with pytest.raises(ValueError, match="residual width"):
        bad = torch.zeros((r.shape[0], 7), dtype=r.dtype)
        pair_ell.pair_stream(plan, [(bad, jacs, w, info)] + lin[1:])
    with pytest.raises(ValueError, match="2 slots"):
        pair_ell.pair_stream(plan, [(r, jacs[:1], w, info)] + lin[1:])
    with pytest.raises(ValueError, match="dtype"):
        pair_ell.pair_stream(plan, [(r, [j.float() for j in jacs], w,
                                     info)] + lin[1:])
    with pytest.raises(ValueError, match="Omega"):
        pair_ell.pair_stream(plan, [(r, jacs, w[:-1], info)] + lin[1:])
    stream = pair_ell.pair_stream(plan, lin)
    with pytest.raises(ValueError, match="must hold"):
        pair_ell.pair_assemble(plan, stream[:-1])
    with pytest.raises(ValueError, match="dtype"):
        pair_ell.pair_assemble(plan, stream.long())
    with pytest.raises(ValueError, match="vertices"):
        pair_ell.assembly_plan(plan.tables, [pair_ell.Unit(0, 0, (), (0, 0))])


def test_pair_scale_checks_its_arguments():
    tprob, pat, values, bT = _wrapper_args()
    sq, rect = pat.square["se2"], next(
        i for i, p in enumerate(pat.pairs) if not p.square)
    lam = torch.tensor(1.0, dtype=torch.float64)
    linv = {g: damp_chol(values[i], tprob.free[g], bT[g], lam)[0]
            for g, i in pat.square.items()}
    pr = pat.pairs[rect]
    with pytest.raises(ValueError, match="square pair"):
        pair_ell.pair_scale(pr.nb, pr.rowptr, values[rect], linv[pr.rg],
                            linv[pr.cg], torch.ones(pr.n, dtype=torch.float64))
    with pytest.raises(ValueError, match="values shape"):
        pair_ell.pair_scale(pr.nb, pr.rowptr, values[sq], linv[pr.rg],
                            linv[pr.cg])
    with pytest.raises(ValueError, match="fit no block widths"):
        pair_ell.pair_scale(pr.nb, pr.rowptr, values[rect], linv[pr.rg][:5],
                            linv[pr.cg])
    with pytest.raises(ValueError, match="int32"):
        pair_ell.pair_scale(pr.nb.long(), pr.rowptr, values[rect],
                            linv[pr.rg], linv[pr.cg])
    with pytest.raises(ValueError, match="rowptr must be"):
        pair_ell.pair_scale(pr.nb, pr.rowptr[:-1].contiguous(), values[rect],
                            linv[pr.rg], linv[pr.cg])
    # the used-slot layout: every used slot once, in row and slot order
    s = pair_ell.pair_scale(pr.nb, pr.rowptr, values[rect], linv[pr.rg],
                            linv[pr.cg], used=pr.used)
    assert s.shape == (pr.dr * pr.dc, pr.used)
    assert torch.equal(pr.rowptr[1:] - pr.rowptr[:-1], pr.cnt)
    rows, slots = pair_ell.used_slots(pr.rowptr)
    assert torch.equal(pr.cols, pr.nb[slots, rows])


def test_pair_spmv_and_bound_check_their_arguments():
    tprob, pat, values, bT = _wrapper_args()
    lam = torch.tensor(1.0, dtype=torch.float64)
    linv, extra = {}, {}
    for g, i in pat.square.items():
        linv[g], _, _, extra[g] = damp_chol(values[i], tprob.free[g], bT[g],
                                            lam)
    svals = pat.scale(values, linv, extra)
    lay = pat.flat_layout(svals)
    assert lay.n == sum(pat.widths[g] * pat.counts[g] for g in pat.groups)
    x = torch.zeros(lay.n, dtype=torch.float64)
    with pytest.raises(ValueError, match="flat"):
        pair_ell.pair_spmv(lay, x[:-1])
    with pytest.raises(ValueError, match="dtype"):
        pair_ell.pair_spmv(lay, x.float())
    with pytest.raises(ValueError, match="partials"):
        pair_ell.pair_spmv_dot(lay, x, torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="dtype"):
        pair_ell.pair_spmv_dot(lay, x, torch.zeros(lay.blocks))
    scal = torch.zeros(10, dtype=torch.float64)
    y = torch.empty_like(x)
    with pytest.raises(ValueError, match="another buffer"):
        pair_ell.pair_spmv_dot_p(lay, scal, x, x, x)
    with pytest.raises(ValueError, match="scal"):
        pair_ell.pair_spmv_dot_p(lay, scal[:9], x, x, y)
    with pytest.raises(ValueError, match="dtype"):
        pair_ell.pair_spmv_dot_p(lay, scal.float(), x, x, y)
    with pytest.raises(ValueError, match="dtype"):
        pair_ell.pair_spmv_dot_p(lay, scal, x, x, y,
                                 torch.zeros(lay.blocks))
    grp = lay.groups[0]
    with pytest.raises(ValueError, match="block width"):
        pair_ell.FlatLayout([pair_ell.FlatGroup(4, grp.n, 0, grp.tables)])
    with pytest.raises(ValueError, match="no row group"):
        pair_ell.FlatLayout([])
    with pytest.raises(ValueError, match="pair tables a row group"):
        pair_ell.FlatLayout([pair_ell.FlatGroup(
            grp.dr, grp.n, grp.off, grp.tables * 5)])
    t0 = grp.tables[0]
    with pytest.raises(ValueError, match="does not fit"):
        pair_ell.FlatLayout([pair_ell.FlatGroup(grp.dr, grp.n, grp.off, (
            pair_ell.FlatTable(t0.rowptr[:-1], t0.cols, t0.values, t0.dc,
                               t0.col_off, t0.ncol),))])
    assert PAIR_WIDTHS == (2, 3, 6)


def test_pair_entries_match_their_ctypes_signatures():
    """Every C entry of csrc/pair_ell.cu takes the arguments its ctypes
    signature in kernels/build.py declares (a pointer, an int or a long
    long each, in order): a signature one argument short passes a pointer
    as an int."""
    import ctypes
    import re
    from openslam_g2o_torch.kernels import build
    src = (build.CSRC / "pair_ell.cu").read_text()
    kinds = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_longlong: "L"}
    entries = re.findall(r"int (g2o_pair_\w+)_##SUFFIX\(([^)]*)\)", src)
    assert {e for e, _ in entries} == {k for k in build._SIGNATURES
                                       if k.startswith("g2o_pair_")}
    for name, params in entries:
        got = "".join(
            "P" if "*" in p else "L" if "long long" in p else "I"
            for p in re.sub(r"\\\s*", " ", params).split(","))
        want = "".join(kinds[t] for t in build._SIGNATURES[name])
        assert got == want, name
