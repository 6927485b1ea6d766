"""K7 on the dense, dual-ELL Schur and general Schur routes
(kernels/trial.py, csrc/trial.cu): the plain versions, which the CPU route
runs, against the JAX package, float64 on the CPU.

* each of the nine vertex types: the plain retraction and its dot
  partials against JAX's `apply_update_parts` and jnp.dot of
  dx . (lambda dx + b), rtol 1e-12, with fixed vertices, stored
  quaternions off unit norm and SE2 angles whose step crosses +-pi;
* each of the 24 edge types, without and with Huber: the plain chi2
  partials summed against the group's term of JAX's `robust_chi2` at a
  candidate, rtol 1e-12; and each scene's total (`robust_chi2`: the
  partials of every group summed by `chi2_sum`) against JAX's;
* the slice as a whole: the dense LM on a small phase-4o world (rtol 1e-7,
  the dense route's float64 precedent), a small BAL problem through
  LevenbergMarquardtSchurELL and the PSI2UV scene through
  LevenbergMarquardtSchur (rtol 1e-8 while an iteration gains) against
  JAX's chi2 trajectories, every wrapper on its plain version (no launch);
* the tables: a wrapper per vertex and edge type of the models, a C entry
  and a ctypes signature per wrapper; a type registered at run time keeps
  the plain version.

The scenes are chip_smoke.py's (phase 4o's worlds, the general path's
scenes, the small BAL graph of the 9-wide camera) and a Simulator3D world for EDGE_SE3:QUAT and EDGE_SE3_TRACKXYZ,
built small in the JAX package and carried across with
`problem_from_numpy`.
"""
import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scenes
from openslam_g2o_tpu.apps.simulator import synthetic_bal_problem as j_bal
from openslam_g2o_tpu.core import algorithms as jalg
from openslam_g2o_tpu.core import ba as jba
from openslam_g2o_tpu.core import ba_ell as jba_ell
from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core import robust as jrobust
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.utils import np_lie

from openslam_g2o_torch import kernels
from openslam_g2o_torch.core import algorithms as talg
from openslam_g2o_torch.core import ba as tba
from openslam_g2o_torch.core import ba_ell as tba_ell
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core import registry
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import build, edge_lin, trial

torch.set_num_threads(1)

RTOL = 1e-12
RTOL_DENSE = 1e-7
RTOL_SCHUR = 1e-8
GAIN_FLOOR = 1e-10


def _world3d(n_poses=16, n_landmarks=12):
    """chip_smoke.py's 3D world with EDGE_SE3:QUAT odometry beside its
    offset edges and EDGE_SE3_TRACKXYZ (offset parameter 1) from each
    landmark's first depth observation, measured at the initial values."""
    g = scenes.world3d_all_graph(JGraph, n_poses, n_landmarks, seed=1)
    rng = np.random.default_rng(4)
    x = lambda vid: g.vertices[vid].params
    for i in range(n_poses - 1):
        z = np_lie.se3_compose(np_lie.se3_inverse(x(i)), x(i + 1))
        z[:3] += rng.normal(0, 0.01, 3)
        g.add_edge("edge_se3", (i, i + 1), z, np.eye(6) * 100.0)
    off = g.parameters[1][1]
    seen = set()
    for e in list(g.edges):
        i, lid = e.vertex_ids[0], e.vertex_ids[-1]
        if e.etype.name == "edge_se3_depth" and lid not in seen:
            seen.add(lid)
            z = np_lie.se3_apply(np_lie.se3_inverse(
                np_lie.se3_compose(x(i), off)), x(lid))
            g.add_edge("edge_se3_xyz", (i, lid), z + rng.normal(0, 0.02, 3),
                       np.eye(3) * 50.0, param_ids=[1])
    return g


def _sba(n_cams=12, n_points=24):
    """chip_smoke.py's SBA world with a VERTEX_INTRINSICS beside the
    cameras' own intrinsics, EDGE_PROJECT_P2MC_INTRINSICS on each P2MC
    observation, and each point seen by two expmap cameras again as
    EDGE_PROJECT_PSI2UV: a new inverse-depth point in the first camera's
    frame, observed by the second."""
    g = scenes.sba_all_graph(JGraph, n_cams, n_points, seed=1)
    g.add_vertex(900000, "intrinsics", [503.0, 497.0, 322.0, 238.0, 0.1])
    by_point = {}
    for e in list(g.edges):
        name, vids = e.etype.name, e.vertex_ids
        if name == "edge_project_p2mc":
            g.add_edge("edge_project_p2mc_intrinsics", (*vids, 900000),
                       e.measurement, e.information)
        elif name == "edge_project_xyz2uv":
            by_point.setdefault(vids[0], []).append(e)
    for j, (pid, obs) in enumerate(sorted(by_point.items())):
        if len(obs) < 2:
            continue
        anchor, seen = obs[0].vertex_ids[1], obs[1]
        pa = np_lie.se3_apply(g.vertices[anchor].params,
                              g.vertices[pid].params)
        g.add_vertex(200000 + j, "sba_point_xyz",
                     np.array([pa[0], pa[1], 1.0]) / pa[2], marginalized=True)
        g.add_edge("edge_project_psi2uv",
                   (200000 + j, seen.vertex_ids[1], anchor),
                   seen.measurement, seen.information, param_ids=[0])
    return g


# scene -> builder of its JAX graph (small); every vertex and edge type of
# the models is in one of them
SCENES = {
    "bal": lambda: scenes.bal_camera_graph(JGraph, 6, 24, seed=1),
    "world2d": lambda: scenes.world2d_all_graph(JGraph, 24, 16, seed=1),
    "world3d": _world3d,
    "sba": _sba,
}


def _scene_of(types):
    """type name -> the scene that holds it."""
    return {t: s for s, gr in ((s, SCENES[s]()) for s in SCENES)
            for t in {*(v.vtype.name for v in gr.vertices.values()),
                      *(e.etype.name for e in gr.edges)} if t in types}


HUBER = jrobust.kernel_id("Huber")
LAM = 0.37


def _port(jprob, params=None, kernel_id=None):
    """The JAX problem's arrays in the port (CPU), at `params` if given,
    every edge group under robust kernel `kernel_id` (delta 0.5) if
    given."""
    arrays = problem_arrays(jprob)
    if params is not None:
        arrays["params"] = {k: np.asarray(v) for k, v in params.items()}
    if kernel_id is not None:
        for e in arrays["edges"].values():
            e["kernel_id"] = kernel_id
            e["delta"] = np.full_like(e["delta"], 0.5)
    return problem_from_numpy(**arrays, device="cpu")


def _with_kernel(jprob, kernel_id):
    """The JAX problem with every edge group under `kernel_id`, delta
    0.5."""
    static = dataclasses.replace(jprob.static, egroups=tuple(
        dataclasses.replace(eg, kernel_id=kernel_id)
        for eg in jprob.static.egroups))
    edges = {k: dataclasses.replace(ea, delta=jnp.full_like(ea.delta, 0.5))
             for k, ea in jprob.edges.items()}
    return dataclasses.replace(jprob, static=static, edges=edges)


@functools.lru_cache(maxsize=None)
def _state(scene):
    """The scene's JAX problem with every fifth vertex fixed, quaternions
    stored 3% off unit norm and a quarter of the SE2 angles within 0.01 of
    +-pi, stepped across the cut; a seeded step dx and gradient b per
    group; JAX's candidate (apply_update_parts), each edge group's term of
    robust_chi2 there and robust_chi2 itself, without and with Huber."""
    jprob = SCENES[scene]().compile(dtype=jnp.float64)
    rng = np.random.default_rng(11)
    params, free, dx, b = {}, {}, {}, {}
    for g in jprob.static.vgroups:
        x = np.array(jprob.params[g.name])
        f = np.array(jprob.free[g.name])
        f[::5] = 0.0
        d = rng.normal(0, 0.02, (g.count, g.tangent_dim))
        if g.vtype.name in ("se3", "se3_expmap", "cam"):
            x[1::3, 3:7] *= 1.03
        if g.vtype.name == "se2":
            x[1::4, 2], d[1::4, 2] = np.pi - 0.01, 0.05
            x[2::4, 2], d[2::4, 2] = -np.pi + 0.01, -0.05
        params[g.name], free[g.name], dx[g.name] = x, f, d
        b[g.name] = rng.normal(0, 10.0, (g.count, g.tangent_dim))
    jp = dataclasses.replace(
        jprob, params={k: jnp.asarray(v) for k, v in params.items()},
        free={k: jnp.asarray(v) for k, v in free.items()})
    jh = _with_kernel(jp, HUBER)

    @jax.jit          # one compilation: eager vmap costs seconds per group
    def outcome(dx):
        cand = jproblem.apply_update_parts(jp, dx)
        e2 = jproblem.edge_chi2(jp, params=cand)
        # each group's term of robust_chi2 (its loop body), per kernel
        terms = {kid: {k: jnp.sum(jrobust.robustify(kid, v, p.edges[k].delta)
                                  [0]) for k, v in e2.items()}
                 for kid, p in ((0, jp), (HUBER, jh))}
        return (cand, terms, {0: jproblem.robust_chi2(jp, cand),
                              HUBER: jproblem.robust_chi2(jh, cand)})

    jcand, terms, total = outcome({k: jnp.asarray(v) for k, v in dx.items()})
    return dict(jprob=jp, params=params, free=free, dx=dx, b=b, cand=jcand,
                terms=terms, total=total)


VERTEX_SCENE = _scene_of(trial.RETRACT_IDS)
EDGE_SCENE = _scene_of(trial.CHI2)


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(
        t.numpy(), j, rtol=RTOL,
        atol=1e-14 * max(float(np.abs(j).max()), 1.0))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


# -- the retractions --------------------------------------------------------

@pytest.mark.parametrize("vname", list(trial.RETRACT_IDS))
def test_retraction_and_dot_match_jax(vname):
    """The plain retraction of one vertex group and its dot partial against
    JAX's apply_update_parts and jnp.dot, fixed vertices, quaternions off
    unit norm (renormalized by every retraction, a fixed vertex's zero step
    included) and SE2 angles across +-pi among them (`_state`)."""
    st = _state(VERTEX_SCENE[vname])
    g = next(g for g in st["jprob"].static.vgroups if g.vtype.name == vname)
    dx, b = st["dx"][g.name], st["b"][g.name]
    assert (st["free"][g.name] == 0).any()
    jdot = jnp.dot(jnp.asarray(dx).ravel(), (LAM * dx + b).ravel())
    # lane-major parts seen transposed, as the Schur routes pass them
    dxT, bT = _t(dx).T.contiguous(), _t(b).T.contiguous()
    x, free = _t(st["params"][g.name]), _t(st["free"][g.name])
    part = torch.empty(1, dtype=torch.float64)
    cand, = trial.trial_retract_groups(
        [trial.RetractGroup(vname, x, dxT.T, free, bT.T)], _t(LAM), part)
    _close(cand, st["cand"][g.name])
    _close(part.sum(), jdot)
    if vname == "se2":
        assert float(cand[:, 2].max()) < np.pi
        assert float(cand[:, 2].min()) >= -np.pi
        assert (np.abs(st["params"][g.name][:, 2]) > 3.13).sum() >= 2
    if vname in ("se3", "se3_expmap", "cam"):
        np.testing.assert_allclose(
            cand[:, 3:7].norm(dim=1).numpy(), 1.0, rtol=1e-15, atol=1e-15)
    # without b: the candidate alone, the same bits
    cand2, = trial.trial_retract_groups(
        [trial.RetractGroup(vname, x, _t(dx), free)])
    assert torch.equal(cand2, cand)


@pytest.mark.parametrize("scene", list(SCENES))
def test_trial_candidate_of_the_dense_route_matches_jax(scene):
    """core/problem.py `trial_candidate` on the dense route's flat tangent
    vectors (views at each group's offset): JAX's candidate, and one dot
    partial per group summing to dx . (lam dx + b) over the whole vector."""
    st = _state(scene)
    tprob = _port(st["jprob"])
    groups = sorted(tprob.static.vgroups, key=lambda g: g.offset)
    flat = lambda parts: _t(np.concatenate(
        [parts[g.name].ravel() for g in groups]))
    dx, b = flat(st["dx"]), flat(st["b"])
    cand, part = tproblem.trial_candidate(
        tprob, tproblem.tangent_parts(tprob, dx),
        tproblem.tangent_parts(tprob, b), _t(LAM))
    assert part.shape == (len(groups),)
    for k, v in st["cand"].items():
        _close(cand[k], v)
    _close(part.sum(), np.dot(dx.numpy(), LAM * dx.numpy() + b.numpy()))
    for k, v in tproblem.apply_update(tprob, dx).items():
        assert torch.equal(v, cand[k])


# -- the chi2 -----------------------------------------------------------------

@pytest.mark.parametrize("huber", [False, True], ids=["none", "huber"])
@pytest.mark.parametrize("tname", list(trial.CHI2))
def test_edge_chi2_matches_jax(tname, huber):
    """One edge group's plain chi2 partials, summed, against the group's
    term of JAX's robust_chi2 at the candidate: sum rho(e^T Omega e)."""
    st = _state(EDGE_SCENE[tname])
    kid = HUBER if huber else 0
    tprob = _port(st["jprob"], st["cand"], kid)
    eg = next(e for e in tprob.static.egroups if e.etype.name == tname)
    ea = tprob.edges[eg.key]
    part = trial.chi2_of(tname)(
        tuple(tprob.params[g] for g in eg.slots), ea.indices, ea.measurement,
        ea.information, ea.delta, ea.pdata, eg.kernel_id)
    assert part.shape == (1,) and eg.kernel_id == kid
    _close(part.sum(), st["terms"][kid][eg.key])


@pytest.mark.parametrize("huber", [False, True], ids=["none", "huber"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_robust_chi2_of_each_scene_matches_jax(scene, huber):
    """robust_chi2 (every group's partials in one vector, summed by
    chi2_sum) against JAX's robust_chi2 at the candidate; on the CPU
    robust_chi2_parts lays out one partial per group."""
    st = _state(scene)
    kid = HUBER if huber else 0
    tprob = _port(st["jprob"], st["cand"], kid)
    parts = tproblem.robust_chi2_parts(tprob)
    assert parts.shape == (len(tprob.static.egroups),)
    _close(tproblem.robust_chi2(tprob), st["total"][kid])
    _close(parts.sum(), st["total"][kid])


# -- the slice as a whole ----------------------------------------------------

def _gaining_prefix(jchi, chi0):
    """The iterations up to the first that gains less than GAIN_FLOOR."""
    n, prev = 0, chi0
    for c in jchi:
        if prev - c <= GAIN_FLOOR * prev:
            break
        n, prev = n + 1, c
    return n


def test_dense_lm_trajectory_matches_jax():
    """The dense LM on the small 2D phase-4o world: every trial's candidate
    and chi2 by the plain K7 route, against JAX's trajectory."""
    jprob = SCENES["world2d"]().compile(dtype=jnp.float64)
    tprob = _port(jprob)
    kernels.reset_launch_counts()
    _, jst = jalg.optimize(jprob, jalg.LevenbergMarquardt(), iterations=5)
    _, tst = talg.optimize(tprob, talg.LevenbergMarquardt(), iterations=5)
    assert not any(kernels.launch_counts().values())
    np.testing.assert_allclose([s["chi2"] for s in tst],
                               [s["chi2"] for s in jst], rtol=RTOL_DENSE)
    assert ([s["levenberg_iters"] for s in tst]
            == [s["levenberg_iters"] for s in jst])


@pytest.mark.parametrize("route", ["ell", "general"])
def test_schur_trajectories_match_jax(route):
    """A small BAL problem through LevenbergMarquardtSchurELL (dual ELL)
    and the PSI2UV scene through LevenbergMarquardtSchur (general path)
    against JAX's chi2 while an iteration gains."""
    if route == "ell":
        jprob, _ = j_bal(n_cams=10, n_points=120, dtype=jnp.float64)
        ja, ta = (jba_ell.LevenbergMarquardtSchurELL(),
                  tba_ell.LevenbergMarquardtSchurELL())
    else:
        jprob = scenes.psi2uv_graph(
            JGraph, scenes.bal_geometry(10, 40)).compile(dtype=jnp.float64)
        ja, ta = jba.LevenbergMarquardtSchur(), tba.LevenbergMarquardtSchur()
    tprob = _port(jprob)
    chi0 = float(tproblem.robust_chi2(tprob))
    np.testing.assert_allclose(chi0, float(jproblem.robust_chi2(jprob)),
                               rtol=RTOL)
    kernels.reset_launch_counts()
    _, jst = jalg.optimize(jprob, ja, iterations=5)
    _, tst = talg.optimize(tprob, ta, iterations=5)
    assert not any(kernels.launch_counts().values())
    jchi = [s["chi2"] for s in jst]
    tchi = [s["chi2"] for s in tst]
    n = _gaining_prefix(jchi, chi0)
    assert n >= 2, jchi
    np.testing.assert_allclose(tchi[:n], jchi[:n], rtol=RTOL_SCHUR)
    assert np.all(np.diff([chi0] + tchi) <= 0)


# -- the tables ---------------------------------------------------------------

def test_tables_cover_the_models_and_the_c_entries():
    """A retraction type id per vertex type and a chi2 wrapper per edge
    type of openslam_g2o_torch.models; trial.cu exports each chi2 wrapper's
    entry pair, the retraction over every group and chi2_sum, and build.py
    declares their signatures; kernels.WRAPPERS lists the wrappers."""
    model_v = {n for n, vt in registry._VERTEX_TYPES.items()
               if vt.retract.__module__.startswith(
                   ("openslam_g2o_torch.models.", "openslam_g2o_torch.ops."))}
    assert set(trial.RETRACT_IDS) == model_v == set(
        tproblem.SUPPORTED_VERTEX_TYPES)
    assert set(trial.CHI2) == set(edge_lin.LINEARIZERS) == set(
        tproblem.SUPPORTED_EDGE_TYPES)
    src = (Path(build.CSRC) / "trial.cu").read_text()
    entries = set(re.findall(
        r"^G2O_TRIAL_CHI2_ENTRIES\((\w+),", src, re.M))
    want = {"g2o_" + w for w in trial.CHI2.values()}
    assert entries == want
    own = {"g2o_chi2_sum", "g2o_trial_retract_groups"}
    assert all(f"int {e}_f32(" in src and f"int {e}_f64(" in src
               for e in own)
    assert want | own <= set(build._SIGNATURES)
    assert not {k for k in build._SIGNATURES
                if k.startswith("g2o_trial_retract_")} - own
    names = {w.__name__ for w in kernels.WRAPPERS}
    assert {w[4:] for w in want | own} <= names
    enum = src[src.index("enum RetractType {"):]
    ids = {k: int(v) for k, v in re.findall(r"kRetract(\w+) = (\d+)",
                                            enum[:enum.index("};")])}
    assert ids.pop("Types") == len(trial.RETRACT_IDS)
    assert sorted(ids.values()) == sorted(trial.RETRACT_IDS.values())


def test_a_type_registered_at_run_time_keeps_the_plain_chi2():
    """robust_chi2_parts runs the plain version for an edge type without a
    wrapper, beside the wrappers of the built-in types."""
    name = "test_trial_range_xy"
    if name not in registry._EDGE_TYPES:
        registry.register_edge_type(registry.EdgeType(
            name=name, tag="TEST_TRIAL_RANGE_XY",
            vertex_types=("se2", "point_xy"), error_dim=1,
            measurement_dim=1,
            error=lambda vp, meas, pdata: torch.sqrt(
                ((vp[1] - vp[0][..., :2]) ** 2).sum(-1, keepdim=True))
            - meas))
    assert trial.chi2_of(name) is None
    from openslam_g2o_torch.core.graph import Graph as TGraph
    g = TGraph()
    g.add_vertex(0, "se2", [0.0, 0.0, 0.3])
    g.add_vertex(1, "point_xy", [3.0, 4.0])
    g.add_edge(name, (0, 1), [4.5], np.eye(1) * 2.0)
    g.add_edge("edge_se2_xy", (0, 1), [3.0, 3.0], np.eye(2))
    prob = g.compile(dtype=torch.float64, device="cpu")
    parts = tproblem.robust_chi2_parts(prob)
    assert parts.shape == (2,)
    keys = [eg.key for eg in prob.static.egroups]
    np.testing.assert_allclose(float(parts[keys.index(name)]),
                               2.0 * 0.5 ** 2, rtol=1e-12)
