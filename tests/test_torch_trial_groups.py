"""K7's `trial_retract_groups` (kernels/trial.py: a trial's retraction over
every vertex group in one launch) as core/problem.py `trial_candidate`
runs it, float64 on the CPU (the plain version).

* `trial_candidate` against JAX's `apply_update_parts` and the step dot of
  the trial bookkeeping (openslam_g2o_tpu/core/algorithms.py:318,
  dx . (lam dx + b) over every group), rtol 1e-12 of the largest entry, on
  (c)'s 2D landmark world (Simulator2D: SE2 poses, XY landmarks), a
  Simulator3D world (SE3 poses, XYZ landmarks), the ba_80k-shaped
  synthetic BAL problem (SE3:EXPMAP cameras, SBA points), phase 4l's
  shared-intrinsics scene (intrinsics, cameras, points) and a BAL file of
  the 9-wide camera, all small, with a fifth of the vertices fixed; dx
  and b as the Schur routes pass them (transposed lane-major parts) and
  as the dense route does (views of one flat vector);
* the partial vector: one partial per group on the CPU, each the group's
  own dot; with the card's partial counts, its length and each group's
  offset those of the per-group partials laid end to end;
* the launches: one per MAX_RETRACT_GROUPS groups, each group's first
  block the prefix of its launch's partial counts, and 11 groups of every
  type through the plain version equal to the per-type wrappers.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scenes
from openslam_g2o_tpu.apps.simulator import Simulator2D, Simulator3D
from openslam_g2o_tpu.apps.simulator import synthetic_bal_problem as j_bal
from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core.graph import Graph as JGraph

from openslam_g2o_torch import kernels
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core import registry
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import trial

torch.set_num_threads(1)

RTOL = 1e-12
LAM = 0.41

SCENES = {
    "world2d": lambda: Simulator2D(world_size=12.0, n_landmarks=20,
                                   seed=0).simulate(40)[0],
    "world3d": lambda: Simulator3D(n_landmarks=20, seed=0).simulate(30)[0],
    "ba80k": lambda: j_bal(n_cams=12, n_points=600, dtype=jnp.float64)[0],
    "intrinsics": lambda: scenes.p2mc_intrinsics_graph(
        JGraph, scenes.bal_geometry(10, 120)),
    "bal": lambda: scenes.bal_camera_graph(JGraph, 6, 24, seed=1),
}


def _close(t, j):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    scale = max(float(np.abs(j).max()), 1e-300)
    assert t.shape == j.shape
    assert float(np.abs(t - j).max()) <= RTOL * scale, \
        float(np.abs(t - j).max()) / scale


@functools.lru_cache(maxsize=None)
def _state(scene):
    """The scene's JAX problem (float64) with every fifth vertex fixed, a
    seeded step dx and gradient b per group, JAX's candidate and step dot;
    and the same problem in the port."""
    made = SCENES[scene]()
    jprob = made if scene == "ba80k" else made.compile(dtype=jnp.float64)
    rng = np.random.default_rng(5)
    free, dx, b = {}, {}, {}
    for g in jprob.static.vgroups:
        f = np.array(jprob.free[g.name])
        f[::5] = 0.0
        free[g.name] = f
        dx[g.name] = rng.normal(0, 0.02, (g.count, g.tangent_dim))
        b[g.name] = rng.normal(0, 10.0, (g.count, g.tangent_dim))
    arrays = problem_arrays(jprob)
    arrays["free"] = free
    tprob = problem_from_numpy(**arrays, device="cpu")
    jp = dataclasses.replace(jprob, free={k: jnp.asarray(v)
                                          for k, v in free.items()})
    jcand = jax.jit(lambda d: jproblem.apply_update_parts(jp, d))(
        {k: jnp.asarray(v) for k, v in dx.items()})
    # the step dot of the trial bookkeeping, over every group
    jdot = sum(float(jnp.dot(jnp.asarray(dx[k]).ravel(),
                             jnp.asarray(LAM * dx[k] + b[k]).ravel()))
               for k in dx)
    return dict(tprob=tprob, dx=dx, b=b, cand=jcand, dot=jdot)


def _alone(vname, x, dx, free, b, lam):
    """One group through trial_retract_groups on its own: (cand, its one
    partial on the CPU)."""
    out = torch.empty(1, dtype=x.dtype)
    cand, = trial.trial_retract_groups(
        [trial.RetractGroup(vname, x, dx, free, b)], lam, out)
    return cand, out


def _parts(tprob, st, layout):
    """dx and b as trial_candidate's callers pass them: transposed
    lane-major parts (the Schur routes) or views of one flat vector at each
    group's offset (the dense route)."""
    if layout == "lane":
        t = lambda d: {k: torch.as_tensor(v.T.copy()).T for k, v in
                       d.items()}
        return t(st["dx"]), t(st["b"])
    groups = sorted(tprob.static.vgroups, key=lambda g: g.offset)
    flat = lambda d: torch.as_tensor(np.concatenate(
        [d[g.name].ravel() for g in groups]))
    return (tproblem.tangent_parts(tprob, flat(st["dx"])),
            tproblem.tangent_parts(tprob, flat(st["b"])))


@pytest.mark.parametrize("layout", ["lane", "flat"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_trial_candidate_matches_jax(scene, layout):
    st = _state(scene)
    tprob = st["tprob"]
    dx, b = _parts(tprob, st, layout)
    kernels.reset_launch_counts()
    cand, part = tproblem.trial_candidate(
        tprob, dx, b, torch.tensor(LAM, dtype=torch.float64))
    assert set(kernels.launch_counts().values()) == {0}
    assert list(cand) == [g.name for g in tprob.static.vgroups]
    for k, v in st["cand"].items():
        _close(cand[k], v)
    _close(part.sum().reshape(()), st["dot"])
    # the candidate without b: the same bits, no partials
    cand2, none = tproblem.trial_candidate(tprob, dx)
    assert none is None
    for k in cand:
        assert torch.equal(cand2[k], cand[k]), k


@pytest.mark.parametrize("scene", list(SCENES))
def test_partials_per_group_and_their_offsets(scene, monkeypatch):
    """On the CPU one partial per group, each the group's own dot (the
    group's retraction on its own); with the card's partial counts,
    trial_candidate hands each group the offset of the per-group partials
    laid end to end, the vector holds their total, and the group's dot
    lands in its first slot with zeros after it."""
    st = _state(scene)
    tprob = st["tprob"]
    dx, b = _parts(tprob, st, "lane")
    lam = torch.tensor(LAM, dtype=torch.float64)
    vgroups = tprob.static.vgroups
    _, part = tproblem.trial_candidate(tprob, dx, b, lam)
    assert part.shape == (len(vgroups),)
    for i, g in enumerate(vgroups):
        _, own = _alone(g.vtype.name, tprob.params[g.name], dx[g.name],
                        tprob.free[g.name], b[g.name], lam)
        assert torch.equal(part[i:i + 1], own), g.name
    card = torch.device("cuda")
    counts = [trial.partial_count(g.count, card) for g in vgroups]
    seen = []
    real = trial.trial_retract_groups

    def recording(groups, lam_=None, out=None):
        seen.extend((g.vname, g.offset) for g in groups)
        return real(groups, lam_, out)

    monkeypatch.setattr(trial, "partial_count",
                        lambda n, device: _card_count(n))
    monkeypatch.setattr(trial, "trial_retract_groups", recording)
    _, part_card = tproblem.trial_candidate(tprob, dx, b, lam)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    if scene == "ba80k":                 # 600 points: three blocks
        assert max(counts) == 3
    assert part_card.shape == (sum(counts),)
    assert seen == [(g.vtype.name, int(o)) for g, o in zip(vgroups, offsets)]
    for i, (g, o, c) in enumerate(zip(vgroups, offsets, counts)):
        assert torch.equal(part_card[o:o + 1], part[i:i + 1]), g.name
        assert not part_card[o + 1:o + c].any(), g.name


def _card_count(n):
    """trial.partial_count on a CUDA device: one partial per block."""
    return max((n + trial.BLOCK - 1) // trial.BLOCK, 1)


@pytest.mark.parametrize("n_groups", [1, 7, 8, 9, 16, 17, 19])
def test_launch_ranges_split_past_eight_groups(n_groups):
    rng = np.random.default_rng(n_groups)
    counts = [int(v) for v in rng.integers(0, 1000, n_groups)]
    counts[0] = 0                       # an empty group takes one block
    launches = trial.retract_launches(counts)
    assert len(launches) == -(-n_groups // trial.MAX_RETRACT_GROUPS)
    card = torch.device("cuda")
    stops = []
    for first, stop, block0, n_blocks in launches:
        assert 0 < stop - first <= trial.MAX_RETRACT_GROUPS
        blocks = [trial.partial_count(n, card) for n in counts[first:stop]]
        assert block0 == tuple(np.concatenate([[0], np.cumsum(blocks)[:-1]]))
        assert n_blocks == sum(blocks)
        stops.append((first, stop))
    assert [s for s, _ in stops] == list(range(0, n_groups,
                                               trial.MAX_RETRACT_GROUPS))
    assert stops[-1][1] == n_groups


def _vertex_group(vname, n, rng):
    vt = registry.vertex_type(vname)
    x = rng.normal(0, 1.0, (n, vt.ambient_dim))
    if vname in ("se3", "se3_expmap", "cam"):
        x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    free = (rng.random(n) > 0.2).astype(np.float64)
    dxT = rng.normal(0, 0.02, (vt.tangent_dim, n))
    bT = rng.normal(0, 1.0, (vt.tangent_dim, n))
    t = torch.as_tensor
    return t(x), t(dxT).T, t(free), t(bT).T


def test_eleven_groups_of_every_type_equal_the_per_type_wrappers():
    """Eleven groups (every vertex type, two of them twice) through
    trial_retract_groups (two launches' worth on the card) against each
    group through it on its own, as the per-type wrappers ran one group:
    the same candidates and partials, bit for bit."""
    rng = np.random.default_rng(2)
    names = list(trial.RETRACT_IDS) + ["se2", "cam"]
    assert set(trial.RETRACT_IDS) == set(tproblem.SUPPORTED_VERTEX_TYPES)
    lam = torch.tensor(LAM, dtype=torch.float64)
    groups, want, offset = [], [], 0
    for i, vname in enumerate(names):
        x, dx, free, b = _vertex_group(vname, 5 + 37 * i, rng)
        groups.append(trial.RetractGroup(vname, x, dx, free, b, offset))
        want.append(_alone(vname, x, dx, free, b, lam))
        offset += 1
    out = torch.empty(offset, dtype=torch.float64)
    cands = trial.trial_retract_groups(groups, lam, out)
    assert len(trial.retract_launches([g.x.shape[0] for g in groups])) == 2
    for i, (cand, (wc, wp)) in enumerate(zip(cands, want)):
        assert torch.equal(cand, wc), names[i]
        assert torch.equal(out[i:i + 1], wp), names[i]
    plain = trial.trial_retract_groups(
        [g._replace(b=None) for g in groups])
    for cand, c2 in zip(cands, plain):
        assert torch.equal(cand, c2)


def test_trial_retract_groups_refuses_bad_arguments():
    rng = np.random.default_rng(0)
    x, dx, free, b = _vertex_group("se2", 10, rng)
    lam = torch.tensor(LAM, dtype=torch.float64)
    out = torch.empty(1, dtype=torch.float64)
    g = trial.RetractGroup("se2", x, dx, free, b, 0)
    with pytest.raises(ValueError, match="no kernel"):
        trial.trial_retract_groups([g._replace(vname="nope")], lam, out)
    with pytest.raises(ValueError, match="some groups only"):
        trial.trial_retract_groups([g, g._replace(b=None, offset=1)], lam,
                                   torch.empty(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="do not fit"):
        trial.trial_retract_groups([g._replace(offset=1)], lam, out)
    with pytest.raises(ValueError, match="x must be"):
        trial.trial_retract_groups([g._replace(x=x[:, :2])], lam, out)
    with pytest.raises(ValueError, match="lam and out"):
        trial.trial_retract_groups([g._replace(b=None)], lam, out)
