"""W^T x over the pose groups in one call (kernels/ba_coupling.py `ba_wtx`
with sequences of groups; core/ba.py `SchurOperator.landmark_side`), on its
plain version, float64 on the CPU.

* On the general path's small scenes (chip_smoke.py's PSI2UV scene, one
  pose group with two pose slots per edge, and its P2MC_INTRINSICS scene,
  two pose groups: the shared intrinsics vertex, then the cameras), the
  one-call landmark side against the chained `ba_wtx_plain` calls it
  replaces (each later group starting from the earlier groups' u) and
  against JAX's S x landmark half (openslam_g2o_tpu/core/ba.py:229-241:
  u = sum over the cross entries of W^T x, then Hinv u) and its
  back-substitution (:276-280, Hinv (b_l - u) free): rtol 1e-12 of the
  largest entry (the same sums in another order).
* On random slot tables: K = 1, 3, 8 and 13 slots (the kernel's eight
  slot warps and more), a third padding, L = 37 (not a multiple of a
  block's 32 landmarks), one to three groups of widths (6, 3), (4, 3) and
  (3, 2), against a loop over landmarks and slots in numpy; acc, b, free
  and Hinv each present and absent.
* The wrapper's checks (more groups than one launch takes raise), its CPU
  dispatch (no launch counted) and that the landmark side makes one call
  over all its groups, on the three-group scene of
  tests/test_torch_sba_cam_types.py too.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scenes
from openslam_g2o_tpu.core import ba as jba
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.core.solvers import batched_small_inv

from openslam_g2o_torch import kernels
from openslam_g2o_torch.core import ba as tba
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import ba_coupling, ba_inv
from tests.test_torch_sba_cam_types import build_sba_cam_graph

torch.set_num_threads(1)

RTOL = 1e-12
GEOMETRY = (10, 120)             # cameras, points of the small BAL scenes
SCENES = {"psi2uv": scenes.psi2uv_graph,
          "p2mc_intrinsics": scenes.p2mc_intrinsics_graph}

_cache = {}


def _pair(name):
    if name not in _cache:
        jprob = SCENES[name](JGraph, scenes.bal_geometry(*GEOMETRY)).compile(
            dtype=jnp.float64)
        tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
        _cache[name] = (jprob, tprob, jba.schur_build(jprob),
                        tba.schur_build(tprob))
    return _cache[name]


def _close(t, j, rtol=RTOL):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                               atol=rtol * max(float(np.abs(j).max()), 1e-300))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_one_call_landmark_side_matches_chained_and_jax(name):
    jprob, tprob, js, ts = _pair(name)
    pat = ts["pattern"]
    groups = [pg for pg in pat.pose_groups if pg.n_entries]
    assert len(groups) == (2 if name == "p2mc_intrinsics" else 1)
    L, dl = pat.n_lm, pat.dl
    lam = 1e-3
    free_l = tprob.free[pat.lm_name]
    _, hinv, _ = ba_inv.ba_block_inv(ts["Hll"], ba_inv.LANDMARK, free_l,
                                     torch.tensor(lam, dtype=torch.float64),
                                     b=ts["b_l"])
    x_vert = np.random.default_rng(5).normal(size=pat.pose_dim)
    x = tba._lane(pat, torch.as_tensor(x_vert)[pat.perm])
    # JAX: the landmark half of s_matvec and of the back-substitution
    u_j = jnp.zeros((L, dl))
    for entry in js["cross"]:
        u_j = u_j + jba._accumulate_lm(
            entry, jnp.einsum("est,es->et", entry["W"],
                              jnp.asarray(x_vert)[entry["rows"]]), L)
    fl = jnp.asarray(free_l.numpy())
    hll_d = js["Hll"] + (lam * fl + (1.0 - fl))[:, None, None] * jnp.eye(dl)
    hinv_j = batched_small_inv(hll_d)
    v_j = jnp.einsum("lst,lt->ls", hinv_j, u_j)
    back_j = jnp.einsum("lst,lt->ls", hinv_j, js["b_l"] - u_j) * fl[:, None]

    W = [ts["W_lm"][pg.name] for pg in groups]
    cams = [pg.lm_pose for pg in groups]
    xs = [x[pg.name] for pg in groups]
    for kw, want in ((dict(hinv=hinv), v_j.T),
                     (dict(hinv=hinv, b=ts["b_l"], free=free_l), back_j.T),
                     ({}, u_j.T)):
        one = ba_coupling.ba_wtx_plain(W, cams, xs, **kw)
        chained = None
        for i, args in enumerate(zip(W, cams, xs)):
            last = i == len(W) - 1
            chained = ba_coupling.ba_wtx_plain(*args, acc=chained,
                                               **(kw if last else {}))
        _close(one, want)
        _close(chained, want)
        _close(one, chained.numpy())
    op = tba.SchurOperator(pat, ts, hinv, None)
    _close(op.landmark_side(x, hinv=hinv), v_j.T)
    _close(op.landmark_side(x, hinv=hinv, b=ts["b_l"], free=free_l),
           back_j.T)


def _random_groups(rng, dims, K, L, with_padding=True):
    """(W_lm, slot table, x) per group as float64 tensors; a third of the
    slots padding (pose index -1) where asked."""
    out = []
    for i, (dp, dl) in enumerate(dims):
        k, C = K + i, 5 + i
        cam = rng.integers(0, C, (k, L)).astype(np.int32)
        if with_padding:
            cam[rng.random((k, L)) < 0.3] = -1
        w = rng.normal(size=(dp * dl, k, L))
        w[:, cam < 0] = 0.0
        out.append((torch.as_tensor(w), torch.as_tensor(cam),
                    torch.as_tensor(rng.normal(size=(dp, C)))))
    return out


def _loop_reference(groups, dl, L, hinv=None, b=None, free=None, acc=None):
    """out[:, l] by a loop over landmarks and slots, in numpy."""
    out = np.zeros((dl, L))
    for l in range(L):
        u = np.zeros(dl)
        for w, cam, x in groups:
            w, cam, x = w.numpy(), cam.numpy(), x.numpy()
            dp = x.shape[0]
            for k in range(cam.shape[0]):
                c = cam[k, l]
                if c >= 0:
                    u += w[:, k, l].reshape(dp, dl).T @ x[:, c]
        if acc is not None:
            u = acc[:, l].numpy() + u
        r = u if b is None else b[:, l].numpy() - u
        y = r if hinv is None else hinv[:, l].numpy().reshape(dl, dl) @ r
        out[:, l] = y if free is None else y * float(free[l])
    return out


DIMS = {"6x3": ((6, 3),), "4x3": ((4, 3),), "3x2": ((3, 2),),
        "intrinsics": ((4, 3), (6, 3)), "intrinsics-last": ((6, 3), (4, 3)),
        "two-cameras": ((6, 3), (6, 3)), "2d-pair": ((3, 2), (3, 2)),
        "three": ((4, 3), (6, 3), (6, 3))}


@pytest.mark.parametrize("K", [1, 3, 8, 13])
@pytest.mark.parametrize("dims", sorted(DIMS))
def test_groups_against_a_loop(K, dims):
    rng = np.random.default_rng(K)
    L = 37
    groups = _random_groups(rng, DIMS[dims], K, L)
    dl = DIMS[dims][0][1]
    hinv = torch.as_tensor(rng.normal(size=(dl * dl, L)))
    W, cams, xs = (list(t) for t in zip(*groups))
    got = ba_coupling.ba_wtx(W, cams, xs, hinv=hinv)
    want = _loop_reference(groups, dl, L, hinv=hinv)
    _close(got, want)
    if len(groups) == 1:
        _close(ba_coupling.ba_wtx(W[0], cams[0], xs[0], hinv=hinv), want)


@pytest.mark.parametrize("terms", list(itertools.product((0, 1), repeat=4)),
                         ids=lambda t: "".join(
                             n if u else "-" for n, u in zip("hbfa", t)))
def test_epilogue_terms_each_present_and_absent(terms):
    """acc, b, free and Hinv (h, b, f, a in the id) on the intrinsics
    scene's two widths."""
    rng = np.random.default_rng(sum(t << i for i, t in enumerate(terms)))
    L, dl = 37, 3
    groups = _random_groups(rng, DIMS["intrinsics"], 8, L)
    extra = dict(hinv=torch.as_tensor(rng.normal(size=(dl * dl, L))),
                 b=torch.as_tensor(rng.normal(size=(dl, L))),
                 free=torch.as_tensor((rng.random(L) < 0.7) * 1.0),
                 acc=torch.as_tensor(rng.normal(size=(dl, L))))
    kw = {k: v for (k, v), use in zip(extra.items(), terms) if use}
    W, cams, xs = (list(t) for t in zip(*groups))
    _close(ba_coupling.ba_wtx(W, cams, xs, **kw),
           _loop_reference(groups, dl, L, **kw))


def test_cpu_dispatch_counts_nothing_and_checks_arguments():
    rng = np.random.default_rng(0)
    groups = _random_groups(rng, DIMS["intrinsics"], 8, 37)
    W, cams, xs = (list(t) for t in zip(*groups))
    kernels.reset_launch_counts()
    ba_coupling.ba_wtx(W, cams, xs)
    assert ba_coupling.ba_wtx.launches == 0
    with pytest.raises(ValueError, match="no pose group"):
        ba_coupling.ba_wtx([], [], [])
    with pytest.raises(ValueError, match="one L"):
        ba_coupling.ba_wtx(W, [cams[0], cams[1][:, :-1]], xs)
    with pytest.raises(ValueError, match="landmark width"):
        (w2, c2, x2), = _random_groups(rng, ((3, 2),), 8, 37)
        ba_coupling.ba_wtx([W[0], w2], [cams[0], c2], [xs[0], x2])
    with pytest.raises(ValueError, match="rows"):
        ba_coupling.ba_wtx(W, cams, [xs[0], xs[0]])
    with pytest.raises(ValueError, match="int32"):
        ba_coupling.ba_wtx(W, [cams[0].long(), cams[1]], xs)
    with pytest.raises(ValueError, match="acc must be"):
        ba_coupling.ba_wtx(W, cams, xs, acc=torch.zeros(3, 36,
                                                       dtype=torch.float64))


def test_landmark_side_makes_one_call_over_its_groups(monkeypatch):
    _, tprob, _, ts = _pair("p2mc_intrinsics")
    pat = ts["pattern"]
    calls = []
    real = ba_coupling.ba_wtx

    def spy(w_lm, lm_cam, x, **kw):
        calls.append(len(w_lm))
        return real(w_lm, lm_cam, x, **kw)

    monkeypatch.setattr(ba_coupling, "ba_wtx", spy)
    x = tba._lane(pat, torch.ones(pat.pose_dim, dtype=torch.float64))
    tba.SchurOperator(pat, ts, None, None).landmark_side(x)
    assert calls == [2]


def test_more_groups_than_a_launch_takes_are_refused():
    """Four pose groups have no launch: the wrapper raises on either
    device (the general path's pattern build refuses such a graph up
    front)."""
    rng = np.random.default_rng(4)
    groups = _random_groups(rng, ((4, 3), (6, 3), (6, 3), (6, 3)), 8, 37)
    W, cams, xs = (list(t) for t in zip(*groups))
    assert ba_coupling.MAX_WTX_GROUPS == 3
    with pytest.raises(ValueError, match="4 pose groups"):
        ba_coupling.ba_wtx(W, cams, xs)
    with pytest.raises(ValueError, match="at most 3"):
        ba_coupling.check_wtx_groups(4)
    ba_coupling.check_wtx_groups(3)


def test_three_group_landmark_side_is_one_call(monkeypatch):
    """tests/test_torch_sba_cam_types.py's graph: the intrinsics, SBACam
    and SE3 expmap groups in one call, equal to the chained plain calls."""
    prob = build_sba_cam_graph(TGraph).compile(dtype=torch.float64,
                                              device="cpu")
    ts = tba.schur_build(prob)
    pat = ts["pattern"]
    groups = [pg for pg in pat.pose_groups if pg.n_entries]
    assert [pg.dim for pg in groups] == [4, 6, 6]
    calls = []
    real = ba_coupling.ba_wtx

    def spy(w_lm, lm_cam, x, **kw):
        calls.append(len(w_lm))
        return real(w_lm, lm_cam, x, **kw)

    monkeypatch.setattr(ba_coupling, "ba_wtx", spy)
    x = tba._lane(pat, torch.as_tensor(np.random.default_rng(3).normal(
        size=pat.pose_dim))[pat.perm])
    got = tba.SchurOperator(pat, ts, None, None).landmark_side(x)
    assert calls == [3]
    chained = None
    for pg in groups:
        chained = real(ts["W_lm"][pg.name], pg.lm_pose, x[pg.name],
                       acc=chained)
    _close(got, chained.numpy())
