"""K10's camera-major records and chunked camera sums on their plain
versions, float64 on the CPU.

* `cam_pos` of the BA pattern is the inverse permutation of `cam_edge`
  (numpy), so observation e's record lands at its place in its camera's
  CSR list.
* The plain fused (EDGE_PROJECT_XYZ2UV, (6, 3)) and generic ((6, 3) and
  (3, 2), residual widths 1-3) edge entries write, at row cam_pos[e] of
  the records, the record of `edge_products_plain` for edge e (Hcc_e, b_p,e,
  W_e, zeros up to a multiple of 8 values), and Hll_e, b_l,e and W_e at
  column e: exactly, the same arithmetic. `EdgeStreams.from_lane_major` and `lane_major` round-trip.
* `ba_cam_sums_plain` against numpy segment sums over the CSR lists (Hcc,
  b_p to rtol 1e-12: the same float64 values summed in another order; W_cam
  exact) at camera degrees 0, 1, 255, 256, 257 and a hub.
* `_build`'s Hcc, b_p and W_cam against JAX `_build`
  (openslam_g2o_tpu/core/ba_ell.py:537-672, camera side :582-606) on a BA
  scene whose observations come in a shuffled order, with camera degrees
  0, 1, 255, 256, 257 (CHUNK - 1, CHUNK, CHUNK + 1 of the chunked sums) and
  one hub camera, fused and generic groups, a robust kernel and a fixed
  camera: Hcc, b_p and W_cam to rtol 1e-12 of the largest entry (sums of
  up to 900 float64 products in another order; XLA forms W_e in another
  order too), and W_cam exactly the port's own per-observation W_e,
  placed by cam_pos (a copy).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.core.graph import Graph as JGraph

from openslam_g2o_torch.core import ba_ell as tba
from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core import registry, robust
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import ba_coupling, ba_edge
from openslam_g2o_torch.utils import np_lie
from tests.test_torch_ba_kernels import (
    RTOL_BUILD, _close, _jax_build, _per_obs_w)
from tests.test_torch_ba_types import CAM, _small_rotation

torch.set_num_threads(1)

DEGREES = {"chunk_edges": [0, 1, 255, 256, 257, 12],
           "hub": [3, 0, 900, 40, 1, 260]}


def degree_scene(Graph, degrees, seed=5):
    """A BA scene through either package's Graph (numpy only): camera i
    sees degrees[i] distinct points, observations added in a shuffled
    order; every third observation is a stereo XYZ2UVU edge (the generic
    entry, residual width 3), every fifth has a Huber kernel; camera 0 and
    point 3 are fixed."""
    rng = np.random.default_rng(seed)
    n_cams, n_points = len(degrees), max(degrees) + 20
    g = Graph()
    g.add_parameter(0, "camera_parameters", CAM)
    pts = rng.uniform(-2, 2, size=(n_points, 3)) + np.array([0.0, 0.0, 8.0])
    w2c = []
    for i in range(n_cams):
        c2w = np.concatenate([[0.3 * i - 0.8, 0.1 * i, 0.0],
                              _small_rotation(rng, 0.05)])
        w2c.append(np_lie.se3_inverse(c2w))
        noisy = np_lie.se3_compose(np.concatenate(
            [rng.normal(0, 0.03, 3), _small_rotation(rng, 0.01)]), w2c[-1])
        g.add_vertex(i, "se3_expmap", noisy, fixed=i == 0)
    for j, p in enumerate(pts):
        g.add_vertex(1000 + j, "sba_point_xyz", p + rng.normal(0, 0.2, 3),
                     fixed=j == 3, marginalized=True)
    obs = [(i, j) for i, d in enumerate(degrees)
           for j in rng.choice(n_points, d, replace=False)]
    for n in rng.permutation(len(obs)):
        i, j = obs[n]
        pc = np_lie.se3_apply(w2c[i], pts[j])
        u = pc[0] / pc[2] * CAM[0] + CAM[1]
        v = pc[1] / pc[2] * CAM[0] + CAM[2]
        kw = dict(kernel="Huber", kernel_delta=1.5) if n % 5 == 0 else {}
        if n % 3 == 0:
            ur = (pc[0] - CAM[3]) / pc[2] * CAM[0] + CAM[1]
            g.add_edge("edge_project_xyz2uvu", (1000 + j, i),
                       np.array([u, v, ur]) + rng.normal(0, 0.5, 3),
                       np.diag([1.0, 1.0, 2.0]), param_ids=[0], **kw)
        else:
            g.add_edge("edge_project_xyz2uv", (1000 + j, i),
                       np.array([u, v]) + rng.normal(0, 0.5, 2),
                       np.array([[1.0, 0.2], [0.2, 2.0]]), param_ids=[0],
                       **kw)
    return g


@pytest.fixture(scope="module", params=sorted(DEGREES))
def scene(request):
    jprob = degree_scene(JGraph, DEGREES[request.param]).compile(
        dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    return request.param, jprob, tprob, _jax_build(jprob)


def test_cam_pos_is_the_inverse_of_cam_edge(scene):
    name, _, tprob, _ = scene
    pat = tba.build_ba_ell_pattern(tprob)
    cam_edge, cam_pos = pat.cam_edge.numpy(), pat.cam_pos.numpy()
    assert pat.cam_pos.dtype == torch.int32 and cam_pos.shape == (pat.n_obs,)
    np.testing.assert_array_equal(cam_pos[cam_edge], np.arange(pat.n_obs))
    np.testing.assert_array_equal(np.sort(cam_pos), np.arange(pat.n_obs))
    counts = np.diff(pat.cam_ptr.numpy())
    np.testing.assert_array_equal(counts, DEGREES[name])


def _record(blocks, e, rs):
    hll, bl, w, hcc, bp = (t[:, e] for t in blocks)
    rec = torch.cat([hcc, bp, w])
    return torch.cat([rec, rec.new_zeros(rs - rec.numel())])


ENTRIES = [("fused", (6, 3), 2)] + [("generic", dims, R)
                                    for dims in ba_edge.BLOCK_DIMS
                                    for R in (1, 2, 3)]


@pytest.mark.parametrize("entry,dims,R", ENTRIES)
def test_edge_entries_write_records_at_cam_pos(entry, dims, R):
    dp, dl = dims
    rng = np.random.default_rng(dp + 10 * R)
    E, off = 90, 7
    n_obs = E + 2 * off
    cam_pos = torch.as_tensor(rng.permutation(n_obs).astype(np.int32))
    out = ba_edge.EdgeStreams.empty(n_obs, dp, dl, torch.float64, "cpu",
                                    cam_pos)
    for t in out.tensors():
        t.fill_(float("nan"))
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    if entry == "fused":
        L, C = 20, 6
        points = T(rng.normal(size=(L, 3)) + np.array([0.0, 0.0, 8.0]))
        cams = T(np.concatenate([rng.normal(0, 0.1, (C, 3)),
                                 np.tile([0.0, 0.0, 0.0, 1.0], (C, 1))],
                                axis=1))
        li = T(rng.integers(0, L, E).astype(np.int32))
        ci = T(rng.integers(0, C, E).astype(np.int32))
        meas = T(rng.normal(0, 50, (E, 2)))
        info = T(np.tile(np.eye(2), (E, 1, 1)))
        delta = T(np.full(E, 2.0))
        camp = T(np.tile(CAM, (E, 1)))
        free_l = T((rng.random(L) > 0.2).astype(np.float64))
        free_c = T((rng.random(C) > 0.2).astype(np.float64))
        kid = robust.kernel_id("Huber")
        ba_edge.ba_xyz2uv_blocks(points, cams, li, ci, meas, info, delta,
                                 camp, free_l, free_c, kid, out, off)
        # the plain fused entry's inputs to the products
        et = registry.edge_type("edge_project_xyz2uv")
        vp = (points[li.long()], cams[ci.long()])
        resid = et.error(vp, meas, (camp,))
        jl, jc = et.jacobian(vp, meas, (camp,))
        e2 = (resid[:, :, None] * info * resid[:, None, :]).sum(dim=(1, 2))
        rho1 = robust.robustify(kid, e2, delta)[1]
        jl = jl * free_l[li.long()][:, None, None]
        jc = jc * free_c[ci.long()][:, None, None]
    else:
        resid, jl, jc = (T(rng.normal(size=s)) for s in
                         ((E, R), (E, R, dl), (E, R, dp)))
        rho1 = T(rng.uniform(0.2, 1.0, E))
        A = rng.normal(size=(E, R, R))
        info = T(A @ A.transpose(0, 2, 1) + np.eye(R))
        ba_edge.ba_edge_blocks(resid, jl, jc, rho1, info, out, off)
    blocks = ba_edge.edge_products_plain(resid, jl, jc, rho1, info)
    rs = ba_edge.record_size(dp, dl)
    assert out.rec.shape == (n_obs, rs) and rs % 8 == 0
    for e in range(E):
        assert torch.equal(out.rec[cam_pos[off + e]], _record(blocks, e, rs))
    assert torch.equal(out.hll[:, off:off + E], blocks[0])
    assert torch.equal(out.bl[:, off:off + E], blocks[1])
    assert torch.equal(out.w[:, off:off + E], blocks[2])
    # nothing outside the group's observations was written
    outside = np.r_[0:off, off + E:n_obs]
    assert torch.isnan(out.rec[cam_pos[outside].long()]).all()
    assert torch.isnan(out.hll[:, outside]).all()
    # the lane-major view and from_lane_major round-trip
    lanes = out.lane_major()
    for a, b in zip(lanes, blocks):
        assert torch.equal(a[:, off:off + E], b)
    back = ba_edge.EdgeStreams.from_lane_major(*lanes, cam_pos)
    mine = cam_pos[off:off + E].long()
    assert torch.equal(back.rec[mine], out.rec[mine])


@pytest.mark.parametrize("degrees", sorted(DEGREES))
@pytest.mark.parametrize("dims", ba_edge.BLOCK_DIMS)
def test_cam_sums_plain_matches_numpy_segment_sums(dims, degrees):
    dp, dl = dims
    counts = DEGREES[degrees]
    rng = np.random.default_rng(dp + len(degrees))
    E = sum(counts)
    rows = ba_coupling.build_pose_rows(counts, rng.integers(0, 50, E), "cpu")
    cam_pos = torch.as_tensor(rng.permutation(E).astype(np.int32))
    data = {k: rng.normal(size=(r, E)) for k, r in
            (("hll", dl * dl), ("bl", dl), ("w", dp * dl), ("hcc", dp * dp),
             ("bp", dp))}
    st = ba_edge.EdgeStreams.from_lane_major(
        *(torch.as_tensor(data[k]) for k in ("hll", "bl", "w", "hcc", "bp")),
        cam_pos)
    hcc, bp, w_cam = ba_edge.ba_cam_sums(st, rows)
    order = np.argsort(cam_pos.numpy())        # observation at each place
    ptr = np.concatenate([[0], np.cumsum(counts)])
    for got, key in ((hcc, "hcc"), (bp, "bp")):
        want = np.stack([data[key][:, order[ptr[c]:ptr[c + 1]]].sum(axis=1)
                         for c in range(len(counts))], axis=1)
        _close(got, want, RTOL_BUILD)
    assert np.array_equal(w_cam.numpy(), data["w"][:, order])
    for c in np.flatnonzero(np.asarray(counts) == 0):
        assert not hcc[:, c].any() and not bp[:, c].any()


def _streams_of(prob, pattern):
    """The per-edge streams `_build` fills, filled the same way."""
    streams = ba_edge.EdgeStreams.empty(pattern.n_obs, pattern.dp,
                                        pattern.dl, prob.dtype, prob.device,
                                        pattern.cam_pos)
    for pg in pattern.proj:
        eg = next(e for e in prob.static.egroups if e.key == pg.egkey)
        ea = prob.edges[pg.egkey]
        if pg.fused:
            lm, cam = pattern.lm_name, pattern.cam_name
            ba_edge.ba_xyz2uv_blocks(
                prob.params[lm], prob.params[cam], ea.indices[pg.lm_slot],
                ea.indices[pg.cam_slot], ea.measurement, ea.information,
                ea.delta, ea.pdata[0], prob.free[lm], prob.free[cam],
                eg.kernel_id, streams, pg.offset)
        else:
            resid, jacs, rho1 = tproblem.linearize_group(prob, eg)
            ba_edge.ba_edge_blocks(
                resid.contiguous(), jacs[pg.lm_slot].contiguous(),
                jacs[pg.cam_slot].contiguous(), rho1.contiguous(),
                ea.information, streams, pg.offset)
    return streams


def test_build_camera_side_matches_jax(scene):
    name, jprob, tprob, (jpat, jsys) = scene
    tpat = tba.build_ba_ell_pattern(tprob)
    # the port's own per-observation W, landmark-major
    w_port = ba_edge.ba_lm_sums(_streams_of(tprob, tpat), tpat.lm_edge)[2]
    tsys = tba._build(tprob, tpat)
    dp, C = 6, tpat.n_cam
    g = jsys["groups"]["se3_expmap"]
    _close(tsys["Hcc"], np.asarray(g["Hcc"]).reshape(dp * dp, C), RTOL_BUILD)
    _close(tsys["b_p"], g["bT"], RTOL_BUILD)
    for c in np.flatnonzero(np.asarray(DEGREES[name]) == 0):
        assert not tsys["Hcc"][:, c].any() and not tsys["b_p"][:, c].any()
    w_obs = _per_obs_w(jpat.proj, [pd["W_lm"][0] for pd in jsys["proj"]],
                       dp * 3)
    _close(tsys["W_cam"], w_obs[:, tpat.cam_edge.numpy()], RTOL_BUILD)
    # a copy: exactly the port's own W_e, at each observation's place
    kk, ll = np.nonzero(tpat.lm_edge.numpy() >= 0)
    pos = tpat.cam_pos.numpy()[tpat.lm_edge.numpy()[kk, ll]]
    assert torch.equal(tsys["W_cam"][:, pos], w_port[:, kk, ll])
    _close(tsys["Hll"], np.asarray(jsys["Hll"]).reshape(9, tpat.n_lm),
           RTOL_BUILD)
