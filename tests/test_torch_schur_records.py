"""K12's operand records and K15's chunk tables, on the CPU.

* `ba_schur_records_plain` against the lane-major tables it copies, exactly:
  W [Dp*dl, K*L] of the dense-Schur route's `_build` (the slot's block per
  row) and Hinv [dl*dl, L] (the landmark's block per row), zero padded to
  a multiple of 16 bytes, at (Dp, dl) = (6, 3) and (3, 2), float32 and
  float64; `_build` makes W's records on the dense-Schur route only, and
  its W per observation matches the JAX package's `_build` through them
  (rtol 1e-12: the same float64 arithmetic in another order).
* `ba_schur_dense` on CPU tensors reads w_lm, not the W records it
  requires (zeroed records give the same S), and refuses records of the
  wrong shape or none.
* K15's destination tables on the chunk edges: lists of 1, 63, 64, 65,
  128, 129 and 80,000 contributions cut into chunks of 1..DENSE_CHUNK
  that tile each list in order, `chunk_dest` naming each chunk's
  destination, and a zero arrival counter per destination.
"""
import numpy as np
import pytest
import torch

from openslam_g2o_torch.apps.simulator import synthetic_bal_problem
from openslam_g2o_torch.core import ba_ell as tba
from openslam_g2o_torch.kernels import ba_inv, ba_schur, dense_assemble
from tests.test_torch_ba_kernels import (
    RTOL_BUILD, _close, _jax_build, _pair, _per_obs_w)

torch.set_num_threads(1)


def _assert_records(rec, x):
    """rec [n, width] holds column i of x [rows, n] as row i, then zeros,
    with rows of a multiple of 16 bytes."""
    rows, n = x.shape
    assert rec.shape[0] == n and rec.dtype == x.dtype
    assert (rec.shape[1] * rec.element_size()) % 16 == 0
    assert rows <= rec.shape[1] < rows + 16 // rec.element_size()
    assert torch.equal(rec[:, :rows].T, x)
    assert not rec[:, rows:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_w_and_hinv_records_copy_the_lane_major_tables(dtype):
    """W of a synthetic BAL system ((6, 3)) and random (3, 2) tables."""
    prob, _ = synthetic_bal_problem(n_cams=12, n_points=200, dtype=dtype,
                                    device="cpu")
    pattern = tba.build_ba_ell_pattern(prob)
    assert tba.dense_schur_ok(prob, pattern)
    sys = tba._build(prob, pattern)
    w_flat = sys["W_lm"].view(18, -1)
    _assert_records(sys["W_rec"], w_flat)
    assert torch.equal(sys["W_rec"], ba_schur.ba_schur_records(w_flat))
    lam = torch.tensor(1e-2, dtype=dtype)
    _, hinv, _ = ba_inv.ba_block_inv(sys["Hll"], ba_inv.LANDMARK,
                                     prob.free["sba_point_xyz"], lam,
                                     b=sys["b_l"])
    _assert_records(ba_schur.ba_schur_records_plain(hinv), hinv)
    rng = np.random.default_rng(3)
    for rows in (6, 4):                      # W and Hinv at (3, 2)
        x = torch.as_tensor(rng.normal(size=(rows, 77)), dtype=dtype)
        _assert_records(ba_schur.ba_schur_records(x), x)
    assert ba_schur.record_width(18, torch.float32) == 20
    assert ba_schur.record_width(18, torch.float64) == 18
    assert ba_schur.record_width(9, torch.float64) == 10
    assert ba_schur.ba_schur_records.launches == 0


def test_w_records_only_on_the_dense_route(monkeypatch):
    prob, _ = synthetic_bal_problem(n_cams=12, n_points=200, device="cpu")
    monkeypatch.setattr(tba, "_DENSE_SCHUR_MAX_TP", -1)
    pattern = tba.build_ba_ell_pattern(prob)
    assert not tba.dense_schur_ok(prob, pattern)
    assert tba._build(prob, pattern)["W_rec"] is None


def test_w_records_match_jax_per_observation():
    """Row k L + l of W's records is the W of the observation in slot k of
    landmark l, as the JAX package's _build forms it (the all-types scene:
    three projection groups, pose-pose edges)."""
    jprob, tprob = _pair("scene")
    jpat, jsys = _jax_build(jprob)
    tpat = tba.build_ba_ell_pattern(tprob)
    assert tba.dense_schur_ok(tprob, tpat)
    rec = tba._build(tprob, tpat)["W_rec"].numpy()
    w_obs = _per_obs_w(jpat.proj, [pd["W_lm"][0] for pd in jsys["proj"]],
                       18)
    lm_edge = tpat.lm_edge.numpy()
    K, L = lm_edge.shape
    kk, ll = np.nonzero(lm_edge >= 0)
    _close(rec[kk * L + ll, :18].T, w_obs[:, lm_edge[kk, ll]], RTOL_BUILD)
    empty = np.nonzero((lm_edge < 0).reshape(-1))[0]
    assert (rec[empty] == 0).all()


def test_schur_dense_on_the_cpu_reads_w_lm():
    prob, _ = synthetic_bal_problem(n_cams=12, n_points=200, device="cpu")
    pattern = tba.build_ba_ell_pattern(prob)
    sys = tba._build(prob, pattern)
    lam = torch.tensor(1e-2, dtype=torch.float64)
    _, hinv, _ = ba_inv.ba_block_inv(sys["Hll"], ba_inv.LANDMARK,
                                     prob.free["sba_point_xyz"], lam,
                                     b=sys["b_l"])
    hcc_d, _, _ = ba_inv.ba_block_inv(sys["Hcc"], ba_inv.CAMERA,
                                      prob.free["se3_expmap"], lam,
                                      want_inv=False)
    pairs = pattern.schur_pairs()
    S = ba_schur.ba_schur_dense(pairs, sys["W_lm"], hinv, hcc_d,
                                w_rec=sys["W_rec"])
    S_zero = ba_schur.ba_schur_dense(pairs, sys["W_lm"], hinv, hcc_d,
                                     w_rec=torch.zeros_like(sys["W_rec"]))
    assert torch.equal(S, S_zero)
    assert torch.equal(S, ba_schur.ba_schur_dense_plain(
        pairs, sys["W_lm"], hinv, hcc_d))
    with pytest.raises(TypeError, match="w_rec"):
        ba_schur.ba_schur_dense(pairs, sys["W_lm"], hinv, hcc_d)
    with pytest.raises(ValueError, match="w_rec"):
        ba_schur.ba_schur_dense(pairs, sys["W_lm"], hinv, hcc_d,
                                w_rec=sys["W_rec"][:, :16])
    assert ba_schur.ba_schur_dense.launches == 0


LIST_LENGTHS = (1, 63, 64, 65, 128, 129, 80000)


@pytest.mark.parametrize("diag", [True, False])
def test_dense_pair_tables_on_the_chunk_edges(diag):
    """Destination d of slot offsets (a, b) gets LIST_LENGTHS[d]
    contributions in an interleaved edge order; its chunks tile its list
    in order, 1..DENSE_CHUNK each, and name d."""
    counts = np.array(LIST_LENGTHS)
    owner = np.repeat(np.arange(len(counts)), counts)
    owner = owner[np.random.default_rng(1).permutation(len(owner))]
    a = owner * 6
    b = a if diag else (owner + len(counts)) * 6
    total_dim = 12 * len(counts)
    p, q, ptr, edge, flag, chunk_ptr, chunk_dest, dest_chunk = \
        dense_assemble._pair_table(a, b, diag, total_dim)
    assert len(p) == len(counts) and (np.diff(ptr) == counts).all()
    assert (p == np.arange(len(counts)) * 6).all()
    assert (q == (p if diag else p + 6 * len(counts))).all()
    assert (flag == 0).all()
    assert chunk_ptr[0] == 0 and chunk_ptr[-1] == ptr[-1]
    assert len(chunk_dest) == len(chunk_ptr) - 1
    assert (np.diff(chunk_dest) >= 0).all()
    for d, n in enumerate(counts):
        mine = np.arange(dest_chunk[d], dest_chunk[d + 1])
        assert (chunk_dest[mine] == d).all()
        sizes = np.diff(chunk_ptr[dest_chunk[d]:dest_chunk[d + 1] + 1])
        assert len(sizes) == -(-n // dense_assemble.DENSE_CHUNK)
        assert (sizes >= 1).all() and (sizes <= dense_assemble.DENSE_CHUNK
                                       ).all()
        assert chunk_ptr[dest_chunk[d]] == ptr[d]
        # the destination's edges, in edge order
        got = edge[ptr[d]:ptr[d + 1]]
        assert (owner[got] == d).all() and (np.diff(got) > 0).all()
    assert (np.bincount(chunk_dest) == -(-counts
                                          // dense_assemble.DENSE_CHUNK)).all()


def test_dense_pattern_carries_chunk_dest_and_zero_counters():
    from openslam_g2o_torch.apps.simulator import Simulator2D
    g, _ = Simulator2D(n_landmarks=30, seed=2, world_size=12.0).simulate(60)
    prob = g.compile(device="cpu")
    pattern = dense_assemble.build_dense_pattern(prob)
    for tb in (tb for tables in pattern.pairs for tb in tables):
        dc = tb.dest_chunk.numpy()
        cd = tb.chunk_dest.numpy()
        assert tb.chunk_dest.dtype == torch.int32
        assert len(cd) == tb.n_chunks
        assert (cd == np.repeat(np.arange(tb.n_dest), np.diff(dc))).all()
        assert tb.arrivals.shape == (tb.n_dest,)
        assert tb.arrivals.dtype == torch.int32 and not tb.arrivals.any()
