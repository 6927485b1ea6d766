"""K10's landmark sums and K13's W v on their plain versions against the
JAX package's owner sums, float64 on the CPU, on the inputs that trap a
tiled or chunked kernel; and the chunk tables of `build_pose_rows` against
a construction in numpy.

* `ba_lm_sums` (both (Dp, dl), with and without W) against JAX
  `_reduce_k_lane` (Hll, b_l) and `_gather_w_lane` (W landmark-major) on
  one bucket holding the same slot table (the traps of the on-card test,
  `tests/test_torch_kernels.py` `_lm_slot_table`): observations numbered
  in a shuffled order, padding slots and a landmark without a valid slot,
  K = 1 and K = 12. Hll and b_l sum at most 12 float64 values per entry in
  another order: rtol 1e-12 of the largest entry. W is a copy: exact.
* `ba_wv` against the JAX implicit S x terms (`_bmv_lane` for Hcc_d x,
  `_apply_w_lane` for W v, the camera-major ELL in one or two buckets
  placed by `_place`) and the reduced right-hand side (b_p - W v) free,
  with the partial dots x . y, at vertex degrees 0, 1, 255, 256, 257
  (CHUNK - 1, CHUNK, CHUNK + 1) and 80,000 (the shared intrinsics vertex
  of chip_smoke.py's scene). A row sums up to 80,000 x dl float64
  products in another order: rtol 1e-12 of the largest entry.
* `build_pose_rows`: at least one chunk per vertex (an empty one where the
  vertex has no entry, so that `ba_wv` finishes that row), chunks of at
  most CHUNK entries tiling each CSR list in order, `chunk_row` the vertex
  of each chunk, `arrivals` one zeroed int32 counter per vertex.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.core import ba_ell as jba

from openslam_g2o_torch.kernels import ba_coupling, ba_edge
from tests.test_torch_kernels import _lm_slot_table

torch.set_num_threads(1)

RTOL = 1e-12


def _close(t, j, rtol=RTOL):
    t, j = t.numpy(), np.asarray(j)
    assert t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-300)
    assert float(np.abs(t - j).max()) <= rtol * scale, \
        float(np.abs(t - j).max()) / scale


@pytest.mark.parametrize("trap", ["shuffled", "padding", "k1", "k12"])
@pytest.mark.parametrize("with_w", [True, False])
@pytest.mark.parametrize("dims", ba_edge.BLOCK_DIMS)
def test_landmark_sums_match_jax_owner_sums(dims, with_w, trap):
    dp, dl = dims
    rng = np.random.default_rng(len(trap) + 10 * dp)
    L = 53
    table, E = _lm_slot_table(trap, L, rng, "cpu")
    table = table.numpy()
    rows = {"hll": dl * dl, "bl": dl, "w": dp * dl, "hcc": dp * dp, "bp": dp}
    data = {k: rng.normal(size=(r, E)) for k, r in rows.items()}
    # the camera records in a shuffled order (W is read through cam_pos)
    cam_pos = torch.as_tensor(rng.permutation(E).astype(np.int32))
    streams = ba_edge.EdgeStreams.from_lane_major(
        *(torch.as_tensor(data[k]) for k in ("hll", "bl", "w", "hcc", "bp")),
        cam_pos)
    if not with_w:
        streams = ba_edge.LandmarkStreams(streams.hll, streams.bl)
    hll, bl, w_lm = ba_edge.ba_lm_sums(streams, torch.as_tensor(table),
                                       with_w=with_w)
    valid = table >= 0
    bucket = [(np.arange(L), jnp.asarray(np.maximum(table, 0)),
               jnp.asarray(valid.astype(np.float64)), None)]
    _close(hll, jba._reduce_k_lane(jnp.asarray(data["hll"]), bucket, None, L))
    _close(bl, jba._reduce_k_lane(jnp.asarray(data["bl"]), bucket, None, L))
    if with_w:
        (want,) = jba._gather_w_lane(jnp.asarray(data["w"]), bucket)
        assert np.array_equal(w_lm.numpy(), np.asarray(want))
        assert not w_lm[:, ~torch.as_tensor(valid)].any()
    else:
        assert w_lm is None
    if trap in ("padding", "k12"):
        assert not hll[:, 5].any() and not bl[:, 5].any()


def _ell_buckets(counts, lm, w_cam):
    """The camera-major ELL of the JAX route from the CSR rows: one bucket
    of the vertices of degree < 1000 and one of the others, each [Dp*dl,
    K_b, C_b] with zeros on padding, and the inverse permutation that
    `_place` takes (the bucketed layout of `_bucketize`)."""
    ptr = np.concatenate([[0], np.cumsum(counts)])
    members = [np.flatnonzero(np.asarray(counts) < 1000),
               np.flatnonzero(np.asarray(counts) >= 1000)]
    members = [m for m in members if len(m)]
    W_list, buckets = [], []
    for m in members:
        K = max(int(max(counts[n] for n in m)), 1)
        W = np.zeros((w_cam.shape[0], K, len(m)))
        nb = np.zeros((K, len(m)), np.int64)
        mask = np.zeros((K, len(m)))
        for i, n in enumerate(m):
            c = counts[n]
            W[:, :c, i] = w_cam[:, ptr[n]:ptr[n + 1]]
            nb[:c, i] = lm[ptr[n]:ptr[n + 1]]
            mask[:c, i] = 1.0
        W_list.append(jnp.asarray(W))
        buckets.append((m, jnp.asarray(nb), jnp.asarray(mask),
                        jnp.asarray(nb)))
    order = np.concatenate(members)
    perm = np.empty(len(counts), np.int64)
    perm[order] = np.arange(len(order))
    return W_list, buckets, jnp.asarray(perm) if len(members) > 1 else None


DEGREES = {"chunk_edges": [0, 1, 255, 256, 257, 40, 0, 3],
           "hub": [3, 80000, 0, 700]}


@pytest.mark.parametrize("mode", ["s_matvec", "reduced_rhs"])
@pytest.mark.parametrize("degrees", sorted(DEGREES))
@pytest.mark.parametrize("dims", ba_coupling.DIMS)
def test_w_v_matches_jax_implicit_terms(dims, degrees, mode):
    dp, dl = dims
    counts = DEGREES[degrees]
    rng = np.random.default_rng(dp + len(degrees))
    N, M, L = len(counts), sum(counts), 3000
    lm = rng.integers(0, L, M)
    rows = ba_coupling.build_pose_rows(counts, lm, torch.device("cpu"))
    w = rng.normal(size=(dp * dl, M))
    v, x = rng.normal(size=(dl, L)), rng.normal(size=(dp, N))
    T = torch.as_tensor
    W_list, buckets, perm = _ell_buckets(counts, lm, w)
    wv = np.asarray(jba._apply_w_lane(W_list, buckets, perm, jnp.asarray(v),
                                      dp, dl, to_lm=False, n_out=N))
    if mode == "s_matvec":
        hcc = rng.normal(size=(dp * dp, N))
        extra = rng.normal(size=(dp, N))
        y, dots = ba_coupling.ba_wv(T(w), rows, T(v), hcc_d=T(hcc), x=T(x),
                                    extra=T(extra), want_dot=True)
        want = np.asarray(jba._bmv_lane(jnp.asarray(hcc.reshape(dp, dp, N)),
                                        jnp.asarray(x))) + extra - wv
        _close(y, want)
        _close(dots, (x * want).sum(axis=0))
    else:
        base = rng.normal(size=(dp, N))
        free = (rng.random(N) > 0.3).astype(np.float64)
        y = ba_coupling.ba_wv(T(w), rows, T(v), base=T(base), free=T(free))
        _close(y, (base - wv) * free[None])


@pytest.mark.parametrize("counts", [[0, 1, 255, 256, 257], [80000], [0],
                                    [], [0, 0, 3, 0], "random"])
def test_pose_rows_chunk_tables_match_numpy(counts):
    rng = np.random.default_rng(3)
    if counts == "random":
        counts = rng.integers(0, 1200, 50).tolist()
    M = int(np.sum(counts))
    rows = ba_coupling.build_pose_rows(counts, rng.integers(0, 9, M),
                                       torch.device("cpu"))
    chunk_ptr, row_chunk, chunk_row = [], [0], []
    start = 0
    for n, c in enumerate(counts):
        pieces = max(-(-c // ba_coupling.CHUNK), 1)
        for i in range(pieces):
            chunk_ptr.append(start + i * ba_coupling.CHUNK)
            chunk_row.append(n)
        row_chunk.append(row_chunk[-1] + pieces)
        start += c
    chunk_ptr.append(start)
    assert rows.chunk_ptr.tolist() == chunk_ptr
    assert rows.row_chunk.tolist() == row_chunk
    assert rows.chunk_row.tolist() == chunk_row
    assert rows.n_chunks == len(chunk_row) >= rows.n_rows == len(counts)
    assert rows.arrivals.dtype == torch.int32
    assert rows.arrivals.tolist() == [0] * len(counts)
    for t in (rows.ptr, rows.lm, rows.chunk_ptr, rows.row_chunk,
              rows.chunk_row):
        assert t.dtype == torch.int32 and t.is_contiguous()
