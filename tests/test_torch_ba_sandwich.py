"""K13's preconditioner blocks (`ba_sandwich`, on its plain version) against
the JAX package's `_sandwich_lane` (openslam_g2o_tpu/core/ba_ell.py:513-534),
float64 on the CPU.

The W entries of each pose vertex come in CSR order, as the port's
`PoseRows` holds them; the JAX side gets the same entries through its own
degree-bucketed owner tables (`_bucketize`, `_gather_w_lane`: K-chunked
scans above 4 x 128 slots). The vertex degrees hold the chunk edges of the
port's CHUNK = 256 (0, 1, 255, 256, 257, and 700: three chunks) and an
empty vertex at the end. Both sum the same float64 products in another
order: rtol 1e-12 of the largest entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openslam_g2o_tpu.core import ba_ell as jba

from openslam_g2o_torch.kernels import ba_coupling

torch.set_num_threads(1)

RTOL = 1e-12
COUNTS = {"chunk-edges": [0, 1, 255, 256, 257, 3, 700, 40, 0],
          "one-vertex": [300]}


def _inputs(counts, dp, dl, seed):
    rng = np.random.default_rng(seed)
    L = 500
    M = sum(counts)
    lm = rng.integers(0, L, M)
    w = rng.standard_normal((dp * dl, M))
    B = rng.standard_normal((L, dl, dl))
    hinv = np.einsum("lab,lcb->acl", B, B)             # SPD, [dl, dl, L]
    hcc = rng.standard_normal((dp * dp, len(counts)))
    return lm, w, hinv, hcc


def _jax_corr(counts, lm, w, hinv, dp, dl):
    """JAX: the correction sum_j W_j Hinv W_j^T per vertex [Dp, Dp, N]
    through the owner tables the dual-ELL pattern builds."""
    N, K = len(counts), max(max(counts), 1)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    tbl = np.zeros((N, K), dtype=np.int64)
    mask = np.zeros((N, K), dtype=bool)
    nb = np.zeros((N, K), dtype=np.int64)
    for n, c in enumerate(counts):
        tbl[n, :c] = np.arange(ptr[n], ptr[n + 1])
        mask[n, :c] = True
        nb[n, :c] = lm[ptr[n]:ptr[n + 1]]
    buckets, perm = jba._bucketize(tbl, mask, nb, jnp.float64)
    w_list = jba._gather_w_lane(jnp.asarray(w), buckets)
    return np.asarray(jba._sandwich_lane(w_list, buckets, perm,
                                         jnp.asarray(hinv), dp, dl, N))


@pytest.mark.parametrize("layout", sorted(COUNTS))
@pytest.mark.parametrize("dims", [(6, 3), (4, 3), (3, 2)])
def test_sandwich_matches_jax(layout, dims):
    dp, dl = dims
    counts = COUNTS[layout]
    lm, w, hinv, hcc = _inputs(counts, dp, dl, seed=dp + len(counts))
    want = hcc - _jax_corr(counts, lm, w, hinv, dp, dl).reshape(dp * dp, -1)
    rows = ba_coupling.build_pose_rows(counts, lm, "cpu")
    assert rows.n_chunks == sum(max(-(-c // ba_coupling.CHUNK), 1)
                                for c in counts)
    args = (torch.from_numpy(w), rows,
            torch.from_numpy(hinv.reshape(dl * dl, -1).copy()),
            torch.from_numpy(hcc))
    before = ba_coupling.ba_sandwich.launches
    for got in (ba_coupling.ba_sandwich_plain(*args),
                ba_coupling.ba_sandwich(*args)):
        got = got.numpy()
        assert got.shape == want.shape
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= RTOL * scale
    # the CPU call ran the plain version: no launch, the counters untouched
    assert ba_coupling.ba_sandwich.launches == before
    assert not rows.arrivals.any()
    # an empty vertex keeps its Hcc block
    for n, c in enumerate(counts):
        if c == 0:
            np.testing.assert_array_equal(want[:, n], hcc[:, n])
