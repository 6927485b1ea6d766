"""Parity of the port's linearization and assembly (the plain versions of
kernels B and C) with the JAX package, on one problem carried across with
interop.problem_from_numpy: a 40-pose ring with closures, a Huber edge
group with outliers, a repeated and a reversed edge, two fixed vertices and
one vertex without edges.

Tolerance: rtol 1e-12 in float64 (relative to the largest entry for H):
the per-edge math is the same sequence of float64 operations; sums over
the contributions of one block run in another order than XLA's.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core import sparse as jsparse
from openslam_g2o_tpu.core.algorithms import _lambda_init_pcg as j_lambda_init
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.utils import np_lie

from openslam_g2o_torch.core import problem as tproblem
from openslam_g2o_torch.core import sparse as tsparse
from openslam_g2o_torch.core.algorithms import _lambda_init_pcg as t_lambda_init
from openslam_g2o_torch.core.graph import Graph as TGraph
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy

torch.set_num_threads(1)

RTOL = 1e-12


def build_graph(Graph, n=40, seed=3):
    """The same graph through either package's Graph API."""
    rng = np.random.default_rng(seed)
    g = Graph()
    step = np.array([1.0, 0.0, 2 * np.pi / n])
    gt = [np.zeros(3)]
    for _ in range(n - 1):
        gt.append(np_lie.se2_compose(gt[-1], step))
    for i, p in enumerate(gt):
        g.add_vertex(i, "se2", p + rng.normal(0, 0.1, 3), fixed=i in (0, 17))
    g.add_vertex(n, "se2", [5.0, 5.0, 0.5])       # no edges
    info = np.array([[200.0, 10.0, 0.0], [10.0, 150.0, 5.0], [0.0, 5.0, 900.0]])
    rel = lambda i, j: np_lie.se2_compose(np_lie.se2_inverse(gt[i]), gt[j])
    for i in range(n):
        j = (i + 1) % n
        g.add_edge("edge_se2", (i, j), rel(i, j) + rng.normal(0, 0.02, 3), info)
    for i in range(0, n, 5):
        j = (i + n // 3) % n
        z = rel(i, j) + rng.normal(0, 0.02, 3)
        if i % 10 == 0:
            z = z + np.array([1.5, -1.0, 0.7])     # outlier: Huber tail
        g.add_edge("edge_se2", (i, j), z, info, kernel="Huber",
                   kernel_delta=1.0)
    g.add_edge("edge_se2", (3, 4), rel(3, 4), info)        # repeated pair
    g.add_edge("edge_se2", (9, 2), rel(9, 2), 2 * info)    # reversed
    return g


def make_jax_graph():
    return build_graph(JGraph)


@pytest.fixture(scope="module")
def problems():
    jprob = make_jax_graph().compile(dtype=jnp.float64)
    tprob = problem_from_numpy(**problem_arrays(jprob), device="cpu")
    return jprob, tprob


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def ell_to_dense(nb, values):
    """Expand block-ELL (nb [K, N], values [K, 9, N]) to a dense [3N, 3N]."""
    nb, values = np.asarray(nb), np.asarray(values)
    K, N = nb.shape
    H = np.zeros((3 * N, 3 * N))
    rows = np.arange(N)
    for k in range(K):
        for a in range(3):
            for c in range(3):
                np.add.at(H, (3 * rows + a, 3 * nb[k] + c), values[k, 3 * a + c])
    return H


def test_port_graph_compiles_to_jax_arrays():
    jprob = make_jax_graph().compile(dtype=jnp.float64)
    tprob = build_graph(TGraph).compile(dtype=torch.float64, device="cpu")
    ja, ta = problem_arrays(jprob), problem_arrays(tprob)
    assert [g.name for g in tprob.static.vgroups] == ["se2"]
    assert list(ta["edges"]) == list(ja["edges"]) == ["edge_se2",
                                                      "edge_se2#Huber"]
    for k in ja["params"]:
        np.testing.assert_array_equal(ta["params"][k], ja["params"][k])
        np.testing.assert_array_equal(ta["free"][k], ja["free"][k])
    for k, e in ja["edges"].items():
        for f in ("measurement", "information", "delta", "kernel_id"):
            np.testing.assert_array_equal(ta["edges"][k][f], e[f])
        for a, b in zip(ta["edges"][k]["indices"], e["indices"]):
            np.testing.assert_array_equal(a, b)


def test_chi2_masks_and_write_back_match_jax(problems):
    jprob, tprob = problems
    _close(tproblem.chi2(tprob), jproblem.chi2(jprob))
    _close(tproblem.robust_chi2(tprob), jproblem.robust_chi2(jprob))
    for t, j in zip(tproblem.tangent_masks(tprob),
                    jproblem.tangent_masks(jprob)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    g = build_graph(TGraph)
    moved = {"se2": tprob.params["se2"] + 1.0}
    tproblem.write_back(tprob.with_params(moved), g)
    got = np.stack([g.vertices[v].params for v in sorted(g.vertices)])
    np.testing.assert_array_equal(got, moved["se2"].numpy())


def test_linearize_matches_jax(problems):
    jprob, tprob = problems
    jl, tl = jproblem.linearize(jprob), tproblem.linearize(tprob)
    assert set(jl) == set(tl)
    for key in jl:
        (jr, jjac, jw), (tr, tjac, tw) = jl[key], tl[key]
        _close(tr, jr, atol=1e-12)
        _close(tw, jw)
        for a, b in zip(tjac, jjac):
            _close(a, b, atol=1e-12)


def test_edge_blocks_match_jax(problems):
    """Kernel B's plain version: every edge's four J_s^T W J_t blocks and
    two gradients, read back from the stream columns."""
    jprob, tprob = problems
    blocks, bvecs = jsparse._edge_blocks(jprob, jproblem.linearize(jprob))
    pattern = tsparse.build_ell_pattern(tprob)
    hblk, bblk = tsparse.edge_blocks(tprob, pattern)
    E = pattern.e_cols                  # columns per block of the streams
    for eg in tprob.static.egroups:
        c0, n = pattern.col0[eg.key], eg.count
        for s in range(2):
            got_b = bblk[:, s * E + c0:s * E + c0 + n].T
            ref_b = np.asarray(bvecs[(eg.key, s)])
            _close(got_b, ref_b, atol=RTOL * np.abs(ref_b).max())
            for t in range(2):
                q = 2 * s + t
                got = hblk[:, q * E + c0:q * E + c0 + n].T.reshape(n, 3, 3)
                scale = float(np.abs(np.asarray(blocks[(eg.key, s, t)])).max())
                _close(got, blocks[(eg.key, s, t)], atol=RTOL * scale)


def test_assembled_ell_matches_dense_system(problems):
    """Kernel C's plain version: the assembled block-ELL H, expanded to
    dense, and b equal JAX build_dense_system (without the fixed-slot unit
    diagonal, which the port adds with the damping)."""
    jprob, tprob = problems
    H, b, _ = jproblem.build_dense_system(jprob, add_fixed_diag=False)
    pattern = tsparse.build_ell_pattern(tprob)
    values, bT = tsparse.assemble_ell(tprob, pattern)
    Ht = ell_to_dense(pattern.nb, values)
    scale = float(np.abs(np.asarray(H)).max())
    _close(Ht, H, atol=RTOL * scale)
    bt = bT["se2"].T.reshape(-1)
    _close(bt, b, atol=RTOL * float(np.abs(np.asarray(b)).max()))


def test_pattern_layout(problems):
    """Slot 0 is each row's own block, also for the vertex without edges;
    a repeated pair shares one slot; padding slots point at column 0 and
    assemble to zero."""
    _, tprob = problems
    pattern = tsparse.build_ell_pattern(tprob)
    nb = pattern.nb.numpy()
    N = tprob.static.vgroups[0].count
    np.testing.assert_array_equal(nb[0], np.arange(N))
    values, _ = tsparse.assemble_ell(tprob, pattern)
    hidx = pattern.hidx.numpy().reshape(-1, pattern.k, N)
    empty = (hidx < 0).all(axis=0)                       # [K, N] no contributor
    assert empty[1:].any() and not empty[0, :N - 1].any()
    pad = empty.copy()
    pad[0] = False                                       # slot 0: own block
    assert (nb[pad] == 0).all()
    assert (values.numpy().transpose(0, 2, 1)[empty] == 0).all()
    for n in range(N):                                   # distinct columns
        cols = nb[~empty[:, n], n]
        assert len(set(cols.tolist())) == len(cols)


def test_assembly_is_deterministic(problems):
    _, tprob = problems
    pattern = tsparse.build_ell_pattern(tprob)
    v1, b1 = tsparse.assemble_ell(tprob, pattern)
    v2, b2 = tsparse.assemble_ell(tprob, pattern)
    assert torch.equal(v1, v2) and torch.equal(b1["se2"], b2["se2"])


def test_lambda_init_matches_jax(problems):
    jprob, tprob = problems
    jl = j_lambda_init(jprob, jsparse.build_ell_pattern(jprob), jprob.params,
                       jnp.asarray(1e-5, jnp.float64))
    pattern = tsparse.build_ell_pattern(tprob)
    tl = t_lambda_init(tprob, pattern, tprob.params,
                       torch.tensor(1e-5, dtype=torch.float64))
    _close(tl, jl)


def test_damped_scaled_system(problems):
    """Damping lam*free + (1-free) on every diagonal block, then the
    symmetric block-Jacobi scaling: the result equals
    Linv (H + diag(extra)) Linv^T computed densely, with unit diagonal
    blocks."""
    from openslam_g2o_torch.kernels.damp_chol import damp_chol
    from openslam_g2o_torch.kernels.jacobi_scale import jacobi_scale
    _, tprob = problems
    pattern = tsparse.build_ell_pattern(tprob)
    values, bT = tsparse.assemble_ell(tprob, pattern)
    free = tprob.free["se2"]
    linv9, _, _, extra = damp_chol(values, free, bT["se2"],
                                   torch.tensor(0.3, dtype=torch.float64))
    assert torch.equal(extra, 0.3 * free + (1.0 - free))
    linv = linv9.view(3, 3, -1).permute(2, 0, 1)
    S = ell_to_dense(pattern.nb, jacobi_scale(pattern.nb, values, linv9,
                                              extra))
    N = pattern.n
    Hd = ell_to_dense(pattern.nb, values) + np.diag(
        np.repeat(extra.numpy(), 3))
    L = np.zeros((3 * N, 3 * N))
    for n in range(N):
        L[3 * n:3 * n + 3, 3 * n:3 * n + 3] = linv[n].numpy()
    ref = L @ Hd @ L.T
    _close(S, ref, atol=1e-12 * np.abs(ref).max())
    for n in range(N):
        _close(S[3 * n:3 * n + 3, 3 * n:3 * n + 3], np.eye(3), atol=1e-12)
