"""The redesigned CG step and assembly of LM-PCG over several vertex groups
(kernels/pair_ell.py) on their plain versions against the JAX package,
float64 on the CPU, on tests/test_torch_lm_pcg_groups.py's worlds.

* The flat-vector operator (`PairOperator` on K4''s used-slot layout, one
  K5' call over every row group): its product, `matvec_dot` and
  `matvec_dot_p` against JAX `ell_matvec_lane` on JAX's scaled system at
  rtol 1e-12 of the largest entry, the folded direction against
  beta p + r, and the partial sums against the dot.
* K2''s position tables: every contribution placed once, destination-major
  (a run a destination), each run in JAX's stream order (`_pair_stream`: the sources in `pair_of` order, then their
  edges), at the destination its edge's vertices name.
* K2''s two passes (`pair_stream`, `pair_assemble`) against JAX
  `_assemble_pair` / `_assemble_b` at 1e-12.
* `pcg_solve`'s two-launch form on a PairOperator (flat vectors, each
  group's part vertex-major, one `cg_update_xr` over every group) against
  JAX `pcg_solve`
  (openslam_g2o_tpu/core/solvers.py:213) on the same scaled system: the
  same ok, the same number of matvecs and x to rtol 1e-10 of the largest
  |x| (tests/test_torch_cg_fused.py's tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openslam_g2o_tpu.core import solvers as jsolvers
from openslam_g2o_tpu.core import sparse as jsparse
from openslam_g2o_tpu.core.problem import linearize as j_linearize

from openslam_g2o_torch.core import solvers as tsolvers
from openslam_g2o_torch.core import sparse as tsparse
from openslam_g2o_torch.kernels import cg_step, pair_ell
from openslam_g2o_torch.kernels.damp_chol import damp_chol
from tests.test_torch_lm_pcg_groups import (
    _close, _dense_jax, _dense_torch, systems, world)

torch.set_num_threads(2)

WORLDS = ("2d", "3d", "psi2uv", "points")
CG_RTOL = 1e-10


def _scaled_pair(name, lam=0.3):
    """(JAX problem, JAX pattern, JAX scaled tables, port pattern, port
    scaled tables (used-slot layout), port bhat)."""
    jprob, tprob = world(name)
    jpat, jvals, _, tpat, tvals, tbT = systems(name)
    jextra = {g.name: lam * jprob.free[g.name] + (1.0 - jprob.free[g.name])
              for g in jprob.static.vgroups}
    jdamped = jsparse.ell_add_diag(jprob, jpat, jvals, jextra)
    jdiag = jpat.diag_blocks(jprob, jvals)
    jlinv = {k: jsolvers.batched_chol_inv_lower(
        v + jextra[k][:, None, None] * jnp.eye(v.shape[-1])[None])
        for k, v in jdiag.items()}
    jS = jsparse.ell_scale_jacobi(jprob, jpat, jdamped, jlinv)
    lam_t = torch.tensor(lam, dtype=torch.float64)
    linv, extra, bhat = {}, {}, {}
    for g, v in tpat.diag_values(tvals).items():
        linv[g], _, bhat[g], extra[g] = damp_chol(v, tprob.free[g], tbT[g],
                                                  lam_t)
    return jprob, jpat, jS, tpat, tpat.scale(tvals, linv, extra), bhat


@pytest.mark.parametrize("name", WORLDS)
def test_flat_operator_matches_jax(name):
    jprob, jpat, jS, tpat, tS, _ = _scaled_pair(name)
    rng = np.random.default_rng(7)
    pT = {g: rng.normal(size=(tpat.widths[g], tpat.counts[g]))
          for g in tpat.groups}
    rT = {g: rng.normal(size=(tpat.widths[g], tpat.counts[g]))
          for g in tpat.groups}
    beta = 0.45
    op = tpat.operator(tS)
    assert op.layout.n == sum(v.size for v in pT.values())
    p = tpat.flatten({g: torch.as_tensor(v) for g, v in pT.items()})
    r = tpat.flatten({g: torch.as_tensor(v) for g, v in rT.items()})
    pnew_T = {g: beta * pT[g] + rT[g] for g in tpat.groups}
    jy = jsparse.ell_matvec_lane(jprob, jpat, jS,
                                 {g: jnp.asarray(v) for g, v in pT.items()})
    jy_new = jsparse.ell_matvec_lane(
        jprob, jpat, jS, {g: jnp.asarray(v) for g, v in pnew_T.items()})
    # the product, on a flat vector and on lane-major parts
    for g, y in tpat.split(op(p)).items():
        _close(y, jy[g])
    for g, y in tsparse.ell_matvec_lane(
            tpat, tS, {g: torch.as_tensor(v) for g, v in pT.items()}).items():
        _close(y, jy[g])
    # with the dot
    y, part = op.matvec_dot(p)
    assert part.shape == (op.layout.blocks,)
    for g, yg in tpat.split(y).items():
        _close(yg, jy[g])
    np.testing.assert_allclose(float(part.sum()), float(torch.dot(p, y)),
                               rtol=1e-12)
    # with the next direction folded in
    scal = torch.zeros(cg_step.N_SCALARS, dtype=torch.float64)
    scal[cg_step.BETA] = beta
    p_new = torch.full_like(p, float("nan"))
    y, part = op.matvec_dot_p(scal, p, r, p_new)
    assert torch.equal(p_new, beta * p + r)
    for g, yg in tpat.split(p_new).items():
        _close(yg, pnew_T[g])
    for g, yg in tpat.split(y).items():
        _close(yg, jy_new[g])
    np.testing.assert_allclose(float(part.sum()),
                               float(torch.dot(p_new, y)), rtol=1e-12)
    # the scaled tables rebuilt as dense blocks: JAX's
    for key, jm in _dense_jax(jprob, jpat, jS).items():
        _close(_dense_torch(tpat, [pair_ell.padded(v, pt.rowptr, pt.k)
                                   for pt, v in zip(tpat.pairs, tS)])[key],
               jm)


@pytest.mark.parametrize("name", WORLDS)
def test_position_tables_are_destination_major_in_jax_stream_order(name):
    jprob, tprob = world(name)
    jpat = jsparse.build_ell_pattern(jprob)
    tpat = tsparse.build_ell_pattern(tprob)
    keys = [eg.key for eg in tprob.static.egroups]
    for pid, pt in enumerate(tpat.pairs[:len(jpat.pairs)]):
        tb = pt.table
        # the sources in JAX's pair_of order
        jsrc = [key for key, p in jpat.pair_of if p == pid]
        assert [(keys[gi], s, t) for gi, s, t in pt.sources] == jsrc
        # every contribution placed once
        pos = np.concatenate([q.numpy() for q in tb.pos])
        assert np.array_equal(np.sort(pos), np.arange(tb.n_contrib))
        # place m holds JAX stream column `col[m]`, at destination dest[m]
        col = np.empty(tb.n_contrib, np.int64)
        col[pos] = np.arange(tb.n_contrib)
        run = np.empty(tb.n_contrib, np.int64)
        run[pos] = np.concatenate([d.numpy() for d in tb.dest])
        assert np.all(np.diff(run) >= 0)               # destination-major
        ptr = tb.ptr.numpy()
        assert ptr[0] == 0 and ptr[-1] == tb.n_contrib
        for rn in np.unique(run):
            seg = slice(ptr[rn], ptr[rn + 1])
            assert np.all(run[seg] == rn)
            assert np.all(np.diff(col[seg]) > 0)       # JAX's stream order
        # each edge's destination: row = its slot-s vertex, the slot's
        # column = its slot-t vertex
        nb = pt.nb.numpy()
        for (gi, s, t), d in zip(pt.sources, tb.dest):
            ea = tprob.edges[keys[gi]]
            d = d.numpy()
            rows, slots = d % pt.n, d // pt.n
            assert np.array_equal(rows, ea.indices[s].numpy())
            assert np.array_equal(nb[slots, rows], ea.indices[t].numpy())
            assert np.all(slots < pt.cnt.numpy()[rows])
    for g, bt in tpat.b_tables.items():
        pos = np.concatenate([q.numpy() for q in bt.pos]) if bt.pos else \
            np.zeros(0, np.int64)
        assert np.array_equal(np.sort(pos), np.arange(bt.n_contrib))


@pytest.mark.parametrize("name", WORLDS)
def test_two_pass_assembly_matches_jax(name):
    jprob, tprob = world(name)
    jpat = jsparse.build_ell_pattern(jprob)
    tpat = tsparse.build_ell_pattern(tprob)
    lin = tsparse.pair_linearize(tprob)
    plan = tpat.plan
    stream = pair_ell.pair_stream(plan, lin)
    assert stream.shape == (plan.stream_len,)
    outs = pair_ell.pair_assemble(plan, stream)
    n = len(tpat.pairs)
    tvals, tbT = outs[:n], dict(zip(tpat.groups, outs[n:]))

    def jax_side(prob):
        blocks, bvecs = jsparse._edge_blocks(prob, j_linearize(prob))
        return ([jsparse._assemble_pair(prob, jpat, blocks, pid)
                 for pid in range(len(jpat.pairs))],
                jsparse._assemble_b(prob, jpat, bvecs))

    jvals, jb = jax.jit(jax_side)(jprob)
    jdense = _dense_jax(jprob, jpat, jvals)
    tdense = _dense_torch(tpat, tvals)
    for key, jm in jdense.items():
        _close(tdense[key], jm)
    for key in set(tdense) - set(jdense):
        assert not tdense[key].any()
    for g in tpat.groups:
        _close(tbT[g].T, jb[g])
    # the padding slots are zeros
    for pt, v in zip(tpat.pairs, tvals):
        pad = torch.arange(pt.k)[:, None] >= pt.cnt[None]
        assert not v.permute(0, 2, 1)[pad].any()


@pytest.mark.parametrize("name", ["2d", "3d"])
@pytest.mark.parametrize("x0", [False, True])
def test_two_launch_pcg_on_pair_operator_matches_jax(name, x0):
    jprob, jpat, jS, tpat, tS, bhat = _scaled_pair(name)
    rng = np.random.default_rng(11)
    x0T = ({g: rng.normal(size=(tpat.widths[g], tpat.counts[g])) * 1e-3
            for g in tpat.groups} if x0 else None)
    counts = [0]

    def bump():
        counts[0] += 1

    def jmv(xT):
        jax.debug.callback(bump)
        return jsparse.ell_matvec_lane(jprob, jpat, jS, xT)

    kw = dict(max_iter=80, tol=1e-9, unroll=2, norm="precond")
    jx, jok = jsolvers.pcg_solve(
        jmv, {g: jnp.asarray(v.numpy()) for g, v in bhat.items()},
        x0=None if x0T is None else {g: jnp.asarray(v)
                                     for g, v in x0T.items()}, **kw)
    jax.block_until_ready(jx)
    jax.effects_barrier()
    calls = {"matvec": 0, "matvec_dot": 0, "matvec_dot_p": 0}
    tx, tok = tsolvers.pcg_solve(
        _Calls(tpat.operator(tS), calls), bhat,
        x0=None if x0T is None else {g: torch.as_tensor(v)
                                     for g, v in x0T.items()}, **kw)
    assert bool(tok) == bool(jok)
    iters = calls["matvec_dot"] + calls["matvec_dot_p"]
    assert calls["matvec"] + iters == counts[0]
    assert calls["matvec_dot"] == 1 and iters > 10
    # x taken apart from the flat vector into lane-major parts
    assert all(tx[g].shape == bhat[g].shape and tx[g].is_contiguous()
               for g in tpat.groups)
    scale = max(float(np.abs(np.asarray(jx[g])).max()) for g in tpat.groups)
    for g in tpat.groups:
        np.testing.assert_allclose(tx[g].numpy(), np.asarray(jx[g]),
                                   rtol=CG_RTOL, atol=CG_RTOL * scale)


class _Calls:
    """The operator as pcg_solve sees it, each form counted."""

    def __init__(self, op, calls):
        self.op, self.calls = op, calls
        self.flatten, self.split = op.flatten, op.split

    def __call__(self, x):
        self.calls["matvec"] += 1
        return self.op(x)

    def matvec_dot(self, p):
        self.calls["matvec_dot"] += 1
        return self.op.matvec_dot(p)

    def matvec_dot_p(self, *a):
        self.calls["matvec_dot_p"] += 1
        return self.op.matvec_dot_p(*a)


@pytest.mark.parametrize("name", WORLDS)
def test_chebyshev_pcg_on_flat_vectors_matches_jax(name, monkeypatch):
    """The preconditioned solve (`pcg_cheby` = 4) on a PairOperator runs on
    the one flat vector, the Chebyshev kernels too, and gives JAX's x."""
    from openslam_g2o_torch.kernels import chebyshev
    jprob, jpat, jS, tpat, tS, bhat = _scaled_pair(name)
    op = tpat.operator(tS)
    hi = float(tpat.row_bound(tS))
    shapes = []
    init = chebyshev.chebyshev_init

    def spy(coef, r):
        shapes.append(tuple(r.shape))
        return init(coef, r)

    monkeypatch.setattr(tsolvers.cheb, "chebyshev_init", spy)
    kw = dict(max_iter=20, tol=1e-9, unroll=1, norm="precond")
    jmv = lambda xT: jsparse.ell_matvec_lane(jprob, jpat, jS, xT)
    jx, jok = jsolvers.pcg_solve(
        jmv, {g: jnp.asarray(v.numpy()) for g, v in bhat.items()},
        precond=jsolvers.make_chebyshev_precond(jmv, hi * 0.02, hi, 4), **kw)
    tx, tok = tsolvers.pcg_solve(
        op, bhat, precond=tsolvers.make_chebyshev_precond(
            op, hi * 0.02, hi, 4), **kw)
    assert bool(tok) == bool(jok)
    n = sum(tpat.widths[g] * tpat.counts[g] for g in tpat.groups)
    assert shapes and set(shapes) == {(n,)}
    scale = max(float(np.abs(np.asarray(jx[g])).max()) for g in tpat.groups)
    for g in tpat.groups:
        assert tx[g].shape == bhat[g].shape
        np.testing.assert_allclose(tx[g].numpy(), np.asarray(jx[g]),
                                   rtol=CG_RTOL, atol=CG_RTOL * scale)


@pytest.mark.parametrize("name", WORLDS)
def test_flat_layout_launches_over_row_group_ranges(name, monkeypatch):
    """Row groups past pair_ell.MAX_GROUPS (or tables past MAX_TABLES) go
    to further launches of K5' and K8': consecutive ranges, each group
    once, each launch's blocks after the last's."""
    *_, tpat, tS, _ = _scaled_pair(name)
    one = tpat.flat_layout(tS)
    assert len(one.launches) == 1
    assert one.launches[0].n_groups == len(tpat.groups)
    monkeypatch.setattr(pair_ell, "MAX_GROUPS", 1)
    lay = tpat.flat_layout(tS)
    assert [c.n_groups for c in lay.launches] == [1] * len(tpat.groups)
    assert [c.block0 for c in lay.launches] == list(np.cumsum(
        [0] + [c.blocks for c in lay.launches[:-1]]))
    assert sum(c.blocks for c in lay.launches) == one.launches[0].blocks
    monkeypatch.setattr(pair_ell, "MAX_GROUPS", 4)
    monkeypatch.setattr(pair_ell, "MAX_TABLES", max(
        len(g.tables) for g in one.groups))
    lay = tpat.flat_layout(tS)
    # a group's table count is word 6 of its 7 in the descriptor
    assert all(sum(c.desc[7 * i + 6] for i in range(c.n_groups))
               <= pair_ell.MAX_TABLES for c in lay.launches)
    assert sum(c.n_groups for c in lay.launches) == len(tpat.groups)
    x = torch.as_tensor(np.random.default_rng(3).normal(size=one.n))
    assert torch.equal(pair_ell.pair_spmv(lay, x), pair_ell.pair_spmv(one, x))
