"""K7 of the port (the plain versions of kernels/retract_chi2.py, which the
CPU path runs) against the JAX package's trial body
(openslam_g2o_tpu/core/algorithms.py:306-332), float64 on CPU.

* candidate, sum rho(e^T Omega e) and dx . (lambda dx + b) against
  apply_update_parts / robust_chi2 / _tree_dot on a ring with a robust edge
  group and fixed vertices, for every robust kernel id: candidate exact
  (the same float64 additions and floor wrap), sums to rtol 1e-12 (another
  summation order);
* the bookkeeping against the reference formulas evaluated with jnp, over
  accepted, rejected, failed (ok False), NaN and inf trials: every output
  equal to the last bit except where a product is rounded differently
  (rtol 1e-15), flags exactly;
* a NaN dx arrives as a non-finite chi2: rho -1, no accept, lambda * nu,
  2 nu, retry;
* argument checks of the two wrappers.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openslam_g2o_tpu.core import problem as jproblem
from openslam_g2o_tpu.core import robust as jrobust
from openslam_g2o_tpu.core.graph import Graph as JGraph
from openslam_g2o_tpu.core.solvers import _tree_dot as j_tree_dot

from openslam_g2o_torch.core import robust as trobust
from openslam_g2o_torch.interop import problem_arrays, problem_from_numpy
from openslam_g2o_torch.kernels import retract_chi2 as K7
from tests.test_torch_assembly import build_graph

torch.set_num_threads(1)


def _problems(kernel="Huber"):
    g = build_graph(JGraph)
    for e in g.edges:
        if e.kernel != "None":
            e.kernel, e.kernel_delta = kernel, 0.8
    jprob = g.compile(dtype=jnp.float64)
    return jprob, problem_from_numpy(**problem_arrays(jprob), device="cpu")


def _edge_groups(tprob):
    return [(ea.indices[0], ea.indices[1], ea.measurement, ea.information,
             ea.delta, eg.kernel_id)
            for eg in tprob.static.egroups
            for ea in (tprob.edges[eg.key],)]


def test_kernel_ids_match_jax():
    assert trobust.kernel_names() == jrobust.kernel_names()


@pytest.mark.parametrize("kernel", trobust.kernel_names()[1:])
def test_retract_chi2_matches_jax(kernel):
    jprob, tprob = _problems(kernel)
    assert len(tprob.static.egroups) == 2
    rng = np.random.default_rng(5)
    N = tprob.params["se2"].shape[0]
    dxT = rng.normal(0, 0.7, (3, N))
    dxT[2] *= 4.0                                    # angles past +-pi
    bT = rng.normal(0, 30.0, (3, N))
    lam = 0.37
    cand, part_dot, part_chi = K7.retract_chi2(
        tprob.params["se2"], torch.as_tensor(dxT), tprob.free["se2"],
        torch.as_tensor(bT), torch.tensor(lam, dtype=torch.float64),
        _edge_groups(tprob))
    jcand = jproblem.apply_update_parts(jprob, {"se2": jnp.asarray(dxT.T)})
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand["se2"]))
    assert (np.abs(cand[:, 2].numpy()) <= np.pi).all()
    fixed = tprob.free["se2"] == 0
    assert torch.equal(cand[fixed], tprob.params["se2"][fixed])
    assert part_chi.shape == (2,) and part_dot.shape == (1,)
    np.testing.assert_allclose(
        float(part_chi.sum()), float(jproblem.robust_chi2(jprob, jcand)),
        rtol=1e-12)
    jd = {"se2": jnp.asarray(dxT)}
    jdot = j_tree_dot(jd, {"se2": lam * jd["se2"] + jnp.asarray(bT)})
    np.testing.assert_allclose(float(part_dot.sum()), float(jdot), rtol=1e-12)


def _reference_outcome(chi_new, dot, ok, lam, ni, chi_cur):
    """The trial body of the JAX package (core/algorithms.py:316-325)."""
    chi_new, dot = jnp.asarray(chi_new), jnp.asarray(dot)
    solved = jnp.logical_and(ok, jnp.isfinite(chi_new))
    chi_new = jnp.where(solved, chi_new, jnp.inf)
    scale = dot + 1e-3
    rho = jnp.where(solved, (chi_cur - chi_new) / scale, -1.0)
    accept = jnp.logical_and(rho > 0, jnp.isfinite(chi_new))
    alpha = 1.0 - (2.0 * rho - 1.0) ** 3
    good_scale = jnp.maximum(1.0 / 3.0, jnp.minimum(alpha, 2.0 / 3.0))
    lam_new = jnp.where(accept, lam * good_scale, lam * ni)
    ni_new = jnp.where(accept, 2.0, ni * 2.0)
    retry = jnp.logical_and(jnp.logical_not(accept), rho < 0)
    return chi_new, rho, accept, lam_new, ni_new, retry


OUTCOME_CASES = {
    # name: (chi_new, dot, ok, lam, ni, chi_cur)
    "accept_good_model": (90.0, 10.5, True, 0.01, 2.0, 100.0),
    "accept_rho_above_one": (70.0, 20.0, True, 3.0, 8.0, 100.0),
    "accept_small_gain": (99.9, 40.0, True, 0.5, 2.0, 100.0),
    "reject_worse": (130.0, 12.0, True, 0.01, 2.0, 100.0),
    "reject_after_rejects": (100.5, 0.2, True, 64.0, 16.0, 100.0),
    "no_change": (100.0, 5.0, True, 0.3, 4.0, 100.0),
    "negative_model_decrease": (90.0, -4.0, True, 0.1, 2.0, 100.0),
    "solve_failed": (100.0, 0.0, False, 0.01, 2.0, 100.0),
    "solve_failed_but_lower": (50.0, 7.0, False, 0.2, 4.0, 100.0),
    "nan_chi2": (float("nan"), 3.0, True, 0.01, 2.0, 100.0),
    "inf_chi2": (float("inf"), 3.0, True, 0.01, 2.0, 100.0),
    "nan_dot": (90.0, float("nan"), True, 0.01, 2.0, 100.0),
}


@pytest.mark.parametrize("case", list(OUTCOME_CASES))
def test_lm_outcome_matches_reference(case):
    chi_new, dot, ok, lam, ni, chi_cur = OUTCOME_CASES[case]
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    # the partial sums arrive split, as the kernels hand them on
    got = K7.lm_outcome(t([chi_new * 0.25, chi_new * 0.75]),
                        t([dot * 0.5, dot * 0.5]), torch.tensor(ok), t(lam),
                        t(ni), t(chi_cur))
    want = _reference_outcome(chi_new, dot, ok, lam, ni, chi_cur)
    names = ("chi_new", "rho", "accept", "lam_new", "ni_new", "retry")
    for name, g, w in zip(names, got, want):
        assert g.dim() == 0, name
        if name in ("accept", "retry"):
            assert g.dtype == torch.bool and bool(g) == bool(w), name
        else:
            np.testing.assert_allclose(float(g), float(w), rtol=1e-15,
                                       err_msg=name)
    if case in ("solve_failed", "solve_failed_but_lower", "nan_chi2",
                "inf_chi2"):
        chi, rho, accept, lam_new, ni_new, retry = got
        assert float(chi) == float("inf") and float(rho) == -1.0
        assert not bool(accept) and bool(retry)
        assert float(lam_new) == lam * ni and float(ni_new) == 2 * ni
    if case == "nan_dot":
        # a NaN gain ratio neither accepts nor retries, as in the reference
        assert not bool(got[2]) and not bool(got[5])


@pytest.mark.parametrize("where", ["translation", "angle"])
def test_nan_step_gives_nonfinite_chi2_and_retry(where):
    _, tprob = _problems()
    N = tprob.params["se2"].shape[0]
    dxT = torch.zeros((3, N), dtype=torch.float64)
    dxT[0 if where == "translation" else 2, 7] = float("nan")
    lam = torch.tensor(0.5, dtype=torch.float64)
    ni = torch.tensor(4.0, dtype=torch.float64)
    cand, part_dot, part_chi = K7.retract_chi2(
        tprob.params["se2"], dxT, tprob.free["se2"], torch.zeros_like(dxT),
        lam, _edge_groups(tprob))
    assert not torch.isfinite(part_chi.sum())
    chi, rho, accept, lam_new, ni_new, retry = K7.lm_outcome(
        part_chi, part_dot, torch.tensor(True), lam, ni,
        torch.tensor(100.0, dtype=torch.float64))
    assert float(chi) == float("inf") and float(rho) == -1.0
    assert not bool(accept) and bool(retry)
    assert float(lam_new) == 2.0 and float(ni_new) == 8.0


def test_wrappers_check_arguments():
    _, tprob = _problems()
    N = tprob.params["se2"].shape[0]
    x, free = tprob.params["se2"], tprob.free["se2"]
    dxT = torch.zeros((3, N), dtype=torch.float64)
    lam = torch.tensor(0.5, dtype=torch.float64)
    groups = _edge_groups(tprob)
    K7.retract_chi2.launches = K7.lm_outcome.launches = 0
    K7.retract_chi2(x, dxT, free, dxT, lam, groups)
    assert K7.retract_chi2.launches == 0            # CPU: the plain version
    with pytest.raises(ValueError, match=r"\[3, N\]"):
        K7.retract_chi2(x, dxT.T.contiguous(), free, dxT, lam, groups)
    with pytest.raises(ValueError, match="0-dim"):
        K7.retract_chi2(x, dxT, free, dxT, lam.reshape(1), groups)
    with pytest.raises(ValueError, match="dtype"):
        K7.retract_chi2(x, dxT.float(), free, dxT, lam, groups)
    with pytest.raises(ValueError, match="robust kernel"):
        K7.retract_chi2(x, dxT, free, dxT, lam, [(*groups[0][:5], 99)])
    with pytest.raises(ValueError, match="int32"):
        K7.retract_chi2(x, dxT, free, dxT, lam,
                        [(groups[0][0].long(), *groups[0][1:])])
    one = torch.ones(1, dtype=torch.float64)
    with pytest.raises(ValueError, match="bool"):
        K7.lm_outcome(one, one, torch.tensor(1.0), lam, lam, lam)
    with pytest.raises(ValueError, match="non-empty"):
        K7.lm_outcome(one[:0], one, torch.tensor(True), lam, lam, lam)
    K7.lm_outcome(one, one, torch.tensor(True), lam, lam, lam)
    assert K7.lm_outcome.launches == 0
