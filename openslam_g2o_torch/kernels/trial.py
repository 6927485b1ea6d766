"""K7 on the dense GN / LM routes, the dual-ELL Schur trial and the general
Schur trial (csrc/trial.cu): one trial's candidate and its robust chi2 for
every vertex and edge type that openslam_g2o_torch.models registers.

Replaces `apply_update_parts` / `apply_update`
(openslam_g2o_tpu/core/problem.py:557-585) and `robust_chi2` (:321) over
`edge_chi2` (:302) and `compute_errors` (:288), the hot loop of every
trial outside the LM-PCG path (whose SE2 / SE3 trial has its own kernels,
kernels/retract_chi2.py):

    trial_retract_<vertex type>  one vertex group: cand = retract(x,
        dx * free) and, with b and lambda given, partial sums of
        dx . (lambda dx + b) over the group's values
    trial_chi2_<edge type>       one edge group: partial sums of
        rho(e^T Omega e) at the candidate, the error by K17's functors
    chi2_sum                     the sum of chi2 partials in lm_outcome's
        order (the chi2 at a route's init, GN's chi2)

core/problem.py `trial_candidate` and `robust_chi2_parts` look each group's
type up in RETRACTIONS / CHI2 (wrapper names, resolved at call time, so a
caller that swaps a wrapper for its plain version swaps it there too) and
hand the partials to kernels/retract_chi2.py `lm_outcome`. A type a caller
registers at run time has no entry and keeps the plain version on either
device. On CPU tensors every wrapper runs its plain version; on CUDA
tensors it launches its kernel or raises.

The step and the gradient of a retraction are [N, D] tensors of any
strides (the kernel reads them by strides): the dense route passes views
of its flat [T] vectors, the Schur routes transposed views of their
lane-major [D, N] parts.
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.core import registry, robust
from openslam_g2o_torch.kernels import build, edge_lin
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)

BLOCK = 256          # kThreads of csrc/common.cuh

# vertex type name -> the name of its retraction wrapper in this module,
# whose kernel is the C entry "g2o_" + that name
RETRACTIONS = {
    "se2": "trial_retract_se2",                  # models/slam2d.py
    "point_xy": "trial_retract_point_xy",
    "se3": "trial_retract_se3",                  # models/slam3d.py
    "point_xyz": "trial_retract_point_xyz",
    "se3_expmap": "trial_retract_se3_expmap",    # models/sba.py
    "sba_point_xyz": "trial_retract_sba_point_xyz",
    "cam": "trial_retract_cam",
    "intrinsics": "trial_retract_intrinsics",
    "bal_camera": "trial_retract_bal_camera",    # models/bal.py
}
# edge type name -> its chi2 wrapper, one per K17 functor
CHI2 = {t: "trial_chi2_" + w[len("edge_lin_"):]
        for t, w in edge_lin.LINEARIZERS.items()}


def partial_count(n: int, device) -> int:
    """The partial sums one wrapper writes for n vertices or edges: a
    block's on the card, one on the CPU."""
    return max((n + BLOCK - 1) // BLOCK, 1) if device.type == "cuda" else 1


def retraction(vtype_name: str):
    """The retraction wrapper of vertex type `vtype_name`, or None."""
    name = RETRACTIONS.get(vtype_name)
    return None if name is None else globals()[name]


def chi2_of(etype_name: str):
    """The chi2 wrapper of edge type `etype_name`, or None (a type
    registered at run time)."""
    name = CHI2.get(etype_name)
    return None if name is None else globals()[name]


def _into(out, total):
    """The partials of a plain version: `total` alone, or written into
    `out` as its first entry with zeros after it."""
    if out is None:
        return total.reshape(1)
    out.zero_()
    out[:1] = total
    return out


# -- the retraction -----------------------------------------------------------

def retract_plain(vtype, x, dx, free, b=None, lam=None, out=None):
    """The plain version of every retraction wrapper: (vtype.retract(x,
    dx * free), the dot product dx . (lam dx + b) as one partial, or None
    without b)."""
    cand = vtype.retract(x, dx * free[:, None])
    if b is None:
        return cand, None
    dot = torch.dot(dx.reshape(-1), (lam * dx + b).reshape(-1))
    return cand, _into(out, dot)


def _strided(what, name, t, shape, like):
    require(t.shape == shape, f"{what}: {name} must be {list(shape)}")
    require(t.device == like.device and t.dtype == like.dtype,
            f"{what}: {name} must be {like.dtype} on {like.device}")
    require(all(s >= 0 for s in t.stride()),
            f"{what}: {name} needs non-negative strides")


def _retract(vname, x, dx, free, b, lam, out):
    """Check the arguments; the plain version on CPU tensors, one launch on
    CUDA tensors. Returns ((cand, part_dot or None), launched)."""
    vt = registry.vertex_type(vname)
    what = f"trial_retract ({vname})"
    N, P, D = x.shape[0], vt.ambient_dim, vt.tangent_dim
    require(x.shape == (N, P) and free.shape == (N,),
            f"{what}: x must be [N, {P}] and free [N]")
    check_tensors(what, x.device, x.dtype, {"x": x, "free": free}, {})
    _strided(what, "dx", dx, (N, D), x)
    dot = b is not None
    if dot:
        _strided(what, "b", b, (N, D), x)
        require(lam is not None and lam.dim() == 0,
                f"{what}: lam must be a 0-dim tensor")
        check_tensors(what, x.device, x.dtype, {"lam": lam}, {})
        if out is not None:
            require(out.shape == (partial_count(N, x.device),),
                    f"{what}: out must hold {partial_count(N, x.device)} "
                    "partials")
            check_tensors(what, x.device, x.dtype, {"out": out}, {})
    if not launch_device(what, x.device):
        return retract_plain(vt, x, dx, free, b, lam, out), False
    cand = torch.empty_like(x)
    part = None
    if dot:
        part = out if out is not None else torch.empty(
            partial_count(N, x.device), dtype=x.dtype, device=x.device)
    build.launch("g2o_" + RETRACTIONS[vname], x, x.data_ptr(), dx.data_ptr(),
                 dx.stride(0), dx.stride(1),
                 b.data_ptr() if dot else None, b.stride(0) if dot else 0,
                 b.stride(1) if dot else 0, free.data_ptr(),
                 lam.data_ptr() if dot else None, cand.data_ptr(),
                 part.data_ptr() if dot else None, N)
    return (cand, part), True


# -- the chi2 -----------------------------------------------------------------

def chi2_plain(etype, kernel_id, params, indices, meas, info, delta, pdata,
               out=None):
    """The plain version of every chi2 wrapper: sum_e rho(e^T Omega e) of
    the model's error at the gathered slot parameters, as one partial."""
    from openslam_g2o_torch.core import problem
    r = etype.error(tuple(p[i] for p, i in zip(params, indices)), meas,
                    pdata)
    rho0, _, _ = robust.robustify(kernel_id, problem._mahalanobis(r, info),
                                  delta)
    return _into(out, rho0.sum())


def _chi2(tname, params, indices, meas, info, delta, pdata, kernel_id, out):
    """Check the arguments; the plain version on CPU tensors, one launch on
    CUDA tensors. Returns (partials, launched)."""
    et = registry.edge_type(tname)
    vts = [registry.vertex_type(n) for n in et.vertex_types]
    pdims = [registry.parameter_type(n).dim for n in et.param_types]
    what = f"trial_chi2 ({tname})"
    S, D, M = len(vts), et.error_dim, et.measurement_dim
    E = meas.shape[0]
    require(len(params) == S and len(indices) == S,
            f"{what}: {S} slots expected")
    require(meas.shape == (E, M) and info.shape == (E, D, D)
            and delta.shape == (E,),
            f"{what}: meas must be [E, {M}], info [E, {D}, {D}], delta [E]")
    require(len(pdata) == len(pdims)
            and all(p.shape == (E, d) for p, d in zip(pdata, pdims)),
            f"{what}: pdata must be one [E, dim] per parameter slot, dims "
            f"{pdims}")
    require(0 <= kernel_id < len(robust.kernel_names()),
            f"{what}: unknown robust kernel id {kernel_id}")
    floats = {"meas": meas, "info": info, "delta": delta}
    ints = {}
    for s, vt in enumerate(vts):
        require(params[s].dim() == 2 and params[s].shape[1] == vt.ambient_dim
                and indices[s].shape == (E,),
                f"{what}: slot {s} needs params [N, {vt.ambient_dim}] and "
                "indices [E]")
        floats[f"params{s}"] = params[s]
        ints[f"indices{s}"] = indices[s]
    floats.update((f"pdata{k}", p) for k, p in enumerate(pdata))
    n_part = partial_count(E, meas.device)
    if out is not None:
        require(out.shape == (n_part,),
                f"{what}: out must hold {n_part} partials")
        floats["out"] = out
    check_tensors(what, meas.device, meas.dtype, floats, ints)
    if not launch_device(what, meas.device):
        return chi2_plain(et, kernel_id, params, indices, meas, info, delta,
                          pdata, out), False
    part = out if out is not None else torch.empty(
        n_part, dtype=meas.dtype, device=meas.device)
    pad = lambda seq, n: [t.data_ptr() for t in seq] + [None] * (n - len(seq))
    slots = [p for s in zip(pad(params, 3), pad(indices, 3)) for p in s]
    build.launch("g2o_" + CHI2[tname], meas, *slots, meas.data_ptr(),
                 info.data_ptr(), delta.data_ptr(), *pad(pdata, 2),
                 int(kernel_id), part.data_ptr(), E)
    return part, True


# -- chi2_sum -----------------------------------------------------------------

def chi2_sum_plain(partials):
    """Plain PyTorch version: the sum as a 0-dim tensor."""
    return partials.sum()


def chi2_sum(partials):
    """The sum of chi2 partials [n] as a 0-dim tensor, in the order of
    kernels/retract_chi2.py `lm_outcome` (one one-block kernel on CUDA
    tensors, the plain version on CPU tensors)."""
    require(partials.dim() == 1 and partials.numel() > 0,
            "chi2_sum: the partials must be a non-empty vector")
    check_tensors("chi2_sum", partials.device, partials.dtype,
                  {"partials": partials}, {})
    if not launch_device("chi2_sum", partials.device):
        return chi2_sum_plain(partials)
    out = torch.empty((), dtype=partials.dtype, device=partials.device)
    build.launch("g2o_chi2_sum", partials, partials.data_ptr(),
                 partials.numel(), out.data_ptr())
    chi2_sum.launches += 1
    return out


chi2_sum.launches = 0


# -- the wrappers -------------------------------------------------------------

def _retract_wrappers(vname: str, wname: str):
    vt = registry.vertex_type(vname)

    def wrapper(x, dx, free, b=None, lam=None, out=None):
        res, launched = _retract(vname, x, dx, free, b, lam, out)
        wrapper.launches += launched
        return res

    def plain(x, dx, free, b=None, lam=None, out=None):
        return retract_plain(vt, x, dx, free, b, lam, out)

    wrapper.__name__ = wrapper.__qualname__ = wname
    wrapper.__doc__ = (
        f"{vt.tag}: (cand = retract(x, dx * free) [N, {vt.ambient_dim}], "
        "partial sums of dx . (lam dx + b), or None without b) for x "
        f"[N, {vt.ambient_dim}], dx and b [N, {vt.tangent_dim}] of any "
        "strides, free [N], lam 0-dim; `out`, if given, takes the partials "
        "(partial_count(N) of them). K7 on CUDA tensors, the plain version "
        "on CPU tensors.")
    plain.__name__ = plain.__qualname__ = wname + "_plain"
    wrapper.launches = 0
    return wrapper, plain


def _chi2_wrappers(tname: str, wname: str):
    et = registry.edge_type(tname)

    def wrapper(params, indices, meas, info, delta, pdata, kernel_id,
                out=None):
        part, launched = _chi2(tname, params, indices, meas, info, delta,
                               pdata, kernel_id, out)
        wrapper.launches += launched
        return part

    def plain(params, indices, meas, info, delta, pdata, kernel_id,
              out=None):
        return chi2_plain(et, kernel_id, params, indices, meas, info, delta,
                          pdata, out)

    wrapper.__name__ = wrapper.__qualname__ = wname
    wrapper.__doc__ = (
        f"{et.tag} (slots {', '.join(et.vertex_types)}): partial sums of "
        "rho(e^T Omega e) at the slots' tables `params` (each [N_s, P_s]), "
        "gathered by `indices` ([E] int32 each), with meas, info, delta, "
        "pdata and the robust kernel id as edge_lin's wrappers take them; "
        "`out`, if given, takes the partials (partial_count(E) of them). "
        "K7 on CUDA tensors, the plain version on CPU tensors.")
    plain.__name__ = plain.__qualname__ = wname + "_plain"
    wrapper.launches = 0
    return wrapper, plain


for _v, _w in RETRACTIONS.items():
    globals()[_w], globals()[_w + "_plain"] = _retract_wrappers(_v, _w)
for _t, _w in CHI2.items():
    globals()[_w], globals()[_w + "_plain"] = _chi2_wrappers(_t, _w)
# the wrappers (kernels.WRAPPERS lists them)
WRAPPERS = (tuple(globals()[_w] for _w in RETRACTIONS.values())
            + tuple(globals()[_w] for _w in CHI2.values()) + (chi2_sum,))
del _v, _t, _w
