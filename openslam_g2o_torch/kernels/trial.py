"""K7 on the dense GN / LM routes, the dual-ELL Schur trial and the general
Schur trial (csrc/trial.cu): one trial's candidate and its robust chi2 for
every vertex and edge type that openslam_g2o_torch.models registers.

Replaces `apply_update_parts` / `apply_update`
(openslam_g2o_tpu/core/problem.py:557-585) and `robust_chi2` (:321) over
`edge_chi2` (:302) and `compute_errors` (:288), the hot loop of every
trial outside the LM-PCG path (whose SE2 / SE3 trial has its own kernels,
kernels/retract_chi2.py):

    trial_retract_groups         the retraction of every vertex
        group of a trial in one launch (up to MAX_RETRACT_GROUPS groups a
        launch): each group's cand = retract(x, dx * free) and, with b and
        lambda given, partial sums of dx . (lambda dx + b) over the
        group's values, at the group's offset in one partial vector
    trial_chi2_<edge type>       one edge group: partial sums of
        rho(e^T Omega e) at the candidate, the error by K17's functors
    chi2_sum                     the sum of chi2 partials in lm_outcome's
        order (the chi2 at a route's init, GN's chi2)

core/problem.py `trial_candidate` hands every group of a type in
RETRACT_IDS to `trial_retract_groups`, and `robust_chi2_parts` looks each
edge group's type up in CHI2 (wrapper names, resolved at call time, so a
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

import collections
import ctypes
from typing import NamedTuple, Optional

import torch

from openslam_g2o_torch.core import registry, robust
from openslam_g2o_torch.kernels import build, edge_lin
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)

BLOCK = 256          # kThreads of csrc/common.cuh

# vertex type name -> its id in trial_retract_groups (RetractType of
# csrc/trial.cu)
RETRACT_IDS = {"se2": 0, "point_xy": 1, "se3": 2, "point_xyz": 3,
               "se3_expmap": 4, "sba_point_xyz": 5, "cam": 6,
               "intrinsics": 7, "bal_camera": 8}
# vertex groups of one trial_retract_groups launch (kRetractMaxGroups)
MAX_RETRACT_GROUPS = 8
# edge type name -> its chi2 wrapper, one per K17 functor
CHI2 = {t: "trial_chi2_" + w[len("edge_lin_"):]
        for t, w in edge_lin.LINEARIZERS.items()}


def _card_blocks(n: int) -> int:
    """The blocks of a launch over n vertices or edges (trial_blocks of
    csrc/trial.cu)."""
    return max((n + BLOCK - 1) // BLOCK, 1)


def partial_count(n: int, device) -> int:
    """The partial sums one wrapper writes for n vertices or edges: a
    block's on the card, one on the CPU."""
    return _card_blocks(n) if device.type == "cuda" else 1


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
    """The plain version of one group's retraction: (vtype.retract(x,
    dx * free), the dot product dx . (lam dx + b) as one partial, or None
    without b)."""
    cand = vtype.retract(x, dx * free[:, None])
    if b is None:
        return cand, None
    dot = torch.dot(dx.reshape(-1), (lam * dx + b).reshape(-1))
    return cand, _into(out, dot)


# The checks below run on every trial, once per vertex group: their
# messages are built only when a check fails.

def _strided(what, name, t, shape, like):
    if t.shape != shape:
        raise ValueError(f"{what}: {name} must be {list(shape)}")
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{what}: {name} must be {like.dtype} on "
                         f"{like.device}")
    if min(t.stride()) < 0:
        raise ValueError(f"{what}: {name} needs non-negative strides")


def _check_retract(what, vt, x, dx, free, b, lam):
    """The checks of one group's retraction arguments."""
    N, P, D = x.shape[0], vt.ambient_dim, vt.tangent_dim
    if x.dim() != 2 or x.shape[1] != P or free.shape != (N,):
        raise ValueError(f"{what}: x must be [N, {P}] and free [N]")
    check_tensors(what, x.device, x.dtype, {"x": x, "free": free}, {})
    _strided(what, "dx", dx, (N, D), x)
    if b is not None:
        _strided(what, "b", b, (N, D), x)
        if lam is None or lam.dim() != 0:
            raise ValueError(f"{what}: lam must be a 0-dim tensor")
        check_tensors(what, x.device, x.dtype, {"lam": lam}, {})


# -- the retraction over every vertex group ----------------------------------

class RetractGroup(NamedTuple):
    """One vertex group of `trial_retract_groups`: its type's name (a key of
    RETRACT_IDS), x [N, P] contiguous, dx and b [N, D] of any strides (b
    None: no dot product), free [N], and `offset`, its first partial in the
    partial vector."""
    vname: str
    x: torch.Tensor
    dx: torch.Tensor
    free: torch.Tensor
    b: Optional[torch.Tensor] = None
    offset: int = 0


def retract_launches(counts):
    """The launches of `trial_retract_groups` on the card over groups of
    counts[i] vertices: (first, stop, block0, n_blocks) per range of
    MAX_RETRACT_GROUPS groups, block0 each group's first block in its
    launch (the prefix of its groups' partial_count), n_blocks the
    launch's grid."""
    out = []
    for first in range(0, len(counts), MAX_RETRACT_GROUPS):
        stop = min(first + MAX_RETRACT_GROUPS, len(counts))
        block0, blocks = [], 0
        for n in counts[first:stop]:
            block0.append(blocks)
            blocks += _card_blocks(n)
        out.append((first, stop, tuple(block0), blocks))
    return out


def trial_retract_groups_plain(groups, lam=None, out=None):
    """The plain version: `retract_plain` group by group, each group's dot
    product written into out[offset:offset + partial_count(N)]."""
    cands = []
    for g in groups:
        vt = registry.vertex_type(g.vname)
        if g.b is None:
            cands.append(retract_plain(vt, g.x, g.dx, g.free)[0])
            continue
        c = partial_count(g.x.shape[0], out.device)
        cands.append(retract_plain(vt, g.x, g.dx, g.free, g.b, lam,
                                   out[g.offset:g.offset + c])[0])
    return cands


def trial_retract_groups(groups, lam=None, out=None):
    """Every group's candidate retract(x, dx * free) (a list in the order of
    `groups`, RetractGroup each) and, with every group's b given, its
    partial sums of dx . (lam dx + b) written into `out` (a vector) at the
    group's offset: partial_count(N) of them, the same bits as the group
    launched alone (a block's sum depends on its group only). One launch
    per MAX_RETRACT_GROUPS groups on CUDA tensors, the plain version on
    CPU tensors. Without b, `lam` and `out` are None."""
    groups = list(groups)
    require(len(groups) > 0, "trial_retract_groups: no group")
    like = groups[0].x
    dot = groups[0].b is not None
    if dot:
        if out is None or out.dim() != 1:
            raise ValueError("trial_retract_groups: out must be a vector")
        check_tensors("trial_retract_groups", like.device, like.dtype,
                      {"out": out}, {})
    elif out is not None or lam is not None:
        raise ValueError("trial_retract_groups: lam and out go with b")
    for g in groups:
        if g.vname not in RETRACT_IDS:
            raise ValueError(f"trial_retract_groups: no kernel for vertex "
                             f"type {g.vname}")
        if (g.b is not None) != dot:
            raise ValueError("trial_retract_groups: b given for some groups "
                             "only")
        what = "trial_retract_groups (" + g.vname + ")"
        _check_retract(what, registry.vertex_type(g.vname), g.x, g.dx,
                       g.free, g.b, lam)
        if g.x.device != like.device or g.x.dtype != like.dtype:
            raise ValueError(f"{what}: every group on {like.device} in "
                             f"{like.dtype}")
        if dot and not (0 <= g.offset and g.offset + partial_count(
                g.x.shape[0], like.device) <= out.numel()):
            raise ValueError(f"trial_retract_groups: the partials of "
                             f"{g.vname} at {g.offset} do not fit out")
    if not launch_device("trial_retract_groups", like.device):
        return trial_retract_groups_plain(groups, lam, out)
    cands = [torch.empty_like(g.x) for g in groups]
    for first, stop, block0, n_blocks in retract_launches(
            [g.x.shape[0] for g in groups]):
        words = []
        for g, cand, b0 in zip(groups[first:stop], cands[first:stop],
                               block0):
            words += [RETRACT_IDS[g.vname], g.x.data_ptr(), g.dx.data_ptr(),
                      g.dx.stride(0), g.dx.stride(1),
                      g.b.data_ptr() if dot else 0,
                      g.b.stride(0) if dot else 0,
                      g.b.stride(1) if dot else 0, g.free.data_ptr(),
                      cand.data_ptr(), g.x.shape[0], b0, g.offset]
        desc = (ctypes.c_longlong * len(words))(*words)
        build.launch("g2o_trial_retract_groups", like, desc, stop - first,
                     n_blocks, lam.data_ptr() if dot else None,
                     out.data_ptr() if dot else None)
        trial_retract_groups.launches += 1
        trial_retract_groups.launches_by_type.update(
            g.vname for g in groups[first:stop])
    return cands


trial_retract_groups.launches = 0
trial_retract_groups.launches_by_type = collections.Counter()


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


for _t, _w in CHI2.items():
    globals()[_w], globals()[_w + "_plain"] = _chi2_wrappers(_t, _w)
# the wrappers (kernels.WRAPPERS lists them)
WRAPPERS = (tuple(globals()[_w] for _w in CHI2.values())
            + (chi2_sum, trial_retract_groups))
del _t, _w
