"""K17: the edge linearizers (csrc/edge_lin.cu) of every edge type that
openslam_g2o_torch.models registers.

Replaces the JAX hot loop `linearize` (openslam_g2o_tpu/core/problem.py:
350-392) over the error functions of models/slam2d.py, slam3d.py, sba.py
and bal.py: its forward branch (vmap(jacfwd) at :378) for twenty-one
types, and its analytic branch (:367-370) for EDGE_SE2,
EDGE_PROJECT_XYZ2UV:EXPMAP and EDGE_PROJECT_XYZ2UVU:EXPMAP, whose closed
forms the kernel computes. For
one edge group each wrapper returns what core/problem.py `linearize_group`
returns: the residual [E, D], the per-slot Jacobians [E, D, Ds] with
respect to the tangent increment, each slot's columns times its vertex's
free flag, and rho' [E]. The forward-mode kernel differentiates the error
through the retractions with a value-and-derivatives scalar (a block per
tile of 32 edges, passes of 6 directions); the closed forms run a block
per tile of 128 edges over the tile loader of csrc/edge_tile.cuh,
EDGE_SE2 a thread per edge that reads and writes global memory itself.
The plain version is the generic route
of `linearize_group` (the error, the type's analytic Jacobian or
`forward_jacobians`' torch.func.jvp, `robustify`, the mask).

An edge type that a caller registers at run time, with an error function
in Python, has no entry here and keeps the generic route on either device:
no hand-written kernel can exist for it, and the JAX package linearizes it
by jacfwd as it does every type.

Every wrapper takes the group's slots as tuples: `params` (each slot's
vertex table [N_s, P_s]), `free` ([N_s]) and `indices` ([E] int32), then
meas [E, M], info [E, D, D], delta [E], pdata (a tuple of [E, dim] per
parameter slot, at most two) and the robust kernel id.
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.core import registry, robust
from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)

# edge type name -> the name of its wrapper in this module, whose kernel is
# the C entry "g2o_" + that name; the widths the kernel's functor assumes
# are the registry's for the type. `linearizer` looks the wrapper up when
# it is called, so that a caller that swaps a wrapper for its plain
# version (chip_smoke.py's plain route) swaps it for core/problem.py
# `linearize_group` too.
LINEARIZERS = {
    # models/slam2d.py
    "edge_se2": "edge_lin_se2",
    "edge_se2_xy": "edge_lin_se2_xy",
    "edge_se2_xy_bearing": "edge_lin_se2_bearing",
    "edge_se2_prior": "edge_lin_se2_prior",
    "edge_se2_prior_xy": "edge_lin_se2_prior_xy",
    "edge_se2_xy_calib": "edge_lin_se2_xy_calib",
    "edge_se2_offset": "edge_lin_se2_offset",
    "edge_se2_xy_offset": "edge_lin_se2_xy_offset",
    # models/slam3d.py
    "edge_se3": "edge_lin_se3",
    "edge_se3_xyz": "edge_lin_se3_xyz",
    "edge_se3_depth": "edge_lin_se3_depth",
    "edge_se3_disparity": "edge_lin_se3_disparity",
    "edge_se3_prior": "edge_lin_se3_prior",
    "edge_se3_offset": "edge_lin_se3_offset",
    # models/sba.py
    "edge_se3_expmap": "edge_lin_se3_expmap",
    "edge_project_xyz2uv": "edge_lin_xyz2uv",
    "edge_project_xyz2uvu": "edge_lin_xyz2uvu",
    "edge_project_psi2uv": "edge_lin_psi2uv",
    "edge_project_p2mc": "edge_lin_p2mc",
    "edge_project_p2mc_intrinsics": "edge_lin_p2mc_intrinsics",
    "edge_project_p2sc": "edge_lin_p2sc",
    "edge_sba_cam": "edge_lin_sba_cam",
    "edge_sba_scale": "edge_lin_sba_scale",
    # models/bal.py
    "edge_project_bal": "edge_lin_bal",
}


def linearizer(type_name: str):
    """The wrapper that linearizes edge type `type_name`, or None (a type
    registered at run time)."""
    name = LINEARIZERS.get(type_name)
    return None if name is None else globals()[name]


def linearize_plain(type_name, params, free, indices, meas, info, delta,
                    pdata, kernel_id):
    """The plain version of every wrapper: core/problem.py
    `linearize_edges`, the generic route of `linearize_group`."""
    from openslam_g2o_torch.core import problem
    return problem.linearize_edges(registry.edge_type(type_name), kernel_id,
                                   params, free, indices, meas, info, delta,
                                   pdata)


def _linearize(type_name, params, free, indices, meas, info, delta, pdata,
               kernel_id):
    """Check the arguments; on CPU tensors the plain version, on CUDA
    tensors one launch of the type's kernel. Returns ((resid, jacs, rho1),
    launched)."""
    et = registry.edge_type(type_name)
    vts = [registry.vertex_type(n) for n in et.vertex_types]
    pdims = [registry.parameter_type(n).dim for n in et.param_types]
    what = f"edge_lin ({type_name})"
    S, D, M = len(vts), et.error_dim, et.measurement_dim
    E = meas.shape[0]
    require(len(params) == S and len(free) == S and len(indices) == S,
            f"{what}: {S} slots expected")
    require(meas.shape == (E, M) and info.shape == (E, D, D)
            and delta.shape == (E,),
            f"{what}: meas must be [E, {M}], info [E, {D}, {D}], delta [E]")
    require(len(pdata) == len(pdims)
            and all(p.shape == (E, d) for p, d in zip(pdata, pdims)),
            f"{what}: pdata must be one [E, dim] per parameter slot, dims "
            f"{pdims}")
    floats = {"meas": meas, "info": info, "delta": delta}
    ints = {}
    for s, vt in enumerate(vts):
        N = params[s].shape[0]
        require(params[s].shape == (N, vt.ambient_dim)
                and free[s].shape == (N,) and indices[s].shape == (E,),
                f"{what}: slot {s} needs params [N, {vt.ambient_dim}], "
                "free [N] and indices [E]")
        floats[f"params{s}"], floats[f"free{s}"] = params[s], free[s]
        ints[f"indices{s}"] = indices[s]
    floats.update((f"pdata{k}", p) for k, p in enumerate(pdata))
    require(0 <= kernel_id < len(robust.kernel_names()),
            f"{what}: unknown robust kernel id {kernel_id}")
    check_tensors(what, meas.device, meas.dtype, floats, ints)
    if not launch_device(what, meas.device):
        return linearize_plain(type_name, params, free, indices, meas, info,
                               delta, pdata, kernel_id), False
    new = lambda *shape: torch.empty(shape, dtype=meas.dtype,
                                     device=meas.device)
    resid, rho1 = new(E, D), new(E)
    jacs = tuple(new(E, D, vt.tangent_dim) for vt in vts)
    if E == 0:
        return (resid, jacs, rho1), False
    pad = lambda seq, n: [t.data_ptr() for t in seq] + [None] * (n - len(seq))
    slots = [p for s in zip(pad(params, 3), pad(free, 3), pad(indices, 3))
             for p in s]
    build.launch("g2o_" + LINEARIZERS[type_name], meas, *slots,
                 meas.data_ptr(), info.data_ptr(), delta.data_ptr(),
                 *pad(pdata, 2), int(kernel_id), resid.data_ptr(),
                 *pad(jacs, 3), rho1.data_ptr(), E)
    return (resid, jacs, rho1), True


def _wrappers(type_name: str, wname: str):
    """The wrapper of one edge type, which owns its launch count, and its
    plain version."""
    et = registry.edge_type(type_name)
    # the kernel computes the type's closed form where the model has one
    # (edge_lin_analytic_kernel), else it runs in forward mode
    form = ("the closed-form Jacobian" if et.jacobian is not None
            else "forward mode")

    def wrapper(params, free, indices, meas, info, delta, pdata, kernel_id):
        out, launched = _linearize(type_name, params, free, indices, meas,
                                   info, delta, pdata, kernel_id)
        wrapper.launches += launched
        return out

    def plain(params, free, indices, meas, info, delta, pdata, kernel_id):
        return linearize_plain(type_name, params, free, indices, meas, info,
                               delta, pdata, kernel_id)

    wrapper.__name__ = wrapper.__qualname__ = wname
    wrapper.__doc__ = (
        f"{et.tag} (slots {', '.join(et.vertex_types)}"
        + (f"; pdata {', '.join(et.param_types)}" if et.param_types else "")
        + f"): K17 ({form}) on CUDA tensors, the plain version on CPU "
        "tensors.")
    plain.__name__ = plain.__qualname__ = wname + "_plain"
    wrapper.launches = 0
    return wrapper, plain


# importing the models registers the types the table names
from openslam_g2o_torch.models import (  # noqa: E402,F401
    bal, sba, slam2d, slam3d)

for _t, _w in LINEARIZERS.items():
    globals()[_w], globals()[_w + "_plain"] = _wrappers(_t, _w)
# the wrappers, in LINEARIZERS' order (kernels.WRAPPERS lists them)
WRAPPERS = tuple(globals()[_w] for _w in LINEARIZERS.values())
del _t, _w
