"""K17: forward-mode edge linearizers (csrc/edge_lin.cu).

Replaces, for EDGE_SE3:QUAT, EDGE_SE3_TRACKXYZ,
EDGE_PROJECT_P2MC_INTRINSICS and EDGE_PROJECT_PSI2UV:EXPMAP, the JAX hot
loop `linearize` (openslam_g2o_tpu/core/problem.py:350-392, vmap(jacfwd) at
:378) over their error functions (models/slam3d.py:70, :95;
models/sba.py:320, :262). For one edge group each wrapper returns what
core/problem.py `linearize_group` returns: the residual [E, D], the
per-slot Jacobians [E, D, Ds] with respect to the tangent increment, each
slot's columns times its vertex's free flag, and rho' [E]. The kernel
differentiates the error through the retractions with a
value-and-derivatives scalar (a thread per edge and pass of up to 6
directions in float32, 3 in float64); the plain version is the generic
route of `linearize_group` (the error, `forward_jacobians`' torch.func.jvp,
`robustify`, the mask).

Every wrapper takes the group's slots as tuples: `params` (each slot's
vertex table [N_s, P_s]), `free` ([N_s]) and `indices` ([E] int32), then
meas [E, M], info [E, D, D], delta [E], pdata (a tuple of [E, dim] per
parameter slot) and the robust kernel id.
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
    "edge_se3": "edge_lin_se3",
    "edge_se3_xyz": "edge_lin_se3_xyz",
    "edge_project_p2mc_intrinsics": "edge_lin_p2mc_intrinsics",
    "edge_project_psi2uv": "edge_lin_psi2uv",
}


def linearizer(type_name: str):
    """The wrapper that linearizes edge type `type_name`, or None."""
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
    pad = lambda seq: [t.data_ptr() for t in seq] + [None] * (3 - S)
    slots = [p for s in zip(pad(params), pad(free), pad(indices)) for p in s]
    build.launch("g2o_" + LINEARIZERS[type_name], meas, *slots,
                 meas.data_ptr(), info.data_ptr(), delta.data_ptr(),
                 pdata[0].data_ptr() if pdata else None, int(kernel_id),
                 resid.data_ptr(), *pad(jacs), rho1.data_ptr(), E)
    return (resid, jacs, rho1), True


def edge_lin_se3(params, free, indices, meas, info, delta, pdata, kernel_id):
    """EDGE_SE3:QUAT (slots se3, se3): K17 on CUDA tensors, the plain
    version on CPU tensors."""
    out, launched = _linearize("edge_se3", params, free, indices, meas, info,
                               delta, pdata, kernel_id)
    edge_lin_se3.launches += launched
    return out


def edge_lin_se3_plain(params, free, indices, meas, info, delta, pdata,
                       kernel_id):
    return linearize_plain("edge_se3", params, free, indices, meas, info,
                           delta, pdata, kernel_id)


def edge_lin_se3_xyz(params, free, indices, meas, info, delta, pdata,
                     kernel_id):
    """EDGE_SE3_TRACKXYZ (slots se3, point_xyz; pdata the sensor offset
    [E, 7]): K17 on CUDA tensors, the plain version on CPU tensors."""
    out, launched = _linearize("edge_se3_xyz", params, free, indices, meas,
                               info, delta, pdata, kernel_id)
    edge_lin_se3_xyz.launches += launched
    return out


def edge_lin_se3_xyz_plain(params, free, indices, meas, info, delta, pdata,
                           kernel_id):
    return linearize_plain("edge_se3_xyz", params, free, indices, meas, info,
                           delta, pdata, kernel_id)


def edge_lin_p2mc_intrinsics(params, free, indices, meas, info, delta, pdata,
                             kernel_id):
    """EDGE_PROJECT_P2MC_INTRINSICS (slots sba_point_xyz, cam,
    intrinsics): K17 on CUDA tensors, the plain version on CPU tensors."""
    out, launched = _linearize("edge_project_p2mc_intrinsics", params, free,
                               indices, meas, info, delta, pdata, kernel_id)
    edge_lin_p2mc_intrinsics.launches += launched
    return out


def edge_lin_p2mc_intrinsics_plain(params, free, indices, meas, info, delta,
                                   pdata, kernel_id):
    return linearize_plain("edge_project_p2mc_intrinsics", params, free,
                           indices, meas, info, delta, pdata, kernel_id)


def edge_lin_psi2uv(params, free, indices, meas, info, delta, pdata,
                    kernel_id):
    """EDGE_PROJECT_PSI2UV:EXPMAP (slots sba_point_xyz (psi), se3_expmap,
    se3_expmap (anchor); pdata the camera parameters [E, 4]): K17 on CUDA
    tensors, the plain version on CPU tensors. The observing camera and
    the anchor may be one vertex; each slot still gets its own columns."""
    out, launched = _linearize("edge_project_psi2uv", params, free, indices,
                               meas, info, delta, pdata, kernel_id)
    edge_lin_psi2uv.launches += launched
    return out


def edge_lin_psi2uv_plain(params, free, indices, meas, info, delta, pdata,
                          kernel_id):
    return linearize_plain("edge_project_psi2uv", params, free, indices,
                           meas, info, delta, pdata, kernel_id)


for _w in (edge_lin_se3, edge_lin_se3_xyz, edge_lin_p2mc_intrinsics,
           edge_lin_psi2uv):
    _w.launches = 0
del _w
