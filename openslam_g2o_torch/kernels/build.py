"""Build and load the hand-written CUDA kernels.

The `.cu` sources under kernels/csrc/ are compiled with nvcc (one process
per source, all started together) and linked into one shared library with a
plain C interface, loaded with ctypes. The library lands
in kernels/_build/ (listed in .gitignore) under a name keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import time: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# No -use_fast_math: the block Cholesky must turn a non-SPD block into NaN,
# and the angle wrap must match the floor formula bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Per source, added to NVCC_FLAGS. The block inverses round every product
# on its own, as their plain version does: a contracted a*d - b*c is finite
# where the separate products overflow to inf - inf = NaN, and the NaN is
# what tells PCG and LM that the block is unusable.
SOURCE_FLAGS = {"ba_inv.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
# exported C symbol -> argtypes (the stream comes last)
_SIGNATURES = {
    "g2o_block_ell_spmv": (_P, _P, _P, _P, _I, _I, _I, _P),
    "g2o_edge_se2_blocks": (_P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                            _I, _I, _I, _P),
    "g2o_edge_se3_blocks": (_P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                            _I, _I, _I, _P),
    "g2o_assemble_gather": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P),
    "g2o_damp_chol": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "g2o_jacobi_scale": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "g2o_lane_block_mv": (_P, _P, _P, _I, _I, _I, _P),
    "g2o_lane_block_mv_dot": (_P, _P, _P, _P, _I, _I, _P),
    "g2o_spmv_dot": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "g2o_spmv_dot_p": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "g2o_dot_partials": (_P, _P, _P, _I, _P),
    "g2o_cg_residual": (_P, _P, _P, _P, _P, _P, _I, _P),
    "g2o_cg_start": (_P, _P, _I, _P, _I, _P, _I, _D, _I, _P),
    "g2o_cg_update_xr": (_P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P),
    "g2o_cg_update_p": (_P, _P, _I, _P, _I, _P, _P, _I, _I, _P),
    "g2o_nonfinite_partials": (_P, _P, _I, _P),
    "g2o_cg_finish": (_P, _P, _I, _P, _P, _I, _P),
    "g2o_gershgorin": (_P, _P, _P, _I, _I, _I, _P),
    "g2o_chebyshev_coeffs": (_P, _P, _I, _P, _P),
    "g2o_chebyshev_init": (_P, _P, _P, _P, _I, _P),
    "g2o_chebyshev_update": (_P, _I, _P, _P, _P, _P, _I, _P),
    "g2o_lane_gather": (_P, _P, _P, _I, _I, _I, _P),
    "g2o_dense_zero": (_P, _L, _P),
    "g2o_dense_pair": (_P,) * 16 + (_I,) * 6 + (_P,),
    "g2o_dense_finalize": (_P, _P, _P, _I, _I, _P),
    "g2o_retract_se2": (_P, _P, _P, _P, _P, _P, _P, _I, _P),
    "g2o_se2_edge_chi2": (_P, _P, _P, _P, _P, _P, _I, _P, _I, _P),
    "g2o_retract_se3": (_P, _P, _P, _P, _P, _P, _P, _I, _P),
    "g2o_se3_edge_chi2": (_P, _P, _P, _P, _P, _P, _I, _P, _I, _P),
    "g2o_lm_outcome": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P),
    "g2o_ba_xyz2uv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                      _L, _L, _P, _P, _P, _P, _P),
    "g2o_ba_generic": (_P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I,
                       _P, _P, _P, _P, _P),
    "g2o_ba_lm_sums": (_P, _P, _P, _P, _I, _I, _L, _I, _I, _P, _P, _P, _P),
    "g2o_ba_cam_sums": (_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P, _P, _P,
                        _P, _P),
    "g2o_ba_inv": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    "g2o_ba_wtx": (_P, _P, _P, _I, _I, _I) * 3 + (_I, _P, _P, _P, _P, _I, _P,
                                                _P),
    "g2o_ba_wv": (_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _P, _P,
                  _P, _P, _I, _I, _P, _P, _P, _P),
    "g2o_ba_sandwich": (_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _I,
                        _I, _P, _P, _P),
    "g2o_ba_records": (_P, _L, _I, _I, _P, _P),
    "g2o_ba_schur": (_P,) * 9 + (_I,) * 5 + (_P, _P),
    "g2o_pair_stream": (_P, _I, _I, _P),
    "g2o_pair_sum": (_P, _I, _I, _P),
    "g2o_pair_scale": (_P,) * 7 + (_I, _L, _I, _L, _I, _I, _P),
    "g2o_pair_flat": (_P, _I, _I, _I) + (_P,) * 7,
    "g2o_pair_bound": (_P, _I, _I, _P, _P, _I, _P, _P),
    "g2o_schur_edge": (_P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I, _P, _P,
                       _P, _P, _L, _P, _P, _P, _L, _P, _I, _P),
}
# K17: one signature for every edge type's entry (three slots and two
# parameter slots, unused ones null); the names are kernels/edge_lin.py's
# LINEARIZERS
for _name in ("se2", "se2_xy", "se2_bearing", "se2_prior", "se2_prior_xy",
              "se2_xy_calib", "se2_offset", "se2_xy_offset", "se3",
              "se3_xyz", "se3_depth", "se3_disparity", "se3_prior",
              "se3_offset", "se3_expmap", "xyz2uv", "xyz2uvu", "psi2uv",
              "p2mc", "p2mc_intrinsics", "p2sc", "sba_cam", "sba_scale",
              "bal"):
    _SIGNATURES["g2o_edge_lin_" + _name] = (_P,) * 14 + (_I,) + (_P,) * 5 + (
        _I, _P)
    # K7's trial chi2 of the same type (trial.cu; kernels/trial.py CHI2)
    _SIGNATURES["g2o_trial_chi2_" + _name] = (_P,) * 11 + (_I, _P, _I, _P)
# K7's trial retraction over every vertex group (trial.cu; kernels/trial.py
# RETRACT_IDS)
_SIGNATURES["g2o_trial_retract_groups"] = (_P, _I, _I, _P, _P, _P)
_SIGNATURES["g2o_chi2_sum"] = (_P, _I, _P, _P)
del _name

_lib = None
_last_build = {}


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compile the kernels if the library for the current sources is not
    built yet; return its path. Raises RuntimeError with nvcc's output on
    failure. The result of the last call is in `last_build()`."""
    lib_path = BUILD_DIR / f"libg2o_torch_kernels_{_digest()}.so"
    if lib_path.exists():
        _last_build.update(path=str(lib_path), seconds=0.0, log="(cached)")
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    # compile and link under private names, then rename: a concurrent build
    # never sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            jobs.append((src.name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c",
                 str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, _, proc in jobs:            # wait for all of them
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        linked = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", linked, *(obj for _, obj, _ in jobs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(linked, lib_path)
    _last_build.update(path=str(lib_path),
                       seconds=time.monotonic() - t0,
                       log=log)
    return lib_path


def last_build() -> dict:
    """{"path", "seconds", "log"} of the last build() in this process."""
    return dict(_last_build)


def load():
    """The loaded kernel library (built on first use), with argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, name + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.g2o_error_string.argtypes = (ctypes.c_int,)
        lib.g2o_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = _lib.g2o_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")


_entries = {}


def entry(name: str, dtype):
    """The C entry point `name` for torch dtype float32/float64."""
    fn = _entries.get((name, dtype))
    if fn is None:
        import torch
        suffix = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
        fn = _entries[(name, dtype)] = getattr(load(), name + suffix)
    return fn


def launch(name: str, like, *args):
    """Call the entry point `name` for `like.dtype` with `args` and, last,
    PyTorch's current stream on `like`'s device, with that device current;
    raise on a CUDA error. This runs once per kernel launch, in the CG loop
    too, so it takes the raw stream handle directly and enters a device
    guard only when another device is current. The handle comes from
    `torch._C._cuda_getCurrentRawStream`, a private binding (what
    `torch.cuda.current_stream(index).cuda_stream` returns, without building
    the Stream object); present in torch 2.11, the version this was run
    with."""
    import torch
    fn = entry(name, like.dtype)
    index = like.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err:
        check(err, name)
