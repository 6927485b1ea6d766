"""Build and load the hand-written CUDA kernels.

The `.cu` sources under kernels/csrc/ are compiled with nvcc into one shared
library with a plain C interface and loaded with ctypes. The library lands
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
# No -use_fast_math: the closed-form Cholesky must turn a non-SPD block into
# NaN, and the angle wrap must match the floor formula bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# exported C symbol -> argtypes (pointers, ints, then the stream)
_SIGNATURES = {
    "g2o_block_ell_spmv": (_P, _P, _P, _P, _I, _I, _P),
    "g2o_edge_se2_blocks": (_P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                            _I, _I, _I, _P),
    "g2o_assemble_gather": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lib = None
_last_build = {}


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    t0 = time.monotonic()
    # build to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _last_build.update(path=str(lib_path),
                       seconds=time.monotonic() - t0,
                       log=proc.stdout + proc.stderr)
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


def entry(name: str, dtype):
    """The C entry point `name` for torch dtype float32/float64."""
    import torch
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
    return getattr(load(), name + suffix)


def stream_of(tensor):
    """The raw cudaStream_t of PyTorch's current stream on tensor's device."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
