"""What a launch form costs the host: `<<<>>>` against `cudaLaunchKernelEx`,
without attributes and with programmatic stream serialization (the form
kernels/csrc/cg_step.cu gives `cg_update_xr`).

    python3 -m openslam_g2o_torch.apps.launch_cost [--n 300000] [--reps 15]

Builds one small CUDA source (below; nvcc, sm_90a, into kernels/_build/)
with two kernels shaped like the two-launch CG step: a product-sized
`primary` that triggers its dependents after its work, and a `dependent`
with `cg_update_xr`'s ten arguments and grid (2048 values a block) that
waits with griddepcontrol.wait before it reads. One C entry point
launches `dependent` in each form, chosen by an argument, so every form
pays the same ctypes call. Three measurements per form, the forms in
serpentine order (0 1 2 2 1 0 ...), median and range over the repeats:

* host: microseconds per call of 200 back-to-back calls, host clock before
  the synchronize (the queue never fills: the card runs each launch in a
  few microseconds);
* loop: wall microseconds per iteration of primary + dependent, with
  torch.cuda.synchronize() after every second iteration, as pcg_solve
  reads its continue flag once per two CG iterations;
* device: CUDA events around 200 back-to-back iterations.

Prints one line per measurement and the card's name and power limit;
needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import time

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void primary(float* y, const float* a, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) y[i] = a[i] * 1.0001f + y[i];
  asm volatile("griddepcontrol.launch_dependents;");
}

__global__ void __launch_bounds__(256) dependent(
    float* scal, const float* part, int n_part, float* x, float* r,
    const float* p, const float* hp, float* part_rr, long long n,
    int* arrivals) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float alpha = scal[0] / (part[0] + (float)n_part);
  const long long base = blockIdx.x * 2048LL + threadIdx.x;
  float rr = 0.f;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const long long i = base + v * 256;
    if (i < n) {
      x[i] += alpha * p[i];
      const float ri = r[i] - alpha * hp[i];
      r[i] = ri;
      rr += ri * ri;
    }
  }
  if (threadIdx.x == 0) part_rr[blockIdx.x] = rr;
  if (arrivals != nullptr && threadIdx.x == 0 && blockIdx.x == 0)
    *arrivals = 0;
}

extern "C" int lc_primary(float* y, const float* a, long long n,
                          void* stream) {
  primary<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      y, a, n);
  return (int)cudaGetLastError();
}

// form 0: <<<>>>; 1: cudaLaunchKernelEx, no attribute; 2: with
// programmatic stream serialization
extern "C" int lc_dependent(int form, float* scal, const float* part,
                            int n_part, float* x, float* r, const float* p,
                            const float* hp, float* part_rr, long long n,
                            int* arrivals, void* stream) {
  const unsigned blocks = (unsigned)((n + 2047) / 2048);
  if (form == 0) {
    dependent<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        scal, part, n_part, x, r, p, hp, part_rr, n, arrivals);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(256);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = form == 2 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dependent, scal, part, n_part, x, r, p, hp, part_rr, n, arrivals);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
"""

FORMS = ("<<<>>>", "cudaLaunchKernelEx", "cudaLaunchKernelEx + PDL")


def _library():
    """Compile SOURCE (once per content) and load it with its argtypes."""
    from openslam_g2o_torch.kernels import build
    digest = hashlib.sha256(SOURCE.encode()
                            + " ".join(build.NVCC_FLAGS).encode())
    path = build.BUILD_DIR / f"liblaunch_cost_{digest.hexdigest()[:16]}.so"
    if not path.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = path.with_suffix(".cu")
        src.write_text(SOURCE)
        done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                               "-o", str(path), str(src)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(path))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lc_primary.argtypes = (P, P, L, P)
    lib.lc_dependent.argtypes = (I, P, P, I, P, P, P, P, P, L, P, P)
    lib.lc_primary.restype = lib.lc_dependent.restype = I
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=300_000,
                    help="values of the dependent's vectors (the SE2 "
                         "serpentine's 3 x 100,000)")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("launch_cost needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    lib = _library()
    dev, n = torch.device("cuda"), args.n
    vec = lambda m: torch.rand(m, device=dev)
    y, a = vec(4 * n), vec(4 * n)        # the product's share of traffic
    x, r, p, hp = vec(n), vec(n), vec(n), vec(n)
    scal, part = vec(10), vec(391)
    part_rr = vec((n + 2047) // 2048)
    arrivals = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(0)
    ptrs = (scal.data_ptr(), part.data_ptr(), 391, x.data_ptr(),
            r.data_ptr(), p.data_ptr(), hp.data_ptr(), part_rr.data_ptr(), n,
            arrivals.data_ptr(), stream)

    def dep(form):
        err = lib.lc_dependent(form, *ptrs)
        if err:
            raise RuntimeError(f"lc_dependent form {form}: CUDA error {err}")

    def prim():
        err = lib.lc_primary(y.data_ptr(), a.data_ptr(), 4 * n, stream)
        if err:
            raise RuntimeError(f"lc_primary: CUDA error {err}")

    def host_us(form, calls=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            dep(form)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e6 * (t1 - t0) / calls

    def loop_us(form, iters=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            prim()
            dep(form)
            if i % 2:
                torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / iters

    def device_us(form, iters=200):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            prim()
            dep(form)
        end.record()
        torch.cuda.synchronize()
        return 1e3 * start.elapsed_time(end) / iters

    measures = {"host": host_us, "loop": loop_us, "device": device_us}
    for fn in measures.values():            # warm up every form
        for form in range(3):
            fn(form, 20)
    res = {(m, f): [] for m in measures for f in range(3)}
    for rep in range(args.reps):
        order = range(3) if rep % 2 == 0 else range(2, -1, -1)
        for form in order:
            for m, fn in measures.items():
                res[(m, form)].append(fn(form))
    what = {"host": "host us per dependent launch (200 back to back)",
            "loop": "wall us per primary + dependent, synchronize every "
                    "second iteration",
            "device": "device us per primary + dependent (CUDA events, 200 "
                      "back to back)"}
    for m in measures:
        for form in range(3):
            v = res[(m, form)]
            print(f"launch_cost {m} {FORMS[form]}: median "
                  f"{statistics.median(v):.3f} us (range {min(v):.3f}-"
                  f"{max(v):.3f}, {len(v)} repeats) n={n}: {what[m]} "
                  f"[{card}]")
    print(card)


if __name__ == "__main__":
    main()
