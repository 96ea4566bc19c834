#!/usr/bin/env python3
"""Do CUDA's atan2f and tanf, compiled by nvcc, equal torch's CUDA atan2
and tan bit for bit? On one NVIDIA GPU:

    python3 tools/torch_probe_trig.py [--log2n 24]

Builds a small kernel twice into build/probe/ (with `--fmad=false`, as
the port's kernels are built, and with nvcc's default, as torch's are)
and runs it on 2^log2n seeded inputs: atan2f on log-uniform magnitudes,
tanf on (-pi/2, pi/2), and the equi-angular distance and pdf of
csrc/common.cuh equi_angular_site from (delta, d, t_max, u). Prints the
count of lanes whose bits differ from torch's ops in each case, and the
card's name and power limit; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SRC = r'''
#include <cuda_runtime.h>
__global__ void lib(const float* y, const float* x, const float* a,
                    float* o1, float* o2, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  o1[i] = atan2f(y[i], x[i]);
  o2[i] = tanf(a[i]);
}
__global__ void equi(const float* delta, const float* d, const float* t_max,
                     const float* u, float* o_dist, float* o_pdf,
                     long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float theta_a = atan2f(-delta[i], d[i]);
  const float theta_b = atan2f(t_max[i] - delta[i], d[i]);
  const float th = theta_a + (theta_b - theta_a) * u[i];
  const float t = d[i] * tanf(th);
  o_dist[i] = delta[i] + t;
  o_pdf[i] = d[i] / ((theta_b - theta_a) * (d[i] * d[i] + t * t));
}
extern "C" cudaError_t run_lib(const float* y, const float* x, const float* a,
                               float* o1, float* o2, long long n) {
  lib<<<(unsigned)((n + 255) / 256), 256>>>(y, x, a, o1, o2, n);
  return cudaDeviceSynchronize();
}
extern "C" cudaError_t run_equi(const float* delta, const float* d,
                                const float* t_max, const float* u,
                                float* o_dist, float* o_pdf, long long n) {
  equi<<<(unsigned)((n + 255) / 256), 256>>>(delta, d, t_max, u, o_dist,
                                              o_pdf, n);
  return cudaDeviceSynchronize();
}
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=24)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_probe_trig: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from rayn_tpu_torch import _build

    out = HERE / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "trig.cu"
    cu.write_text(SRC)
    libs = {}
    for tag, flags in (("--fmad=false", ["--fmad=false"]),
                       ("nvcc default", [])):
        so = out / f"trig{len(libs)}.so"
        subprocess.run([_build._nvcc(), "-gencode", _build.ARCH,
                        "-std=c++17", "-O3", *flags, "-Xcompiler", "-fPIC",
                        "-shared", "-o", str(so), str(cu)], check=True)
        lib = ctypes.CDLL(str(so))
        lib.run_lib.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64]
        lib.run_equi.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64]
        lib.run_lib.restype = lib.run_equi.restype = ctypes.c_int
        libs[tag] = lib

    dev = torch.device("cuda", 0)
    n = 1 << args.log2n
    g = torch.Generator(device=dev).manual_seed(0)

    def uniform(lo, hi):
        return torch.empty(n, device=dev).uniform_(lo, hi, generator=g)

    def magnitude(lo, hi):   # log-uniform in [e^lo, e^hi)
        return torch.exp(uniform(lo, hi))

    y, x = uniform(-1, 1) * magnitude(-10, 6), magnitude(-10, 6)
    a = uniform(-1.5707963, 1.5707963)
    delta, d = uniform(-1, 1) * magnitude(-6, 4.5), magnitude(-8, 4.5)
    t_max, u = magnitude(-12, 5), uniform(0, 1)
    theta_a = torch.atan2(-delta, d)
    theta_b = torch.atan2(t_max - delta, d)
    t = d * torch.tan(theta_a + (theta_b - theta_a) * u)
    want = (torch.atan2(y, x), torch.tan(a), delta + t,
            d / ((theta_b - theta_a) * (d * d + t * t)))

    def n_diff(got, ref):
        same = ((got.view(torch.int32) == ref.view(torch.int32))
                | (torch.isnan(got) & torch.isnan(ref)))
        return int((~same).sum())

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    for tag, lib in libs.items():
        got = [torch.empty(n, device=dev) for _ in range(4)]
        p = [t.data_ptr() for t in got]
        assert lib.run_lib(y.data_ptr(), x.data_ptr(), a.data_ptr(), p[0],
                           p[1], n) == 0
        assert lib.run_equi(delta.data_ptr(), d.data_ptr(),
                            t_max.data_ptr(), u.data_ptr(), p[2], p[3],
                            n) == 0
        diffs = [n_diff(gv, w) for gv, w in zip(got, want)]
        print(f"{tag}: of {n} lanes, atan2f differs on {diffs[0]}, tanf on "
              f"{diffs[1]}, the equi-angular distance on {diffs[2]} and "
              f"its pdf on {diffs[3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
