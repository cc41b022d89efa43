"""The FP64 tensor cores' mma.sync shapes on the card: fragment layouts and
rates.

    python3 fp64_mma_probe.py

Builds a small CUDA library (nvcc, sm_90a) and, for each float64
``mma.sync`` shape (m8n8k4, and m16n8k4, m16n8k8, m16n8k16, which sm_90
adds), checks one product against numpy with the fragment layout the
float64 kernels assume (lane 4g + t: A rows g and g + 8 at columns t, t + 4,
...; B row t + 4i at column g; C (g, 2t), (g, 2t + 1), (g + 8, ...)), then
times a loop of independent products on every SM (CUDA events) and prints
TFLOP/s beside the card's name and power limit. It also times an int8
count's conversion to a double, I2F.F64 against one FP64 add on its bits.
The float64 family (``clonealign_torch/ops/csrc/fused_likelihood_f64.cu``)
takes m16n8k8 from what this prints on the H100.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
template <int S> struct Sh;
template <> struct Sh<0> { static constexpr int M = 8, N = 8, K = 4, NA = 1, NB = 1, NC = 2; };
template <> struct Sh<1> { static constexpr int M = 16, N = 8, K = 4, NA = 2, NB = 1, NC = 4; };
template <> struct Sh<2> { static constexpr int M = 16, N = 8, K = 8, NA = 4, NB = 2, NC = 4; };
template <> struct Sh<3> { static constexpr int M = 16, N = 8, K = 16, NA = 8, NB = 4, NC = 4; };
template <int S> __device__ __forceinline__ void mma(double* d, const double* a, const double* b) {
  if constexpr (S == 0)
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
                 : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
  else if constexpr (S == 1)
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
                 "{%0,%1,%2,%3};" : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  else if constexpr (S == 2)
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
                 "{%8,%9}, {%0,%1,%2,%3};" : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  else
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
                 "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
                   "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
template <int S> __global__ void layout_kernel(const double* A, const double* B, double* C) {
  using H = Sh<S>;
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  double a[8], b[4], d[4] = {0, 0, 0, 0};
  for (int i = 0; i < H::NA; ++i)
    a[i] = S == 0 ? A[g * H::K + t]
         : A[(g + 8 * (S == 1 ? i : i % 2)) * H::K + t + 4 * (S == 1 ? 0 : i / 2)];
  for (int i = 0; i < H::NB; ++i) b[i] = B[(t + 4 * i) * H::N + g];
  mma<S>(d, a, b);
  for (int i = 0; i < H::NC; ++i) C[(g + 8 * (i / 2)) * H::N + 2 * t + i % 2] = d[i];
}
template <int S> __global__ void rate_kernel(double* out, int iters) {
  double a[8], b[4], d[4][4];
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int j = 0; j < 4; ++j) for (int i = 0; i < 4; ++i) d[j][i] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j) mma<S>(d[j], a, b);
  }
  double s = 0;
  for (int j = 0; j < 4; ++j) for (int i = 0; i < 4; ++i) s += d[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void conv_kernel(const int8_t* y, double* out, int iters, int magic) {
  double acc[4] = {0, 0, 0, 0};
  const int v = y[threadIdx.x];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = v + u * it;
      const double x = magic ? __hiloint2double(0x43380000, w ^ 0x80000000) - 6755401588539392.0
                             : (double)w;
      acc[u] = fma(x, 1.0000001, acc[u]);
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc[0] + acc[1] + acc[2] + acc[3];
}
extern "C" {
int probe_layout(int s, const double* A, const double* B, double* C) {
  switch (s) {
    case 0: layout_kernel<0><<<1, 32>>>(A, B, C); break;
    case 1: layout_kernel<1><<<1, 32>>>(A, B, C); break;
    case 2: layout_kernel<2><<<1, 32>>>(A, B, C); break;
    default: layout_kernel<3><<<1, 32>>>(A, B, C);
  }
  return (int)cudaDeviceSynchronize();
}
int probe_rate(int s, double* out, int blocks, int iters) {
  switch (s) {
    case 0: rate_kernel<0><<<blocks, 128>>>(out, iters); break;
    case 1: rate_kernel<1><<<blocks, 128>>>(out, iters); break;
    case 2: rate_kernel<2><<<blocks, 128>>>(out, iters); break;
    default: rate_kernel<3><<<blocks, 128>>>(out, iters);
  }
  return (int)cudaGetLastError();
}
int probe_conv(const int8_t* y, double* out, int blocks, int iters, int magic) {
  conv_kernel<<<blocks, 256>>>(y, out, iters, magic);
  return (int)cudaGetLastError();
}
}
'''
SHAPES = {0: (8, 8, 4), 1: (16, 8, 4), 2: (16, 8, 8), 3: (16, 8, 16)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fp64_mma_probe: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from clonealign_torch.ops import _build

    with tempfile.TemporaryDirectory() as d:
        cu, so = Path(d) / "probe.cu", Path(d) / "probe.so"
        cu.write_text(SOURCE)
        subprocess.run([_build._nvcc(), *_build.ARCH, "-O3", "-shared", "-Xcompiler", "-fPIC",
                        "-o", str(so), str(cu)], check=True)
        lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_layout.argtypes = [i, p, p, p]
    lib.probe_rate.argtypes = [i, p, i, i]
    lib.probe_conv.argtypes = [p, p, i, i, i]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    rng = np.random.default_rng(0)
    ok = True
    for s, (M, N, K) in SHAPES.items():
        A, B = rng.normal(size=(M, K)), rng.normal(size=(K, N))
        tA, tB = torch.tensor(A, device="cuda"), torch.tensor(B, device="cuda")
        C = torch.full((M, N), float("nan"), dtype=torch.float64, device="cuda")
        err = lib.probe_layout(s, tA.data_ptr(), tB.data_ptr(), C.data_ptr())
        diff = float(np.max(np.abs(C.cpu().numpy() - A @ B)))
        ok &= err == 0 and diff < 1e-12
        print(f"m{M}n{N}k{K}: layout error {err}, max |C - AB| {diff:.3e}")
    out = torch.empty(132 * 16 * 128, dtype=torch.float64, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for s, (M, N, K) in SHAPES.items():
        blocks, iters = 132 * 16, 2048
        lib.probe_rate(s, out.data_ptr(), blocks, 16)
        start.record()
        lib.probe_rate(s, out.data_ptr(), blocks, iters)
        end.record()
        torch.cuda.synchronize()
        flops = blocks * 4 * iters * 4 * 2 * M * N * K
        print(f"m{M}n{N}k{K}: {flops / start.elapsed_time(end) / 1e9:.2f} TFLOP/s")
    y = torch.randint(-100, 100, (256,), dtype=torch.int8, device="cuda")
    for magic, name in ((0, "I2F.F64"), (1, "an FP64 add on the bits")):
        lib.probe_conv(y.data_ptr(), out.data_ptr(), 132 * 8, 16, magic)
        start.record()
        lib.probe_conv(y.data_ptr(), out.data_ptr(), 132 * 8, 4096, magic)
        end.record()
        torch.cuda.synchronize()
        rate = 132 * 8 * 256 * 4096 * 4 / start.elapsed_time(end) / 1e9
        print(f"int8 to double by {name}, then an FMA: {rate:.2f} T elements/s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
