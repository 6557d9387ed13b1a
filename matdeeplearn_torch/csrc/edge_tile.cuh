// Pieces shared by the edge-tile kernels (fused_cgconv.cu, fused_cfconv.cu
// and fused_bilinear.cu): the tile geometry, the choice of columns a
// thread owns, the activations, the run-flush epilogue that adds a tile's
// rows into their destination nodes, and the fixed-order sum of the
// backward kernels' per-block partial weight gradients. Each .cu file
// builds into its own library, so the anonymous namespace gives every
// library its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTE = 32;          // edges per tile
constexpr int kRows = kTE / 8;   // tile rows per thread (8 warps)
constexpr int kKC = 32;          // right-operand rows per shared-memory chunk
constexpr int kMaxShared = 232448;
constexpr int kBadShape = 1001;  // a width over 256, or too much shared memory

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Columns a thread owns (of 32 * CPT): the smallest instantiated CPT that
// covers n columns, or 0 when n > 256.
int cpt_for(int n) {
  const int need = (n + 31) / 32;
  if (need <= 1) return 1;
  if (need <= 2) return 2;
  if (need <= 4) return 4;
  if (need <= 5) return 5;
  if (need <= 8) return 8;
  return 0;
}

__device__ __forceinline__ float sigmoidf(float a) {
  return 1.f / (1.f + expf(-a));
}

// Unthresholded softplus, as the reference package computes it.
__device__ __forceinline__ float softplusf(float a) {
  return fmaxf(a, 0.f) + log1pf(expf(-fabsf(a)));
}

// out[dst[r], c] += v_s[r, c] for the tile's rows whose weight w_s[r] is
// not zero: one thread per column adds runs of equal dst and flushes each
// with one atomicAdd. Right for any dst order; on dst-sorted edges about
// one atomic per node and column.
__device__ void flush_runs(const float* v_s, int d, const float* w_s,
                           const int* dst_s, float* __restrict__ out) {
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float acc = 0.f;
    int cur = -1;
    for (int r = 0; r < kTE; ++r) {
      if (w_s[r] == 0.f) continue;
      const int node = dst_s[r];
      if (node != cur) {
        if (cur >= 0) atomicAdd(out + (long long)cur * d + c, acc);
        acc = 0.f;
        cur = node;
      }
      acc += v_s[r * d + c];
    }
    if (cur >= 0) atomicAdd(out + (long long)cur * d + c, acc);
  }
}

// The partials hold, per block, tiles_w 4 x 4 micro-tiles; micro-tile m
// covers rows 4 * (m / cgroups) and columns 4 * (m % cgroups) of the
// weight gradient. dw[k, c] (rows x nb, row-major) = Σ_b partial[b][the
// micro-tile of (k, c)], summed in block order.
__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(const float* __restrict__ partial, int blocks,
                    int tiles_w, int cgroups, int rows, int nb,
                    float* __restrict__ dw) {
  const long long total = (long long)tiles_w * 16;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < total; p += stride) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partial[(long long)b * total + p];
    const int m = (int)(p / 16);
    const int i = (int)(p % 16) / 4;
    const int q = (int)(p % 4);
    const int k = (m / cgroups) * 4 + i;
    const int c = (m % cgroups) * 4 + q;
    if (k < rows && c < nb) dw[(long long)k * nb + c] = s;
  }
}

// Launches wgrad_reduce_kernel on `stream`; returns cudaGetLastError().
int launch_wgrad_reduce(const void* partial, void* dw, int blocks,
                        int tiles_w, int cgroups, int rows, int nb,
                        void* stream) {
  const long long total = (long long)tiles_w * 16;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  wgrad_reduce_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), blocks, tiles_w, cgroups, rows, nb,
      static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

}  // namespace
