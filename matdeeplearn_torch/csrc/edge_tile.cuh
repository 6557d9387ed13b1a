// Pieces shared by the edge-tile kernels (fused_cgconv.cu, fused_cfconv.cu
// and fused_bilinear.cu): the block size and shape limits, the
// activations, the run-flush epilogue that adds a tile's rows into their
// destination nodes, the fixed-order sum of the backward
// kernels' per-block partial weight gradients, and the mma.sync and
// async-copy primitives of the 3xTF32 kernels (wgmma.cuh holds the wgmma
// ones). Each .cu file builds into
// its own library, so the anonymous namespace gives every library its own
// copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShared = 232448;
constexpr int kBadShape = 1001;  // a width over 256, or too much shared memory

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int round8(int v) { return (v + 7) & ~7; }

// The smallest stride >= v that is 4 mod 32: an A fragment's 8 rows x 4
// columns then fall in 32 distinct banks.
__host__ __device__ inline int stride_a(int v) { return v + (36 - v % 32) % 32; }

// The smallest stride >= v that is 8 mod 16 (8 or 24 mod 32): a B
// fragment's 4 rows x 8 columns then fall in 32 distinct banks.
__host__ __device__ inline int stride_b(int v) { return v + (24 - v % 16) % 16; }

__device__ __forceinline__ float sigmoidf(float a) {
  return 1.f / (1.f + expf(-a));
}

// Unthresholded softplus, as the reference package computes it.
__device__ __forceinline__ float softplusf(float a) {
  return fmaxf(a, 0.f) + log1pf(expf(-fabsf(a)));
}

// out[dst[r], c] += v_s[r * ldv + cs * c] (ldv = d unless given) for the
// TE rows of a tile whose weight w_s[r] is not zero, c < d: one thread per
// column adds runs of equal dst and flushes each with one atomicAdd. Right
// for any dst order; on dst-sorted edges about one atomic per node and
// column.
template <int TE>
__device__ void flush_runs(const float* v_s, int d, const float* w_s,
                           const int* dst_s, float* __restrict__ out,
                           int ldv = 0, int cs = 1) {
  if (ldv == 0) ldv = d;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float acc = 0.f;
    int cur = -1;
    for (int r = 0; r < TE; ++r) {
      if (w_s[r] == 0.f) continue;
      const int node = dst_s[r];
      if (node != cur) {
        if (cur >= 0) atomicAdd(out + (long long)cur * d + c, acc);
        acc = 0.f;
        cur = node;
      }
      acc += v_s[r * ldv + cs * c];
    }
    if (cur >= 0) atomicAdd(out + (long long)cur * d + c, acc);
  }
}

// The partials hold, per slice, tiles_w 4 x 4 micro-tiles; micro-tile m
// covers rows 4 * (m / cgroups) and columns 4 * (m % cgroups) of the
// weight gradient. dw[k, c] (rows x nb, row-major) = Σ_b partial[b][the
// micro-tile of (k, c)].
//
// Bound: bytes (every slice read once). Each block owns 32 float4 of a
// slice, one per lane, so a warp reads 512 contiguous bytes of a slice;
// warp w sums the slices [w*B/8, (w+1)*B/8) with kAcc independent
// accumulators (kAcc loads in flight per thread, not one dependent chain
// of scalar loads), and warp 0 adds the 8 warp sums in warp order. The order of every addition is fixed by the slice
// count alone, so dw is bit-identical from run to run.
constexpr int kAcc = 8;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(const float4* __restrict__ partial, int blocks,
                    long long total4, int cgroups, int rows, int nb,
                    float* __restrict__ dw) {
  __shared__ float4 warp_s[kThreads / 32][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * 32 + lane;
  const int b0 = (int)((long long)blocks * warp / (kThreads / 32));
  const int b1 = (int)((long long)blocks * (warp + 1) / (kThreads / 32));
  float4 acc[kAcc];
#pragma unroll
  for (int u = 0; u < kAcc; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p < total4) {
    int b = b0;
    for (; b + kAcc <= b1; b += kAcc) {
      float4 v[kAcc];
#pragma unroll
      for (int u = 0; u < kAcc; ++u) v[u] = partial[(long long)(b + u) * total4 + p];
#pragma unroll
      for (int u = 0; u < kAcc; ++u) add4(acc[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kAcc; ++u) {
      if (b + u < b1) add4(acc[u], partial[(long long)(b + u) * total4 + p]);
    }
  }
#pragma unroll
  for (int u = 1; u < kAcc; ++u) add4(acc[0], acc[u]);
  warp_s[warp][lane] = acc[0];
  __syncthreads();
  if (warp != 0 || p >= total4) return;
  float4 s = warp_s[0][lane];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) add4(s, warp_s[w][lane]);
  const int m = (int)(p / 4);
  const int k = (m / cgroups) * 4 + (int)(p % 4);
  const int c = (m % cgroups) * 4;
  if (k >= rows) return;
  float* row = dw + (long long)k * nb;
  const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (c + q < nb) row[c + q] = v[q];
  }
}

// Launches wgrad_reduce_kernel on `stream`; returns cudaGetLastError().
int launch_wgrad_reduce(const void* partial, void* dw, int blocks,
                        int tiles_w, int cgroups, int rows, int nb,
                        void* stream) {
  const long long total4 = (long long)tiles_w * 4;
  const unsigned grid = (unsigned)((total4 + 31) / 32);
  wgrad_reduce_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(partial), blocks, total4, cgroups, rows, nb,
      static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

// ---- 3xTF32 tensor-core products (mma.sync m16n8k8) and cp.async --------
//
// a = hi + lo, each rounded to TF32 (cvt.rna); a·b is taken as
// hi_a·hi_b + hi_a·lo_b + lo_a·hi_b, accumulated in f32, small terms
// first. The dropped lo_a·lo_b and the rounding of lo leave about 2^-21 of
// |a·b|: f32 accuracy for these sums, as the TPU kernel's hi/lo bf16 split
// (ops/pallas_fused.py:_hilo) gives its MXU.

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// lo is rounded as cvt.rna would, in two integer operations: v - hi is
// finite wherever v is, and where v is not, hi carries it.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// d += a·b for one m16n8k8 TF32 fragment: a (16 x 8, row) in 4 registers,
// b (8 x 8, col) in 2, d (16 x 8) in 4; the PTX ISA's fragment layouts:
// with g = lane / 4 and t = lane % 4, a = {A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi[0], bhi[1]);
  mma_tf32(d, ahi, blo[0], blo[1]);
  mma_tf32(d, ahi, bhi[0], bhi[1]);
}

// acc[mt][i] += A[mt] · B[i] in 3xTF32, pass by pass over all fragments
// (lo·hi, then hi·lo, then hi·hi): each accumulator takes its three
// products in mma_3xtf32's order, and no mma.sync waits on the one issued
// just before it.
template <int MT, int NTW>
__device__ __forceinline__ void mma_3xtf32_tile(
    float (&acc)[MT][NTW][4], const uint32_t (&ahi)[MT][4],
    const uint32_t (&alo)[MT][4], const uint32_t (&bhi)[NTW][2],
    const uint32_t (&blo)[NTW][2]) {
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][i], alo[mt], bhi[i][0], bhi[i][1]);
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][i], ahi[mt], blo[i][0], blo[i][1]);
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][i], ahi[mt], bhi[i][0], bhi[i][1]);
}

// 16-byte global → shared copy; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 4-byte global → shared copy; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes = 4) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace
