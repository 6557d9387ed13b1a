// NNConv's bilinear edge message, forward and backward kernels for Hopper
// (sm_90a), with a plain C interface for ctypes (bound in
// matdeeplearn_torch/ops/fused_bilinear.py).
//
// mdl_fused_bilinear_fwd replaces the reference package's
// ops/pallas_bilinear.py:_fwd_kernel and :_fwd_kernel_chunked (two TPU
// schedules of one function); mdl_fused_bilinear_bwd together with
// mdl_fused_bilinear_wgrad replaces :_bwd_kernel and :_bwd_kernel_chunked.
//
// The bias is unit h = H of the hidden layer: a[e, H] = 1 and W[H] = b1,
// so W = [W1; b1] holds H + 1 units of D x K each. Per edge e, with the
// cotangent g and ge = mask * g:
//   msg[e]   = mask[e] * Σ_{h<=H} a[e,h] * (xj[e] @ W[h])         (1 x K)
//   U[e,h]   = ge[e] @ W[h]^T                                     (1 x D)
//   d_xj[e]  = Σ_{h<=H} a[e,h] * U[e,h]
//   d_a[e,h] = xj[e] · U[e,h]                                     (h < H)
//   dW[h]    = Σ_e (a[e,h] * xj[e])^T ge[e]                       (D x K)
// so msg = X @ W with X[e, h*D + d] = a[e,h] * xj[e,d], and dW = X^T ge.
// Neither X nor the (E, D, K) per-edge weight tensor is ever stored. A row
// whose mask is 0 is skipped: its msg, d_xj and d_a rows stay the caller's
// zeros and it adds nothing to dW.
//
// Bound: operations. At MPNN_demo width (D = K = H = 100) a real edge costs
// 2*(H+1)*D*K ≈ 2.02 MFLOP forward and twice that backward (U, and dW),
// against ~1.2 KB of its rows. Plain f32 FMA out of shared memory; no
// tensor cores (a later PR's speed work):
//
// * Forward and backward (d_xj, d_a): one block of 256 threads owns a tile
//   of 64 edges, loaded once into shared memory (xj for the forward; ge and
//   xj for the backward). For each unit h it runs one (64 x D) @ (D x K)
//   product (forward) or (64 x K) @ (K x D) product (backward, against W[h]
//   transposed by the caller) with W[h] streamed through shared memory in
//   chunks of up to 32 KB. Thread (tx, ty) of the 8 warps accumulates rows
//   ty + 8r (r < 8) and columns tx + 32j (j < CPT) in registers: every
//   value read from shared memory feeds 8 FMAs. The unit's product lands
//   in a second set of registers, which the epilogue folds in: the forward
//   adds a[e,h] times it to the message; the backward adds a[e,h] times U
//   to d_xj and reduces xj · U across the warp (one warp holds whole rows)
//   into d_a[e,h]. A tile with no real edge costs one barrier.
// * dW is ((H+1)*D x K): 4 MB at MPNN_demo, too large for per-block copies
//   of it. So it has a kernel of its own, over work items (slice of 64
//   rows of the flat dW) x (edge split s of S), walked by a persistent
//   grid of as many blocks as the card holds at once. An item sums the
//   edge tiles s, s + S, s + 2S, ... in order (interleaved, so the tail of
//   pad slots spreads over the splits) into its 64 x K slice in registers
//   (8 rows and CPT columns a thread) and writes it to its split's
//   partial; the last of the S items of a slice to finish (an atomic
//   count) adds the S partials in the order s = 0..S-1. So repeated runs
//   give bit-identical dW. The flat rows (row h*D + d is unit h's row d)
//   waste no rows at D = 100. A slice reads its 64 columns of X, built from
//   xj and a, and all of ge: ~30 MB at MPNN_demo's training batch, ~4.7 GB
//   from L2 over its 158 slices, against ~0.06 GB of inputs.
//
// The caller zeroes out, d_xj, d_a and the counts, and allocates
// everything; the kernels never synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile.cuh"

namespace {

constexpr int kBTE = 64;            // edges per tile (forward, backward)
constexpr int kBRows = kBTE / 8;    // tile rows per thread (8 warps)
constexpr int kChunkFloats = 8192;  // 32 KB: largest shared chunk of W[h]
constexpr int kWTE = 32;            // edges per step of the dW kernel
constexpr int kWRows = 64;          // rows of the flat dW a dW item owns
constexpr int kItemsPerSlot = 4;    // dW items per resident block
static_assert(kThreads % kWRows == 0, "a dW thread loads one X column");

struct Geometry {
  long long e;  // edge slots
  int d;        // xj width D
  int k;        // message width K
  int h;        // hidden units H (W holds H + 1 units)
};

// Rows of a right operand (ka x ldn) in one shared-memory chunk.
int chunk_rows(int ka, int ldn) {
  const int fit = (kChunkFloats / ldn) & ~3;
  const int rows = fit > 4 ? fit : 4;
  return round4(ka) < rows ? round4(ka) : rows;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sc_s[r] = mask of edge e0 + r (0 past the end) for the tile's kBTE rows;
// returns, uniformly across the block, whether any of them is real.
__device__ bool load_scale(const float* __restrict__ mask, long long e0,
                           long long e, float* sc_s) {
  bool real = false;
  if (threadIdx.x < kBTE) {
    const long long i = e0 + threadIdx.x;
    const float m = i < e ? mask[i] : 0.f;
    sc_s[threadIdx.x] = m;
    real = m != 0.f;
  }
  return __syncthreads_or(real) != 0;
}

// dst[r][c] = (scaled ? sc_s[r] : 1) * src[e0 + r][c] for c < w, zero for
// c in [w, ld) and for skipped rows. src is (e x w) row-major.
__device__ void load_rows(const float* __restrict__ src, long long e0, int w,
                          int ld, const float* sc_s, bool scaled,
                          float* dst) {
  for (int i = threadIdx.x; i < kBTE * ld; i += kThreads) {
    const int r = i / ld;
    const int c = i - r * ld;
    const float s = sc_s[r];
    float v = 0.f;
    if (s != 0.f && c < w) {
      v = src[(e0 + r) * w + c];
      if (scaled) v *= s;
    }
    dst[i] = v;
  }
}

// a[e, h], 1 for the bias unit h = H, 0 for a skipped row.
__device__ __forceinline__ float unit_weight(const float* __restrict__ a,
                                             long long e, int h,
                                             const Geometry& g, float s) {
  if (s == 0.f) return 0.f;
  return h < g.h ? a[e * g.h + h] : 1.f;
}

// part[r][j] = Σ_{k < ka} a_s[row][k] * b[k][c] for row = ty + 8r and
// c = tx + 32j. a_s is a kBTE x lda tile in shared memory, zero from
// column ka to round4(ka); b is a ka x nb row-major matrix in device
// memory, streamed through b_s in chunks of kc rows, 32 * CPT columns wide
// and zero beyond nb. Starts each chunk with a barrier, so the caller's
// writes to a_s are visible and the previous chunk's readers are done.
template <int CPT>
__device__ void unit_gemm(const float* __restrict__ a_s, int lda, int ka,
                          const float* __restrict__ b, int nb, int kc,
                          float* __restrict__ b_s,
                          float (&part)[kBRows][CPT]) {
  constexpr int ldn = 32 * CPT;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kBRows; ++r) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) part[r][j] = 0.f;
  }
  for (int k0 = 0; k0 < ka; k0 += kc) {
    const int kr = min(kc, ka - k0);
    const int kr4 = round4(kr);
    __syncthreads();
    for (int i = threadIdx.x; i < kr4 * ldn; i += kThreads) {
      const int kk = i / ldn;
      const int c = i - kk * ldn;
      b_s[i] = (kk < kr && c < nb) ? b[(long long)(k0 + kk) * nb + c] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kr4; kk += 4) {
      float4 a4[kBRows];
#pragma unroll
      for (int r = 0; r < kBRows; ++r) {
        a4[r] = *reinterpret_cast<const float4*>(a_s + (ty + 8 * r) * lda +
                                                 k0 + kk);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* brow = b_s + (kk + q) * ldn + tx;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float bv = brow[32 * j];
#pragma unroll
          for (int r = 0; r < kBRows; ++r) {
            const float av = q == 0 ? a4[r].x
                           : q == 1 ? a4[r].y
                           : q == 2 ? a4[r].z
                                    : a4[r].w;
            part[r][j] = fmaf(av, bv, part[r][j]);
          }
        }
      }
    }
  }
}

template <int CPT>
__global__ void __launch_bounds__(kThreads)
bilinear_fwd_kernel(const float* __restrict__ xj, const float* __restrict__ a,
                    const float* __restrict__ w,
                    const float* __restrict__ mask, float* __restrict__ out,
                    Geometry g, int kc) {
  constexpr int ldn = 32 * CPT;
  const int ldx = round4(g.d);
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // kBTE x ldx
  float* b_s = x_s + kBTE * ldx;                 // kc x ldn
  float* sc_s = b_s + kc * ldn;                  // kBTE

  const long long e0 = (long long)blockIdx.x * kBTE;
  if (!load_scale(mask, e0, g.e, sc_s)) return;
  load_rows(xj, e0, g.d, ldx, sc_s, false, x_s);

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  float acc[kBRows][CPT], part[kBRows][CPT];
#pragma unroll
  for (int r = 0; r < kBRows; ++r) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
  }
  for (int h = 0; h <= g.h; ++h) {
    unit_gemm<CPT>(x_s, ldx, g.d, w + (long long)h * g.d * g.k, g.k, kc, b_s,
                   part);
#pragma unroll
    for (int r = 0; r < kBRows; ++r) {
      const int row = ty + 8 * r;
      const float ah = unit_weight(a, e0 + row, h, g, sc_s[row]);
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(ah, part[r][j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < kBRows; ++r) {
    const int row = ty + 8 * r;
    const float s = sc_s[row];
    if (s == 0.f) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 32 * j;
      if (c < g.k) out[(e0 + row) * g.k + c] = s * acc[r][j];
    }
  }
}

// wt holds W[h]^T (K x D) for each unit, (H+1) x K x D.
template <int CPT>
__global__ void __launch_bounds__(kThreads)
bilinear_bwd_kernel(const float* __restrict__ xj, const float* __restrict__ a,
                    const float* __restrict__ wt,
                    const float* __restrict__ mask,
                    const float* __restrict__ gout, float* __restrict__ dxj,
                    float* __restrict__ da, Geometry g, int kc) {
  constexpr int ldn = 32 * CPT;
  const int ldk = round4(g.k);
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // kBTE x ldn: xj
  float* g_s = x_s + kBTE * ldn;                 // kBTE x ldk: ge
  float* b_s = g_s + kBTE * ldk;                 // kc x ldn
  float* sc_s = b_s + kc * ldn;                  // kBTE

  const long long e0 = (long long)blockIdx.x * kBTE;
  if (!load_scale(mask, e0, g.e, sc_s)) return;
  load_rows(xj, e0, g.d, ldn, sc_s, false, x_s);
  load_rows(gout, e0, g.k, ldk, sc_s, true, g_s);

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  float dx[kBRows][CPT], u[kBRows][CPT];
#pragma unroll
  for (int r = 0; r < kBRows; ++r) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) dx[r][j] = 0.f;
  }
  for (int h = 0; h <= g.h; ++h) {
    unit_gemm<CPT>(g_s, ldk, g.k, wt + (long long)h * g.k * g.d, g.d, kc, b_s,
                   u);
#pragma unroll
    for (int r = 0; r < kBRows; ++r) {
      const int row = ty + 8 * r;
      const float ah = unit_weight(a, e0 + row, h, g, sc_s[row]);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        dx[r][j] = fmaf(ah, u[r][j], dx[r][j]);
        dot = fmaf(x_s[row * ldn + tx + 32 * j], u[r][j], dot);
      }
      if (h < g.h) {  // uniform across the block
        dot = warp_sum(dot);
        if (tx == 0 && sc_s[row] != 0.f) da[(e0 + row) * g.h + h] = dot;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kBRows; ++r) {
    const int row = ty + 8 * r;
    if (sc_s[row] == 0.f) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 32 * j;
      if (c < g.d) dxj[(e0 + row) * g.d + c] = dx[r][j];
    }
  }
}

// Work item i of slices * S: slice = i % slices covers rows r0 = 64 *
// slice .. r0 + 63 of the flat ((H+1)*D x K) dW, row h*D + d being unit h's
// row d (a slice may span two units); split s = i / slices walks the edge
// tiles s, s + S, s + 2S, ... in order. Thread (tx, ty) owns rows r0 + 8 *
// ty + i (i < 8) and columns tx + 32j. Items that run at the same time
// share their split, so their reads of xj and ge meet in L2. partial holds
// S copies of dW, counts one zero per slice.
template <int CPT>
__global__ void __launch_bounds__(kThreads)
bilinear_wgrad_kernel(const float* __restrict__ xj,
                      const float* __restrict__ a,
                      const float* __restrict__ mask,
                      const float* __restrict__ gout,
                      float* __restrict__ partial, int* __restrict__ counts,
                      float* __restrict__ dw, Geometry g, int splits) {
  constexpr int ldn = 32 * CPT;
  __shared__ __align__(16) float x_s[kWTE * kWRows];  // X[e, r0..r0+63]
  __shared__ __align__(16) float g_s[kWTE * ldn];     // ge[e]
  __shared__ float sc_s[kWTE];
  __shared__ int last;

  const int rows = (g.h + 1) * g.d;
  const int slices = (rows + kWRows - 1) / kWRows;
  const long long items = (long long)slices * splits;
  const long long tiles = (g.e + kWTE - 1) / kWTE;
  const long long plane = (long long)rows * g.k;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  // the X column this thread loads (kThreads is a multiple of kWRows)
  const int col = threadIdx.x % kWRows;

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int slice = (int)(item % slices);
    const int s = (int)(item / slices);
    const int r0 = slice * kWRows;
    const int fr = r0 + col;
    const int uh = fr / g.d;  // unit and row of W this thread's column is
    const int ud = fr - uh * g.d;
    float acc[8][CPT];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
    }
    for (long long t = s; t < tiles; t += splits) {
      const long long e0 = t * kWTE;
      // sc_s is read only before the second barrier below, which every
      // thread of the previous step has passed
      bool real = false;
      if (threadIdx.x < kWTE) {
        const long long e = e0 + threadIdx.x;
        const float m = e < g.e ? mask[e] : 0.f;
        sc_s[threadIdx.x] = m;
        real = m != 0.f;
      }
      // every thread is also done reading the previous step's x_s and g_s
      if (!__syncthreads_or(real)) continue;
      for (int i = threadIdx.x; i < kWTE * kWRows; i += kThreads) {
        const int r = i / kWRows;
        const long long e = e0 + r;
        const float m = sc_s[r];
        x_s[i] = (m != 0.f && fr < rows)
                     ? unit_weight(a, e, uh, g, m) * xj[e * g.d + ud]
                     : 0.f;
      }
      for (int i = threadIdx.x; i < kWTE * ldn; i += kThreads) {
        const int r = i / ldn;
        const int c = i - r * ldn;
        const float m = sc_s[r];
        g_s[i] = (m != 0.f && c < g.k) ? m * gout[(e0 + r) * g.k + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kWTE; ++r) {
        const float4 x0 =
            *reinterpret_cast<const float4*>(x_s + r * kWRows + 8 * ty);
        const float4 x1 =
            *reinterpret_cast<const float4*>(x_s + r * kWRows + 8 * ty + 4);
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float gv = g_s[r * ldn + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(xv[i], gv, acc[i][j]);
        }
      }
    }

    // this split's rows, then the last item of the slice adds all S
    float* mine = partial + s * plane + (long long)r0 * g.k;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (r0 + 8 * ty + i >= rows) continue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 32 * j;
        if (c < g.k) mine[(8 * ty + i) * g.k + c] = acc[i][j];
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counts + slice, 1) == splits - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      const long long base = (long long)r0 * g.k;
      const int n = min(kWRows, rows - r0) * g.k;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        float v = 0.f;
        for (int p = 0; p < splits; ++p) {
          v += __ldcg(partial + p * plane + base + i);
        }
        dw[base + i] = v;
      }
    }
    __syncthreads();  // `last` is rewritten by the next item
  }
}

template <int CPT>
int launch_fwd(const float* xj, const float* a, const float* w,
               const float* mask, float* out, const Geometry& g,
               cudaStream_t s) {
  const int ldn = 32 * CPT;
  const int kc = chunk_rows(g.d, ldn);
  const size_t smem =
      sizeof(float) * ((size_t)kBTE * round4(g.d) + (size_t)kc * ldn + kBTE);
  if (smem > (size_t)kMaxShared) return kBadShape;
  cudaError_t err = cudaFuncSetAttribute(
      bilinear_fwd_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + kBTE - 1) / kBTE;
  bilinear_fwd_kernel<CPT><<<(unsigned)tiles, kThreads, smem, s>>>(
      xj, a, w, mask, out, g, kc);
  return (int)cudaGetLastError();
}

template <int CPT>
int launch_bwd(const float* xj, const float* a, const float* wt,
               const float* mask, const float* gout, float* dxj, float* da,
               const Geometry& g, cudaStream_t s) {
  const int ldn = 32 * CPT;
  const int kc = chunk_rows(g.k, ldn);
  const size_t smem =
      sizeof(float) * ((size_t)kBTE * ldn + (size_t)kBTE * round4(g.k) +
                       (size_t)kc * ldn + kBTE);
  if (smem > (size_t)kMaxShared) return kBadShape;
  cudaError_t err = cudaFuncSetAttribute(
      bilinear_bwd_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + kBTE - 1) / kBTE;
  bilinear_bwd_kernel<CPT><<<(unsigned)tiles, kThreads, smem, s>>>(
      xj, a, wt, mask, gout, dxj, da, g, kc);
  return (int)cudaGetLastError();
}

// Slices of the flat dW: blocks of kWRows of its (H+1)*D rows.
int wgrad_slices(int d, int h) { return ((h + 1) * d + kWRows - 1) / kWRows; }

// Blocks of bilinear_wgrad_kernel<CPT> the card holds at once.
template <int CPT>
int wgrad_slots(int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bilinear_wgrad_kernel<CPT>, kThreads, 0);
  }
  *slots = sms * per_sm;
  return (int)err;
}

template <int CPT>
int launch_wgrad(const float* xj, const float* a, const float* mask,
                 const float* gout, float* partial, int* counts, float* dw,
                 const Geometry& g, int splits, cudaStream_t s) {
  int slots = 0;
  const int err = wgrad_slots<CPT>(&slots);
  if (err != 0) return err;
  const long long items = (long long)wgrad_slices(g.d, g.h) * splits;
  const unsigned grid = (unsigned)(items < slots ? items : slots);
  bilinear_wgrad_kernel<CPT><<<grid < 1 ? 1 : grid, kThreads, 0, s>>>(
      xj, a, mask, gout, partial, counts, dw, g, splits);
  return (int)cudaGetLastError();
}

Geometry make_geometry(long long e, int d, int k, int h) {
  Geometry g;
  g.e = e; g.d = d; g.k = k; g.h = h;
  return g;
}

}  // namespace

extern "C" {

// Slices of the flat dW: its counts buffer holds this many ints.
int mdl_fused_bilinear_wgrad_slices(int d, int h) {
  return wgrad_slices(d, h);
}

// Edge splits S of the dW kernel for these shapes on the current device:
// about kItemsPerSlot work items per block the card holds at once, at
// most one split per edge tile. Returns S >= 1, or minus a cudaError_t.
int mdl_fused_bilinear_wgrad_splits(long long e, int d, int k, int h) {
  int slots = 0, err = 0;
  switch (cpt_for(k)) {
    case 1: err = wgrad_slots<1>(&slots); break;
    case 2: err = wgrad_slots<2>(&slots); break;
    case 4: err = wgrad_slots<4>(&slots); break;
    case 5: err = wgrad_slots<5>(&slots); break;
    case 8: err = wgrad_slots<8>(&slots); break;
    default: return -kBadShape;
  }
  if (err != 0) return -err;
  const long long slices = wgrad_slices(d, h);
  const long long tiles = (e + kWTE - 1) / kWTE;
  long long s = ((long long)kItemsPerSlot * slots + slices - 1) / slices;
  if (s > tiles) s = tiles;
  return s < 1 ? 1 : (int)s;
}

// All pointers are device pointers on the current device. xj (e x d), a
// (e x h), mask (e); w ((h+1)*d x k) is [W1; b1] with W1 as (h*d x k);
// out (e x k) holds zeros. Returns 0 or a cudaError_t (kBadShape for an
// unsupported width or shared-memory size).
int mdl_fused_bilinear_fwd(const void* xj, const void* a, const void* w,
                           const void* mask, void* out, long long e, int d,
                           int k, int h, void* stream) {
  const Geometry g = make_geometry(e, d, k, h);
  const float* xp = static_cast<const float*>(xj);
  const float* ap = static_cast<const float*>(a);
  const float* wp = static_cast<const float*>(w);
  const float* mp = static_cast<const float*>(mask);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpt_for(d) == 0) return kBadShape;
  switch (cpt_for(k)) {
    case 1: return launch_fwd<1>(xp, ap, wp, mp, op, g, s);
    case 2: return launch_fwd<2>(xp, ap, wp, mp, op, g, s);
    case 4: return launch_fwd<4>(xp, ap, wp, mp, op, g, s);
    case 5: return launch_fwd<5>(xp, ap, wp, mp, op, g, s);
    case 8: return launch_fwd<8>(xp, ap, wp, mp, op, g, s);
    default: return kBadShape;
  }
}

// wt ((h+1) x k x d) holds each unit of [W1; b1] transposed; gout (e x k);
// dxj (e x d) and da (e x h) hold zeros.
int mdl_fused_bilinear_bwd(const void* xj, const void* a, const void* wt,
                           const void* mask, const void* gout, void* dxj,
                           void* da, long long e, int d, int k, int h,
                           void* stream) {
  const Geometry g = make_geometry(e, d, k, h);
  const float* xp = static_cast<const float*>(xj);
  const float* ap = static_cast<const float*>(a);
  const float* wp = static_cast<const float*>(wt);
  const float* mp = static_cast<const float*>(mask);
  const float* gp = static_cast<const float*>(gout);
  float* dxp = static_cast<float*>(dxj);
  float* dap = static_cast<float*>(da);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpt_for(k) == 0) return kBadShape;
  switch (cpt_for(d)) {
    case 1: return launch_bwd<1>(xp, ap, wp, mp, gp, dxp, dap, g, s);
    case 2: return launch_bwd<2>(xp, ap, wp, mp, gp, dxp, dap, g, s);
    case 4: return launch_bwd<4>(xp, ap, wp, mp, gp, dxp, dap, g, s);
    case 5: return launch_bwd<5>(xp, ap, wp, mp, gp, dxp, dap, g, s);
    case 8: return launch_bwd<8>(xp, ap, wp, mp, gp, dxp, dap, g, s);
    default: return kBadShape;
  }
}

// dw ((h+1)*d x k) = [dW1; db1]. partial holds splits * (h+1)*d*k floats,
// counts mdl_fused_bilinear_wgrad_slices(d, h) zeros; splits as
// mdl_fused_bilinear_wgrad_splits gives it (any splits >= 1 is right).
int mdl_fused_bilinear_wgrad(const void* xj, const void* a, const void* mask,
                             const void* gout, void* partial, void* counts,
                             void* dw, long long e, int d, int k, int h,
                             int splits, void* stream) {
  const Geometry g = make_geometry(e, d, k, h);
  const float* xp = static_cast<const float*>(xj);
  const float* ap = static_cast<const float*>(a);
  const float* mp = static_cast<const float*>(mask);
  const float* gp = static_cast<const float*>(gout);
  float* pp = static_cast<float*>(partial);
  int* cp = static_cast<int*>(counts);
  float* dwp = static_cast<float*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpt_for(d) == 0 || splits < 1) return kBadShape;
  switch (cpt_for(k)) {
    case 1: return launch_wgrad<1>(xp, ap, mp, gp, pp, cp, dwp, g, splits, s);
    case 2: return launch_wgrad<2>(xp, ap, mp, gp, pp, cp, dwp, g, splits, s);
    case 4: return launch_wgrad<4>(xp, ap, mp, gp, pp, cp, dwp, g, splits, s);
    case 5: return launch_wgrad<5>(xp, ap, mp, gp, pp, cp, dwp, g, splits, s);
    case 8: return launch_wgrad<8>(xp, ap, mp, gp, pp, cp, dwp, g, splits, s);
    default: return kBadShape;
  }
}

}  // extern "C"
