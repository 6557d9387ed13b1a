// Fused SchNet cfconv forward and backward kernels for Hopper (sm_90a), with
// a plain C interface for ctypes (bound in matdeeplearn_torch/ops/fused_cfconv.py).
//
// mdl_fused_cfconv_fwd replaces the reference package's
// ops/pallas_fused_schnet.py:_fwd_kernel, and mdl_fused_cfconv_bwd together
// with mdl_fused_cfconv_wgrad_reduce replaces :_bwd_kernel.
//
// Per real edge e (mask[e] != 0, 0 <= dst[e] < n), with i = dst[e]:
//   b[e]  = [ek(dist[e]) | 1]                   (De + 1 columns)
//   ek_k  = exp(coeff * (dist[e] - k*step)^2),   k < De
//   pre   = b[e] · W0e                          (W0e = [W0; b0]: De+1 x F)
//   a     = ssp(pre) = softplus(pre) - ln 2      (unthresholded softplus)
//   w     = [a | 1] · W1e                       (W1e = [W1; b1]: F+1 x F)
//   s[e]  = mask[e] * 0.5 * (cos(d_raw[e] * scale) + 1),  scale = pi / cutoff
//   out[i] += xj[e] * w * s[e]
// The backward recomputes pre, a and w, then with gg = g[i]:
//   d_xj[e] = gg * w * s[e],  dw = gg * xj[e] * s[e]
//   dpre    = (dw · W1^T) * sigmoid(pre)     (ssp' = sigmoid)
//   dW1e   += [a | 1]^T · dw,  dW0e += b[e]^T · dpre  (bias rows last)
// An edge whose s is 0 (masked, dst out of range, or d_raw at the cutoff)
// adds nothing to any output, so its row is skipped: a tile of TE edges
// with none left costs one barrier, and d_xj keeps the caller's zeros on
// every masked edge.
//
// Bound: operations. At SchNet_demo width (F 150, De 50) a real edge costs
// 2*(51 + 151)*150 ≈ 61k FLOP forward and about 2.7 times that backward,
// against ~0.6 KB of inputs and outputs (the xj row, d_xj, two distances),
// far above the card's f32 operations-per-byte line. Every intermediate
// stays on chip:
//
// * One block of 256 threads owns a tile of TE = 32 edges. It computes the
//   basis tile in shared memory, runs the first GEMM against W0e, writes
//   [ssp(pre) | 1] as the second GEMM's left operand into shared memory and
//   runs the second GEMM against W1e. Each GEMM streams its right operand
//   through shared memory in chunks of 32 rows; thread (tx, ty) of the 8
//   warps accumulates rows ty + 8r (r < 4) and columns tx + 32j (j < CPT)
//   in registers, reading the left tile as float4 broadcasts and the right
//   rows as consecutive floats. Plain f32 FMA; no tensor cores (a later
//   PR's speed work). At F = 150 the threads cover 160 columns (CPT 5) and
//   10 idle; the largest F is 256.
// * The forward's node sums go through the run-flush epilogue of csr.cu's
//   segment sum (edge_tile.cuh, shared with fused_cgconv.cu): the tile's
//   messages are staged in shared memory, one thread per column walks the
//   32 rows, adds runs of equal dst and flushes each run with one
//   atomicAdd. Right for any dst order; on dst-sorted edges about one
//   atomic per node and column. There is no node-side gradient: messages
//   depend on the source row xj alone.
// * The weight gradients are sums over every edge of the batch. The
//   backward runs a persistent grid (about two blocks per SM); each block
//   walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... and adds each
//   tile's b^T · dpre and [a | 1]^T · dw into its own slice of a partial
//   buffer in device memory (no atomics, 4 x 4 register micro-tiles, float4
//   traffic). mdl_fused_cfconv_wgrad_reduce sums the slices in a fixed
//   order (edge_tile.cuh). dw · W1^T needs W1 transposed: the caller
//   passes W1T.
//
// The caller zeroes out, d_xj and the partial buffer, and allocates
// everything; the kernels never synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile.cuh"

namespace {

constexpr float kLog2 = 0.6931471805599453f;

struct Geometry {
  long long e;  // edge slots
  int f;        // filter width F
  int de;       // Gaussian basis size De
  int n;        // node slots
  int ldz0;     // round4(De + 1): row stride of the basis tile [ek | 1]
  int ldz1;     // round4(F + 1): row stride of the hidden tile [a | 1]
  int ldn;      // round4(F): row stride of F-wide tiles
  float coeff;  // -0.5 / width^2
  float step;   // 1 / (De - 1): the basis offsets are k * step
  float scale;  // pi / cutoff
};

Geometry make_geometry(long long e, int f, int de, int n, float coeff,
                       float step, float scale) {
  Geometry g;
  g.e = e; g.f = f; g.de = de; g.n = n;
  g.ldz0 = round4(de + 1);
  g.ldz1 = round4(f + 1);
  g.ldn = round4(f);
  g.coeff = coeff; g.step = step; g.scale = scale;
  return g;
}

// Shifted softplus: ssp(a) = softplus(a) - ln 2.
__device__ __forceinline__ float sspf(float a) { return softplusf(a) - kLog2; }

// Loads the tile's row scales s = mask * cutoff and destinations into
// shared memory (s is 0 for a masked edge, one whose dst lies outside
// [0, n), and a slot past the end) and returns, uniformly across the
// block, whether any row of it is left.
__device__ bool load_edges(const int* __restrict__ dst,
                           const float* __restrict__ mask,
                           const float* __restrict__ wraw, long long e0,
                           const Geometry& g, float* sc_s, int* dst_s) {
  bool real = false;
  if (threadIdx.x < kTE) {
    const long long e = e0 + threadIdx.x;
    float s = 0.f;
    int node = 0;
    if (e < g.e) {
      node = dst[e];
      const float m = mask != nullptr ? mask[e] : 1.f;
      if (m != 0.f && node >= 0 && node < g.n) {
        s = m * (0.5f * (cosf(wraw[e] * g.scale) + 1.f));
      }
    }
    sc_s[threadIdx.x] = s;
    dst_s[threadIdx.x] = node;
    real = s != 0.f;
  }
  return __syncthreads_or(real) != 0;
}

// Basis tile [ek(dist) | 1 | zero pad to ldz0]; zero rows for skipped edges.
__device__ void load_basis(const float* __restrict__ dist, long long e0,
                           const Geometry& g, const float* sc_s,
                           float* e_s) {
  for (int i = threadIdx.x; i < kTE * g.ldz0; i += kThreads) {
    const int r = i / g.ldz0;
    const int k = i - r * g.ldz0;
    float v = 0.f;
    if (sc_s[r] != 0.f) {
      if (k < g.de) {
        const float diff = dist[e0 + r] - (float)k * g.step;
        v = expf(g.coeff * diff * diff);
      } else if (k == g.de) {
        v = 1.f;
      }
    }
    e_s[i] = v;
  }
}

// acc[r][j] = Σ_k a[row][k] * b[k][c] for row = ty + 8r and c = tx + 32j < nb.
// a_s is a kTE x lda tile in shared memory (lda >= round4(ka)) whose
// columns from ka to round4(ka) are zero; b is a ka x nb row-major matrix
// in device memory, streamed through b_s (kKC x ldn, ldn >= nb). Starts
// with a barrier, so the caller's writes to a_s are visible, and leaves b_s
// in use.
template <int CPT>
__device__ void tile_gemm(const float* __restrict__ a_s, int lda, int ka,
                          const float* __restrict__ b, int nb,
                          float* __restrict__ b_s, int ldn,
                          float (&acc)[kRows][CPT]) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
  }
  for (int k0 = 0; k0 < ka; k0 += kKC) {
    __syncthreads();
    for (int i = threadIdx.x; i < kKC * ldn; i += kThreads) {
      const int kk = i / ldn;
      const int c = i - kk * ldn;
      b_s[i] = (k0 + kk < ka && c < nb) ? b[(long long)(k0 + kk) * nb + c]
                                        : 0.f;
    }
    __syncthreads();
    const int kend = min(kKC, round4(ka - k0));
    for (int kk = 0; kk < kend; kk += 4) {
      float4 a4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        a4[r] = *reinterpret_cast<const float4*>(a_s + (ty + 8 * r) * lda +
                                                 k0 + kk);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* brow = b_s + (kk + q) * ldn;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = tx + 32 * j;
          const float bv = c < nb ? brow[c] : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float av = q == 0 ? a4[r].x
                           : q == 1 ? a4[r].y
                           : q == 2 ? a4[r].z
                                    : a4[r].w;
            acc[r][j] = fmaf(av, bv, acc[r][j]);
          }
        }
      }
    }
  }
}

// Hidden tile [ssp(pre) | 1 | zero pad to ldz1]; zero rows for skipped
// edges. The caller's next tile_gemm begins with the barrier that makes it
// visible.
template <int CPT>
__device__ void store_hidden(const float (&pre)[kRows][CPT],
                             const Geometry& g, const float* sc_s,
                             float* a_s) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = ty + 8 * r;
    const bool real = sc_s[row] != 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 32 * j;
      if (c < g.f) a_s[row * g.ldz1 + c] = real ? sspf(pre[r][j]) : 0.f;
    }
  }
  const int tail = g.ldz1 - g.f;  // 1 to 4 columns: the ones, then zeros
  for (int i = threadIdx.x; i < kTE * tail; i += kThreads) {
    const int r = i / tail;
    const int k = i - r * tail;
    a_s[r * g.ldz1 + g.f + k] = (k == 0 && sc_s[r] != 0.f) ? 1.f : 0.f;
  }
}

template <int CPT>
__global__ void __launch_bounds__(kThreads)
fused_cfconv_fwd_kernel(const float* __restrict__ xj,
                        const float* __restrict__ dist,
                        const float* __restrict__ wraw,
                        const int* __restrict__ dst,
                        const float* __restrict__ mask,
                        const float* __restrict__ w0,
                        const float* __restrict__ w1,
                        float* __restrict__ out, Geometry g) {
  extern __shared__ float4 smem4[];
  float* e_s = reinterpret_cast<float*>(smem4);
  float* a_s = e_s + kTE * g.ldz0;
  float* b_s = a_s + kTE * g.ldz1;
  float* sc_s = b_s + kKC * g.ldn;
  int* dst_s = reinterpret_cast<int*>(sc_s + kTE);

  const long long e0 = (long long)blockIdx.x * kTE;
  if (!load_edges(dst, mask, wraw, e0, g, sc_s, dst_s)) return;
  load_basis(dist, e0, g, sc_s, e_s);

  float acc[kRows][CPT];
  tile_gemm<CPT>(e_s, g.ldz0, g.de + 1, w0, g.f, b_s, g.ldn, acc);
  store_hidden<CPT>(acc, g, sc_s, a_s);
  tile_gemm<CPT>(a_s, g.ldz1, g.f + 1, w1, g.f, b_s, g.ldn, acc);
  __syncthreads();  // a_s is free: stage the messages there (ldz1 > F)

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  float* msg_s = a_s;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = ty + 8 * r;
    const float s = sc_s[row];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 32 * j;
      if (c < g.f) {
        msg_s[row * g.f + c] =
            s != 0.f ? xj[(e0 + row) * g.f + c] * acc[r][j] * s : 0.f;
      }
    }
  }
  __syncthreads();
  flush_runs(msg_s, g.f, sc_s, dst_s, out);
}

template <int CPT>
__global__ void __launch_bounds__(kThreads)
fused_cfconv_bwd_kernel(const float* __restrict__ xj,
                        const float* __restrict__ dist,
                        const float* __restrict__ wraw,
                        const int* __restrict__ dst,
                        const float* __restrict__ mask,
                        const float* __restrict__ w0,
                        const float* __restrict__ w1,
                        const float* __restrict__ w1t,
                        const float* __restrict__ gout,
                        float* __restrict__ dxj,
                        float* __restrict__ partial, Geometry g,
                        long long num_tiles) {
  extern __shared__ float4 smem4[];
  float* e_s = reinterpret_cast<float*>(smem4);
  float* a_s = e_s + kTE * g.ldz0;
  float* dw_s = a_s + kTE * g.ldz1;
  float* dp_s = dw_s + kTE * g.ldn;
  float* b_s = dp_s + kTE * g.ldn;
  float* sc_s = b_s + kKC * g.ldn;
  int* dst_s = reinterpret_cast<int*>(sc_s + kTE);

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  // columns F..ldn-1 of dw_s and dp_s are never written: zero them once
  for (int i = threadIdx.x; i < 2 * kTE * g.ldn; i += kThreads) dw_s[i] = 0.f;
  const int cgroups = g.ldn / 4;
  const int kg0 = g.ldz0 / 4;                        // dW0e micro-tile rows
  const int tiles_w = (kg0 + g.ldz1 / 4) * cgroups;  // 4 x 4 micro-tiles
  float4* part = reinterpret_cast<float4*>(partial) +
                 (long long)blockIdx.x * tiles_w * 4;

  for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long e0 = tile * kTE;
    __syncthreads();  // the previous tile's readers are done
    if (!load_edges(dst, mask, wraw, e0, g, sc_s, dst_s)) continue;
    load_basis(dist, e0, g, sc_s, e_s);

    float pre[kRows][CPT], acc[kRows][CPT];
    tile_gemm<CPT>(e_s, g.ldz0, g.de + 1, w0, g.f, b_s, g.ldn, pre);
    store_hidden<CPT>(pre, g, sc_s, a_s);
    tile_gemm<CPT>(a_s, g.ldz1, g.f + 1, w1, g.f, b_s, g.ldn, acc);

    // d_xj = gg * w * s straight to device memory; dw = gg * xj * s
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty + 8 * r;
      const float s = sc_s[row];
      const long long e = e0 + row;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 32 * j;
        if (c < g.f) {
          float dwv = 0.f;
          if (s != 0.f) {
            const float gg = gout[(long long)dst_s[row] * g.f + c] * s;
            dxj[e * g.f + c] = gg * acc[r][j];
            dwv = gg * xj[e * g.f + c];
          }
          dw_s[row * g.ldn + c] = dwv;
        }
      }
    }

    // dpre = (dw · W1^T) * sigmoid(pre)
    tile_gemm<CPT>(dw_s, g.ldn, g.f, w1t, g.f, b_s, g.ldn, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty + 8 * r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 32 * j;
        if (c < g.f) dp_s[row * g.ldn + c] = acc[r][j] * sigmoidf(pre[r][j]);
      }
    }
    __syncthreads();

    // this block's slice of [dW0e; dW1e] += [b^T · dpre; [a | 1]^T · dw]
    for (int m = threadIdx.x; m < tiles_w; m += kThreads) {
      const int kgi = m / cgroups;
      const int c = (m - kgi * cgroups) * 4;
      const bool first = kgi < kg0;
      const float* z_s = first ? e_s : a_s;
      const float* d_s = first ? dp_s : dw_s;
      const int ldz = first ? g.ldz0 : g.ldz1;
      const int k = (first ? kgi : kgi - kg0) * 4;
      float acc4[4][4] = {};
      for (int r = 0; r < kTE; ++r) {
        if (sc_s[r] == 0.f) continue;
        const float4 zv = *reinterpret_cast<const float4*>(z_s + r * ldz + k);
        const float4 dv = *reinterpret_cast<const float4*>(d_s + r * g.ldn + c);
        const float zr[4] = {zv.x, zv.y, zv.z, zv.w};
        const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc4[i][q] = fmaf(zr[i], dr[q], acc4[i][q]);
        }
      }
      float4* p = part + (long long)m * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 v = p[i];
        v.x += acc4[i][0];
        v.y += acc4[i][1];
        v.z += acc4[i][2];
        v.w += acc4[i][3];
        p[i] = v;
      }
    }
  }
}

size_t fwd_shared_bytes(const Geometry& g) {
  return sizeof(float) * ((size_t)kTE * g.ldz0 + (size_t)kTE * g.ldz1 +
                          (size_t)kKC * g.ldn + kTE) +
         sizeof(int) * kTE;
}

size_t bwd_shared_bytes(const Geometry& g) {
  return fwd_shared_bytes(g) + sizeof(float) * 2 * (size_t)kTE * g.ldn;
}

template <int CPT>
int launch_fwd(const float* xj, const float* dist, const float* wraw,
               const int* dst, const float* mask, const float* w0,
               const float* w1, float* out, const Geometry& g,
               cudaStream_t s) {
  const size_t smem = fwd_shared_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cfconv_fwd_kernel<CPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + kTE - 1) / kTE;
  fused_cfconv_fwd_kernel<CPT><<<(unsigned)tiles, kThreads, smem, s>>>(
      xj, dist, wraw, dst, mask, w0, w1, out, g);
  return (int)cudaGetLastError();
}

template <int CPT>
int launch_bwd(const float* xj, const float* dist, const float* wraw,
               const int* dst, const float* mask, const float* w0,
               const float* w1, const float* w1t, const float* gout,
               float* dxj, float* partial, const Geometry& g, int blocks,
               cudaStream_t s) {
  const size_t smem = bwd_shared_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cfconv_bwd_kernel<CPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + kTE - 1) / kTE;
  fused_cfconv_bwd_kernel<CPT><<<(unsigned)blocks, kThreads, smem, s>>>(
      xj, dist, wraw, dst, mask, w0, w1, w1t, gout, dxj, partial, g, tiles);
  return (int)cudaGetLastError();
}

// Columns a thread owns (of 32 * CPT): the smallest instantiated CPT that
// covers F, or 0 when F > 256.
int cpt_for(int f) {
  const int need = (f + 31) / 32;
  if (need <= 1) return 1;
  if (need <= 2) return 2;
  if (need <= 4) return 4;
  if (need <= 5) return 5;
  if (need <= 8) return 8;
  return 0;
}

constexpr int kBadShape = 1001;  // F > 256 or shared memory over the limit

}  // namespace

extern "C" {

// Floats per block of the weight gradients' partial buffer (the caller
// allocates blocks times that many zeros).
long long mdl_fused_cfconv_partial_floats(int f, int de) {
  const Geometry g = make_geometry(0, f, de, 0, 0.f, 0.f, 0.f);
  return (long long)(g.ldz0 + g.ldz1) * g.ldn;
}

// All pointers are device pointers on the current device. w0 is the
// (De+1) x F extended weight [W0; b0], w1 the (F+1) x F [W1; b1]; out holds
// n*f zeros; mask may be null (every edge real). Returns 0 or a
// cudaError_t (kBadShape for an unsupported F or shared-memory size).
int mdl_fused_cfconv_fwd(const void* xj, const void* dist, const void* wraw,
                         const void* dst, const void* mask, const void* w0,
                         const void* w1, void* out, long long e, int f,
                         int de, int n, float coeff, float step, float scale,
                         void* stream) {
  const Geometry g = make_geometry(e, f, de, n, coeff, step, scale);
  if (fwd_shared_bytes(g) > (size_t)kMaxShared) return kBadShape;
  const float* xp = static_cast<const float*>(xj);
  const float* dp = static_cast<const float*>(dist);
  const float* rp = static_cast<const float*>(wraw);
  const int* dsp = static_cast<const int*>(dst);
  const float* mp = static_cast<const float*>(mask);
  const float* w0p = static_cast<const float*>(w0);
  const float* w1p = static_cast<const float*>(w1);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cpt_for(f)) {
    case 1: return launch_fwd<1>(xp, dp, rp, dsp, mp, w0p, w1p, op, g, s);
    case 2: return launch_fwd<2>(xp, dp, rp, dsp, mp, w0p, w1p, op, g, s);
    case 4: return launch_fwd<4>(xp, dp, rp, dsp, mp, w0p, w1p, op, g, s);
    case 5: return launch_fwd<5>(xp, dp, rp, dsp, mp, w0p, w1p, op, g, s);
    case 8: return launch_fwd<8>(xp, dp, rp, dsp, mp, w0p, w1p, op, g, s);
    default: return kBadShape;
  }
}

// w1t is W1^T (F x F); gout (n x f); dxj (e x f) holds zeros; partial holds
// blocks * mdl_fused_cfconv_partial_floats(f, de) zeros.
int mdl_fused_cfconv_bwd(const void* xj, const void* dist, const void* wraw,
                         const void* dst, const void* mask, const void* w0,
                         const void* w1, const void* w1t, const void* gout,
                         void* dxj, void* partial, long long e, int f, int de,
                         int n, float coeff, float step, float scale,
                         int blocks, void* stream) {
  const Geometry g = make_geometry(e, f, de, n, coeff, step, scale);
  if (bwd_shared_bytes(g) > (size_t)kMaxShared || blocks < 1) return kBadShape;
  const float* xp = static_cast<const float*>(xj);
  const float* dp = static_cast<const float*>(dist);
  const float* rp = static_cast<const float*>(wraw);
  const int* dsp = static_cast<const int*>(dst);
  const float* mp = static_cast<const float*>(mask);
  const float* w0p = static_cast<const float*>(w0);
  const float* w1p = static_cast<const float*>(w1);
  const float* w1tp = static_cast<const float*>(w1t);
  const float* gp = static_cast<const float*>(gout);
  float* dxp = static_cast<float*>(dxj);
  float* pp = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cpt_for(f)) {
    case 1: return launch_bwd<1>(xp, dp, rp, dsp, mp, w0p, w1p, w1tp, gp, dxp, pp, g, blocks, s);
    case 2: return launch_bwd<2>(xp, dp, rp, dsp, mp, w0p, w1p, w1tp, gp, dxp, pp, g, blocks, s);
    case 4: return launch_bwd<4>(xp, dp, rp, dsp, mp, w0p, w1p, w1tp, gp, dxp, pp, g, blocks, s);
    case 5: return launch_bwd<5>(xp, dp, rp, dsp, mp, w0p, w1p, w1tp, gp, dxp, pp, g, blocks, s);
    case 8: return launch_bwd<8>(xp, dp, rp, dsp, mp, w0p, w1p, w1tp, gp, dxp, pp, g, blocks, s);
    default: return kBadShape;
  }
}

// dw ((round4(De+1) + round4(F+1)) x F) = the sum over blocks of the
// backward's partials: rows 0..De are [dW0; db0], rows round4(De+1) ..
// round4(De+1)+F are [dW1; db1], the rest zero.
int mdl_fused_cfconv_wgrad_reduce(const void* partial, void* dw, int blocks,
                                  int f, int de, void* stream) {
  const Geometry g = make_geometry(0, f, de, 0, 0.f, 0.f, 0.f);
  const int cgroups = g.ldn / 4;
  const int rows = g.ldz0 + g.ldz1;
  return launch_wgrad_reduce(partial, dw, blocks, (rows / 4) * cgroups,
                             cgroups, rows, f, stream);
}

}  // extern "C"
