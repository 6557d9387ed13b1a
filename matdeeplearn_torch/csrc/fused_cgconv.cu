// Fused CGConv forward and backward kernels for Hopper (sm_90a), with a
// plain C interface for ctypes (bound in matdeeplearn_torch/ops/fused_cgconv.py).
//
// mdl_fused_cgconv_fwd replaces the reference package's
// ops/pallas_fused.py:_fwd_kernel, and mdl_fused_cgconv_bwd together with
// mdl_fused_cgconv_wgrad_reduce replaces ops/pallas_fused.py:_bwd_kernel.
//
// Per real edge e (mask[e] != 0, 0 <= dst[e] < n), with i = dst[e]:
//   z[e]  = [x[i] | xj[e] | ek(dist[e]) | 1]     (K1 = 2D + De + 1 columns)
//   ek_k  = exp(coeff * (dist[e] - k*step)^2),   k < De
//   [af | as] = z[e] · W                         (W: K1 x 2D, bias last row)
//   out[i] += mask[e] * sigmoid(af) * softplus(as)
// The backward recomputes af and as, then with gg = mask[e] * g[i]:
//   d_af = gg*softplus(as)*s(af)*(1-s(af)),  d_as = gg*s(af)*s(as)
//   d_x[i] += d_af·Wfi^T + d_as·Wsi^T,  d_xj[e] = d_af·Wfj^T + d_as·Wsj^T
//   dW += z[e]^T · [d_af | d_as]  (its last row is the bias gradient)
// Masked edges are skipped: a tile of TE edges with no real edge costs one
// barrier; inside a mixed tile their rows are zero and add nothing.
//
// Bound: operations. At CGCNN_demo width (D 100, De 50) each real edge
// costs 2*251*200 FLOP forward and about 2.6 times that backward, against
// ~1.2 KB of inputs and outputs a real edge, far above the card's f32
// operations-per-byte line. The designs keep every intermediate on chip:
//
// * One block of 256 threads owns a tile of TE = 32 edges. It builds the
//   z tile in shared memory (x rows gathered by dst, xj rows, the Gaussian
//   basis computed in place, a column of ones for the bias), and streams W
//   through shared memory in chunks of 32 rows. Thread (tx, ty) of the
//   8 warps accumulates rows ty + 8r (r < 4) and columns tx + 32j (j < CPT)
//   of both af and as in registers: z is read as float4 broadcasts, W rows
//   as consecutive floats, so neither read has bank conflicts. Plain f32
//   FMA; no tensor cores (a later PR's speed work).
// * Node-side sums (out in the forward, d_x in the backward) go through
//   the epilogue of csr.cu's segment sum: the tile's rows are staged in
//   shared memory, one thread per column walks the 32 rows, adds runs of
//   equal dst and flushes each run with one atomicAdd. That is right for
//   any dst order; on dst-sorted edges it is about one atomic per node and
//   column. Atomics make the order of f32 additions vary from run to run.
// * The weight gradient is a sum over every edge of the batch. The
//   backward runs a persistent grid (about two blocks per SM); each block
//   walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... and adds each
//   tile's z^T · dA into its own slice of a partial buffer in device
//   memory (no atomics, 4 x 4 register micro-tiles, float4 traffic).
//   mdl_fused_cgconv_wgrad_reduce then sums the slices in a fixed order
//   (edge_tile.cuh holds the sum and the epilogue, shared with
//   fused_cfconv.cu).
//   d_z = dA · W^T needs W transposed: the caller passes WT = W[:2D]^T.
//
// The caller zeroes out, d_x, d_xj and the partial buffer, and allocates
// everything; the kernels never synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile.cuh"

namespace {

struct Geometry {
  long long e;  // edge slots
  int d;        // feature width D
  int de;       // Gaussian basis size De
  int n;        // node slots
  int k1;       // 2D + De + 1 rows of W
  int ldz;      // round4(k1): row stride of the z tile
  int ldn;      // round4(2D): row stride of [af | as]-wide tiles
  float coeff;  // -0.5 / width^2
  float step;   // 1 / (De - 1): the basis offsets are k * step
};

Geometry make_geometry(long long e, int d, int de, int n, float coeff,
                       float step) {
  Geometry g;
  g.e = e; g.d = d; g.de = de; g.n = n;
  g.k1 = 2 * d + de + 1;
  g.ldz = round4(g.k1);
  g.ldn = round4(2 * d);
  g.coeff = coeff; g.step = step;
  return g;
}

// Loads the tile's edge weights and destinations into shared memory (a
// masked edge, or one whose dst lies outside [0, n), gets weight 0) and
// returns, uniformly across the block, whether any edge of it is real.
__device__ bool load_edges(const int* __restrict__ dst,
                           const float* __restrict__ mask, long long e0,
                           const Geometry& g, float* w_s, int* dst_s) {
  bool real = false;
  if (threadIdx.x < kTE) {
    const long long e = e0 + threadIdx.x;
    float w = 0.f;
    int node = 0;
    if (e < g.e) {
      node = dst[e];
      w = mask != nullptr ? mask[e] : 1.f;
      if (node < 0 || node >= g.n) w = 0.f;
    }
    w_s[threadIdx.x] = w;
    dst_s[threadIdx.x] = node;
    real = w != 0.f;
  }
  return __syncthreads_or(real) != 0;
}

// z tile: [x[dst] | xj | basis(dist) | 1 | zero pad to ldz]; zero rows for
// masked edges.
__device__ void load_z(const float* __restrict__ x,
                       const float* __restrict__ xj,
                       const float* __restrict__ dist, long long e0,
                       const Geometry& g, const float* w_s, const int* dst_s,
                       float* z_s) {
  for (int i = threadIdx.x; i < kTE * g.ldz; i += kThreads) {
    const int r = i / g.ldz;
    const int k = i - r * g.ldz;
    float v = 0.f;
    if (w_s[r] != 0.f) {
      const long long e = e0 + r;
      if (k < g.d) {
        v = x[(long long)dst_s[r] * g.d + k];
      } else if (k < 2 * g.d) {
        v = xj[e * g.d + (k - g.d)];
      } else if (k < 2 * g.d + g.de) {
        const float diff = dist[e] - (float)(k - 2 * g.d) * g.step;
        v = expf(g.coeff * diff * diff);
      } else if (k == g.k1 - 1) {
        v = 1.f;
      }
    }
    z_s[i] = v;
  }
}

// acc0[r][j] = Σ_k a[row][k] * b[k][c], acc1[r][j] = Σ_k a[row][k] *
// b[k][half + c], for row = ty + 8r and c = tx + 32j < half. a_s is a
// kTE x lda tile in shared memory whose columns from ka to round4(ka) are
// zero; b is a ka x 2*half row-major matrix in device memory, streamed
// through b_s (kKC x ldn). Starts with a barrier, so the caller's writes
// to a_s are visible, and leaves b_s in use.
template <int CPT>
__device__ void tile_gemm(const float* __restrict__ a_s, int lda, int ka,
                          const float* __restrict__ b, int half,
                          float* __restrict__ b_s, int ldn,
                          float (&acc0)[kRows][CPT],
                          float (&acc1)[kRows][CPT]) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int nb = 2 * half;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      acc0[r][j] = 0.f;
      acc1[r][j] = 0.f;
    }
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
          const float b0 = c < half ? brow[c] : 0.f;
          const float b1 = c < half ? brow[half + c] : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float av = q == 0 ? a4[r].x
                           : q == 1 ? a4[r].y
                           : q == 2 ? a4[r].z
                                    : a4[r].w;
            acc0[r][j] = fmaf(av, b0, acc0[r][j]);
            acc1[r][j] = fmaf(av, b1, acc1[r][j]);
          }
        }
      }
    }
  }
}

template <int CPT>
__global__ void __launch_bounds__(kThreads)
fused_cgconv_fwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ xj,
                        const float* __restrict__ dist,
                        const int* __restrict__ dst,
                        const float* __restrict__ mask,
                        const float* __restrict__ w,
                        float* __restrict__ out, Geometry g) {
  extern __shared__ float4 smem4[];
  float* z_s = reinterpret_cast<float*>(smem4);
  float* b_s = z_s + kTE * g.ldz;
  float* w_s = b_s + kKC * g.ldn;
  int* dst_s = reinterpret_cast<int*>(w_s + kTE);

  const long long e0 = (long long)blockIdx.x * kTE;
  if (!load_edges(dst, mask, e0, g, w_s, dst_s)) return;
  load_z(x, xj, dist, e0, g, w_s, dst_s, z_s);

  float af[kRows][CPT], as[kRows][CPT];
  tile_gemm<CPT>(z_s, g.ldz, g.k1, w, g.d, b_s, g.ldn, af, as);
  __syncthreads();  // z_s is free: stage the messages there

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  float* msg_s = z_s;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = ty + 8 * r;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 32 * j;
      if (c < g.d) {
        msg_s[row * g.d + c] =
            w_s[row] * sigmoidf(af[r][j]) * softplusf(as[r][j]);
      }
    }
  }
  __syncthreads();
  flush_runs(msg_s, g.d, w_s, dst_s, out);
}

template <int CPT>
__global__ void __launch_bounds__(kThreads)
fused_cgconv_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ xj,
                        const float* __restrict__ dist,
                        const int* __restrict__ dst,
                        const float* __restrict__ mask,
                        const float* __restrict__ w,
                        const float* __restrict__ wt,
                        const float* __restrict__ gout,
                        float* __restrict__ dx, float* __restrict__ dxj,
                        float* __restrict__ partial, Geometry g,
                        long long num_tiles) {
  extern __shared__ float4 smem4[];
  float* z_s = reinterpret_cast<float*>(smem4);
  float* da_s = z_s + kTE * g.ldz;
  float* b_s = da_s + kTE * g.ldn;
  float* w_s = b_s + kKC * g.ldn;
  int* dst_s = reinterpret_cast<int*>(w_s + kTE);

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  // da_s columns 2D..ldn-1 are never written: zero the tile once.
  for (int i = threadIdx.x; i < kTE * g.ldn; i += kThreads) da_s[i] = 0.f;
  const int cgroups = g.ldn / 4;
  const int tiles_w = (g.ldz / 4) * cgroups;  // 4 x 4 micro-tiles of dW
  float4* part = reinterpret_cast<float4*>(partial) +
                 (long long)blockIdx.x * tiles_w * 4;

  for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long e0 = tile * kTE;
    __syncthreads();  // the previous tile's readers are done
    if (!load_edges(dst, mask, e0, g, w_s, dst_s)) continue;
    load_z(x, xj, dist, e0, g, w_s, dst_s, z_s);

    float af[kRows][CPT], as[kRows][CPT];
    tile_gemm<CPT>(z_s, g.ldz, g.k1, w, g.d, b_s, g.ldn, af, as);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty + 8 * r;
      const float wr = w_s[row];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 32 * j;
        if (c < g.d) {
          const float gg =
              wr != 0.f ? wr * gout[(long long)dst_s[row] * g.d + c] : 0.f;
          const float sf = sigmoidf(af[r][j]);
          const float ss = sigmoidf(as[r][j]);
          da_s[row * g.ldn + c] = gg * softplusf(as[r][j]) * sf * (1.f - sf);
          da_s[row * g.ldn + g.d + c] = gg * sf * ss;
        }
      }
    }

    // [d_xi | d_xj] = dA · W[:2D]^T
    float di[kRows][CPT], dj[kRows][CPT];
    tile_gemm<CPT>(da_s, g.ldn, 2 * g.d, wt, g.d, b_s, g.ldn, di, dj);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty + 8 * r;
      if (w_s[row] == 0.f) continue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 32 * j;
        if (c < g.d) dxj[(e0 + row) * g.d + c] = dj[r][j];
      }
    }
    __syncthreads();  // b_s is free: stage d_xi there (kKC*ldn >= kTE*D)
    float* di_s = b_s;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty + 8 * r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 32 * j;
        if (c < g.d) di_s[row * g.d + c] = di[r][j];
      }
    }
    __syncthreads();
    flush_runs(di_s, g.d, w_s, dst_s, dx);

    // this block's slice of dW += z^T · dA, in 4 x 4 micro-tiles
    for (int m = threadIdx.x; m < tiles_w; m += kThreads) {
      const int k = (m / cgroups) * 4;
      const int c = (m % cgroups) * 4;
      float acc[4][4] = {};
      for (int r = 0; r < kTE; ++r) {
        if (w_s[r] == 0.f) continue;
        const float4 zv = *reinterpret_cast<const float4*>(z_s + r * g.ldz + k);
        const float4 dv =
            *reinterpret_cast<const float4*>(da_s + r * g.ldn + c);
        const float zr[4] = {zv.x, zv.y, zv.z, zv.w};
        const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(zr[i], dr[q], acc[i][q]);
        }
      }
      float4* p = part + (long long)m * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 v = p[i];
        v.x += acc[i][0];
        v.y += acc[i][1];
        v.z += acc[i][2];
        v.w += acc[i][3];
        p[i] = v;
      }
    }
  }
}

size_t fwd_shared_bytes(const Geometry& g) {
  return sizeof(float) * ((size_t)kTE * g.ldz + (size_t)kKC * g.ldn + kTE) +
         sizeof(int) * kTE;
}

size_t bwd_shared_bytes(const Geometry& g) {
  return fwd_shared_bytes(g) + sizeof(float) * (size_t)kTE * g.ldn;
}

template <int CPT>
int launch_fwd(const float* x, const float* xj, const float* dist,
               const int* dst, const float* mask, const float* w, float* out,
               const Geometry& g, cudaStream_t s) {
  const size_t smem = fwd_shared_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cgconv_fwd_kernel<CPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + kTE - 1) / kTE;
  fused_cgconv_fwd_kernel<CPT><<<(unsigned)tiles, kThreads, smem, s>>>(
      x, xj, dist, dst, mask, w, out, g);
  return (int)cudaGetLastError();
}

template <int CPT>
int launch_bwd(const float* x, const float* xj, const float* dist,
               const int* dst, const float* mask, const float* w,
               const float* wt, const float* gout, float* dx, float* dxj,
               float* partial, const Geometry& g, int blocks,
               cudaStream_t s) {
  const size_t smem = bwd_shared_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cgconv_bwd_kernel<CPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + kTE - 1) / kTE;
  fused_cgconv_bwd_kernel<CPT><<<(unsigned)blocks, kThreads, smem, s>>>(
      x, xj, dist, dst, mask, w, wt, gout, dx, dxj, partial, g, tiles);
  return (int)cudaGetLastError();
}

// Columns a thread owns (of 32 * CPT): the smallest instantiated CPT that
// covers D, or 0 when D > 256.
int cpt_for(int d) {
  const int need = (d + 31) / 32;
  if (need <= 1) return 1;
  if (need <= 2) return 2;
  if (need <= 4) return 4;
  if (need <= 5) return 5;
  if (need <= 8) return 8;
  return 0;
}

constexpr int kBadShape = 1001;  // D > 256 or shared memory over the limit

}  // namespace

extern "C" {

// Floats per block of the weight gradient's partial buffer (the caller
// allocates blocks times that many zeros).
long long mdl_fused_cgconv_partial_floats(int d, int de) {
  const Geometry g = make_geometry(0, d, de, 0, 0.f, 0.f);
  return (long long)(g.ldz / 4) * (g.ldn / 4) * 16;
}

// All pointers are device pointers on the current device. w is the
// (2D+De+1) x 2D extended weight [[Wfi Wsi]; [Wfj Wsj]; [Wfe Wse]; [bf bs]];
// out holds n*d zeros; mask may be null (every edge real). Returns 0 or a
// cudaError_t (kBadShape for an unsupported D or shared-memory size).
int mdl_fused_cgconv_fwd(const void* x, const void* xj, const void* dist,
                         const void* dst, const void* mask, const void* w,
                         void* out, long long e, int d, int de, int n,
                         float coeff, float step, void* stream) {
  const Geometry g = make_geometry(e, d, de, n, coeff, step);
  if (fwd_shared_bytes(g) > (size_t)kMaxShared) return kBadShape;
  const float* xp = static_cast<const float*>(x);
  const float* xjp = static_cast<const float*>(xj);
  const float* dp = static_cast<const float*>(dist);
  const int* dsp = static_cast<const int*>(dst);
  const float* mp = static_cast<const float*>(mask);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cpt_for(d)) {
    case 1: return launch_fwd<1>(xp, xjp, dp, dsp, mp, wp, op, g, s);
    case 2: return launch_fwd<2>(xp, xjp, dp, dsp, mp, wp, op, g, s);
    case 4: return launch_fwd<4>(xp, xjp, dp, dsp, mp, wp, op, g, s);
    case 5: return launch_fwd<5>(xp, xjp, dp, dsp, mp, wp, op, g, s);
    case 8: return launch_fwd<8>(xp, xjp, dp, dsp, mp, wp, op, g, s);
    default: return kBadShape;
  }
}

// wt is W[:2D]^T (2D x 2D); gout (n x d); dx (n x d) and dxj (e x d) hold
// zeros; partial holds blocks * mdl_fused_cgconv_partial_floats(d, de)
// zeros.
int mdl_fused_cgconv_bwd(const void* x, const void* xj, const void* dist,
                         const void* dst, const void* mask, const void* w,
                         const void* wt, const void* gout, void* dx,
                         void* dxj, void* partial, long long e, int d, int de,
                         int n, float coeff, float step, int blocks,
                         void* stream) {
  const Geometry g = make_geometry(e, d, de, n, coeff, step);
  if (bwd_shared_bytes(g) > (size_t)kMaxShared || blocks < 1) return kBadShape;
  const float* xp = static_cast<const float*>(x);
  const float* xjp = static_cast<const float*>(xj);
  const float* dp = static_cast<const float*>(dist);
  const int* dsp = static_cast<const int*>(dst);
  const float* mp = static_cast<const float*>(mask);
  const float* wp = static_cast<const float*>(w);
  const float* wtp = static_cast<const float*>(wt);
  const float* gp = static_cast<const float*>(gout);
  float* dxp = static_cast<float*>(dx);
  float* dxjp = static_cast<float*>(dxj);
  float* pp = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cpt_for(d)) {
    case 1: return launch_bwd<1>(xp, xjp, dp, dsp, mp, wp, wtp, gp, dxp, dxjp, pp, g, blocks, s);
    case 2: return launch_bwd<2>(xp, xjp, dp, dsp, mp, wp, wtp, gp, dxp, dxjp, pp, g, blocks, s);
    case 4: return launch_bwd<4>(xp, xjp, dp, dsp, mp, wp, wtp, gp, dxp, dxjp, pp, g, blocks, s);
    case 5: return launch_bwd<5>(xp, xjp, dp, dsp, mp, wp, wtp, gp, dxp, dxjp, pp, g, blocks, s);
    case 8: return launch_bwd<8>(xp, xjp, dp, dsp, mp, wp, wtp, gp, dxp, dxjp, pp, g, blocks, s);
    default: return kBadShape;
  }
}

// dw (2D+De+1 x 2D) = the sum over blocks of the backward's partials.
int mdl_fused_cgconv_wgrad_reduce(const void* partial, void* dw, int blocks,
                                  int d, int de, void* stream) {
  const Geometry g = make_geometry(0, d, de, 0, 0.f, 0.f);
  const int cgroups = g.ldn / 4;
  return launch_wgrad_reduce(partial, dw, blocks, (g.ldz / 4) * cgroups,
                             cgroups, g.k1, 2 * d, stream);
}

}  // extern "C"
