// Fused SchNet cfconv forward and backward kernels for Hopper (sm_90a), with
// a plain C interface for ctypes (bound in matdeeplearn_torch/ops/fused_cfconv.py).
//
// mdl_fused_cfconv_fwd replaces the reference package's
// ops/pallas_fused_schnet.py:_fwd_kernel; mdl_fused_cfconv_bwd (the edge
// rows), mdl_fused_cfconv_wgrad (the weight gradients, in slices) and
// mdl_fused_cfconv_wgrad_reduce (the fixed-order sum of the slices)
// together replace :_bwd_kernel.
//
// Per real edge e (mask[e] != 0, 0 <= dst[e] < n), with i = dst[e]:
//   b[e]  = [ek(dist[e]) | 1]                   (De + 1 columns)
//   ek_k  = exp(coeff * (dist[e] - k*step)^2),   k < De
//   pre   = b[e] · W0e                          (W0e = [W0; b0]: De+1 x F)
//   a     = ssp(pre) = softplus(pre) - ln 2      (unthresholded softplus)
//   w     = [a | 1] · W1e                       (W1e = [W1; b1]: F+1 x F)
//   s[e]  = mask[e] * 0.5 * (cos(d_raw[e] * scale) + 1),  scale = pi / cutoff
//   out[i] += xj[e] * w * s[e]
// The backward recomputes pre, a and w, then with gg = g[i] * s[e]:
//   d_xj[e] = gg * w,  dw = gg * xj[e]
//   dpre    = (dw · W1^T) * sigmoid(pre)     (ssp' = sigmoid)
//   dW1e   += [a | 1]^T · dw,  dW0e += b[e]^T · dpre  (bias rows last)
// An edge whose s is 0 (masked, dst out of range, or d_raw at the cutoff)
// adds nothing to any output, so its row is skipped: d_xj keeps the
// caller's zeros on every such edge.
//
// Bound: operations. At SchNet_demo width (F 150, De 50) a real edge costs
// 2*(50 + 150)*150 = 60k FLOP forward and 2*(2*50 + 3*150)*150 = 165k
// backward (three row products and two weight-gradient products), against
// ~0.6 KB of inputs and outputs (the xj row, d_xj, two distances). At
// chip_smoke's training batch (45,509 real edges of 80,176) the backward's
// 7.51e9 FLOP take 0.0455 ms at the 3xTF32 rate (495/3 TFLOP/s; 0.112 ms
// at the FMA pipes' 67).
//
// * The forward, on the FMA pipes: one block of 256 threads owns a tile of
//   TE = 32 edges. It computes the basis tile in shared memory, runs the
//   first GEMM against W0e, writes [ssp(pre) | 1] as the second GEMM's left
//   operand into shared memory and runs the second GEMM against W1e. Each
//   GEMM streams its right operand through shared memory in chunks of 32
//   rows; thread (tx, ty) of the 8 warps accumulates rows ty + 8r (r < 4)
//   and columns tx + 32j (j < CPT) in registers, reading the left tile as
//   float4 broadcasts and the right rows as consecutive floats. At F = 150
//   the threads cover 160 columns (CPT 5) and 10 idle; the largest F is
//   256. The node sums go through the run-flush epilogue of edge_tile.cuh:
//   the tile's messages are staged in shared memory, one thread per column
//   walks the 32 rows, adds runs of equal dst and flushes each run with one
//   atomicAdd. Right for any dst order. There is no node-side gradient:
//   messages depend on the source row xj alone.
// * The backward runs every product on the tensor cores in 3xTF32 (each
//   operand split into TF32 hi + lo, lo·hi + hi·lo + hi·hi accumulated in
//   f32: f32 accuracy), split into the edge rows and the weight gradient,
//   as fused_cgconv.cu splits CGConv's.
// * mdl_fused_cfconv_bwd, on wgmma m64nNk8 (wgmma.cuh): a first kernel
//   splits W0 and W1 (twice: as W1 and as W1^T) once a call into TF32 hi
//   and lo in the byte order of the K-major B descriptors (in place of a
//   transposed copy of W1 a call). A block of two warpgroups owns a tile
//   of 128 edges, each warp 16 rows x all np = 8 NTW >= F columns (152 at
//   F 150), and runs the three row products one after another into one set
//   of accumulators: pre = b·W0 with the basis computed in registers as A;
//   w = a·W1 and dw·W1^T with A from a shared tile that holds a, then dw,
//   laid out as the accumulators left them (two 8-byte loads a k-step; the
//   B rows of W1 are in the matching pair order). The split weights stream
//   through a two-stage ring by 16-byte cp.async (4 k-steps a stage where
//   it fits), a stage's copies issued right after its predecessor's wgmma.
//   Each epilogue moves the accumulators into the tile and does its
//   element-wise work there in a rolled loop over whole rows (8 elements a
//   thread in flight): + b0 and ssp; + b1, d_xj = gg * w and dw = gg * xj;
//   dpre = that * sigmoid(pre). It writes d_xj and the real rows of a, dw
//   and dpre (zero past F) for the weight gradient; pre waits in the dpre
//   row between the first and last epilogue. At F 150: 76 accumulators and
//   152 registers a thread, 165 KB of shared memory, one block an SM; the
//   xj rows and (dst sorted) the g rows of a tile are prefetched into L2 at
//   its start. The rows a, dw, dpre and pre (about 110 MB at chip_smoke's
//   batch) are written and read again.
// * mdl_fused_cfconv_wgrad, on mma.sync m16n8k8 (edge_tile.cuh): [dW0e;
//   dW1e] = [b | 1]^T · dpre and [a | 1]^T · dw as split-K products over
//   the edges. Block (tile, slice) owns a 64 x 160 tile of one of the two
//   and the 32-edge chunks slice, slice + S, ... (the strided order spreads
//   the tail pads of a dst-sorted batch over every slice), two chunk
//   buffers deep: while the warps multiply one chunk, the next one's dpre
//   or dw columns come by cp.async and its dist or a rows by loads held in
//   registers, [b | 1] or [a | 1] formed from them once the product is
//   issued; a chunk with no real edge is skipped. 105 registers, 62 KB of
//   shared memory, two blocks an SM. Each slice writes, never adds, its
//   tiles in the 4 x 4 micro-tile layout of wgrad_reduce_kernel
//   (edge_tile.cuh), which mdl_fused_cfconv_wgrad_reduce sums in a fixed
//   order. No atomics touch the weight gradients: they are bit-identical
//   from run to run.
//
// The caller zeroes out and d_xj, and allocates everything; the kernels
// never synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile.cuh"
#include "wgmma.cuh"

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
// Thread t < TE stores edge e0 + t's row scale s and destination in
// sc_s[t] and dst_s[t]; returns whether s != 0 (false for other threads).
template <int TE>
__device__ bool store_edge(const int* __restrict__ dst,
                           const float* __restrict__ mask,
                           const float* __restrict__ wraw, long long e0,
                           const Geometry& g, float* sc_s, int* dst_s) {
  if (threadIdx.x >= TE) return false;
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
  return s != 0.f;
}

template <int TE = kTE>
__device__ bool load_edges(const int* __restrict__ dst,
                           const float* __restrict__ mask,
                           const float* __restrict__ wraw, long long e0,
                           const Geometry& g, float* sc_s, int* dst_s) {
  return __syncthreads_or(
             store_edge<TE>(dst, mask, wraw, e0, g, sc_s, dst_s)) != 0;
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

// ---- the backward: edge rows on wgmma ---------------------------------

// The backward's B operands, unit after unit in one split buffer: unit 0
// (kt0 = ceil(De/8) k-steps) is W0 for pre = b·W0, B[n][k] = W0[k][n];
// unit 1 (NTW k-steps) is W1 for w = a·W1, B[n][k] = W1[k][n]; unit 2 (NTW
// k-steps) is W1 for dpre = dw·W1^T, B[n][k] = W1[n][k]. In units 1 and 2
// the k-step's position p holds column 8 s + pair_col(p) (wgmma.cuh), so
// their A fragments are the previous product's accumulators as they
// stand. Zero past De or F.
struct CfconvBwdB {
  const float* w0;
  const float* w1;
  int f, de, kt0, ntw;
  __device__ float operator()(long long s, int n, int c) const {
    if (s < kt0) {
      const int k = 8 * (int)s + c;
      return n < f && k < de ? w0[(long long)k * f + n] : 0.f;
    }
    s -= kt0;
    const bool second = s >= ntw;
    const int k = 8 * (int)(second ? s - ntw : s) + pair_col(c);
    if (n >= f || k >= f) return 0.f;
    return second ? w1[(long long)n * f + k] : w1[(long long)k * f + n];
  }
};

constexpr int kBTE = 128;  // edges of a backward tile: two warpgroups of 64
constexpr int kBKS = 4;    // most k-steps a backward stage holds

struct BwdLayout {
  int ntw;  // n8-tiles of the F columns: np = 8 ntw (the row buffers' width)
  int np;
  int kt0;  // k-steps of pre = b·W0: ceil(De / 8)
  int ks;   // k-steps a stage holds (<= kBKS)
  int ldt;  // row stride of the tile of a, dw and the epilogues (8 mod 32)
};

// Two W stages, the tile, and the tile's row scales, destinations and
// distances.
size_t bwd_shared_bytes(const BwdLayout& b) {
  return sizeof(float) * (2 * (size_t)b.ks * kstep_words(b.np) +
                          (size_t)kBTE * b.ldt + 2 * kBTE) +
         sizeof(int) * kBTE;
}

// The layout for width F: the most k-steps a stage whose shared memory
// fits. False where none fits or F > 256.
bool bwd_layout(const Geometry& g, BwdLayout* b) {
  b->ntw = ntw_bucket((g.f + 7) / 8);
  if (b->ntw == 0) return false;
  b->np = 8 * b->ntw;
  b->kt0 = (g.de + 7) / 8;
  b->ldt = stride_acc(b->np);
  for (int ks = kBKS; ks >= 1; --ks) {
    b->ks = ks;
    if (bwd_shared_bytes(*b) <= (size_t)kMaxShared) return true;
  }
  return false;
}

// Asks L2 to fetch the 16-byte granules that lie inside [p, p + bytes):
// a hint that the rows an epilogue reads arrive while the products run.
__device__ __forceinline__ void prefetch_l2(const void* p, long long bytes) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  const unsigned long long lo = (a + 15) & ~15UL;
  const unsigned long long hi = (a + bytes) & ~15UL;
  if (hi > lo) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                 :: "l"(lo), "r"((unsigned)(hi - lo)) : "memory");
  }
}

// The edge rows of the backward for one tile of 128 edges, two
// warpgroups of 64 rows, each warp 16 rows x all np columns. The split
// weights stream through a two-stage ring of ks k-steps (16-byte
// cp.async, one stage ahead, one barrier a stage); each k-step issues
// three wgmma (3xTF32). Product 1: pre = b·W0 with A (the Gaussian basis)
// computed in registers. Products 2 (w = a·W1) and 3 (dw·W1^T) take A
// from the tile t_s, two 8-byte loads a k-step: a and dw there are laid
// out as the accumulators left them, and the B rows of W1 in pair order
// match. Each epilogue moves the accumulators into the tile (two 8-byte
// stores a pair, short code at any NTW) and does its element-wise work
// there in a rolled loop, one row of np columns after another, so that
// its device-memory accesses are whole rows: (1) pre = + b0, a =
// ssp(pre); the rows a and pre; (2) w = + b1, gg = g[dst] * s, d_xj = gg *
// w, dw = gg * xj; the rows d_xj and dw; (3) dpre = that * sigmoid(pre),
// pre read back from the dpre row. Rows of edges whose s is 0 are not
// written; a tile with no real edge costs one barrier.
template <int NTW>
__global__ void __launch_bounds__(kThreads, 1)
fused_cfconv_bwd_kernel(const float* __restrict__ xj,
                        const float* __restrict__ dist,
                        const float* __restrict__ wraw,
                        const int* __restrict__ dst,
                        const float* __restrict__ mask,
                        const uint32_t* __restrict__ ws,
                        const float* __restrict__ b0,
                        const float* __restrict__ b1,
                        const float* __restrict__ gout,
                        float* __restrict__ dxj, float* __restrict__ arow,
                        float* __restrict__ dwrow, float* __restrict__ dprow,
                        Geometry g, BwdLayout b) {
  constexpr int NP = 8 * NTW;
  const int kw = kstep_words(NP);
  const int stage_words = b.ks * kw;
  extern __shared__ float4 smem4[];
  uint32_t* w_s = reinterpret_cast<uint32_t*>(smem4);      // 2 stages
  float* t_s = reinterpret_cast<float*>(w_s + 2 * stage_words);  // the tile
  float* sc_s = t_s + kBTE * b.ldt;                        // row scales s
  float* di_s = sc_s + kBTE;                               // distances
  int* dst_s = reinterpret_cast<int*>(di_s + kBTE);

  const long long e0 = (long long)blockIdx.x * kBTE;
  if (threadIdx.x < kBTE) {
    const long long e = e0 + threadIdx.x;
    di_s[threadIdx.x] = e < g.e ? dist[e] : 0.f;
  }
  if (!load_edges<kBTE>(dst, mask, wraw, e0, g, sc_s, dst_s)) return;
  if (threadIdx.x == 0) {  // the xj rows and, dst sorted, the g rows of epilogue 2
    const long long rows = min((long long)kBTE, g.e - e0);
    prefetch_l2(xj + e0 * g.f, rows * g.f * 4);
    const int lo = dst_s[0], hi = dst_s[rows - 1];
    if (lo <= hi && hi - lo < 2 * kBTE) {
      prefetch_l2(gout + (long long)lo * g.f, (long long)(hi - lo + 1) * g.f * 4);
    }
  }
  // stages: ns0 of unit 0, then ns of unit 1 and ns of unit 2
  const int ns0 = (b.kt0 + b.ks - 1) / b.ks;
  const int ns = (NTW + b.ks - 1) / b.ks;
  const int stages = ns0 + 2 * ns;

  // stage s: k-steps [k0, k0 + cnt) of the split buffer
  auto load_stage = [&](int s) {
    if (s < stages) {
      int k0, cnt;
      if (s < ns0) {
        k0 = s * b.ks;
        cnt = min(b.ks, b.kt0 - k0);
      } else {
        const int t = s - ns0;
        const int u = t / ns;
        const int j0 = (t - u * ns) * b.ks;
        k0 = b.kt0 + u * NTW + j0;
        cnt = min(b.ks, NTW - j0);
      }
      const int q = cnt * kw / 4;
      uint32_t* to = w_s + (s & 1) * stage_words;
      const uint32_t* from = ws + (long long)k0 * kw;
      for (int i = threadIdx.x; i < q; i += kThreads) {
        cp_async16(to + 4 * i, from + 4 * i);
      }
    }
    cp_async_commit();
  };
  load_stage(0);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int r0 = 16 * warp + gr;  // the lane's rows r0 and r0 + 8
  const bool real[2] = {sc_s[r0] != 0.f, sc_s[r0 + 8] != 0.f};
  const float dr[2] = {di_s[r0], di_s[r0 + 8]};
  const float* ta = t_s + r0 * b.ldt + 2 * tq;  // the lane's A pairs

  float acc[NTW][4];
  // one product: stages [s0, s0 + n); unit 0 computes its A from the
  // basis, units 1 and 2 read theirs from the tile
  auto product = [&](int s0, int n, int kt, bool basis) {
    for (int s = s0; s < s0 + n; ++s) {
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();  // stage s landed; every warp is done with s - 1
      const uint32_t* wst = w_s + (s & 1) * stage_words;
      const int j0 = (s - s0) * b.ks;
      const int nks = min(b.ks, kt - j0);
      uint32_t ahi[kBKS][4], alo[kBKS][4];
      fence_acc(acc);
#pragma unroll
      for (int ks = 0; ks < kBKS; ++ks) {
        if (ks < nks) {  // uniform across the block
          const int j = j0 + ks;
          if (basis) {
            float v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int k = 8 * j + tq + 4 * (q >> 1);
              const int h = q & 1;
              const float diff = dr[h] - (float)k * g.step;
              v[q] = real[h] && k < g.de ? expf(g.coeff * diff * diff) : 0.f;
            }
            split_a(v[0], v[1], v[2], v[3], ahi[ks], alo[ks]);
          } else {
            const float2 p0 = *reinterpret_cast<const float2*>(ta + 8 * j);
            const float2 p1 =
                *reinterpret_cast<const float2*>(ta + 8 * b.ldt + 8 * j);
            split_a(p0.x, p1.x, p0.y, p1.y, ahi[ks], alo[ks]);
          }
          const uint32_t* wk = wst + ks * kw;
          wgmma_fence();
          wgmma_3xtf32(acc, ahi[ks], alo[ks], b_desc(wk), b_desc(wk + NP * 8),
                       j == 0 ? 0 : 1);
        }
      }
      wgmma_commit();
      load_stage(s + 1);  // while the tensor cores work
      wgmma_wait();
#pragma unroll
      for (int ks = 0; ks < kBKS; ++ks) {
        if (ks < nks) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            fence_reg(ahi[ks][q]);
            fence_reg(alo[ks][q]);
          }
        }
      }
      fence_acc(acc);
    }
    __syncthreads();  // every warp is done reading the tile
    acc_to_tile(acc, t_s, b.ldt, r0, 0, tq);
    __syncthreads();
  };

  // product 1 and its epilogue: pre = + b0, a = ssp(pre); rows pre (into
  // dprow) and a; a stays in the tile as product 2's A
  product(0, ns0, b.kt0, true);
  constexpr int U = 8;  // tile elements a thread has in flight
  for (int i0 = threadIdx.x; i0 < kBTE * NP; i0 += U * kThreads) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= kBTE * NP) break;
      const int r = i / NP;
      const int c = i - r * NP;
      float* p = t_s + r * b.ldt + c;
      const bool in = c < g.f;
      const float pre = *p + (in ? __ldg(b0 + c) : 0.f);
      const bool on = sc_s[r] != 0.f;
      const float a = on && in ? sspf(pre) : 0.f;
      if (on) {
        const long long at = (e0 + r) * NP + c;
        arow[at] = a;
        dprow[at] = pre;
      }
      *p = a;
    }
  }
  // product 2 and its epilogue: w = + b1, gg = g[dst] * s, d_xj = gg * w,
  // dw = gg * xj; the row dw; dw stays in the tile as product 3's A
  product(ns0, ns, NTW, false);
  for (int i0 = threadIdx.x; i0 < kBTE * NP; i0 += U * kThreads) {
    float gv[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // the loads first, all in flight
      const int i = i0 + u * kThreads;
      const int r = i / NP;
      const int c = i - r * NP;
      const bool in = i < kBTE * NP && sc_s[r] != 0.f && c < g.f;
      gv[u] = in ? gout[(long long)dst_s[r] * g.f + c] : 0.f;
      xv[u] = in ? xj[(e0 + r) * g.f + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= kBTE * NP) break;
      const int r = i / NP;
      const int c = i - r * NP;
      float* p = t_s + r * b.ldt + c;
      const float s = sc_s[r];
      float dw = 0.f;
      if (s != 0.f) {
        const long long e = e0 + r;
        if (c < g.f) {
          const float gg = gv[u] * s;
          dxj[e * g.f + c] = gg * (*p + __ldg(b1 + c));
          dw = gg * xv[u];
        }
        dwrow[e * NP + c] = dw;
      }
      *p = dw;
    }
  }
  // product 3 and its epilogue: dpre = (dw · W1^T) * sigmoid(pre), pre
  // read back from the dpre row
  product(ns0 + ns, ns, NTW, false);
  for (int i0 = threadIdx.x; i0 < kBTE * NP; i0 += U * kThreads) {
    float pv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / NP;
      pv[u] = i < kBTE * NP && sc_s[r] != 0.f
                  ? dprow[(e0 + r) * NP + i - r * NP] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= kBTE * NP) break;
      const int r = i / NP;
      if (sc_s[r] != 0.f) {
        const int c = i - r * NP;
        dprow[(e0 + r) * NP + c] = t_s[r * b.ldt + c] * sigmoidf(pv[u]);
      }
    }
  }
}

// ---- the backward: the weight gradient ---------------------------------

constexpr int kWM = 64;         // rows of a block's tile of one group
constexpr int kWN = 160;        // columns of a block's tile
constexpr int kWK = 32;         // edges of a chunk
constexpr int kLdZ = kWM + 8;   // 8 mod 32: conflict-free A fragments of z^T
constexpr int kLdD = kWN + 8;   // 8 mod 32: conflict-free B fragments

// M-tiles of each group: [b | 1] (ldz0 rows, with dpre) and [a | 1]
// (ldz1 rows, with dw).
void wgrad_tiles(const Geometry& g, int* mt0, int* ntn, int* tiles) {
  *mt0 = (g.ldz0 + kWM - 1) / kWM;
  const int mt1 = (g.ldz1 + kWM - 1) / kWM;
  *ntn = (g.ldn + kWN - 1) / kWN;
  *tiles = (*mt0 + mt1) * *ntn;
}

// Shared memory of the weight-gradient kernel: two chunk buffers (z, the
// dpre or dw columns, row scales, destinations).
constexpr int kWBuf = kWK * (kLdZ + kLdD + 2);
constexpr size_t kWgradShared = sizeof(float) * 2 * kWBuf;

// Slice `slice` of [dW0e; dW1e] = the sums over the 32-edge chunks slice,
// slice + slices, ... of [b | 1]^T · dpre and [a | 1]^T · dw, for this
// block's 64 x 160 tile of one group; 8 warps in 2 (32 rows) x 4 (40
// columns), each 2 x 5 m16n8 fragments, mma.sync m16n8k8 in 3xTF32. The
// chunks stream through two buffers, one chunk ahead, one barrier a chunk:
// while the warps multiply chunk c, its successor's dpre or dw columns
// come by cp.async (zero-filled for edges that are not real) and its z
// inputs (dist, or the a rows) by loads held in registers, stored as [b |
// 1] or [a | 1] once the product is issued. A chunk with no real edge is
// skipped. Each slice writes, never adds, its tile in wgrad_reduce_kernel's
// micro-tile layout, every entry of the (ldz0 + ldz1) x ldn slice, pads as
// zeros.
__global__ void __launch_bounds__(kThreads, 2)
fused_cfconv_wgrad_kernel(const float* __restrict__ dist,
                          const float* __restrict__ wraw,
                          const int* __restrict__ dst,
                          const float* __restrict__ mask,
                          const float* __restrict__ arow,
                          const float* __restrict__ dwrow,
                          const float* __restrict__ dprow,
                          float* __restrict__ partial, Geometry g, int np,
                          int mt0, int ntn, int tiles, int slices) {
  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);
  // buffer u: d (kWK x kLdD, first: 16-byte rows), z, row scales, dst
  auto d_of = [&](int u) { return buf0 + u * kWBuf; };
  auto z_of = [&](int u) { return buf0 + u * kWBuf + kWK * kLdD; };
  auto sc_of = [&](int u) { return buf0 + u * kWBuf + kWK * (kLdD + kLdZ); };
  auto dst_of = [&](int u) {
    return reinterpret_cast<int*>(sc_of(u) + kWK);
  };

  const int tile = blockIdx.x % tiles;
  const int slice = blockIdx.x / tiles;
  const int mtile = tile / ntn;
  const bool first = mtile < mt0;  // [b | 1] with dpre, or [a | 1] with dw
  const int m0 = (first ? mtile : mtile - mt0) * kWM;
  const int n0 = (tile % ntn) * kWN;
  const int ldzg = first ? g.ldz0 : g.ldz1;
  const float* drows = first ? dprow : dwrow;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int wm = (warp >> 2) * 32;
  const int wn = (warp & 3) * 40;
  // this thread's z column (fixed) and rows r0, r0 + 4, ...
  const int kc = threadIdx.x & (kWM - 1);
  const int m = m0 + kc;
  const int r0 = threadIdx.x / kWM;
  constexpr int R = kWK * kWM / kThreads;

  float acc[2][5][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][i][q] = 0.f;

  // chunk ch into buffer u, its edges already in sc_of(u) and dst_of(u):
  // the d columns by cp.async, the z inputs into v
  float v[R];
  auto issue = [&](long long ch, int u) {
    const long long e0 = ch * kWK;
    const float* sc = sc_of(u);
    float* d_s = d_of(u);
    for (int i = threadIdx.x; i < kWK * (kWN / 4); i += kThreads) {
      const int r = i / (kWN / 4);
      const int c = n0 + 4 * (i - r * (kWN / 4));
      const bool ok = sc[r] != 0.f && c < np;
      cp_async16(d_s + r * kLdD + (c - n0),
                 ok ? drows + (e0 + r) * np + c : drows, ok ? 16 : 0);
    }
    cp_async_commit();
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const long long e = e0 + r0 + 4 * q;
      v[q] = sc[r0 + 4 * q] == 0.f ? 0.f
             : first               ? dist[e]
             : m < g.f             ? arow[e * np + m]
                                   : 0.f;
    }
  };
  // v into buffer u's z rows as [b | 1] or [a | 1]
  auto store_z = [&](int u) {
    const float* sc = sc_of(u);
    float* z_s = z_of(u);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = r0 + 4 * q;
      float val = 0.f;
      if (sc[r] != 0.f) {
        if (first) {
          if (m < g.de) {
            const float diff = v[q] - (float)m * g.step;
            val = expf(g.coeff * diff * diff);
          } else if (m == g.de) {
            val = 1.f;
          }
        } else {
          val = m < g.f ? v[q] : m == g.f ? 1.f : 0.f;
        }
      }
      z_s[r * kLdZ + kc] = val;
    }
  };

  const long long chunks = (g.e + kWK - 1) / kWK;
  long long ch = slice;
  int u = 0;
  bool live = ch < chunks &&
              load_edges<kWK>(dst, mask, wraw, ch * kWK, g, sc_of(0), dst_of(0));
  if (live) {
    issue(ch, 0);
    store_z(0);
  }
  while (ch < chunks) {
    const long long next = ch + slices;
    const bool mine = next < chunks &&
                      store_edge<kWK>(dst, mask, wraw, next * kWK, g,
                                      sc_of(u ^ 1), dst_of(u ^ 1));
    cp_async_wait<0>();
    // chunk ch's buffer is complete, the next chunk's edges visible; every
    // warp is done with the buffer before it
    const bool live_next = __syncthreads_or(mine) != 0;
    if (live_next) issue(next, u ^ 1);
    if (live) {
      const float* z_s = z_of(u);
      const float* d_s = d_of(u);
#pragma unroll
      for (int ks = 0; ks < kWK / 8; ++ks) {
        uint32_t ahi[2][4], alo[2][4];
        const float* zr = z_s + (8 * ks + tq) * kLdZ + wm + gr;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          split_a(zr[16 * mt], zr[16 * mt + 8], zr[4 * kLdZ + 16 * mt],
                  zr[4 * kLdZ + 16 * mt + 8], ahi[mt], alo[mt]);
        }
        const float* dr = d_s + (8 * ks + tq) * kLdD + wn + gr;
        uint32_t bhi[5][2], blo[5][2];
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          split_tf32(dr[8 * i], bhi[i][0], blo[i][0]);
          split_tf32(dr[4 * kLdD + 8 * i], bhi[i][1], blo[i][1]);
        }
        mma_3xtf32_tile<2, 5>(acc, ahi, alo, bhi, blo);
      }
    }
    if (live_next) store_z(u ^ 1);
    ch = next;
    u ^= 1;
    live = live_next;
  }

  // write the tile into this slice, in wgrad_reduce_kernel's micro-tiles
  const int cg = g.ldn / 4;
  float* out = partial + (long long)slice * (g.ldz0 + g.ldz1) * g.ldn;
  const int rbase = first ? 0 : g.ldz0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = m0 + wm + 16 * mt + gr + 8 * (q >> 1);
        const int n = n0 + wn + 8 * i + 2 * tq + (q & 1);
        if (kk < ldzg && n < g.ldn) {
          const int k = rbase + kk;
          out[((k >> 2) * cg + (n >> 2)) * 16 + (k & 3) * 4 + (n & 3)] =
              acc[mt][i][q];
        }
      }
    }
  }
}

size_t fwd_shared_bytes(const Geometry& g) {
  return sizeof(float) * ((size_t)kTE * g.ldz0 + (size_t)kTE * g.ldz1 +
                          (size_t)kKC * g.ldn + kTE) +
         sizeof(int) * kTE;
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

template <int NTW>
int launch_bwd(const float* xj, const float* dist, const float* wraw,
               const int* dst, const float* mask, const uint32_t* ws,
               const float* b0, const float* b1, const float* gout,
               float* dxj, float* arow, float* dwrow, float* dprow,
               const Geometry& g, const BwdLayout& b, cudaStream_t s) {
  const size_t smem = bwd_shared_bytes(b);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cfconv_bwd_kernel<NTW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + kBTE - 1) / kBTE;
  fused_cfconv_bwd_kernel<NTW><<<(unsigned)tiles, kThreads, smem, s>>>(
      xj, dist, wraw, dst, mask, ws, b0, b1, gout, dxj, arow, dwrow, dprow,
      g, b);
  return (int)cudaGetLastError();
}

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

// Width of the backward's row buffers (a, dw, dpre): 8 ntw_bucket(ceil(F /
// 8)) >= F columns.
int mdl_fused_cfconv_row_width(int f) { return 8 * ntw_bucket((f + 7) / 8); }

// Words of the backward's split weights (its ws argument), or -kBadShape
// for an unsupported width.
long long mdl_fused_cfconv_bwd_split_words(int f, int de) {
  if (f < 1 || f > 256 || de < 1) return -kBadShape;
  BwdLayout b;
  if (!bwd_layout(make_geometry(0, f, de, 0, 0.f, 0.f, 0.f), &b)) {
    return -kBadShape;
  }
  return (long long)(b.kt0 + 2 * b.ntw) * kstep_words(b.np);
}

// The backward's edge rows. w0 (De x F) and w1 (F x F) without their
// biases b0 and b1 (F each); ws holds mdl_fused_cfconv_bwd_split_words(f,
// de) words, no initial value needed; gout (n x f); dxj (e x f) holds
// zeros; arow, dwrow and dprow (e x mdl_fused_cfconv_row_width(f)) need no
// initial value: the rows of real edges are written (a = ssp(pre), dw =
// g[dst] * s * xj and dpre, zero past F). Launches the weight split, then
// the tiles.
int mdl_fused_cfconv_bwd(const void* xj, const void* dist, const void* wraw,
                         const void* dst, const void* mask, const void* w0,
                         const void* b0, const void* w1, const void* b1,
                         void* ws, const void* gout, void* dxj, void* arow,
                         void* dwrow, void* dprow, long long e, int f, int de,
                         int n, float coeff, float step, float scale,
                         void* stream) {
  if (f < 1 || f > 256 || de < 1) return kBadShape;
  const Geometry g = make_geometry(e, f, de, n, coeff, step, scale);
  BwdLayout b;
  if (!bwd_layout(g, &b)) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* wsp = static_cast<uint32_t*>(ws);
  const int err = launch_split(
      CfconvBwdB{static_cast<const float*>(w0), static_cast<const float*>(w1),
                 f, de, b.kt0, b.ntw},
      b.kt0 + 2 * b.ntw, b.np, wsp, s);
  if (err != 0) return err;
  const float* xp = static_cast<const float*>(xj);
  const float* dp = static_cast<const float*>(dist);
  const float* rp = static_cast<const float*>(wraw);
  const int* dsp = static_cast<const int*>(dst);
  const float* mp = static_cast<const float*>(mask);
  const float* b0p = static_cast<const float*>(b0);
  const float* b1p = static_cast<const float*>(b1);
  const float* gp = static_cast<const float*>(gout);
  float* dxp = static_cast<float*>(dxj);
  float* ap = static_cast<float*>(arow);
  float* wp = static_cast<float*>(dwrow);
  float* pp = static_cast<float*>(dprow);
  switch (b.ntw) {
    case 4: return launch_bwd<4>(xp, dp, rp, dsp, mp, wsp, b0p, b1p, gp, dxp, ap, wp, pp, g, b, s);
    case 13: return launch_bwd<13>(xp, dp, rp, dsp, mp, wsp, b0p, b1p, gp, dxp, ap, wp, pp, g, b, s);
    case 19: return launch_bwd<19>(xp, dp, rp, dsp, mp, wsp, b0p, b1p, gp, dxp, ap, wp, pp, g, b, s);
    case 25: return launch_bwd<25>(xp, dp, rp, dsp, mp, wsp, b0p, b1p, gp, dxp, ap, wp, pp, g, b, s);
    case 32: return launch_bwd<32>(xp, dp, rp, dsp, mp, wsp, b0p, b1p, gp, dxp, ap, wp, pp, g, b, s);
    default: return kBadShape;
  }
}

// Blocks of mdl_fused_cfconv_wgrad per slice.
int mdl_fused_cfconv_wgrad_tiles(int f, int de) {
  int mt0, ntn, tiles;
  wgrad_tiles(make_geometry(0, f, de, 0, 0.f, 0.f, 0.f), &mt0, &ntn, &tiles);
  return tiles;
}

// The weight gradients in `slices` slices: partial holds slices *
// mdl_fused_cfconv_partial_floats(f, de) floats, every one written (no
// initial value needed); arow, dwrow and dprow are the edge kernel's.
// Launches slices * mdl_fused_cfconv_wgrad_tiles(f, de) blocks.
int mdl_fused_cfconv_wgrad(const void* dist, const void* wraw,
                           const void* dst, const void* mask,
                           const void* arow, const void* dwrow,
                           const void* dprow, void* partial, long long e,
                           int f, int de, int n, float coeff, float step,
                           float scale, int slices, void* stream) {
  if (f < 1 || f > 256 || de < 1 || slices < 1) return kBadShape;
  const Geometry g = make_geometry(e, f, de, n, coeff, step, scale);
  int mt0, ntn, tiles;
  wgrad_tiles(g, &mt0, &ntn, &tiles);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_cfconv_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWgradShared);
  if (err != cudaSuccess) return (int)err;
  fused_cfconv_wgrad_kernel<<<(unsigned)(tiles * slices), kThreads,
                              kWgradShared,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), static_cast<const float*>(wraw),
      static_cast<const int*>(dst), static_cast<const float*>(mask),
      static_cast<const float*>(arow), static_cast<const float*>(dwrow),
      static_cast<const float*>(dprow), static_cast<float*>(partial), g,
      mdl_fused_cfconv_row_width(f), mt0, ntn, tiles, slices);
  return (int)cudaGetLastError();
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
