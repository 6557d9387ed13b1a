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
// chip_smoke's training batch (45,509 real edges of 80,176) the forward's
// 2.73e9 FLOP take 0.0166 ms and the backward's 7.51e9 0.0455 ms at the
// 3xTF32 rate (495/3 TFLOP/s; 0.041 and 0.112 ms at the FMA pipes' 67).
//
// Every product runs on the tensor cores in 3xTF32 (each operand split
// into TF32 hi + lo, lo·hi + hi·lo + hi·hi accumulated in f32: f32
// accuracy).
//
// * The row kernels, mdl_fused_cfconv_fwd and mdl_fused_cfconv_bwd (the
//   backward's edge rows), on wgmma m64nNk8 (wgmma.cuh), share their
//   machinery (RowProducts): a first kernel splits W0 and W1 once a call
//   into TF32 hi and lo in the byte order of the K-major B descriptors
//   (the backward also W1 as W1^T: CfconvB's unit 2, in place of a
//   transposed copy). A block of two warpgroups owns a tile of 128 edges,
//   each warp 16 rows x all np = 8 NTW >= F columns (152 at F 150), and
//   runs the products one after another into one set of accumulators:
//   pre = b·W0 with the basis computed in registers as A; w = a·W1 (and in
//   the backward dw·W1^T) with A from a shared tile that holds a (then
//   dw), laid out as the accumulators left them (two 8-byte loads a
//   k-step; the B rows of W1 are in the matching pair order). The split
//   weights stream through a two-stage ring by 16-byte cp.async (4
//   k-steps a stage where it fits), a stage's copies issued right after
//   its predecessor's wgmma. At F 150: 76 accumulators, 165 KB of shared
//   memory, one block an SM; the xj rows of a tile (and in the backward,
//   dst sorted, its g rows) are prefetched into L2 at its start.
//   - The forward (254 registers at F 150): pre goes into the tile as the
//     accumulators left it, and product 2 forms each k-step's A fragment
//     as ssp(pre + b0) in registers while the tensor cores work on the
//     k-step before. Its epilogue runs on the accumulators: msg = s * xj *
//     (w + b1), each of a lane's two rows' 38 xj values loaded at once;
//     then the tile, by 16-row slices a warp, adds the messages into out
//     (runs of equal dst summed in a register, each flushed with one
//     atomicAdd: right for any dst order). It writes out and nothing else.
//     Timed phase by phase on an H100 80GB HBM3 at 700 W, a tile's first
//     product, second product with the softplus, epilogue and flush took
//     4.5, 16.2, 5.3 and 3.8 µs at chip_smoke's batch.
//   - The backward's edge rows (156 registers): each epilogue moves the
//     accumulators into the tile and does its element-wise work there in
//     a rolled loop over whole rows (8 elements a thread in flight), the
//     biases added there: + b0 and ssp; + b1, d_xj = gg * w and dw =
//     gg * xj; dpre = that * sigmoid(pre). It writes d_xj and the real
//     rows of a, dw and dpre (zero past F) for the weight gradient; pre
//     waits in the dpre row between the first and last epilogue. The rows
//     a, dw, dpre and pre (about 110 MB at chip_smoke's batch) are written
//     and read again.
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
  int ldz0;     // round4(De + 1): the weight gradient's rows of [dW0; db0]
  int ldz1;     // round4(F + 1): its rows of [dW1; db1]
  int ldn;      // round4(F): its columns
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

template <int TE>
__device__ bool load_edges(const int* __restrict__ dst,
                           const float* __restrict__ mask,
                           const float* __restrict__ wraw, long long e0,
                           const Geometry& g, float* sc_s, int* dst_s) {
  return __syncthreads_or(
             store_edge<TE>(dst, mask, wraw, e0, g, sc_s, dst_s)) != 0;
}

// ---- the edge rows on wgmma: the forward and the backward's edge kernel

// The B operands of the row products, unit after unit in one split
// buffer: unit 0 (kt0 = ceil(De/8) k-steps) is W0 for pre = b·W0,
// B[n][k] = W0[k][n]; unit 1 (NTW k-steps) is W1 for w = a·W1, B[n][k] =
// W1[k][n]; unit 2 (NTW k-steps, the backward's alone) is W1 for dpre =
// dw·W1^T, B[n][k] = W1[n][k]. In units 1 and 2 the k-step's position p
// holds column 8 s + pair_col(p) (wgmma.cuh), so their A fragments are the
// previous product's accumulators as they stand. Zero past De or F. The
// forward splits units 0 and 1, the backward all three.
struct CfconvB {
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

constexpr int kRowTE = 128;  // edges of a row tile: two warpgroups of 64
constexpr int kRowKS = 4;    // most k-steps a stage holds

struct RowLayout {
  int ntw;  // n8-tiles of the F columns: np = 8 ntw (the row buffers' width)
  int np;
  int kt0;  // k-steps of pre = b·W0: ceil(De / 8)
  int ks;   // k-steps a stage holds (<= kRowKS)
  int ldt;  // row stride of the tile of a, dw and the epilogues (8 mod 32)
};

// Two W stages, the tile, and the tile's row scales, destinations and
// distances.
size_t row_shared_bytes(const RowLayout& b) {
  return sizeof(float) * (2 * (size_t)b.ks * kstep_words(b.np) +
                          (size_t)kRowTE * b.ldt + 2 * kRowTE) +
         sizeof(int) * kRowTE;
}

// The layout for width F: the most k-steps a stage whose shared memory
// fits. False where none fits or F > 256.
bool row_layout(const Geometry& g, RowLayout* b) {
  b->ntw = ntw_bucket((g.f + 7) / 8);
  if (b->ntw == 0) return false;
  b->np = 8 * b->ntw;
  b->kt0 = (g.de + 7) / 8;
  b->ldt = stride_acc(b->np);
  for (int ks = kRowKS; ks >= 1; --ks) {
    b->ks = ks;
    if (row_shared_bytes(*b) <= (size_t)kMaxShared) return true;
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

// Where a row product's A comes from: the Gaussian basis of the tile's
// distances, computed in registers; the tile; or ssp(tile + bias), zero for
// skipped rows and past F, computed in registers as each k-step's fragment
// is loaded, so that the shifted softplus runs while the tensor cores work.
enum ASource { kBasis, kTile, kSspTile };

// The row products of one tile of 128 edges, two warpgroups of 64 rows,
// each warp 16 rows x all np columns, chained into one set of
// accumulators. The split weights stream through a two-stage ring of ks
// k-steps (16-byte cp.async, one stage ahead, one barrier a stage; a
// stage's copies issued right after the previous stage's wgmma); each
// k-step issues three wgmma (3xTF32). Unit 0 (pre = b·W0) takes kBasis;
// units 1 and 2 read their A from the tile t_s (kTile or kSspTile), two
// 8-byte loads a k-step: to_tile left it there as the accumulators lay,
// and the B rows of W1 in pair order match. to_tile moves the
// accumulators into the tile (two 8-byte stores a pair, short code at any
// NTW), for an epilogue that runs as a rolled loop over whole rows or for
// the next product's A.
template <int NTW>
struct RowProducts {
  const uint32_t* ws;
  uint32_t* w_s;
  float* t_s;
  const Geometry& g;
  const RowLayout& b;
  int kw, stage_words, ns0, ns, stages, tq, r0;
  bool real[2];
  float dr[2];

  // units: W1's units after unit 0 (1 forward, 2 backward); sc_s and di_s
  // hold the tile's row scales and distances
  __device__ RowProducts(const uint32_t* ws_, uint32_t* w_s_, float* t_s_,
                         const float* sc_s, const float* di_s,
                         const Geometry& g_, const RowLayout& b_, int units)
      : ws(ws_), w_s(w_s_), t_s(t_s_), g(g_), b(b_) {
    kw = kstep_words(8 * NTW);
    stage_words = b.ks * kw;
    ns0 = (b.kt0 + b.ks - 1) / b.ks;
    ns = (NTW + b.ks - 1) / b.ks;
    stages = ns0 + units * ns;
    const int lane = threadIdx.x & 31;
    tq = lane & 3;
    r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);  // the lane's rows r0, r0 + 8
    real[0] = sc_s[r0] != 0.f;
    real[1] = sc_s[r0 + 8] != 0.f;
    dr[0] = di_s[r0];
    dr[1] = di_s[r0 + 8];
  }

  // stage s (ns0 of unit 0, then ns of each later unit): k-steps
  // [k0, k0 + cnt) of the split buffer, one cp.async group
  __device__ __forceinline__ void load_stage(int s) const {
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
  }

  // one product: stages [s0, s0 + n) over kt k-steps, A from `src` (bias:
  // the kSspTile source's)
  template <ASource src>
  __device__ __forceinline__ void run(int s0, int n, int kt,
                                      float (&acc)[NTW][4],
                                      const float* bias = nullptr) const {
    constexpr int NP = 8 * NTW;
    const float* ta = t_s + r0 * b.ldt + 2 * tq;  // the lane's A pairs
    for (int s = s0; s < s0 + n; ++s) {
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();  // stage s landed; every warp is done with s - 1
      const uint32_t* wst = w_s + (s & 1) * stage_words;
      const int j0 = (s - s0) * b.ks;
      const int nks = min(b.ks, kt - j0);
      uint32_t ahi[kRowKS][4], alo[kRowKS][4];
      fence_acc(acc);
#pragma unroll
      for (int ks = 0; ks < kRowKS; ++ks) {
        if (ks < nks) {  // uniform across the block
          const int j = j0 + ks;
          if (src == kBasis) {
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
            float2 p0 = *reinterpret_cast<const float2*>(ta + 8 * j);
            float2 p1 =
                *reinterpret_cast<const float2*>(ta + 8 * b.ldt + 8 * j);
            if (src == kSspTile) {
              const int c = 8 * j + 2 * tq;
              const float u0 = c < g.f ? __ldg(bias + c) : 0.f;
              const float u1 = c + 1 < g.f ? __ldg(bias + c + 1) : 0.f;
              p0.x = real[0] && c < g.f ? sspf(p0.x + u0) : 0.f;
              p0.y = real[0] && c + 1 < g.f ? sspf(p0.y + u1) : 0.f;
              p1.x = real[1] && c < g.f ? sspf(p1.x + u0) : 0.f;
              p1.y = real[1] && c + 1 < g.f ? sspf(p1.y + u1) : 0.f;
            }
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
      for (int ks = 0; ks < kRowKS; ++ks) {
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
  }

  // the accumulators into the tile, once every warp is done reading it
  __device__ __forceinline__ void to_tile(const float (&acc)[NTW][4]) const {
    __syncthreads();
    acc_to_tile(acc, t_s, b.ldt, r0, 0, tq);
    __syncthreads();
  }
};

// The shared memory of a row kernel (row_shared_bytes): the ring of two W
// stages, the tile, and the tile's row scales, distances and destinations.
struct RowShared {
  uint32_t* w_s;
  float* t_s;
  float* sc_s;
  float* di_s;
  int* dst_s;
};

__device__ __forceinline__ RowShared row_shared(const RowLayout& b,
                                                float4* smem4) {
  RowShared r;
  r.w_s = reinterpret_cast<uint32_t*>(smem4);  // 2 stages
  r.t_s = reinterpret_cast<float*>(r.w_s + 2 * b.ks * kstep_words(b.np));
  r.sc_s = r.t_s + kRowTE * b.ldt;
  r.di_s = r.sc_s + kRowTE;
  r.dst_s = reinterpret_cast<int*>(r.di_s + kRowTE);
  return r;
}

// out[dst[r], c] += t_s[r * ldt + c] for the tile's rows whose scale is
// not zero, c < f: warp w takes rows 16 w .. 16 w + 15 (their scales and
// destinations held in registers), lane l the columns l, l + 32, ...,
// loading its 16 values of a column at once; runs of equal dst are summed
// in a register and flushed with one atomicAdd. Right for any dst order.
__device__ void flush_slices(const float* t_s, int ldt, int f,
                             const float* sc_s, const int* dst_s,
                             float* __restrict__ out) {
  constexpr int R = kRowTE / (kThreads / 32);
  const int r0 = R * (threadIdx.x >> 5);
  int node[R];
#pragma unroll
  for (int k = 0; k < R; ++k) node[k] = sc_s[r0 + k] != 0.f ? dst_s[r0 + k] : -1;
  for (int c = threadIdx.x & 31; c < f; c += 32) {
    float v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = t_s[(r0 + k) * ldt + c];
    float acc = 0.f;
    int cur = -1;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (node[k] < 0) continue;
      if (node[k] != cur) {
        if (cur >= 0) atomicAdd(out + (long long)cur * f + c, acc);
        acc = 0.f;
        cur = node[k];
      }
      acc += v[k];
    }
    if (cur >= 0) atomicAdd(out + (long long)cur * f + c, acc);
  }
}

// The forward for one tile of 128 edges. Product 1: pre = b·W0, into the
// tile. Product 2: w = a·W1 with a = ssp(pre + b0) formed fragment by
// fragment (kSspTile). Epilogue msg = s * xj * (w + b1) on the
// accumulators, each of the lane's two rows' xj values (prefetched into L2
// at the tile's start) loaded all at once, then into the tile, which
// flush_slices adds into out by runs of equal dst (right for any dst
// order). Nothing but out is written; a tile with no real edge costs one
// barrier.
template <int NTW>
__global__ void __launch_bounds__(kThreads, 1)
fused_cfconv_fwd_kernel(const float* __restrict__ xj,
                        const float* __restrict__ dist,
                        const float* __restrict__ wraw,
                        const int* __restrict__ dst,
                        const float* __restrict__ mask,
                        const uint32_t* __restrict__ ws,
                        const float* __restrict__ b0,
                        const float* __restrict__ b1,
                        float* __restrict__ out, Geometry g, RowLayout b) {
  extern __shared__ float4 smem4[];
  const RowShared sh = row_shared(b, smem4);
  const long long e0 = (long long)blockIdx.x * kRowTE;
  if (threadIdx.x < kRowTE) {
    const long long e = e0 + threadIdx.x;
    sh.di_s[threadIdx.x] = e < g.e ? dist[e] : 0.f;
  }
  if (!load_edges<kRowTE>(dst, mask, wraw, e0, g, sh.sc_s, sh.dst_s)) return;
  if (threadIdx.x == 0) {  // the xj rows of epilogue 2
    prefetch_l2(xj + e0 * g.f, min((long long)kRowTE, g.e - e0) * g.f * 4);
  }
  const RowProducts<NTW> p(ws, sh.w_s, sh.t_s, sh.sc_s, sh.di_s, g, b, 1);
  p.load_stage(0);
  float acc[NTW][4];

  p.template run<kBasis>(0, p.ns0, b.kt0, acc);
  p.to_tile(acc);
  p.template run<kSspTile>(p.ns0, p.ns, NTW, acc, b0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows r0 and r0 + 8
    const int r = p.r0 + 8 * h;
    const float s = sh.sc_s[r];
    const float* xr = xj + (e0 + r) * g.f;
    float xv[NTW][2];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {  // the loads first, all in flight
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = 8 * j + 2 * p.tq + q;
        xv[j][q] = s != 0.f && c < g.f ? xr[c] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = 8 * j + 2 * p.tq + q;
        float& v = acc[j][2 * h + q];
        v = c < g.f ? s * xv[j][q] * (v + __ldg(b1 + c)) : 0.f;
      }
    }
  }
  p.to_tile(acc);
  flush_slices(sh.t_s, b.ldt, g.f, sh.sc_s, sh.dst_s, out);
}

// The backward's edge rows for one tile of 128 edges: products 1 and 2 as
// the forward's, then dw·W1^T. Epilogues: (1) pre = + b0, a = ssp(pre);
// the rows a and pre; (2) w = + b1, gg = g[dst] * s, d_xj = gg * w, dw =
// gg * xj; the rows d_xj and dw; (3) dpre = that * sigmoid(pre), pre read
// back from the dpre row. Rows of edges whose s is 0 are not written; a
// tile with no real edge costs one barrier.
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
                        Geometry g, RowLayout b) {
  constexpr int NP = 8 * NTW;
  constexpr int U = 8;  // tile elements a thread has in flight
  extern __shared__ float4 smem4[];
  const RowShared sh = row_shared(b, smem4);
  float* t_s = sh.t_s;
  const float* sc_s = sh.sc_s;
  const int* dst_s = sh.dst_s;
  const long long e0 = (long long)blockIdx.x * kRowTE;
  if (threadIdx.x < kRowTE) {
    const long long e = e0 + threadIdx.x;
    sh.di_s[threadIdx.x] = e < g.e ? dist[e] : 0.f;
  }
  if (!load_edges<kRowTE>(dst, mask, wraw, e0, g, sh.sc_s, sh.dst_s)) return;
  if (threadIdx.x == 0) {  // the xj rows and, dst sorted, the g rows of epilogue 2
    const long long rows = min((long long)kRowTE, g.e - e0);
    prefetch_l2(xj + e0 * g.f, rows * g.f * 4);
    const int lo = dst_s[0], hi = dst_s[rows - 1];
    if (lo <= hi && hi - lo < 2 * kRowTE) {
      prefetch_l2(gout + (long long)lo * g.f, (long long)(hi - lo + 1) * g.f * 4);
    }
  }
  const RowProducts<NTW> p(ws, sh.w_s, t_s, sc_s, sh.di_s, g, b, 2);
  p.load_stage(0);
  float acc[NTW][4];

  // product 1 and its epilogue: pre = + b0, a = ssp(pre); rows pre (into
  // dprow) and a; a stays in the tile as product 2's A
  p.template run<kBasis>(0, p.ns0, b.kt0, acc);
  p.to_tile(acc);
  for (int i0 = threadIdx.x; i0 < kRowTE * NP; i0 += U * kThreads) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= kRowTE * NP) break;
      const int r = i / NP;
      const int c = i - r * NP;
      float* q = t_s + r * b.ldt + c;
      const bool in = c < g.f;
      const float pre = *q + (in ? __ldg(b0 + c) : 0.f);
      const bool on = sc_s[r] != 0.f;
      const float a = on && in ? sspf(pre) : 0.f;
      if (on) {
        const long long at = (e0 + r) * NP + c;
        arow[at] = a;
        dprow[at] = pre;
      }
      *q = a;
    }
  }
  // product 2 and its epilogue: w = + b1, gg = g[dst] * s, d_xj = gg * w,
  // dw = gg * xj; the row dw; dw stays in the tile as product 3's A
  p.template run<kTile>(p.ns0, p.ns, NTW, acc);
  p.to_tile(acc);
  for (int i0 = threadIdx.x; i0 < kRowTE * NP; i0 += U * kThreads) {
    float gv[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // the loads first, all in flight
      const int i = i0 + u * kThreads;
      const int r = i / NP;
      const int c = i - r * NP;
      const bool in = i < kRowTE * NP && sc_s[r] != 0.f && c < g.f;
      gv[u] = in ? gout[(long long)dst_s[r] * g.f + c] : 0.f;
      xv[u] = in ? xj[(e0 + r) * g.f + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= kRowTE * NP) break;
      const int r = i / NP;
      const int c = i - r * NP;
      float* q = t_s + r * b.ldt + c;
      const float s = sc_s[r];
      float dw = 0.f;
      if (s != 0.f) {
        const long long e = e0 + r;
        if (c < g.f) {
          const float gg = gv[u] * s;
          dxj[e * g.f + c] = gg * (*q + __ldg(b1 + c));
          dw = gg * xv[u];
        }
        dwrow[e * NP + c] = dw;
      }
      *q = dw;
    }
  }
  // product 3 and its epilogue: dpre = (dw · W1^T) * sigmoid(pre), pre
  // read back from the dpre row
  p.template run<kTile>(p.ns0 + p.ns, p.ns, NTW, acc);
  p.to_tile(acc);
  for (int i0 = threadIdx.x; i0 < kRowTE * NP; i0 += U * kThreads) {
    float pv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / NP;
      pv[u] = i < kRowTE * NP && sc_s[r] != 0.f
                  ? dprow[(e0 + r) * NP + i - r * NP] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= kRowTE * NP) break;
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

template <int NTW>
int launch_fwd(const float* xj, const float* dist, const float* wraw,
               const int* dst, const float* mask, const uint32_t* ws,
               const float* b0, const float* b1, float* out,
               const Geometry& g, const RowLayout& b, cudaStream_t s) {
  const size_t smem = row_shared_bytes(b);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cfconv_fwd_kernel<NTW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + kRowTE - 1) / kRowTE;
  fused_cfconv_fwd_kernel<NTW><<<(unsigned)tiles, kThreads, smem, s>>>(
      xj, dist, wraw, dst, mask, ws, b0, b1, out, g, b);
  return (int)cudaGetLastError();
}

template <int NTW>
int launch_bwd(const float* xj, const float* dist, const float* wraw,
               const int* dst, const float* mask, const uint32_t* ws,
               const float* b0, const float* b1, const float* gout,
               float* dxj, float* arow, float* dwrow, float* dprow,
               const Geometry& g, const RowLayout& b, cudaStream_t s) {
  const size_t smem = row_shared_bytes(b);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cfconv_bwd_kernel<NTW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + kRowTE - 1) / kRowTE;
  fused_cfconv_bwd_kernel<NTW><<<(unsigned)tiles, kThreads, smem, s>>>(
      xj, dist, wraw, dst, mask, ws, b0, b1, gout, dxj, arow, dwrow, dprow,
      g, b);
  return (int)cudaGetLastError();
}

// Words of the split weights of a row kernel whose products read W1 in
// `units` units after W0 (1: the forward, 2: the backward), or -kBadShape
// for an unsupported width.
long long split_words(int f, int de, int units) {
  if (f < 1 || f > 256 || de < 1) return -kBadShape;
  RowLayout b;
  if (!row_layout(make_geometry(0, f, de, 0, 0.f, 0.f, 0.f), &b)) {
    return -kBadShape;
  }
  return (long long)(b.kt0 + units * b.ntw) * kstep_words(b.np);
}

// Splits units 0 .. units of the row products' B operands (CfconvB) into
// ws; 0 or a cudaError_t.
int split_weights(const void* w0, const void* w1, int units,
                  const Geometry& g, const RowLayout& b, uint32_t* ws,
                  cudaStream_t s) {
  return launch_split(
      CfconvB{static_cast<const float*>(w0), static_cast<const float*>(w1),
              g.f, g.de, b.kt0, b.ntw},
      b.kt0 + units * b.ntw, b.np, ws, s);
}

}  // namespace

extern "C" {

// Floats per block of the weight gradients' partial buffer (the caller
// allocates blocks times that many zeros).
long long mdl_fused_cfconv_partial_floats(int f, int de) {
  const Geometry g = make_geometry(0, f, de, 0, 0.f, 0.f, 0.f);
  return (long long)(g.ldz0 + g.ldz1) * g.ldn;
}

// Words of the forward's split weights (its ws argument), or -kBadShape
// for an unsupported width.
long long mdl_fused_cfconv_fwd_split_words(int f, int de) {
  return split_words(f, de, 1);
}

// All pointers are device pointers on the current device. w0 (De x F) and
// w1 (F x F) without their biases b0 and b1 (F each); ws holds
// mdl_fused_cfconv_fwd_split_words(f, de) words, no initial value needed;
// out holds n*f zeros; mask may be null (every edge real). Launches the
// weight split, then the tiles. Returns 0 or a cudaError_t (kBadShape for
// an unsupported F or De).
int mdl_fused_cfconv_fwd(const void* xj, const void* dist, const void* wraw,
                         const void* dst, const void* mask, const void* w0,
                         const void* b0, const void* w1, const void* b1,
                         void* ws, void* out, long long e, int f, int de,
                         int n, float coeff, float step, float scale,
                         void* stream) {
  if (f < 1 || f > 256 || de < 1) return kBadShape;
  const Geometry g = make_geometry(e, f, de, n, coeff, step, scale);
  RowLayout b;
  if (!row_layout(g, &b)) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* wsp = static_cast<uint32_t*>(ws);
  const int err = split_weights(w0, w1, 1, g, b, wsp, s);
  if (err != 0) return err;
  const float* xp = static_cast<const float*>(xj);
  const float* dp = static_cast<const float*>(dist);
  const float* rp = static_cast<const float*>(wraw);
  const int* dsp = static_cast<const int*>(dst);
  const float* mp = static_cast<const float*>(mask);
  const float* b0p = static_cast<const float*>(b0);
  const float* b1p = static_cast<const float*>(b1);
  float* op = static_cast<float*>(out);
  switch (b.ntw) {
    case 4: return launch_fwd<4>(xp, dp, rp, dsp, mp, wsp, b0p, b1p, op, g, b, s);
    case 13: return launch_fwd<13>(xp, dp, rp, dsp, mp, wsp, b0p, b1p, op, g, b, s);
    case 19: return launch_fwd<19>(xp, dp, rp, dsp, mp, wsp, b0p, b1p, op, g, b, s);
    case 25: return launch_fwd<25>(xp, dp, rp, dsp, mp, wsp, b0p, b1p, op, g, b, s);
    case 32: return launch_fwd<32>(xp, dp, rp, dsp, mp, wsp, b0p, b1p, op, g, b, s);
    default: return kBadShape;
  }
}

// Width of the backward's row buffers (a, dw, dpre): 8 ntw_bucket(ceil(F /
// 8)) >= F columns.
int mdl_fused_cfconv_row_width(int f) { return 8 * ntw_bucket((f + 7) / 8); }

// Words of the backward's split weights (its ws argument), or -kBadShape
// for an unsupported width.
long long mdl_fused_cfconv_bwd_split_words(int f, int de) {
  return split_words(f, de, 2);
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
  RowLayout b;
  if (!row_layout(g, &b)) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* wsp = static_cast<uint32_t*>(ws);
  const int err = split_weights(w0, w1, 2, g, b, wsp, s);
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
