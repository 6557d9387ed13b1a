// NNConv's bilinear edge message: the bf16 arm (`precision: bf16`) of its
// forward, its backward to the rows and its weight gradient on Hopper's
// bf16 tensor cores (sm_90a), with a plain C interface for ctypes (bound in
// matdeeplearn_torch/ops/fused_bilinear.py).
//
// For the arm the reference package calls mxu_bf16,
// mdl_fused_bilinear_bf16_fwd replaces ops/pallas_bilinear.py:
// _fwd_kernel_chunked and :_fwd_kernel; mdl_fused_bilinear_bf16_fwd_image
// (on the cotangent) and mdl_fused_bilinear_bf16_bwd_a replace the backward
// to the rows (d_xj, d_a) of :_bwd_kernel_chunked and :_bwd_kernel, and
// mdl_fused_bilinear_bf16_wgrad their weight gradient (fused_bilinear.cu,
// the f32 arm, gives the notation). The function and its rounding points
// are the chunked schedule's, with X[e, h D + d] = [a | 1][e, h] * xj[e, d]
// and ge = mask * g:
//   msg      = mask * (bf16(X_{h<H}) @ bf16(W1) + xj @ b1)
//   d_xj     = mask * (Σ_{h<H} bf16(a_h ge) @ bf16(W1[h])^T + ge @ b1^T)
//   d_a[:,h] = rowsum((bf16(xj) @ bf16(W1[h])) * ge)
//   dW       = bf16(X)^T bf16(ge)            (the bias unit's rows too)
// (:194-197, :215-217 and the wrapper's g @ b1^T, :406). A product of two
// bf16 values is exact in f32, so `wgmma ... .f32.bf16.bf16` forms exactly
// the products of the arm's plain versions (ops/fused_bilinear.py); only
// the order of the f32 sums differs.
//
// Bound: operations. At chip_smoke's training batch (45,509 real edges,
// D = H = K = 100) the forward and the weight gradient each do 9.24e10
// operations, 0.0934 ms at the dense BF16 rate (989.4 TFLOP/s), the
// backward to the rows twice as many tensor products (d_xj's and d_a's):
// 0.0948 ms counts the function as the f32 arm's U = ge @ W^T once. What
// holds them back (PERF.md §6): forming X (an f32 multiply and half a
// cvt.rn.bf16x2.f32 an entry, its f32 operands read from shared memory, 4
// bytes an entry in the weight gradient), the B tiles' shared-memory reads,
// and each warpgroup's chain of wgmma into one accumulator, each waiting on
// the one before.
//
// * mdl_fused_bilinear_bf16_fwd. A layout kernel writes W once a call as the
//   exact shared-memory image of the wgmma B operand (K-major core matrices of
//   8 rows x 16 bytes without swizzle, wgmma.cuh:b_desc): bf16(W1) unit after
//   unit, each unit's D rows padded to whole k16-steps (kd = round16(D) / 16)
//   by np = 8 NTW >= round8(K) columns, then b1 split into TF32 hi and lo for
//   the bias unit. A block of consumer warpgroups, one m64 tile of edges each
//   (three up to K = 152, else two), and one producer warp owns a tile of 192
//   (128) edges. The producer's lane 0 streams the image through a ring of 2-4
//   stages of up to 32 KB (a stage: ks consecutive k16-steps, across units),
//   each one cp.async.bulk that completes on the stage's `full` mbarrier; the
//   consumers give a stage back on its `empty` mbarrier once its last wgmma
//   retired. No block barrier in the loop. X never lies in shared memory: each
//   consumer thread keeps the xj values of its A fragments in f32 in shared
//   memory slots of its own (two 16-byte loads a k16-step), multiplies them by
//   its rows' a[e, h] and packs them by cvt.rn.bf16x2.f32 (round to nearest
//   even of the f32 product: round_bf16's point) into the A registers of wgmma
//   m64nNk16, a batch of 8 k16-steps at a time (4 past K = 104, 2 past K =
//   200), each step's A in registers of its own; the batch's wgmma go as one
//   group, waited for before the next batch is built (A registers are read
//   asynchronously: none may be written while a group that reads them is in
//   flight). Stages hold whole batches (the image is padded with zero
//   k16-steps), so no wgmma sits in a branch. The bias unit comes last in
//   3xTF32 (wgmma m64nNk8 on the f32 xj split into hi and lo), so xj @ b1
//   keeps f32 accuracy as the chunked schedule keeps it. At D = H = K = 100:
//   stages of 8 k16-steps (26.6 KB) in a ring of 4, 193 KB of shared memory; W
//   is read from L2 once per tile with a real edge (2.44 MB: ~0.58 GB at that
//   batch, against 1.4 GB of f32 W and its split for the f32 kernel). A tile
//   with no real edge returns at once; the epilogue scales by the mask and
//   writes real rows only; no atomics.
// * the backward to the rows: two layout kernels write the forward's image
//   of W1 (for d_a) and of each unit's transpose W1[h]^T with b1^T (for
//   d_xj), then two kernels. d_xj is the forward's own function with D and
//   K exchanged: mdl_fused_bilinear_bf16_fwd_image runs the forward's tiles
//   on xj := g over the transposed image (the mask is 0 or 1, so masking
//   the output masks ge), bf16(a_h g) formed in registers as the forward
//   forms bf16(a_h xj), the bias unit g @ b1^T in 3xTF32. d_a runs on
//   mdl_fused_bilinear_bf16_bwd_a: a tile of 128 edges in two consumer
//   warpgroups (one m64 tile each) and a producer warp whose lane 0 streams
//   the forward's image a whole unit a stage (kd k16-steps of np rows, 23.3
//   KB at D = K = 100) through a ring of up to 4 slots by cp.async.bulk on
//   mbarriers; the d_a tile has no bias unit. Its A, bf16(xj), is the same
//   for every unit: each consumer thread packs its rows' k16-steps
//   (cvt.rn.bf16x2.f32) into registers once a tile (28 at D = 100, the
//   steps rounded up to 4, 7, 10 or 16 with zeros, so that no wgmma sits
//   in a branch), and none of them is written again. Per unit the
//   warpgroup issues its wgmma m64nNk16 into T_h (52 registers at K =
//   100), waits, gives the slot back and reduces each row: the fmaf chain
//   of T_h against f32 mask * g at the same positions (kept in 52
//   registers while they fit beside A and T, else read from L1), then the 4
//   lanes of the quad. The other warpgroup's products can run while one
//   reduces. Per unit and tile at D = K = 100, counted from the shapes:
//   ~728 cycles of tensor work, the two warpgroups' B reads of 46.6 KB
//   from shared memory (~364 cycles at 128 B a cycle; g stays out of
//   shared memory), and the unit's 23.3 KB streamed from L2 into every SM
//   (the whole 2.33 MB image once per tile: ~0.83 GB a call at chip_smoke's
//   batch). PERF.md §6 gives what it measures against these. No atomics:
//   d_xj and d_a are the same bits from run to run; masked rows stay the
//   caller's zeros; a tile with no real edge returns at once.
// * mdl_fused_bilinear_bf16_wgrad: dW = bf16(X)^T bf16(mask * g) as a split-K
//   GEMM over the 64-edge chunks that hold a real edge
//   (live_chunks_kernel<64>). A prologue writes bf16(mask * g) of each listed
//   chunk once a call as that chunk's wgmma B image (4 k16-steps by np
//   columns, 13.3 KB at K = 100). Block (split s, tile) owns 256 flat rows of
//   dW (128 past K = 104) and all np columns in two consumer warpgroups and
//   walks the chunks s, s + S, ...; its producer warp brings each chunk in
//   through a ring of 2-4 stages: the B image and the chunk's xj rows as they
//   lie in memory (64 x D f32) by two bulk copies, the [a | 1] columns of the
//   tile's units (unit-major) by the warp's own loads. Each consumer thread
//   forms its A fragments of X^T in registers from those f32 rows (a * xj
//   rounded by cvt.rn.bf16x2.f32), the chunk's 4 k16-steps as one batch as in
//   the forward, and issues wgmma m64nNk16. At D = H = K = 100: 40 row tiles
//   (the f32 kernel: 79 of 128 rows), 40 KB a stage, a ring of 4; xj is read
//   from L2 once per row tile and chunk (~0.73 GB, and ~0.38 GB of the bf16 g
//   image, at that batch). Each block writes its tile once into its split's
//   partial, and wgrad_reduce_kernel (edge_tile.cuh) adds the S partials in a
//   fixed order: dW is bit-identical from run to run, with no atomics.
//
// A block's warps share the SM's four register quarters: 9 warps (two
// consumer warpgroups and the producer warp) put 3 on a quarter, so at most
// 168 registers a thread, 13 warps 128. That sets the tiles: the forward's
// accumulators take 52 at K = 100 and a batch's A fragments 32 (three
// warpgroups); the weight gradient's 104 (two m64 tiles a warpgroup, so
// that each chunk of xj is read from L2 by half as many row tiles) and a
// chunk's A fragments 32; d_a's A 28, T 52 and mask * g 52 (two
// warpgroups). Past K = 200, or past D = 160 with K > 152, d_a's A and T
// do not fit beside the addresses and ptxas spills or serialises: right,
// slow, off the main path.
//
// The caller allocates everything, the images and out, d_xj and d_a
// (zeros) too; the kernels never synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "edge_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kCW = 8;                  // consumer warps: two warpgroups
constexpr int kBlock = 32 * (kCW + 1);  // and one producer warp
constexpr int kStageMax = 32768;        // most bytes of a ring stage
constexpr int kChunk = 64;              // edges of a weight-gradient chunk

struct Geometry {
  long long e;  // edge slots
  int d;        // xj width D
  int k;        // message width K
  int h;        // hidden units H (W holds H + 1 units)
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Two f32 values rounded to bf16 (to nearest, ties to even) in one
// register, lo in the lower half: cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int MT_, int NTW_>
struct Tag {
  static constexpr int MT = MT_;
  static constexpr int NTW = NTW_;
};

// f(Tag<MT, NTW>) for the weight gradient's tilings: MT 2 for NTW 4 and
// 13, MT 1 for NTW 4, 13, 19, 25 and 32.
template <class F>
int dispatch(int mt, int ntw, F&& f) {
  if (mt == 2) {
    switch (ntw) {
      case 4: return f(Tag<2, 4>{});
      case 13: return f(Tag<2, 13>{});
      default: return kBadShape;
    }
  }
  switch (ntw) {
    case 4: return f(Tag<1, 4>{});
    case 13: return f(Tag<1, 13>{});
    case 19: return f(Tag<1, 19>{});
    case 25: return f(Tag<1, 25>{});
    case 32: return f(Tag<1, 32>{});
    default: return kBadShape;
  }
}

// ---- the forward: msg = mask * (X @ W) ------------------------------------

// Consumer warpgroups of a forward block, one m64 tile of edges each: 3
// (13 warps, at most 128 registers a thread) while the accumulators leave
// room, else 2 (9 warps, 168). Each warpgroup's wgmma chain into its
// accumulators waits on the one before, so more warpgroups keep more
// products in flight.
__host__ __device__ constexpr int fwd_groups(int ntw) { return ntw <= 19 ? 3 : 2; }

// k16-steps a forward wgmma group takes: as many as the registers allow
// beside the 4 NTW accumulators (a step's A fragment is 4 registers).
__host__ __device__ constexpr int fwd_batch(int ntw) {
  return ntw <= 13 ? 8 : ntw <= 25 ? 4 : 2;
}

struct FwdPlan {
  int kd;           // k16-steps of a unit: round16(D) / 16
  int np;           // B rows of the image (message columns): 8 NTW
  int steps;        // bf16 k16-steps of the image: H kd, padded with zero
                    // steps to whole stages
  int ks;           // bf16 k16-steps a stage holds: a multiple of the batch
  int kb;           // bias k16-steps a stage holds (hi and lo: 4x the bytes)
  int nbs;          // bf16 stages
  int stages;       // all stages
  int ring;         // slots of the ring
  int stage_bytes;  // bytes of a slot
  long long bias_off;  // byte offset of the bias part of the image
};

// A consumer thread's xj slots: kd k16-steps x two halves of 16 bytes,
// laid out so that a warp's 16-byte loads are contiguous.
size_t fwd_xf_bytes(int kd, int ncw) { return (size_t)kd * 2 * 128 * ncw * 16; }

// The mask of the tile and the ring's barriers.
size_t fwd_misc_bytes(int ncw, int ring) { return (size_t)64 * ncw * 4 + 2 * ring * 8; }

size_t fwd_shared_bytes(const FwdPlan& p, int ncw) {
  return (size_t)p.ring * p.stage_bytes + fwd_xf_bytes(p.kd, ncw) +
         fwd_misc_bytes(ncw, p.ring);
}

// The deepest ring (4, 3 or 2 slots) whose slots take a batch of bf16
// k16-steps and a bias k16-step beside the xj slots; false where none fits.
bool fwd_plan(const Geometry& g, int ntw, FwdPlan* p) {
  const int batch = fwd_batch(ntw);
  const int ncw = fwd_groups(ntw);
  p->kd = round16(g.d) / 16;
  p->np = 8 * ntw;
  const int real = g.h * p->kd;
  for (int ring = 4; ring >= 2; --ring) {
    const long long left = (long long)kMaxShared - (long long)fwd_xf_bytes(p->kd, ncw) -
                           (long long)fwd_misc_bytes(ncw, ring);
    if (left <= 0) continue;
    const int cap = (int)std::min<long long>(left / ring, kStageMax) & ~255;
    const int most = cap / (p->np * 32) / batch * batch;
    const int kb = std::min(p->kd, cap / (p->np * 128));
    if (most < batch || kb < 1) continue;
    // the fewest stages, then the steps dealt evenly in whole batches
    const int nbs = (std::max(real, 1) + most - 1) / most;
    const int per = (std::max(real, 1) + nbs - 1) / nbs;
    p->ks = (per + batch - 1) / batch * batch;
    p->steps = real == 0 ? 0 : nbs * p->ks;
    p->nbs = real == 0 ? 0 : nbs;
    p->kb = kb;
    p->ring = ring;
    p->stages = p->nbs + (p->kd + kb - 1) / kb;
    p->stage_bytes = std::max(p->ks * p->np * 32, kb * p->np * 128);
    p->bias_off = (long long)p->steps * p->np * 32;
    return true;
  }
  return false;
}

long long fwd_image_bytes(const FwdPlan& p) {
  return p.bias_off + (long long)p.kd * p.np * 128;
}

// The forward's plan for these widths; NTW is the wgmma width bucket of
// round8(K).
int fwd_choose(const Geometry& g, FwdPlan* p) {
  const int ntw = ntw_bucket(round8(g.k) / 8);
  if (ntw == 0 || !fwd_plan(g, ntw, p)) return kBadShape;
  return 0;
}

// bf16(W1) as the forward's B: for k16-step j = h kd + s and core-matrix
// row q = (n8 * 2 + kh) * 8 + r of the step, the 16 bytes of row j * 2 np +
// q hold bf16(W1[h D + 16 s + 8 kh + c][8 n8 + r]) for c < 8 (zero past D,
// K and the last unit): b_desc's layout, 2 np rows of 16 bytes a
// k16-step. With `transposed` the caller's w1 holds each unit as a K x D
// matrix (the weight of widths (K, D)) and the image is of its transpose:
// element (row d, column n) of unit h is w1[h D K + n D + d]. One thread
// writes one row.
__global__ void __launch_bounds__(kThreads)
w_image_kernel(const float* __restrict__ w1, Geometry g, int kd, int np,
               long long rows, int transposed, uint4* __restrict__ img) {
  const long long rs = transposed ? 1 : g.k;  // strides of a row, a column
  const long long cs = transposed ? g.d : 1;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < rows;
       i += (long long)gridDim.x * kThreads) {
    const int r = (int)(i & 7);
    const int kh = (int)((i >> 3) & 1);
    const long long rest = i >> 4;
    const int n8 = (int)(rest % (np / 8));
    const long long j = rest / (np / 8);
    const int h = (int)(j / kd);
    const int d0 = 16 * (int)(j - (long long)h * kd) + 8 * kh;
    const int n = 8 * n8 + r;
    const float* src = w1 + (long long)h * g.d * g.k + n * cs;
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      v[c] = h < g.h && d0 + c < g.d && n < g.k ? src[(d0 + c) * rs] : 0.f;
    }
    img[i] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                        pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// b1 as the bias unit's B in TF32 (split_kmajor_kernel's Src): k8-step t
// of 2 kd, B row n, position c < 8 is b1[8 t + pair_col(c)][n]. Positions
// c and c + 4 of a k8-step hold the columns 2c and 2c + 1 because the A
// fragment of k8-step t is the lane's xj pair of k16-step t / 2, half t %
// 2 (columns 2 tq and 2 tq + 1 at positions tq and tq + 4).
// With `transposed`, b1 holds the bias of widths (K, D) and this is its
// transpose: b1[n D + dd].
struct BiasB {
  const float* b1;
  int d, k, transposed;
  __device__ float operator()(long long t, int n, int c) const {
    const int dd = 8 * (int)t + pair_col(c);
    if (dd >= d || n >= k) return 0.f;
    return transposed ? b1[(long long)n * d + dd] : b1[(long long)dd * k + n];
  }
};

// Launches the two layout kernels: bf16(W1) at img, b1's split after it
// (of each unit's transpose and b1's with `transposed`).
int launch_image(const float* w1, const float* b1, uint8_t* img,
                 const Geometry& g, const FwdPlan& p, int transposed,
                 cudaStream_t s) {
  const long long rows = (long long)p.steps * p.np * 2;
  if (rows > 0) {
    const long long blocks = (rows + kThreads - 1) / kThreads;
    w_image_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), kThreads, 0,
                     s>>>(w1, g, p.kd, p.np, rows, transposed,
                          reinterpret_cast<uint4*>(img));
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return launch_split(BiasB{b1, g.d, g.k, transposed}, 2LL * p.kd, p.np,
                      reinterpret_cast<uint32_t*>(img + p.bias_off), s);
}

// Stage i of the image: its byte offset and size.
__device__ __forceinline__ void fwd_stage(const FwdPlan& p, int i,
                                          long long* off, int* bytes) {
  if (i < p.nbs) {
    *off = (long long)i * p.ks * p.np * 32;
    *bytes = p.ks * p.np * 32;
  } else {
    const int s0 = (i - p.nbs) * p.kb;
    *off = p.bias_off + (long long)s0 * p.np * 128;
    *bytes = min(p.kb, p.kd - s0) * p.np * 128;
  }
}

// One tile of 64 NCW edges: consumer warpgroup wg owns rows 64 wg .. (warp
// w of it rows 64 wg + 16 w ..), all np columns; warp 4 NCW is the
// producer. For
// lane (gr, tq) the xj slot of k16-step s, half hf holds {xj[r][c], xj[r][c
// + 1], xj[r + 8][c], xj[r + 8][c + 1]} with r its row, c = 16 s + 8 hf + 2
// tq (zero past D and on masked rows): the A pairs of the bf16 k16-step,
// and the A fragments of the bias unit's two k8-steps in pair_col order.
// Every stage of bf16 steps is ks / KB whole batches (the image's padding
// steps are zeros, their a zero), so no wgmma sits in a branch.
template <int NTW, int NCW = fwd_groups(NTW)>
__global__ void __launch_bounds__(128 * NCW + 32, 1)
bilinear_bf16_fwd_kernel(const float* __restrict__ xj,
                         const float* __restrict__ a,
                         const uint8_t* __restrict__ img,
                         const float* __restrict__ mask,
                         float* __restrict__ out, Geometry g, FwdPlan p) {
  constexpr int KB = fwd_batch(NTW);
  constexpr int TE = 64 * NCW;   // edges of the tile
  constexpr int NCT = 128 * NCW;  // consumer threads
  extern __shared__ __align__(128) uint8_t smem_b[];
  uint8_t* ring = smem_b;
  float4* xf = reinterpret_cast<float4*>(ring + (size_t)p.ring * p.stage_bytes);
  float* sc_s = reinterpret_cast<float*>(xf + (size_t)p.kd * 2 * NCT);
  uint64_t* full = reinterpret_cast<uint64_t*>(sc_s + TE);
  uint64_t* empty = full + p.ring;

  const long long e0 = (long long)blockIdx.x * TE;
  if (!load_scale<TE>(mask, e0, g.e, sc_s)) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.ring; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NCW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NCW) {  // the producer: one bulk copy a stage
    if (lane == 0) {
      for (int i = 0; i < p.stages; ++i) {
        const int slot = i % p.ring;
        if (i >= p.ring) mbar_wait(empty + slot, ((i / p.ring) - 1) & 1);
        long long off;
        int bytes;
        fwd_stage(p, i, &off, &bytes);
        mbar_arrive_tx(full + slot, (uint32_t)bytes);
        bulk_g2s(ring + (size_t)slot * p.stage_bytes, img + off,
                 (uint32_t)bytes, full + slot);
      }
    }
    return;
  }

  const int ct = threadIdx.x;  // consumer thread
  const int r0 = 16 * warp + (lane >> 2);  // the lane's rows r0 and r0 + 8
  const int tq = lane & 3;
  const bool real0 = sc_s[r0] != 0.f;
  const bool real1 = sc_s[r0 + 8] != 0.f;
  for (int s = 0; s < p.kd; ++s) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = 16 * s + 8 * hf + 2 * tq;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = c + (q & 1);
        const bool real = q < 2 ? real0 : real1;
        v[q] = real && col < g.d ? __ldg(xj + (e0 + r0 + 8 * (q >> 1)) * g.d + col)
                                 : 0.f;
      }
      xf[(s * 2 + hf) * NCT + ct] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }

  // a[e, h] of the lane's rows for the current unit and the next (zero on
  // masked rows and past the last unit)
  const float* a0p = a + (e0 + r0) * g.h;
  const float* a1p = a0p + 8 * g.h;
  auto a_of = [&](int h, bool real, const float* ap) {
    return real && h < g.h ? __ldg(ap + h) : 0.f;
  };
  float a0 = a_of(0, real0, a0p), a1 = a_of(0, real1, a1p);
  float n0 = a_of(1, real0, a0p), n1 = a_of(1, real1, a1p);

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  int s = 0;  // the k16-step within its unit of the next bf16 step
  int h = 0;  // and its unit
  auto give_back = [&](int slot) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
  };
  for (int i = 0; i < p.nbs; ++i) {
    const int slot = i % p.ring;
    mbar_wait(full + slot, (i / p.ring) & 1);
    const uint8_t* st = ring + (size_t)slot * p.stage_bytes;
    for (int q0 = 0; q0 < p.ks; q0 += KB) {
      // A = bf16(a[e, h] * xj) of the batch's k16-steps, each in registers
      // of its own: no wgmma that reads them is in flight while they are
      // written
      uint32_t af[KB][4];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        const float4 v0 = xf[(s * 2) * NCT + ct];
        const float4 v1 = xf[(s * 2 + 1) * NCT + ct];
        af[kk][0] = pack_bf16(a0 * v0.x, a0 * v0.y);
        af[kk][1] = pack_bf16(a1 * v0.z, a1 * v0.w);
        af[kk][2] = pack_bf16(a0 * v1.x, a0 * v1.y);
        af[kk][3] = pack_bf16(a1 * v1.z, a1 * v1.w);
        if (++s == p.kd) {  // the next unit
          s = 0;
          ++h;
          a0 = n0;
          a1 = n1;
          n0 = a_of(h + 1, real0, a0p);
          n1 = a_of(h + 1, real1, a1p);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        WgmmaBf16<NTW>::mma(acc, af[kk], b_desc(st + (q0 + kk) * p.np * 32), 1);
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int kk = 0; kk < KB; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) fence_reg(af[kk][q]);
    }
    give_back(slot);
  }

  // the bias unit: xj @ b1 in 3xTF32, two k8-steps a k16-step
  for (int i = p.nbs; i < p.stages; ++i) {
    const int slot = i % p.ring;
    mbar_wait(full + slot, (i / p.ring) & 1);
    const uint8_t* st = ring + (size_t)slot * p.stage_bytes;
    const int s0 = (i - p.nbs) * p.kb;
    const int n = min(p.kb, p.kd - s0);
    for (int q = 0; q < n; ++q) {
      uint32_t hi[2][4], lo[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float4 v = xf[((s0 + q) * 2 + hf) * NCT + ct];
        split_a(v.x, v.z, v.y, v.w, hi[hf], lo[hf]);
      }
      const uint8_t* base = st + q * p.np * 128;
      wgmma_fence();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        wgmma_3xtf32(acc, hi[hf], lo[hf], b_desc(base + hf * p.np * 64),
                     b_desc(base + hf * p.np * 64 + p.np * 32), 1);
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fence_reg(hi[hf][r]);
          fence_reg(lo[hf][r]);
        }
    }
    give_back(slot);
  }
  fence_acc(acc);

#pragma unroll
  for (int j = 0; j < NTW; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + 8 * (q >> 1);
      const int c = 8 * j + 2 * tq + (q & 1);
      const float sc = sc_s[row];
      if (sc != 0.f && c < g.k) out[(e0 + row) * g.k + c] = sc * acc[j][q];
    }
  }
}

template <int NTW>
int launch_fwd(const float* xj, const float* a, const uint8_t* img,
               const float* mask, float* out, const Geometry& g,
               const FwdPlan& p, cudaStream_t s) {
  constexpr int NCW = fwd_groups(NTW);
  const size_t smem = fwd_shared_bytes(p, NCW);
  const cudaError_t err = cudaFuncSetAttribute(
      bilinear_bf16_fwd_kernel<NTW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + 64 * NCW - 1) / (64 * NCW);
  bilinear_bf16_fwd_kernel<NTW>
      <<<(unsigned)tiles, 128 * NCW + 32, smem, s>>>(xj, a, img, mask, out, g, p);
  return (int)cudaGetLastError();
}

// The forward's tiles for these widths on an image laid out already.
int launch_fwd_any(const float* xj, const float* a, const uint8_t* img,
                   const float* mask, float* out, const Geometry& g,
                   const FwdPlan& p, cudaStream_t s) {
  switch (ntw_bucket(round8(g.k) / 8)) {
    case 4: return launch_fwd<4>(xj, a, img, mask, out, g, p, s);
    case 13: return launch_fwd<13>(xj, a, img, mask, out, g, p, s);
    case 19: return launch_fwd<19>(xj, a, img, mask, out, g, p, s);
    case 25: return launch_fwd<25>(xj, a, img, mask, out, g, p, s);
    default: return launch_fwd<32>(xj, a, img, mask, out, g, p, s);
  }
}

// ---- d_a of the backward to the rows: (bf16(xj) @ bf16(W_h)) . (mask * g) --

constexpr int kAEdges = 16 * kCW;  // edges of a d_a tile: two warpgroups

// k16-steps of a unit that a d_a kernel keeps in registers: round16(D) / 16
// rounded up to 4, 7, 10 or 16 (0 past D = 256). The steps past the unit's
// are zeros in A and in the ring's slots.
__host__ __device__ constexpr int bwd_a_steps(int kd) {
  return kd <= 4 ? 4 : kd <= 7 ? 7 : kd <= 10 ? 10 : kd <= 16 ? 16 : 0;
}

// Whether the thread's mask * g values stay in registers beside A (4 KD)
// and the accumulator (4 NTW): within 168 registers with room for the
// addresses. Else the epilogue reads them from global memory (L1) each
// unit.
__host__ __device__ constexpr bool bwd_a_g_in_registers(int kd, int ntw) {
  return 4 * kd + 8 * ntw <= 136;
}

struct BwdAPlan {
  int kd;           // k16-steps of a unit in the forward's image
  int np;           // its B rows: 8 NTW
  int unit_bytes;   // a unit of the image: kd k16-steps, one bulk copy
  int stage_bytes;  // a slot of the ring: bwd_a_steps(kd) k16-steps
  int ring;         // slots: 4 where they fit, down to 1
};

size_t bwd_a_shared_bytes(const BwdAPlan& b) {
  return (size_t)b.ring * b.stage_bytes + kAEdges * 4 + 2 * b.ring * 8;
}

// The plan of the forward's image for these widths (its kd and np), with
// the deepest ring of whole units that fits; kBadShape where none does.
int bwd_a_choose(const Geometry& g, BwdAPlan* b) {
  FwdPlan p;
  if (fwd_choose(g, &p) != 0 || bwd_a_steps(p.kd) == 0) return kBadShape;
  b->kd = p.kd;
  b->np = p.np;
  b->unit_bytes = p.kd * p.np * 32;
  b->stage_bytes = bwd_a_steps(p.kd) * p.np * 32;
  for (b->ring = 4; b->ring >= 1; --b->ring) {
    if (bwd_a_shared_bytes(*b) <= (size_t)kMaxShared) return 0;
  }
  return kBadShape;
}

// One tile of 128 edges: consumer warp w (of two warpgroups) owns rows 16 w
// .. 16 w + 15, lane (gr, tq) rows r0 = 16 w + gr and r0 + 8; warp kCW is
// the producer, whose lane 0 streams unit h of the forward's image
// (bf16(W_h), D rows padded to kd k16-steps by np columns) into slot h %
// ring by one bulk copy. A = bf16(xj) of the lane's rows in registers, KD
// k16-steps, built once: no register a wgmma reads is ever written again.
// For each unit the warpgroup issues KD wgmma m64nNk16 into acc = T_h (the
// steps past kd multiply zeros), waits, gives the slot back, and reduces
// its row: d_a[e, h] = the fmaf chain of the lane's T_h values against
// mask * g at the same positions (columns 8 j + 2 tq, 8 j + 2 tq + 1 for j
// < NTW), then over the 4 lanes of the quad as (v0 + v1) + (v2 + v3). A
// warpgroup holds whole rows, so no sum crosses warps. Real rows only are
// written.
template <int KD, int NTW>
__global__ void __launch_bounds__(kBlock, 1)
bilinear_bf16_bwd_a_kernel(const float* __restrict__ xj,
                           const uint8_t* __restrict__ img,
                           const float* __restrict__ mask,
                           const float* __restrict__ gout,
                           float* __restrict__ da, Geometry g, BwdAPlan b) {
  constexpr bool kGReg = bwd_a_g_in_registers(KD, NTW);
  extern __shared__ __align__(128) uint8_t smem_b[];
  uint8_t* ring = smem_b;
  float* sc_s = reinterpret_cast<float*>(ring + (size_t)b.ring * b.stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(sc_s + kAEdges);
  uint64_t* empty = full + b.ring;

  const long long e0 = (long long)blockIdx.x * kAEdges;
  if (!load_scale<kAEdges>(mask, e0, g.e, sc_s)) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < b.ring; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kCW);
    }
    mbar_fence_init();
  }
  // the k16-steps of each slot past a unit's stay zero: the copies fill kd
  const int tail = (b.stage_bytes - b.unit_bytes) / 16;
  for (int i = threadIdx.x; i < b.ring * tail; i += kBlock) {
    const int slot = i / tail;
    uint4* z = reinterpret_cast<uint4*>(ring + (size_t)slot * b.stage_bytes +
                                        b.unit_bytes);
    z[i - slot * tail] = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();  // those zeros are read by wgmma (the async proxy)
  __syncthreads();

  if (warp == kCW) {  // the producer: one bulk copy a unit
    if (lane == 0) {
      for (int h = 0; h < g.h; ++h) {
        const int slot = h % b.ring;
        if (h >= b.ring) mbar_wait(empty + slot, ((h / b.ring) - 1) & 1);
        mbar_arrive_tx(full + slot, (uint32_t)b.unit_bytes);
        bulk_g2s(ring + (size_t)slot * b.stage_bytes,
                 img + (long long)h * b.unit_bytes, (uint32_t)b.unit_bytes,
                 full + slot);
      }
    }
    return;
  }

  const int r0 = 16 * warp + (lane >> 2);
  const int tq = lane & 3;
  const float sc0 = sc_s[r0], sc1 = sc_s[r0 + 8];
  const bool real0 = sc0 != 0.f, real1 = sc1 != 0.f;
  const float* x0 = xj + (e0 + r0) * g.d;
  const float* x1 = x0 + 8 * g.d;
  auto x_at = [&](bool real, const float* xr, int c) {
    return real && c < g.d ? __ldg(xr + c) : 0.f;
  };
  uint32_t af[KD][4];
#pragma unroll
  for (int s = 0; s < KD; ++s) {
    const int c = 16 * s + 2 * tq;
    af[s][0] = pack_bf16(x_at(real0, x0, c), x_at(real0, x0, c + 1));
    af[s][1] = pack_bf16(x_at(real1, x1, c), x_at(real1, x1, c + 1));
    af[s][2] = pack_bf16(x_at(real0, x0, c + 8), x_at(real0, x0, c + 9));
    af[s][3] = pack_bf16(x_at(real1, x1, c + 8), x_at(real1, x1, c + 9));
  }
  // mask * g at the accumulator's positions (zero past K, masked rows)
  const float* g0 = gout + (e0 + r0) * g.k;
  const float* g1 = g0 + 8 * g.k;
  auto g_at = [&](float sc, const float* gr, int c) {
    if (sc == 0.f || c >= g.k) return 0.f;
    return sc * __ldg(gr + c);
  };
  float gv[kGReg ? NTW : 1][4];
  if constexpr (kGReg) {
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int c = 8 * j + 2 * tq;
      gv[j][0] = g_at(sc0, g0, c);
      gv[j][1] = g_at(sc0, g0, c + 1);
      gv[j][2] = g_at(sc1, g1, c);
      gv[j][3] = g_at(sc1, g1, c + 1);
    }
  }
  float* da0 = da + (e0 + r0) * g.h;
  float* da1 = da0 + 8 * g.h;

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int h = 0; h < g.h; ++h) {
    const int slot = h % b.ring;
    mbar_wait(full + slot, (h / b.ring) & 1);
    const uint8_t* st = ring + (size_t)slot * b.stage_bytes;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KD; ++s) {
      WgmmaBf16<NTW>::mma(acc, af[s], b_desc(st + s * b.np * 32), s > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      float v[4];
      if constexpr (kGReg) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = gv[j][q];
      } else {
        const int c = 8 * j + 2 * tq;
        v[0] = g_at(sc0, g0, c);
        v[1] = g_at(sc0, g0, c + 1);
        v[2] = g_at(sc1, g1, c);
        v[3] = g_at(sc1, g1, c + 1);
      }
      dot0 = fmaf(acc[j][0], v[0], dot0);
      dot0 = fmaf(acc[j][1], v[1], dot0);
      dot1 = fmaf(acc[j][2], v[2], dot1);
      dot1 = fmaf(acc[j][3], v[3], dot1);
    }
    dot0 += __shfl_xor_sync(0xffffffffu, dot0, 1);
    dot0 += __shfl_xor_sync(0xffffffffu, dot0, 2);
    dot1 += __shfl_xor_sync(0xffffffffu, dot1, 1);
    dot1 += __shfl_xor_sync(0xffffffffu, dot1, 2);
    if (tq == 0) {
      if (real0) da0[h] = dot0;
      if (real1) da1[h] = dot1;
    }
  }
}

template <int KD, int NTW>
int launch_bwd_a(const float* xj, const uint8_t* img, const float* mask,
                 const float* gout, float* da, const Geometry& g,
                 const BwdAPlan& b, cudaStream_t s) {
  const size_t smem = bwd_a_shared_bytes(b);
  const cudaError_t err = cudaFuncSetAttribute(
      bilinear_bf16_bwd_a_kernel<KD, NTW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + kAEdges - 1) / kAEdges;
  bilinear_bf16_bwd_a_kernel<KD, NTW><<<(unsigned)tiles, kBlock, smem, s>>>(
      xj, img, mask, gout, da, g, b);
  return (int)cudaGetLastError();
}

template <int NTW>
int launch_bwd_a_steps(const float* xj, const uint8_t* img, const float* mask,
                       const float* gout, float* da, const Geometry& g,
                       const BwdAPlan& b, cudaStream_t s) {
  switch (bwd_a_steps(b.kd)) {
    case 4: return launch_bwd_a<4, NTW>(xj, img, mask, gout, da, g, b, s);
    case 7: return launch_bwd_a<7, NTW>(xj, img, mask, gout, da, g, b, s);
    case 10: return launch_bwd_a<10, NTW>(xj, img, mask, gout, da, g, b, s);
    default: return launch_bwd_a<16, NTW>(xj, img, mask, gout, da, g, b, s);
  }
}

// ---- the weight gradient: dW = bf16(X)^T bf16(mask * g) -------------------

struct WgPlan {
  int tm;       // flat rows of a tile: 128 MT
  int rows;     // (H+1) D
  int mtiles;   // row tiles
  int units;    // most units of [a | 1] a tile's rows span
  int np;       // columns of the B image: 8 NTW
  int ring;     // slots of the ring
  int gbytes;   // a chunk's B image: 64 x np bf16
  int xbytes;   // its xj rows: 64 x D f32
  int abytes;   // its [a | 1] columns: 64 x units f32, to 16 bytes
  int stage_bytes;
  int cg;           // round4(K) / 4: micro-tile columns of the partial
  long long plane;  // floats of one split's partial (wgrad_reduce layout)
};

bool wg_plan(const Geometry& g, int mt, int ntw, WgPlan* w) {
  w->tm = 128 * mt;
  w->rows = (g.h + 1) * g.d;
  w->mtiles = (w->rows + w->tm - 1) / w->tm;
  const int span = (w->tm - 1) / g.d + 2;
  w->units = span < g.h + 1 ? span : g.h + 1;
  w->np = 8 * ntw;
  w->gbytes = kChunk * w->np * 2;
  w->xbytes = kChunk * g.d * 4;
  w->abytes = (kChunk * w->units * 4 + 15) & ~15;
  w->stage_bytes = w->gbytes + w->xbytes + w->abytes;
  w->cg = round4(g.k) / 4;
  w->plane = (long long)(round4(w->rows) / 4) * w->cg * 16;
  for (int ring = 4; ring >= 2; --ring) {
    if ((long long)ring * (w->stage_bytes + 16) <= kMaxShared) {
      w->ring = ring;
      return true;
    }
  }
  return false;
}

size_t wg_shared_bytes(const WgPlan& w) {
  return (size_t)w.ring * w.stage_bytes + 2 * w.ring * 8;
}

int wg_choose(const Geometry& g, int* mt, WgPlan* w) {
  const int ntw = ntw_bucket(round8(g.k) / 8);
  if (ntw == 0) return kBadShape;
  if (ntw <= 13 && wg_plan(g, 2, ntw, w)) {
    *mt = 2;
    return 0;
  }
  if (wg_plan(g, 1, ntw, w)) {
    *mt = 1;
    return 0;
  }
  return kBadShape;
}

// The B image of the listed chunks: for live position b < live[0] (chunk
// ch = live[1 + b]), k16-step s < 4 and core-matrix row q = (n8 * 2 + kh)
// * 8 + r, the 16 bytes of row (b * 4 + s) * 2 np + q hold bf16(mask[e] *
// g[e][8 n8 + r]) for the edges e = 64 ch + 16 s + 8 kh + c, c < 8 (zero
// past E or K). One block a position, one thread a row.
__global__ void __launch_bounds__(kThreads)
g_image_kernel(const float* __restrict__ gout, const float* __restrict__ mask,
               const int* __restrict__ live, long long e, int k, int np,
               uint4* __restrict__ img) {
  if ((int)blockIdx.x >= live[0]) return;
  const long long ch = live[1 + blockIdx.x];
  const int rows = 8 * np;
  uint4* dst = img + (long long)blockIdx.x * rows;
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const int r = i & 7;
    const int kh = (i >> 3) & 1;
    const int rest = i >> 4;
    const int n = 8 * (rest % (np / 8)) + r;
    const long long eb = ch * kChunk + 16 * (rest / (np / 8)) + 8 * kh;
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const long long ee = eb + c;
      v[c] = ee < e && n < k ? mask[ee] * gout[ee * k + n] : 0.f;
    }
    dst[i] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                        pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// Block (split, tile): tile = blockIdx % mtiles owns flat dW rows m0 .. m0 +
// tm - 1 (consumer warpgroup wg the m64 tiles wg MT ..), all np columns;
// split = blockIdx / mtiles walks the live positions split, split + S, ...
// A stage holds a chunk's B image, its xj rows and its [a | 1] columns for
// the tile's units, unit-major (the bias unit's column 1; zeros past E;
// the producer's lanes load them, two rows a lane). The lane's
// A fragment of a k16-step: X^T rows m and m + 8, edges 16 ks + {2 tq, 2 tq
// + 1, 2 tq + 8, 2 tq + 9}, each bf16([a | 1][e, u(m)] * xj[e, d(m)]).
template <int MT, int NTW>
__global__ void __launch_bounds__(kBlock, 1)
bilinear_bf16_wgrad_kernel(const float* __restrict__ xj,
                           const float* __restrict__ a,
                           const uint8_t* __restrict__ gimg,
                           const int* __restrict__ live,
                           float* __restrict__ partial, Geometry g, WgPlan w,
                           int splits) {
  extern __shared__ __align__(128) uint8_t smem_b[];
  uint8_t* ring = smem_b;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)w.ring * w.stage_bytes);
  uint64_t* empty = full + w.ring;

  const int tile = blockIdx.x % w.mtiles;
  const int split = blockIdx.x / w.mtiles;
  const int m0 = tile * w.tm;
  const int u_first = m0 / g.d;
  const int units = min(w.units, g.h + 1 - u_first);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < w.ring; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, kCW);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_live = live[0];

  if (warp == kCW) {  // the producer warp
    int i = 0;
    for (int pos = split; pos < n_live; pos += splits, ++i) {
      const int slot = i % w.ring;
      if (i >= w.ring) mbar_wait(empty + slot, ((i / w.ring) - 1) & 1);
      uint8_t* st = ring + (size_t)slot * w.stage_bytes;
      float* xs = reinterpret_cast<float*>(st + w.gbytes);
      float* as = reinterpret_cast<float*>(st + w.gbytes + w.xbytes);
      const long long eb = (long long)live[1 + pos] * kChunk;
      const int valid = (int)(g.e - eb < kChunk ? g.e - eb : kChunk);
      // the [a | 1] columns, unit-major: as[u * 64 + r]; this lane's rows
      // r = lane and lane + 32
      const float* ar0 = a + (eb + lane) * g.h + u_first;
      const float* ar1 = ar0 + 32 * g.h;
#pragma unroll 4
      for (int u = 0; u < units; ++u) {
        const bool bias = u_first + u == g.h;
        as[u * kChunk + lane] = lane >= valid ? 0.f : bias ? 1.f : __ldg(ar0 + u);
        as[u * kChunk + lane + 32] = lane + 32 >= valid ? 0.f : bias ? 1.f : __ldg(ar1 + u);
      }
      if (valid < kChunk) {  // the last chunk: its rows past E are zeros
        for (int idx = lane; idx < kChunk * g.d; idx += 32) {
          xs[idx] = idx < valid * g.d ? __ldg(xj + eb * g.d + idx) : 0.f;
        }
      }
      if (lane == 0) {
        const bool whole = valid == kChunk;
        mbar_arrive_tx(full + slot, (uint32_t)(w.gbytes + (whole ? w.xbytes : 0)));
        bulk_g2s(st, gimg + (long long)pos * w.gbytes, (uint32_t)w.gbytes, full + slot);
        if (whole) bulk_g2s(xs, xj + eb * g.d, (uint32_t)w.xbytes, full + slot);
      } else {
        mbar_arrive(full + slot);
      }
    }
    return;
  }

  const int gr = lane >> 2;
  const int tq = lane & 3;
  // the [a | 1] column and xj column of the lane's rows (rows past the
  // last stay in bounds; they are never written)
  int ao[MT][2], xo[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int m = min(m0 + 64 * ((warp >> 2) * MT + mt) + 16 * (warp & 3) + gr + 8 * q,
                        w.rows - 1);
      const int u = m / g.d;
      ao[mt][q] = u - u_first;
      xo[mt][q] = m - u * g.d;
    }
  }

  float acc[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;
  int i = 0;
  for (int pos = split; pos < n_live; pos += splits, ++i) {
    const int slot = i % w.ring;
    mbar_wait(full + slot, (i / w.ring) & 1);
    const uint8_t* st = ring + (size_t)slot * w.stage_bytes;
    const float* xs = reinterpret_cast<const float*>(st + w.gbytes);
    const float* as = reinterpret_cast<const float*>(st + w.gbytes + w.xbytes);
    // the chunk's 4 k16-steps of A = X^T, each in registers of its own
    uint32_t af[4][MT][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int e2 = 16 * ks + 2 * tq;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float* xr = xs + e2 * g.d + xo[mt][q];
          const float* au = as + ao[mt][q] * kChunk + e2;
          const float2 a01 = *reinterpret_cast<const float2*>(au);
          const float2 a89 = *reinterpret_cast<const float2*>(au + 8);
          af[ks][mt][q] = pack_bf16(a01.x * xr[0], a01.y * xr[g.d]);
          af[ks][mt][2 + q] = pack_bf16(a89.x * xr[8 * g.d], a89.y * xr[9 * g.d]);
        }
      }
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t desc = b_desc(st + ks * w.np * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) WgmmaBf16<NTW>::mma(acc[mt], af[ks][mt], desc, 1);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) fence_reg(af[ks][mt][q]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);

  float* out = partial + (long long)split * w.plane;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + 64 * ((warp >> 2) * MT + mt) + 16 * (warp & 3) + gr + 8 * (q >> 1);
        const int n = 8 * j + 2 * tq + (q & 1);
        if (m < w.rows && n < g.k) {
          out[((m >> 2) * w.cg + (n >> 2)) * 16 + (m & 3) * 4 + (n & 3)] = acc[mt][j][q];
        }
      }
    }
  }
}

// Sets the kernel's shared-memory size and returns the blocks the card
// holds at once in *slots.
template <int MT, int NTW>
int wg_slots(const WgPlan& w, int* slots) {
  const size_t smem = wg_shared_bytes(w);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      bilinear_bf16_wgrad_kernel<MT, NTW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bilinear_bf16_wgrad_kernel<MT, NTW>, kBlock, smem);
  }
  *slots = sms * per_sm;
  return (int)err;
}

template <int MT, int NTW>
int launch_wgrad(const float* xj, const float* a, const uint8_t* gimg,
                 const int* live, float* partial, const Geometry& g,
                 const WgPlan& w, int splits, cudaStream_t s) {
  int slots = 0;
  const int err = wg_slots<MT, NTW>(w, &slots);  // sets the shared size
  if (err != 0) return err;
  bilinear_bf16_wgrad_kernel<MT, NTW>
      <<<(unsigned)(w.mtiles * splits), kBlock, wg_shared_bytes(w), s>>>(
          xj, a, gimg, live, partial, g, w, splits);
  return (int)cudaGetLastError();
}

Geometry make_geometry(long long e, int d, int k, int h) {
  Geometry g;
  g.e = e; g.d = d; g.k = k; g.h = h;
  return g;
}

bool bad_widths(int d, int k, int h) {
  return d < 1 || d > 256 || k < 1 || k > 256 || h < 0;
}

}  // namespace

extern "C" {

// Bytes of the forward's weight image (its img argument) for these widths,
// or -kBadShape where the tiling cannot take them.
long long mdl_fused_bilinear_bf16_image_bytes(int d, int k, int h) {
  if (bad_widths(d, k, h)) return -kBadShape;
  FwdPlan p;
  if (fwd_choose(make_geometry(0, d, k, h), &p) != 0) return -kBadShape;
  return fwd_image_bytes(p);
}

// Writes the forward's weight image of w1 (h x d*k) and b1 (d*k) into img
// (mdl_fused_bilinear_bf16_image_bytes bytes): the layout kernels alone.
// With transposed != 0, w1 (h x k*d) and b1 (k*d) are the weight of
// widths (k, d), and the image is of each unit's transpose and of b1's:
// the forward's B for d_xj (mdl_fused_bilinear_bf16_fwd_image on g).
int mdl_fused_bilinear_bf16_weight_image(const void* w1, const void* b1,
                                         void* img, int d, int k, int h,
                                         int transposed, void* stream) {
  if (bad_widths(d, k, h)) return kBadShape;
  const Geometry g = make_geometry(0, d, k, h);
  FwdPlan p;
  if (fwd_choose(g, &p) != 0) return kBadShape;
  return launch_image(static_cast<const float*>(w1),
                      static_cast<const float*>(b1), static_cast<uint8_t*>(img),
                      g, p, transposed, static_cast<cudaStream_t>(stream));
}

// The forward's tiles alone on an image that
// mdl_fused_bilinear_bf16_weight_image wrote for (d, k, h): out (e x k,
// zeros) = mask * (Σ_h bf16(a_h xj) @ bf16(W_h) + xj @ b1). On g (e x k)
// with the image of W1's transpose (d and k exchanged) this is the
// backward's d_xj = mask * (Σ_h bf16(a_h g) @ bf16(W_h)^T + g @ b1^T).
int mdl_fused_bilinear_bf16_fwd_image(const void* xj, const void* a,
                                      const void* img, const void* mask,
                                      void* out, long long e, int d, int k,
                                      int h, void* stream) {
  if (bad_widths(d, k, h)) return kBadShape;
  const Geometry g = make_geometry(e, d, k, h);
  FwdPlan p;
  if (fwd_choose(g, &p) != 0) return kBadShape;
  return launch_fwd_any(
      static_cast<const float*>(xj), static_cast<const float*>(a),
      static_cast<const uint8_t*>(img), static_cast<const float*>(mask),
      static_cast<float*>(out), g, p, static_cast<cudaStream_t>(stream));
}

// d_a (e x h, zeros) of the backward to the rows: d_a[e, h] = Σ_n
// (bf16(xj) @ bf16(W_h))[e, n] * mask[e] * gout[e, n], with img the
// forward's weight image of (d, k, h) (mdl_fused_bilinear_bf16_weight_image,
// transposed 0; its units alone are read). xj (e x d), mask (e), gout (e x
// k), f32. Returns 0 or a cudaError_t (kBadShape for widths the tiling
// cannot take).
int mdl_fused_bilinear_bf16_bwd_a(const void* xj, const void* img,
                                  const void* mask, const void* gout,
                                  void* da, long long e, int d, int k, int h,
                                  void* stream) {
  if (bad_widths(d, k, h)) return kBadShape;
  const Geometry g = make_geometry(e, d, k, h);
  BwdAPlan b;
  if (bwd_a_choose(g, &b) != 0) return kBadShape;
  if (h == 0 || e == 0) return 0;
  const float* xp = static_cast<const float*>(xj);
  const uint8_t* im = static_cast<const uint8_t*>(img);
  const float* mp = static_cast<const float*>(mask);
  const float* gp = static_cast<const float*>(gout);
  float* dp = static_cast<float*>(da);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ntw_bucket(round8(k) / 8)) {
    case 4: return launch_bwd_a_steps<4>(xp, im, mp, gp, dp, g, b, s);
    case 13: return launch_bwd_a_steps<13>(xp, im, mp, gp, dp, g, b, s);
    case 19: return launch_bwd_a_steps<19>(xp, im, mp, gp, dp, g, b, s);
    case 25: return launch_bwd_a_steps<25>(xp, im, mp, gp, dp, g, b, s);
    default: return launch_bwd_a_steps<32>(xp, im, mp, gp, dp, g, b, s);
  }
}

// All pointers are device pointers on the current device: xj (e x d), a
// (e x h), w1 (h x d*k), b1 (d*k), mask (e), all f32; img holds
// mdl_fused_bilinear_bf16_image_bytes(d, k, h) bytes, no initial value
// needed; out (e x k) holds zeros. Launches the layout kernels, then the
// tiles. Returns 0 or a cudaError_t (kBadShape for widths the tiling
// cannot take).
int mdl_fused_bilinear_bf16_fwd(const void* xj, const void* a, const void* w1,
                                const void* b1, void* img, const void* mask,
                                void* out, long long e, int d, int k, int h,
                                void* stream) {
  if (bad_widths(d, k, h)) return kBadShape;
  const Geometry g = make_geometry(e, d, k, h);
  FwdPlan p;
  if (fwd_choose(g, &p) != 0) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* im = static_cast<uint8_t*>(img);
  const int err = launch_image(static_cast<const float*>(w1),
                               static_cast<const float*>(b1), im, g, p, 0, s);
  if (err != 0) return err;
  return launch_fwd_any(static_cast<const float*>(xj),
                        static_cast<const float*>(a), im,
                        static_cast<const float*>(mask),
                        static_cast<float*>(out), g, p, s);
}

// Bytes of the weight gradient's B image (its gimg argument): every 64-edge
// chunk's, at most, for e edges and widths d, k; -kBadShape where the
// tiling cannot take them.
long long mdl_fused_bilinear_bf16_gimg_bytes(long long e, int d, int k, int h) {
  if (bad_widths(d, k, h)) return -kBadShape;
  int mt = 0;
  WgPlan w;
  if (wg_choose(make_geometry(e, d, k, h), &mt, &w) != 0) return -kBadShape;
  return ((e + kChunk - 1) / kChunk) * w.gbytes;
}

// Floats of one split's partial of the weight gradient.
long long mdl_fused_bilinear_bf16_partial_floats(int d, int k, int h) {
  if (bad_widths(d, k, h)) return -kBadShape;
  int mt = 0;
  WgPlan w;
  if (wg_choose(make_geometry(0, d, k, h), &mt, &w) != 0) return -kBadShape;
  return w.plane;
}

// Edge splits S of the weight gradient on the current device: of S = 1 ..
// max(16, slots / tiles) (at most one split per chunk), the one whose
// tiles x S blocks fill their last wave of the card's resident blocks
// best, the smaller on a tie. Returns S >= 1, or minus a cudaError_t
// (kBadShape for widths the tiling cannot take).
int mdl_fused_bilinear_bf16_wgrad_splits(long long e, int d, int k, int h) {
  if (bad_widths(d, k, h)) return -kBadShape;
  int mt = 0;
  WgPlan w;
  if (wg_choose(make_geometry(e, d, k, h), &mt, &w) != 0) return -kBadShape;
  int slots = 0;
  const int err = dispatch(mt, ntw_bucket(round8(k) / 8), [&](auto t) {
    return wg_slots<decltype(t)::MT, decltype(t)::NTW>(w, &slots);
  });
  if (err != 0) return -err;
  if (slots < 1) return -kBadShape;
  const long long chunks = (e + kChunk - 1) / kChunk;
  const long long most = slots / w.mtiles > 16 ? slots / w.mtiles : 16;
  long long best = 1;
  double best_fill = 0.0;
  for (long long s = 1; s <= most && s <= chunks; ++s) {
    const long long blocks = w.mtiles * s;
    const long long waves = (blocks + slots - 1) / slots;
    const double fill = (double)blocks / (double)(waves * slots);
    if (fill > best_fill + 1e-9) {
      best = s;
      best_fill = fill;
    }
  }
  return (int)best;
}

// dw ((h+1)*d x k) = [dW1; dB1] of the bf16 arm. xj (e x d, 16-byte
// aligned), a (e x h), mask (e), gout (e x k), f32; live holds 1 + ceil(e /
// 64) ints, gimg mdl_fused_bilinear_bf16_gimg_bytes, partial splits *
// mdl_fused_bilinear_bf16_partial_floats floats (none needs an initial
// value); splits as mdl_fused_bilinear_bf16_wgrad_splits gives it (any
// splits >= 1 is right). Launches the live-chunk list, the B image, the
// split kernel, then the fixed-order sum of the splits.
int mdl_fused_bilinear_bf16_wgrad(const void* xj, const void* a,
                                  const void* mask, const void* gout,
                                  void* live, void* gimg, void* partial,
                                  void* dw, long long e, int d, int k, int h,
                                  int splits, void* stream) {
  if (bad_widths(d, k, h) || splits < 1) return kBadShape;
  const Geometry g = make_geometry(e, d, k, h);
  int mt = 0;
  WgPlan w;
  if (wg_choose(g, &mt, &w) != 0) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(mask);
  int* lp = static_cast<int*>(live);
  uint8_t* gp = static_cast<uint8_t*>(gimg);
  live_chunks_kernel<kChunk><<<1, 1024, 0, s>>>(mp, e, lp);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long chunks = (e + kChunk - 1) / kChunk;
  g_image_kernel<<<(unsigned)chunks, kThreads, 0, s>>>(
      static_cast<const float*>(gout), mp, lp, e, k, w.np,
      reinterpret_cast<uint4*>(gp));
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const float* xp = static_cast<const float*>(xj);
  const float* ap = static_cast<const float*>(a);
  float* pp = static_cast<float*>(partial);
  err = dispatch(mt, ntw_bucket(round8(k) / 8), [&](auto t) {
    return launch_wgrad<decltype(t)::MT, decltype(t)::NTW>(xp, ap, gp, lp, pp,
                                                           g, w, splits, s);
  });
  if (err != 0) return err;
  return launch_wgrad_reduce(partial, dw, splits, (int)(w.plane / 16), w.cg,
                             w.rows, k, stream);
}

}  // extern "C"
