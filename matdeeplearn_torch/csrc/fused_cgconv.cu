// Fused CGConv forward and backward kernels for Hopper (sm_90a), with a
// plain C interface for ctypes (bound in matdeeplearn_torch/ops/fused_cgconv.py).
//
// mdl_fused_cgconv_fwd replaces the reference package's
// ops/pallas_fused.py:_fwd_kernel. mdl_fused_cgconv_bwd (the edge rows),
// mdl_fused_cgconv_wgrad (the weight gradient, in slices) and
// mdl_fused_cgconv_wgrad_reduce (the fixed-order sum of the slices)
// together replace ops/pallas_fused.py:_bwd_kernel.
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
// Masked edges add nothing; their d_xj rows are zero.
//
// Bound: operations. At CGCNN_demo width (D 100, De 50) each real edge
// costs 2*250*200 FLOP forward and about 2.8 times that backward, against
// ~1.2 KB of inputs and outputs a real edge, far above the card's
// operations-per-byte line. At chip_smoke's training batch (45,509 real
// edges of 80,176) the forward's 4.55e9 FLOP take 0.0276 ms at the 3xTF32
// rate (495/3 TFLOP/s; 0.068 ms at the FMA pipes' 67). Every intermediate
// stays on chip but dA.
//
// Every product runs on the tensor cores in 3xTF32 (each operand split
// into TF32 hi + lo by split_tf32, lo·hi + hi·lo + hi·hi accumulated in
// f32: f32 accuracy, as the TPU kernel's hi/lo bf16 split gives its MXU).
//
// * mdl_fused_cgconv_fwd, on wgmma m64nNk8 (wgmma.cuh): a first kernel
//   splits W once a call into TF32 hi and lo in the byte order of the
//   no-swizzle K-major B descriptors, its columns interleaved (af and as
//   of one feature side by side). A block of two warpgroups owns a tile of
//   128 edges (each warpgroup 64 rows and all N = 8 NTW >= 2D columns;
//   past D = 128, 64 edges and a column half each). Stage s brings up to 4
//   k-steps of the split W (16-byte cp.async) and z chunk s, the stage's
//   columns of z = [x[dst] | xj | basis | 1] (x and xj by cp.async, 16
//   bytes where D is a multiple of 4; the basis computed), into two-stage
//   rings: any De fits, and a stage's copies are issued right after its
//   predecessor's wgmma, so they land while the tensor cores work. Per
//   k-step a warp loads its A fragment from the z chunk, splits it, and its
//   warpgroup issues three wgmma. The epilogue moves the accumulators into
//   a shared tile in place of the ring, forms mask * sigmoid(af) *
//   softplus(as) there in a rolled loop (short code, 8 elements a thread
//   in flight) and adds the tile into out through the run-flush epilogue
//   of edge_tile.cuh (runs of equal dst added in a register, each flushed
//   with one atomicAdd: right for any dst order). At D 100: N = 200, 100
//   accumulators and 163 registers a thread, 143 KB of shared memory (4-k-
//   step stages of 51 KB, 18 KB z chunks), one block an SM; the split W
//   (410 KB) is read from L2 once per tile with a real edge. A tile with
//   no real edge costs one barrier. The backward's mma_tile over the padded
//   W (64-edge tiles, mma.sync) was the other design timed: 0.2073-0.2077
//   ms against this one's 0.1453-0.1457 at chip_smoke's batch, in turns on
//   an H100 80GB HBM3 at 700 W (bench_torch_bwd_rows.py --op cgconv_fwd).
//
// The backward, on mma.sync m16n8k8 (edge_tile.cuh):
//
// * mdl_fused_cgconv_bwd: one block of 256 threads owns a tile of TE = 64
//   edges (32 at D > 128, where the accumulators would not fit). It builds
//   z in shared memory, recomputes [af | as] = z·W with mma.sync m16n8k8,
//   forms dA = [d_af | d_as] in place of z, writes dA's real rows to
//   device memory, then computes [d_xi | d_xj] = dA · W[:2D]^T the same
//   way. The 8 warps split the tile 2 (rows) x 4 (n8-tiles, interleaved);
//   each warp keeps af and as (then d_xi and d_xj) for the same columns,
//   so the activations need no exchange. The weights stream through two
//   16-row shared buffers by cp.async, the next chunk in flight while the
//   warps multiply the current one; the wrapper pads them (Wp: round8(K1)
//   x 2*round8(D), each half of the columns zero-padded to round8(D), and
//   WTp, W[:2D]^T in the same padded layout), so every row is a whole
//   number of 16-byte copies at any D. Row strides of 4 mod 32 (z, dA)
//   and 8 mod 16 (weights) keep every fragment load free of bank
//   conflicts. d_x goes through the run-flush epilogue; d_xj rows are
//   written for every slot of the tile (zero where masked), so the
//   wrapper allocates it without zeroing.
// * mdl_fused_cgconv_wgrad: dW = z^T · dA as a split-K product over the
//   edges. Block (tile, slice) owns a 128 x 112 tile of dW (z columns x
//   padded dA columns) and the 32-edge chunks slice, slice + S, ... (the
//   strided order spreads the tail pads of a dst-sorted batch over every
//   slice). Per chunk it regenerates its z columns from x[dst], xj and
//   dist in shared memory, copies the dA columns by cp.async (zero-filled
//   for masked edges), and multiplies with the accumulators in registers.
//   Each slice writes, never adds, its dW in the 4 x 4 micro-tile layout
//   of wgrad_reduce_kernel; no atomics touch dW, so it is bit-identical
//   from run to run.
//
// The caller zeroes out and d_x, and allocates everything; the kernels
// never synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile.cuh"
#include "wgmma.cuh"

namespace {

struct Geometry {
  long long e;  // edge slots
  int d;        // feature width D
  int de;       // Gaussian basis size De
  int n;        // node slots
  int k1;       // 2D + De + 1 rows of W
  int ldz;      // round4(k1): rows of the weight gradient's micro-tiles
  int ldn;      // round4(2D): its columns
  int dp;       // round8(D): each half of the padded weight columns
  int kp;       // round8(k1): rows of the padded weight Wp
  int lda;      // row stride of the backward's z / dA tile (4 mod 32)
  int ldb;      // row stride of a streamed weight chunk: 2*dp + 8
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
  g.dp = round8(d);
  g.kp = round8(g.k1);
  g.lda = stride_a(g.kp > 2 * g.dp ? g.kp : 2 * g.dp);
  g.ldb = 2 * g.dp + 8;
  g.coeff = coeff; g.step = step;
  return g;
}

// Loads the tile's edge weights and destinations into shared memory (a
// masked edge, or one whose dst lies outside [0, n), gets weight 0) and
// returns, uniformly across the block, whether any edge of it is real.
template <int TE = kTE>
__device__ bool load_edges(const int* __restrict__ dst,
                           const float* __restrict__ mask, long long e0,
                           const Geometry& g, float* w_s, int* dst_s) {
  bool real = false;
  if (threadIdx.x < TE) {
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

// The basis column k < De of edge e, the column of ones at k == De, zero
// beyond.
__device__ __forceinline__ float basis_or_one(const float* __restrict__ dist,
                                              long long e, int k,
                                              const Geometry& g) {
  if (k < g.de) {
    const float diff = dist[e] - (float)k * g.step;
    return expf(g.coeff * diff * diff);
  }
  return k == g.de ? 1.f : 0.f;
}

// ---- the forward: [af | as] = z · W on wgmma --------------------------

constexpr int kFKS = 4;  // most k-steps a forward stage holds

// W as the forward's B operand, its columns interleaved: B row n is W's
// column (n & 1) * D + n / 2 (af and as of feature n / 2 side by side, so a
// thread's accumulator pair {d[j][0], d[j][1]} is af and as of one
// feature), its columns the k-step's 8 rows of W (zero past K1 or D).
struct CgconvFwdB {
  const float* w;
  int d, k1;
  __device__ float operator()(long long s, int n, int c) const {
    const int k = 8 * (int)s + c;
    const int f = n >> 1;
    return f < d && k < k1 ? w[(long long)k * 2 * d + (n & 1) * d + f] : 0.f;
  }
};

struct FwdLayout {
  int ntw;  // n8-tiles of a warpgroup
  int wn;   // warpgroups across the columns (1, or 2 past D = 128)
  int te;   // edges of a tile: 128 / wn
  int np;   // B rows: 8 * ntw * wn >= 2D
  int kt;   // k-steps: round8(K1) / 8
  int ks;   // k-steps a stage holds: 4, 2 or 1
  int ldz;  // row stride of a z chunk (4 mod 32)
  int ldt;  // row stride of the epilogue's [af | as] tile (8 mod 32)
};

// Two stages of the split W, or the epilogue's tile in their place; two z
// chunks; the tile's edge weights, destinations and distances.
size_t fwd_shared_bytes(const FwdLayout& f) {
  const size_t ring = 2 * (size_t)f.ks * kstep_words(f.np);
  const size_t tile = (size_t)f.te * f.ldt;
  return sizeof(float) * ((ring > tile ? ring : tile) +
                          2 * (size_t)f.te * f.ldz + 2 * f.te) +
         sizeof(int) * f.te;
}

// The layout for width D: the most k-steps a stage whose shared memory
// fits. False where none fits or D > 256.
bool fwd_layout(const Geometry& g, FwdLayout* f) {
  f->wn = g.d <= 128 ? 1 : 2;
  f->ntw = ntw_bucket(f->wn == 1 ? (2 * g.d + 7) / 8 : (g.d + 7) / 8);
  if (f->ntw == 0) return false;
  f->te = 128 / f->wn;
  f->np = 8 * f->ntw * f->wn;
  f->kt = round8(g.k1) / 8;
  f->ldt = stride_acc(f->np);
  for (int ks = kFKS; ks >= 1; ks /= 2) {  // 8 ks divides the block
    f->ks = ks;
    f->ldz = stride_a(8 * ks);
    if (fwd_shared_bytes(*f) <= (size_t)kMaxShared) return true;
  }
  return false;
}

// Issues z chunk `s` of the tile (its TE rows x 8 ks columns of [x[dst] |
// xj | basis | 1 | zero], zero rows for masked edges) into z_s: the x and
// xj columns by cp.async, so that they land while this stage's wgmma run;
// the basis (from the distances in di_s), the ones and the zeros by plain
// stores. A thread keeps V consecutive columns (V = 4, 16-byte copies,
// where D is a multiple of 4 and so every segment starts on a quad; else
// V = 1) and walks rows. The caller commits the group.
template <int TE, int V>
__device__ void issue_z_chunk(const float* __restrict__ x,
                              const float* __restrict__ xj, long long e0,
                              const Geometry& g, const FwdLayout& f, int s,
                              const float* wt_s, const int* dst_s,
                              const float* di_s, float* z_s) {
  const int wv = 8 * f.ks / V;  // threads a row
  const int p = V * (threadIdx.x % wv);
  const int k = s * 8 * f.ks + p;
  for (int r = threadIdx.x / wv; r < TE; r += kThreads / wv) {
    float* to = z_s + r * f.ldz + p;
    if (wt_s[r] != 0.f && k < 2 * g.d) {
      const float* from = k < g.d ? x + (long long)dst_s[r] * g.d + k
                                  : xj + (e0 + r) * g.d + k - g.d;
      if (V == 4) {
        cp_async16(to, from);
      } else {
        cp_async4(to, from);
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int kv = k + v - 2 * g.d;
        float val = 0.f;
        if (wt_s[r] != 0.f && kv < g.de) {
          const float diff = di_s[r] - (float)kv * g.step;
          val = expf(g.coeff * diff * diff);
        } else if (wt_s[r] != 0.f && kv == g.de) {
          val = 1.f;
        }
        to[v] = val;
      }
    }
  }
}

// One tile of TE = 128 / WN edges, two warpgroups: with WN = 1 each owns
// 64 of the tile's rows and all 8 NTW columns of the interleaved [af | as];
// with WN = 2 both own the tile's 64 rows, warpgroup wn the columns
// 8 NTW wn .. . Stage s brings ks k-steps of the split W (16-byte
// cp.async) and z chunk s into two-stage rings, one stage ahead, one
// barrier a stage. For each k-step a warp loads and splits its A fragment
// from the z chunk and its warpgroup issues three wgmma (3xTF32). The
// epilogue moves the accumulators to a shared tile in place of the ring,
// forms mask * sigmoid(af) * softplus(as) there in a rolled loop (in place
// of af) and flushes it (flush_runs).
template <int NTW, int WN>
__global__ void __launch_bounds__(kThreads, 1)
fused_cgconv_fwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ xj,
                        const float* __restrict__ dist,
                        const int* __restrict__ dst,
                        const float* __restrict__ mask,
                        const uint32_t* __restrict__ ws,
                        float* __restrict__ out, Geometry g, FwdLayout f) {
  constexpr int TE = 128 / WN;
  const int stage_words = f.ks * kstep_words(f.np);
  const int ring = max(2 * stage_words, TE * f.ldt);
  extern __shared__ float4 smem4[];
  uint32_t* w_s = reinterpret_cast<uint32_t*>(smem4);  // 2 stages
  float* z_s = reinterpret_cast<float*>(w_s + ring);    // 2 chunks
  float* wt_s = z_s + 2 * TE * f.ldz;                   // edge weights
  float* di_s = wt_s + TE;                              // distances
  int* dst_s = reinterpret_cast<int*>(di_s + TE);

  const long long e0 = (long long)blockIdx.x * TE;
  if (threadIdx.x < TE) {
    const long long e = e0 + threadIdx.x;
    di_s[threadIdx.x] = e < g.e ? dist[e] : 0.f;
  }
  if (!load_edges<TE>(dst, mask, e0, g, wt_s, dst_s)) return;
  const int stages = (f.kt + f.ks - 1) / f.ks;

  // stage s: k-steps of the split W and z chunk s, one cp.async group
  auto load_stage = [&](int s) {
    if (s < stages) {
      const int q = min(f.ks, f.kt - s * f.ks) * kstep_words(f.np) / 4;
      uint32_t* to = w_s + (s & 1) * stage_words;
      const uint32_t* from = ws + (long long)s * stage_words;
      for (int i = threadIdx.x; i < q; i += kThreads) {
        cp_async16(to + 4 * i, from + 4 * i);
      }
      float* zc = z_s + (s & 1) * TE * f.ldz;
      if (g.d % 4 == 0) {
        issue_z_chunk<TE, 4>(x, xj, e0, g, f, s, wt_s, dst_s, di_s, zc);
      } else {
        issue_z_chunk<TE, 1>(x, xj, e0, g, f, s, wt_s, dst_s, di_s, zc);
      }
    }
    cp_async_commit();
  };
  load_stage(0);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int wn = WN == 1 ? 0 : warp >> 2;
  const int row0 = 16 * (WN == 1 ? warp : warp & 3);
  const int col0 = wn * NTW * 8;
  const int r0 = row0 + gr;
  const int b_hi = (col0 / 8) * 64;
  const int b_lo = f.np * 8 + b_hi;

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int s = 0; s < stages; ++s) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    const uint32_t* wst = w_s + (s & 1) * stage_words;
    const float* zk = z_s + (s & 1) * TE * f.ldz + r0 * f.ldz + tq;
    const int nks = min(f.ks, f.kt - s * f.ks);
    uint32_t ahi[kFKS][4], alo[kFKS][4];
    fence_acc(acc);
#pragma unroll
    for (int ks = 0; ks < kFKS; ++ks) {
      if (ks < nks) {  // uniform across the block
        const float* zr = zk + 8 * ks;
        split_a(zr[0], zr[8 * f.ldz], zr[4], zr[8 * f.ldz + 4], ahi[ks],
                alo[ks]);
        const uint32_t* wk = wst + ks * kstep_words(f.np);
        wgmma_fence();
        wgmma_3xtf32(acc, ahi[ks], alo[ks], b_desc(wk + b_hi),
                     b_desc(wk + b_lo), s == 0 && ks == 0 ? 0 : 1);
      }
    }
    wgmma_commit();
    load_stage(s + 1);  // while the tensor cores work
    wgmma_wait();
#pragma unroll
    for (int ks = 0; ks < kFKS; ++ks) {
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
  __syncthreads();  // every warpgroup is done with the ring

  // the messages, in place of af in the [af | as] tile
  float* t_s = reinterpret_cast<float*>(w_s);
  acc_to_tile(acc, t_s, f.ldt, r0, col0, tq);
  __syncthreads();
#pragma unroll 8
  for (int i = threadIdx.x; i < TE * g.d; i += kThreads) {
    const int r = i / g.d;
    float* p = t_s + r * f.ldt + 2 * (i - r * g.d);
    p[0] = wt_s[r] * sigmoidf(p[0]) * softplusf(p[1]);
  }
  __syncthreads();
  flush_runs<TE>(t_s, g.d, wt_s, dst_s, out, f.ldt, 2);
}

// ---- the backward: edge rows -------------------------------------------

constexpr int kKS = 16;  // weight rows per cp.async chunk (two k-steps)

// The backward's z tile of TE rows: [x[dst] | xj | basis | 1 | zero to kp]
// at row stride lda, zero rows for masked edges. Warp w takes rows w,
// w + 8, ...; a lane issues the loads of all its rows before it stores.
template <int TE>
__device__ void build_z(const float* __restrict__ x,
                        const float* __restrict__ xj,
                        const float* __restrict__ dist, long long e0,
                        const Geometry& g, const float* w_s,
                        const int* dst_s, float* z_s) {
  constexpr int R = TE / 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = lane; c < g.d; c += 32) {
    float xv[R], jv[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = warp + 8 * q;
      const bool real = w_s[r] != 0.f;
      xv[q] = real ? x[(long long)dst_s[r] * g.d + c] : 0.f;
      jv[q] = real ? xj[(e0 + r) * g.d + c] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float* row = z_s + (warp + 8 * q) * g.lda;
      row[c] = xv[q];
      row[g.d + c] = jv[q];
    }
  }
  for (int k = lane; k < g.kp - 2 * g.d; k += 32) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = warp + 8 * q;
      z_s[r * g.lda + 2 * g.d + k] =
          w_s[r] != 0.f ? basis_or_one(dist, e0 + r, k, g) : 0.f;
    }
  }
}

// Copies rows k0 .. k0 + kKS (those below rows) of the rows x width
// row-major matrix b into b_s (stride ldb) by cp.async, as one group.
__device__ void stage_rows(const float* __restrict__ b, int rows, int k0,
                           int width, float* b_s, int ldb) {
  const int n = min(kKS, rows - k0) * (width / 4);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / (width / 4);
    const int c = 4 * (i - r * (width / 4));
    cp_async16(b_s + r * ldb + c, b + (long long)(k0 + r) * width + c);
  }
  cp_async_commit();
}

// acc[mt][i][h] = a_s · b over kp columns of a_s, on the tensor cores
// (3xTF32): the warp's rows (warp / 4) * 16 * MT + 16 * mt (+ g, + g + 8)
// and, for each half h of the output, the n8-tile nt = warp % 4 + 4i of
// that half (columns h * dp + 8 * nt ..). a_s holds kp zero-padded
// columns at stride g.lda; b is a kp x 2*dp row-major matrix in device
// memory, streamed through the two kKS-row buffers of b_s. Starts and
// ends with a barrier: the caller's writes to a_s are visible, and a_s
// and b_s are free afterwards.
template <int MT, int NTW>
__device__ void mma_tile(const float* a_s, int kp,
                         const float* __restrict__ b, const Geometry& g,
                         float* b_s, float (&acc)[MT][NTW][2][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int row0 = (warp >> 2) * 16 * MT;
  const int wn = warp & 3;
  const int ntiles = g.dp / 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][i][h][q] = 0.f;

  const int chunks = (kp + kKS - 1) / kKS;
  stage_rows(b, kp, 0, 2 * g.dp, b_s, g.ldb);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      stage_rows(b, kp, (ch + 1) * kKS, 2 * g.dp,
                 b_s + ((ch + 1) & 1) * kKS * g.ldb, g.ldb);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* bs = b_s + (ch & 1) * kKS * g.ldb;
#pragma unroll
    for (int ks = 0; ks < kKS / 8; ++ks) {
      const int ka = ch * kKS + 8 * ks;
      if (ka >= kp) break;
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* ar = a_s + (row0 + 16 * mt + gr) * g.lda + ka + tq;
        split_tf32(ar[0], ahi[mt][0], alo[mt][0]);
        split_tf32(ar[8 * g.lda], ahi[mt][1], alo[mt][1]);
        split_tf32(ar[4], ahi[mt][2], alo[mt][2]);
        split_tf32(ar[8 * g.lda + 4], ahi[mt][3], alo[mt][3]);
      }
      const float* br = bs + (8 * ks + tq) * g.ldb + gr;
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const int nt = wn + 4 * i;
        if (nt >= ntiles) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = h * g.dp + 8 * nt;
          uint32_t bhi[2], blo[2];
          split_tf32(br[col], bhi[0], blo[0]);
          split_tf32(br[4 * g.ldb + col], bhi[1], blo[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_3xtf32(acc[mt][i][h], ahi[mt], alo[mt], bhi, blo);
          }
        }
      }
    }
    __syncthreads();
  }
}

// The edge rows of the backward for one tile of TE = 32 * MT edges: d_x
// (atomically flushed runs), d_xj (every slot of the tile), and dA for
// the weight-gradient kernel (real rows of da, E x 2*dp).
template <int MT, int NTW>
__global__ void __launch_bounds__(kThreads, 2)
fused_cgconv_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ xj,
                        const float* __restrict__ dist,
                        const int* __restrict__ dst,
                        const float* __restrict__ mask,
                        const float* __restrict__ wp,
                        const float* __restrict__ wtp,
                        const float* __restrict__ gout,
                        float* __restrict__ dx, float* __restrict__ dxj,
                        float* __restrict__ da, Geometry g) {
  constexpr int TE = 32 * MT;
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);
  float* b_s = a_s + TE * g.lda;
  float* w_s = b_s + 2 * kKS * g.ldb;
  int* dst_s = reinterpret_cast<int*>(w_s + TE);

  const long long e0 = (long long)blockIdx.x * TE;
  const int span = (int)min((long long)TE, g.e - e0) * g.d;  // d_xj floats
  float* dxj_tile = dxj + e0 * g.d;
  if (!load_edges<TE>(dst, mask, e0, g, w_s, dst_s)) {
    for (int i = threadIdx.x; i < span; i += kThreads) dxj_tile[i] = 0.f;
    return;
  }
  build_z<TE>(x, xj, dist, e0, g, w_s, dst_s, a_s);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int row0 = (warp >> 2) * 16 * MT;
  const int wn = warp & 3;
  const int ntiles = g.dp / 8;

  // [af | as] = z · W, then dA = [d_af | d_as] in place of z (zero in the
  // pad columns of each half, as the pad rows of WTp are)
  float acc[MT][NTW][2][4];
  mma_tile<MT, NTW>(a_s, g.kp, wp, g, b_s, acc);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int nt = wn + 4 * i;
      if (nt >= ntiles) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = row0 + 16 * mt + gr + 8 * (q >> 1);
        const int c = 8 * nt + 2 * tq + (q & 1);
        const float wr = w_s[row];
        const float gg = wr != 0.f && c < g.d
                             ? wr * gout[(long long)dst_s[row] * g.d + c]
                             : 0.f;
        const float af = acc[mt][i][0][q];
        const float as = acc[mt][i][1][q];
        const float sf = sigmoidf(af);
        a_s[row * g.lda + c] = gg * softplusf(as) * sf * (1.f - sf);
        a_s[row * g.lda + g.dp + c] = gg * sf * sigmoidf(as);
      }
    }
  }
  __syncthreads();
  const int row4 = g.dp / 2;  // float4 in a row of dA
  for (int i = threadIdx.x; i < TE * row4; i += kThreads) {
    const int r = i / row4;
    const int c = i - r * row4;
    if (w_s[r] != 0.f) {
      reinterpret_cast<float4*>(da)[(e0 + r) * row4 + c] =
          reinterpret_cast<const float4*>(a_s + r * g.lda)[c];
    }
  }

  // [d_xi | d_xj] = dA · W[:2D]^T, staged as two TE x D tiles in place of dA
  mma_tile<MT, NTW>(a_s, 2 * g.dp, wtp, g, b_s, acc);
  float* di_s = a_s;
  float* dj_s = a_s + TE * g.d;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int nt = wn + 4 * i;
      if (nt >= ntiles) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = row0 + 16 * mt + gr + 8 * (q >> 1);
        const int c = 8 * nt + 2 * tq + (q & 1);
        if (c < g.d) {
          di_s[row * g.d + c] = acc[mt][i][0][q];
          dj_s[row * g.d + c] = acc[mt][i][1][q];
        }
      }
    }
  }
  __syncthreads();
  flush_runs<TE>(di_s, g.d, w_s, dst_s, dx);
  for (int i = threadIdx.x; i < span; i += kThreads) {
    dxj_tile[i] = w_s[i / g.d] != 0.f ? dj_s[i] : 0.f;
  }
}

// ---- the backward: the weight gradient ---------------------------------

constexpr int kWM = 128;        // dW rows (z columns) of a block
constexpr int kWN = 112;        // dW columns (of the padded 2*dp) of a block
constexpr int kWK = 32;         // edges of a chunk
constexpr int kLdZ = kWM + 8;   // 8 mod 32: conflict-free A fragments of z^T
constexpr int kLdD = kWN + 8;   // 24 mod 32: conflict-free B fragments

// Slice `slice` of dW = Σ over chunks slice, slice + slices, ... of
// z[chunk]^T · dA[chunk], for this block's 128 x 112 tile; 8 warps in
// 4 (32 rows) x 2 (56 columns), each 2 x 7 m16n8 fragments.
__global__ void __launch_bounds__(kThreads, 2)
fused_cgconv_wgrad_kernel(const float* __restrict__ x,
                          const float* __restrict__ xj,
                          const float* __restrict__ dist,
                          const int* __restrict__ dst,
                          const float* __restrict__ mask,
                          const float* __restrict__ da,
                          float* __restrict__ partial, Geometry g,
                          int ntiles_n, int tiles, int slices) {
  __shared__ float z_s[kWK * kLdZ];
  __shared__ __align__(16) float d_s[kWK * kLdD];
  __shared__ float w_s[kWK];
  __shared__ int dst_s[kWK];

  const int tile = blockIdx.x % tiles;
  const int slice = blockIdx.x / tiles;
  const int m0 = (tile / ntiles_n) * kWM;
  const int n0 = (tile % ntiles_n) * kWN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 56;
  const int ldg = 2 * g.dp;
  // this thread's z column (fixed) and rows r0, r0 + 2, ...
  const int kc = threadIdx.x & (kWM - 1);
  const int k = m0 + kc;
  const int r0 = threadIdx.x / kWM;
  constexpr int R = kWK * kWM / kThreads;

  float acc[2][7][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][i][q] = 0.f;

  const long long chunks = (g.e + kWK - 1) / kWK;
  for (long long ch = slice; ch < chunks; ch += slices) {
    const long long e0 = ch * kWK;
    if (!load_edges<kWK>(dst, mask, e0, g, w_s, dst_s)) continue;
    for (int i = threadIdx.x; i < kWK * (kWN / 4); i += kThreads) {
      const int r = i / (kWN / 4);
      const int c = n0 + 4 * (i - r * (kWN / 4));
      const bool ok = w_s[r] != 0.f && c < ldg;
      cp_async16(d_s + r * kLdD + (c - n0),
                 ok ? da + (e0 + r) * ldg + c : da, ok ? 16 : 0);
    }
    cp_async_commit();
    float v[R];
    if (k < g.d) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = r0 + 2 * q;
        v[q] = w_s[r] != 0.f ? x[(long long)dst_s[r] * g.d + k] : 0.f;
      }
    } else if (k < 2 * g.d) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = r0 + 2 * q;
        v[q] = w_s[r] != 0.f ? xj[(e0 + r) * g.d + k - g.d] : 0.f;
      }
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = r0 + 2 * q;
        v[q] = w_s[r] != 0.f && k < g.k1
                   ? basis_or_one(dist, e0 + r, k - 2 * g.d, g)
                   : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) z_s[(r0 + 2 * q) * kLdZ + kc] = v[q];
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kWK / 8; ++ks) {
      uint32_t ahi[2][4], alo[2][4];
      const float* zr = z_s + (8 * ks + tq) * kLdZ + wm + gr;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        split_tf32(zr[16 * mt], ahi[mt][0], alo[mt][0]);
        split_tf32(zr[16 * mt + 8], ahi[mt][1], alo[mt][1]);
        split_tf32(zr[4 * kLdZ + 16 * mt], ahi[mt][2], alo[mt][2]);
        split_tf32(zr[4 * kLdZ + 16 * mt + 8], ahi[mt][3], alo[mt][3]);
      }
      const float* dr = d_s + (8 * ks + tq) * kLdD + wn + gr;
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        uint32_t bhi[2], blo[2];
        split_tf32(dr[8 * i], bhi[0], blo[0]);
        split_tf32(dr[4 * kLdD + 8 * i], bhi[1], blo[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_3xtf32(acc[mt][i], ahi[mt], alo[mt], bhi, blo);
        }
      }
    }
    __syncthreads();
  }

  // write the tile into this slice, in wgrad_reduce_kernel's micro-tiles
  const int cg = round4(2 * g.d) / 4;
  float* out = partial + (long long)slice * (round4(g.k1) / 4) * cg * 16;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < 7; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = m0 + wm + 16 * mt + gr + 8 * (q >> 1);
        const int n = n0 + wn + 8 * i + 2 * tq + (q & 1);
        const int h = n / g.dp;
        const int c = n - h * g.dp;
        if (kk < g.k1 && h < 2 && c < g.d) {
          const int nc = h * g.d + c;
          out[((kk >> 2) * cg + (nc >> 2)) * 16 + (kk & 3) * 4 + (nc & 3)] =
              acc[mt][i][q];
        }
      }
    }
  }
}

size_t bwd_shared_bytes(const Geometry& g, int te) {
  return sizeof(float) * ((size_t)te * g.lda + 2 * (size_t)kKS * g.ldb + te) +
         sizeof(int) * te;
}

// Tile shape of the backward's edge kernel for width D: (MT, NTW) with
// TE = 32 * MT edges and NTW n8-tiles of each half a warp, or (0, 0).
void bwd_shape(int d, int& mt, int& ntw) {
  const int ntiles = round8(d) / 8;
  mt = ntiles <= 16 ? 2 : 1;
  ntw = ntiles <= 4 ? 1 : ntiles <= 8 ? 2 : ntiles <= 16 ? 4
      : ntiles <= 24 ? 6 : ntiles <= 32 ? 8 : 0;
  if (ntw == 0) mt = 0;
}

// Output tiles of the weight-gradient kernel per slice.
void wgrad_tiles(const Geometry& g, int& ntiles_n, int& tiles) {
  ntiles_n = (2 * g.dp + kWN - 1) / kWN;
  tiles = ((g.k1 + kWM - 1) / kWM) * ntiles_n;
}

template <int NTW, int WN>
int launch_fwd(const float* x, const float* xj, const float* dist,
               const int* dst, const float* mask, const uint32_t* ws,
               float* out, const Geometry& g, const FwdLayout& f,
               cudaStream_t s) {
  const size_t smem = fwd_shared_bytes(f);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cgconv_fwd_kernel<NTW, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + f.te - 1) / f.te;
  fused_cgconv_fwd_kernel<NTW, WN><<<(unsigned)tiles, kThreads, smem, s>>>(
      x, xj, dist, dst, mask, ws, out, g, f);
  return (int)cudaGetLastError();
}

template <int MT, int NTW>
int launch_bwd(const float* x, const float* xj, const float* dist,
               const int* dst, const float* mask, const float* wp,
               const float* wtp, const float* gout, float* dx, float* dxj,
               float* da, const Geometry& g, cudaStream_t s) {
  const size_t smem = bwd_shared_bytes(g, 32 * MT);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cgconv_bwd_kernel<MT, NTW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + 32 * MT - 1) / (32 * MT);
  fused_cgconv_bwd_kernel<MT, NTW><<<(unsigned)tiles, kThreads, smem, s>>>(
      x, xj, dist, dst, mask, wp, wtp, gout, dx, dxj, da, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats per slice of the weight gradient's partial buffer: the 4 x 4
// micro-tiles of the (2D+De+1) x 2D gradient.
long long mdl_fused_cgconv_partial_floats(int d, int de) {
  const Geometry g = make_geometry(0, d, de, 0, 0.f, 0.f);
  return (long long)(g.ldz / 4) * (g.ldn / 4) * 16;
}

// Blocks of mdl_fused_cgconv_wgrad per slice.
int mdl_fused_cgconv_wgrad_tiles(int d, int de) {
  const Geometry g = make_geometry(0, d, de, 0, 0.f, 0.f);
  int ntiles_n, tiles;
  wgrad_tiles(g, ntiles_n, tiles);
  return tiles;
}

// Words of the forward's split weight (its ws argument) for these widths,
// or -kBadShape for an unsupported one.
long long mdl_fused_cgconv_fwd_split_words(int d, int de) {
  const Geometry g = make_geometry(0, d, de, 0, 0.f, 0.f);
  FwdLayout f;
  if (d < 1 || !fwd_layout(g, &f)) return -kBadShape;
  return (long long)f.kt * kstep_words(f.np);
}

// All pointers are device pointers on the current device. w is the
// (2D+De+1) x 2D extended weight [[Wfi Wsi]; [Wfj Wsj]; [Wfe Wse]; [bf bs]];
// ws holds mdl_fused_cgconv_fwd_split_words(d, de) words, no initial value
// needed; out holds n*d zeros; mask may be null (every edge real).
// Launches the weight split, then the tiles. Returns 0 or a cudaError_t
// (kBadShape for an unsupported D or shared-memory size).
int mdl_fused_cgconv_fwd(const void* x, const void* xj, const void* dist,
                         const void* dst, const void* mask, const void* w,
                         void* ws, void* out, long long e, int d, int de,
                         int n, float coeff, float step, void* stream) {
  const Geometry g = make_geometry(e, d, de, n, coeff, step);
  FwdLayout f;
  if (d < 1 || !fwd_layout(g, &f)) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* wsp = static_cast<uint32_t*>(ws);
  const int err = launch_split(
      CgconvFwdB{static_cast<const float*>(w), d, g.k1}, f.kt, f.np, wsp, s);
  if (err != 0) return err;
  const float* xp = static_cast<const float*>(x);
  const float* xjp = static_cast<const float*>(xj);
  const float* dp = static_cast<const float*>(dist);
  const int* dsp = static_cast<const int*>(dst);
  const float* mp = static_cast<const float*>(mask);
  float* op = static_cast<float*>(out);
  switch (f.ntw * 10 + f.wn) {
    case 41: return launch_fwd<4, 1>(xp, xjp, dp, dsp, mp, wsp, op, g, f, s);
    case 131: return launch_fwd<13, 1>(xp, xjp, dp, dsp, mp, wsp, op, g, f, s);
    case 191: return launch_fwd<19, 1>(xp, xjp, dp, dsp, mp, wsp, op, g, f, s);
    case 251: return launch_fwd<25, 1>(xp, xjp, dp, dsp, mp, wsp, op, g, f, s);
    case 321: return launch_fwd<32, 1>(xp, xjp, dp, dsp, mp, wsp, op, g, f, s);
    case 192: return launch_fwd<19, 2>(xp, xjp, dp, dsp, mp, wsp, op, g, f, s);
    case 252: return launch_fwd<25, 2>(xp, xjp, dp, dsp, mp, wsp, op, g, f, s);
    case 322: return launch_fwd<32, 2>(xp, xjp, dp, dsp, mp, wsp, op, g, f, s);
    default: return kBadShape;
  }
}

// The backward's edge rows. wp is W padded to round8(K1) x 2*round8(D)
// (each half of the columns zero-padded), wtp is W[:2D]^T in the same
// padded layout (2*round8(D) square); gout (n x d); dx (n x d) holds
// zeros; dxj (e x d) and da (e x 2*round8(D)) need no initial value:
// every row of dxj is written, and the rows of da of real edges.
int mdl_fused_cgconv_bwd(const void* x, const void* xj, const void* dist,
                         const void* dst, const void* mask, const void* wp,
                         const void* wtp, const void* gout, void* dx,
                         void* dxj, void* da, long long e, int d, int de,
                         int n, float coeff, float step, void* stream) {
  const Geometry g = make_geometry(e, d, de, n, coeff, step);
  int mt, ntw;
  bwd_shape(d, mt, ntw);
  if (mt == 0 || bwd_shared_bytes(g, 32 * mt) > (size_t)kMaxShared) {
    return kBadShape;
  }
  const float* xp = static_cast<const float*>(x);
  const float* xjp = static_cast<const float*>(xj);
  const float* dsp = static_cast<const float*>(dist);
  const int* dtp = static_cast<const int*>(dst);
  const float* mp = static_cast<const float*>(mask);
  const float* wpp = static_cast<const float*>(wp);
  const float* wtpp = static_cast<const float*>(wtp);
  const float* gp = static_cast<const float*>(gout);
  float* dxp = static_cast<float*>(dx);
  float* dxjp = static_cast<float*>(dxj);
  float* dap = static_cast<float*>(da);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mt * 100 + ntw) {
    case 201: return launch_bwd<2, 1>(xp, xjp, dsp, dtp, mp, wpp, wtpp, gp, dxp, dxjp, dap, g, s);
    case 202: return launch_bwd<2, 2>(xp, xjp, dsp, dtp, mp, wpp, wtpp, gp, dxp, dxjp, dap, g, s);
    case 204: return launch_bwd<2, 4>(xp, xjp, dsp, dtp, mp, wpp, wtpp, gp, dxp, dxjp, dap, g, s);
    case 106: return launch_bwd<1, 6>(xp, xjp, dsp, dtp, mp, wpp, wtpp, gp, dxp, dxjp, dap, g, s);
    case 108: return launch_bwd<1, 8>(xp, xjp, dsp, dtp, mp, wpp, wtpp, gp, dxp, dxjp, dap, g, s);
    default: return kBadShape;
  }
}

// The weight gradient in `slices` slices: partial holds slices *
// mdl_fused_cgconv_partial_floats(d, de) floats, every one of a micro-tile
// within the gradient written (no initial value needed); da is the edge
// kernel's. Launches slices * mdl_fused_cgconv_wgrad_tiles(d, de) blocks.
int mdl_fused_cgconv_wgrad(const void* x, const void* xj, const void* dist,
                           const void* dst, const void* mask, const void* da,
                           void* partial, long long e, int d, int de, int n,
                           float coeff, float step, int slices,
                           void* stream) {
  const Geometry g = make_geometry(e, d, de, n, coeff, step);
  if (slices < 1 || d > 256) return kBadShape;
  int ntiles_n, tiles;
  wgrad_tiles(g, ntiles_n, tiles);
  fused_cgconv_wgrad_kernel<<<(unsigned)(tiles * slices), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(xj),
      static_cast<const float*>(dist), static_cast<const int*>(dst),
      static_cast<const float*>(mask), static_cast<const float*>(da),
      static_cast<float*>(partial), g, ntiles_n, tiles, slices);
  return (int)cudaGetLastError();
}

// dw (2D+De+1 x 2D) = the sum over the slices of the weight gradient.
int mdl_fused_cgconv_wgrad_reduce(const void* partial, void* dw, int blocks,
                                  int d, int de, void* stream) {
  const Geometry g = make_geometry(0, d, de, 0, 0.f, 0.f);
  const int cgroups = g.ldn / 4;
  return launch_wgrad_reduce(partial, dw, blocks, (g.ldz / 4) * cgroups,
                             cgroups, g.k1, 2 * d, stream);
}

}  // extern "C"
