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
// so msg = X @ W with X[e, r] = [a | 1][e, r / D] * xj[e, r % D] over the
// flat reduction r < (H+1)*D (row h*D + d of W is unit h's row d), and
// dW = X^T ge. Neither X nor the (E, D, K) per-edge weight tensor is ever
// stored. A row whose mask is 0 is skipped: its msg, d_xj and d_a rows
// stay the caller's zeros and it adds nothing to dW.
//
// Bound: operations. At MPNN_demo width (D = K = H = 100) a real edge costs
// 2*(H+1)*D*K ≈ 2.02 MFLOP forward and twice that backward (U, and dW),
// against ~1.2 KB of its rows.
//
// All three kernels run on the tensor cores in 3xTF32 (each operand split
// into TF32 hi + lo by split_tf32, lo·hi + hi·lo + hi·hi accumulated in
// f32, f32 accuracy): the forward and the weight gradient on mma.sync
// m16n8k8 (edge_tile.cuh), issued pass by pass over a warp's fragments
// (mma_3xtf32_tile) so that no mma waits on the one before it, the
// backward to the rows on wgmma m64nNk8. In the forward and the weight
// gradient, the operand that the warps share is split once per chunk into
// shared memory in fragment order (a warp loads a B fragment's hi and lo as
// one 16-byte load a lane), and the generated operand X (or X^T) is formed
// once per chunk in shared memory as f32 and split by each warp as it loads
// its A fragment. Bound of each at the 3xTF32 rate (495/3 TFLOP/s) at
// chip_smoke's training batch (45,509 real edges in 80,176 slots): 9.24e10
// operations ≈ 0.56 ms for the forward and the weight gradient, 9.19e10 +
// 1.8e9 ≈ 0.568 ms for the backward to the rows.
//
// * mdl_fused_bilinear_fwd: msg = mask * (X @ W) as one GEMM. A block of
//   256 threads owns a tile of 128 edges (64 where K > 128 or the tile does
//   not fit, 32 after that): its xj rows and [a | 1 | 0] rows are loaded
//   once into shared memory. W, zero-padded by the wrapper to a multiple of
//   32 rows and round8(K) columns, streams through in chunks of 32 flat
//   rows. The warps specialise: 4 multiply (2 x 2, each 64 edges x NTW
//   n8-tiles, 28 accumulators at K = 100) while the other 4 load W chunk
//   c + 1 into registers, split it into the free W buffer and build X chunk
//   c + 1 (X[e, r] for the chunk's 32 flat rows r, which may span units:
//   any D works); one barrier a chunk. At D = H = K = 100: shared memory
//   208 KB (W 2 x 28.7 KB, X 2 x 18.4 KB, the xj tile 51 KB, the [a | 1]
//   tile 67.6 KB), one block an SM; W is read from L2 once per tile with a
//   real edge (~1.4 GB at that batch). A tile with no real edge costs one
//   barrier; the epilogue scales by the mask and writes real rows only.
// * mdl_fused_bilinear_wgrad: dW = X^T (mask * g) as a split-K GEMM.
//   live_chunks_kernel first lists the 32-edge chunks that hold a real
//   edge (a batch's tail of pads drops out). Block (split s, tile) owns 128
//   flat rows x up to 128 columns of dW in registers (8 warps in 4 x 2,
//   each 32 rows x its n8-tiles) and walks the listed chunks s, s + S, ...
//   Each chunk's xj rows, [a | 1] columns for the tile's units and g
//   columns come by cp.async (16-byte where the widths allow) two chunks
//   ahead into a two-slot ring; after each chunk's product the block
//   builds the next chunk's X^T and its mask * g, split in fragment order
//   (two barriers a chunk). At D = H = K = 100: 79 tiles, 105 KB of shared
//   memory and two blocks an SM; S from the SM count, so that tiles x S
//   blocks fill their last wave best (S = 10 on 132 SMs). Each block reads
//   xj and g of its split's chunks once (~2.9 GB from L2 over all blocks)
//   and writes its tile once, never adds, into its split's partial in
//   wgrad_reduce_kernel's layout; that kernel (edge_tile.cuh) sums the S
//   partials in a fixed order. No atomics touch dW and no buffer is
//   zeroed, so dW is bit-identical from run to run on one card.
// * mdl_fused_bilinear_bwd (d_xj, d_a): U = ge @ W^T, a (E x round8(K)) @
//   (round8(K) x (H+1)*D) GEMM with a short reduction and a wide output,
//   each unit's D columns folded at once into d_xj and d_a. A first kernel
//   splits W once a call into TF32 hi and lo, laid out as the wgmma B
//   descriptors read it (K-major core matrices of 8 rows x 16 bytes, no
//   swizzle; 8.7 MB at MPNN_demo width). A block of two warpgroups owns a
//   tile of 128 edges (each warpgroup 64 rows and all of round8(D) <= 104
//   columns; past D = 104, 64 edges and a column half each): its ge = mask
//   * g and xj rows are loaded once into shared memory, and ge is the A
//   operand of every unit, loaded and split by each warp into registers
//   k-step by k-step. The split W streams through a two-stage ring by
//   16-byte cp.async, a stage being up to 8 k-steps of one unit (7 + 6 at
//   K = 100), one barrier a stage; each k-step issues three wgmma m64nNk8
//   (N = 104 at D = 100; 52 U accumulators a thread) and the stage ends on
//   wgmma.wait_group. After a unit's last stage: d_xj += a[e, h] U (the
//   bias unit by 1) in 52 more registers, d_a[e, h] = xj . U reduced over a
//   row inside the 4 lanes that share it (a warpgroup holds whole rows, so
//   no reduction across warps; past D = 104 the two column halves' partials
//   add in warpgroup order), and the next unit's first wgmma drops U. At D
//   = H = K = 100: 201 KB of shared memory (W 2 x 46.6 KB, ge 53.2 KB, xj
//   53.2 KB), one block an SM, 214 registers; the split W is read from L2
//   once per tile with a real edge (~3.1 GB at that batch). A tile with no
//   real edge costs one barrier. No atomics: d_xj and d_a are
//   bit-identical from run to run.
//
// The bf16 arm (the last argument of each entry point; `precision: bf16`
// runs it, the reference's mxu_bf16) takes the heavy products' operands
// rounded to bf16, to nearest with ties to even (round_bf16), with f32
// accumulation, at the rounding points of the reference's chunked
// schedules (:_fwd_kernel_chunked, :_bwd_kernel_chunked): the forward
// bf16(a·xj) @ bf16(W1) plus xj @ b1 unrounded, the weight gradient
// bf16(X)^T bf16(ge) (the bias unit's xj rounded too), d_a[e, h] =
// bf16(xj) · (ge @ bf16(W_h)^T) with ge unrounded. One point differs, by
// design: the reference rounds each unit's a_h·g before its product with
// W1[h]^T; this backward never forms a·g (one U_h serves d_xj and d_a), so
// d_xj = Σ_h a_h (ge @ bf16(W_h)^T) + ge @ b1^T, with a·g exact. The
// callers round W1 (ops/fused_bilinear.py:arm_weight); the kernels round
// X, ge and xj as they build their tiles. A product of bf16 values is
// exact in TF32, so the arm drops the passes whose operand has no lo part:
// one pass (hi·hi) in the forward's chunks below the bias unit and in the
// whole weight gradient, two (lo·hi, hi·hi) for the backward's units h <
// H; the bias unit keeps three. Bounds of the arm at the dense BF16 rate
// (989.4 TFLOP/s) at chip_smoke's training batch: 9.24e10 operations ≈
// 0.0934 ms for the forward and the weight gradient, ≈ 0.0947 ms for the
// backward to the rows.
//
// The caller zeroes out, d_xj and d_a, and allocates everything; the
// kernels never synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile.cuh"
#include "wgmma.cuh"

namespace {

struct Geometry {
  long long e;  // edge slots
  int d;        // xj width D
  int k;        // message width K
  int h;        // hidden units H (W holds H + 1 units)
};

// sc_s[r] = mask of edge e0 + r (0 past the end) for the tile's TE rows;
// returns, uniformly across the block, whether any of them is real.
template <int TE>
__device__ bool load_scale(const float* __restrict__ mask, long long e0,
                           long long e, float* sc_s) {
  bool real = false;
  if (threadIdx.x < TE) {
    const long long i = e0 + threadIdx.x;
    const float m = i < e ? mask[i] : 0.f;
    sc_s[threadIdx.x] = m;
    real = m != 0.f;
  }
  return __syncthreads_or(real) != 0;
}

// ---- the forward: msg = mask * (X @ W) on the tensor cores ---------------

constexpr int kFK = 32;   // flat rows of W (columns of X) a chunk holds
constexpr int kLdX = 36;  // row stride of an X chunk: 4 mod 32
constexpr int kPW = 4;    // producing warps of a forward block

struct FwdLayout {
  int rows;  // (H+1)*D: the flat reduction
  int kp;    // round8(K): columns of the padded weight
  int ntt;   // n8-tiles of a W chunk's fragment layout: NTW * WN >= kp / 8
  int ldx;   // row stride of the xj tile
  int lda;   // row stride of the [a | 1 | 0] tile, >= H + 2
  unsigned long long magic;  // ceil(2^32 / D): c / D = (c * magic) >> 32
};

FwdLayout fwd_layout(const Geometry& g, int ntt) {
  FwdLayout f;
  f.rows = (g.h + 1) * g.d;
  f.kp = round8(g.k);
  f.ntt = ntt;
  f.ldx = stride_a(g.d);
  f.lda = stride_a(g.h + 2);
  f.magic = ((1ull << 32) + g.d - 1) / g.d;
  return f;
}

// Two W chunks in fragment order, two X chunks, the xj and [a | 1 | 0]
// tiles and the mask.
size_t fwd_shared_bytes(const FwdLayout& f, int te) {
  return sizeof(float) * (2 * (size_t)kFK * 8 * f.ntt * 2 +
                          2 * (size_t)te * kLdX + (size_t)te * (f.ldx + f.lda) +
                          te);
}

// The B operands of the tensor-core kernels are kept in shared memory in
// fragment order, split once: for k-step ks and n8-tile nt of a chunk,
// lane (g, t) of a warp finds {hi B[t][g], hi B[t+4][g], lo B[t][g],
// lo B[t+4][g]} as the uint4 at slot (ks * ntt + nt) * 32 + lane, so a
// warp loads a fragment as 512 contiguous bytes.
__device__ __forceinline__ uint4 split_pair(float b0, float b1) {
  uint4 q;
  split_tf32(b0, q.x, q.z);
  split_tf32(b1, q.y, q.w);
  return q;
}

// Loads the PF slots of W chunk ch that producer thread pt (of NT) owns:
// B[t][g] and B[t+4][g] are W rows ch * kFK + 8 * ks + t (+ 4), column 8 *
// nt + g; zero past the padded width kp. The loads stay in flight until
// store_w.
template <int NT, int PF>
__device__ __forceinline__ void stage_w(const float* __restrict__ wp, int ch,
                                        int kp, int ntt, int pt,
                                        float (&st)[PF][2]) {
#pragma unroll
  for (int p = 0; p < PF; ++p) {
    const int slot = pt + p * NT;
    const int tile = slot >> 5;
    const int ks = tile / ntt;
    const int n = 8 * (tile - ks * ntt) + ((slot & 31) >> 2);
    const float* src = wp + (long long)(ch * kFK + 8 * ks + (slot & 3)) * kp + n;
    st[p][0] = n < kp ? __ldg(src) : 0.f;
    st[p][1] = n < kp ? __ldg(src + 4 * kp) : 0.f;
  }
}

template <int NT, int PF>
__device__ __forceinline__ void store_w(const float (&st)[PF][2], int pt,
                                        uint4* w_s) {
#pragma unroll
  for (int p = 0; p < PF; ++p) {
    w_s[pt + p * NT] = split_pair(st[p][0], st[p][1]);
  }
}

// Unit u = c / D and row d = c % D of flat column c (exact while c * D <
// 2^32: the rounding of magic then adds less than 1 / D to c / D).
__device__ __forceinline__ void unit_of(int c, const FwdLayout& f, int dd,
                                        int& u, int& d) {
  u = (int)(((unsigned long long)c * f.magic) >> 32);
  d = c - u * dd;
}

// X chunk ch (TE x kFK at row stride kLdX): X[e, c] = [a | 1][e, c / D] *
// xj[e, c % D] over the flat columns c of the chunk, zero past the last
// unit (column H + 1 of a_s); the bf16 arm rounds the products of the
// units h < H (the bias unit's xj stays as it is). Producer warp pw (of
// NPW) builds rows pw, pw + NPW, ..., lane l column l.
template <int TE, int NPW, bool kBf16>
__device__ __forceinline__ void build_x(int ch, int pw, const float* x_s,
                                        const float* a_s, const FwdLayout& f,
                                        const Geometry& g, float* xc_s) {
  const int lane = threadIdx.x & 31;
  int u, d;
  unit_of(ch * kFK + lane, f, g.d, u, d);
  const int oa = min(u, g.h + 1);
  const bool round = kBf16 && u < g.h;
#pragma unroll 4
  for (int r = pw; r < TE; r += NPW) {
    const float v = a_s[r * f.lda + oa] * x_s[r * f.ldx + d];
    xc_s[r * kLdX + lane] = round ? round_bf16(v) : v;
  }
}

// One tile of TE = WM * 16 * MT edges in WM * WN + kPW warps. The first
// WM * WN warps multiply: WM rows of 16 * MT edges and WN columns, warp column
// wn owning the n8-tiles wn, wn + WN, ... (NTW of them, the last ones past
// kp where WN does not divide the tile count; they feed output columns
// that are never written). The other kPW warps produce: while the first
// multiply chunk c, they load W chunk c + 1, split it into the free W
// buffer and build X chunk c + 1; one barrier a chunk. wp is [W1; b1]
// zero-padded to a multiple of kFK rows and to kp columns.
//
// The bf16 arm (kBf16; wp's W1 rows rounded by the caller, b1's not):
// build_x rounds X's products of the units h < H, and a chunk whose flat
// rows all lie below the bias unit multiplies in one TF32 pass (hi·hi:
// its operands are bf16 values, exact in TF32); the chunks that hold bias
// rows keep the three passes, so xj @ b1 stays f32-accurate.
template <int MT, int WM, int WN, int NTW, bool kBf16>
__global__ void __launch_bounds__(32 * (WM * WN + kPW), 1)
bilinear_fwd_kernel(const float* __restrict__ xj, const float* __restrict__ a,
                    const float* __restrict__ wp,
                    const float* __restrict__ mask, float* __restrict__ out,
                    Geometry g, FwdLayout f) {
  constexpr int NC = WM * WN;             // multiplying warps
  constexpr int NPT = 32 * kPW;           // producing threads
  constexpr int TE = WM * 16 * MT;
  constexpr int NTT = NTW * WN;
  constexpr int WCH = kFK / 8 * NTT * 32;  // fragment slots of a W chunk
  static_assert(WCH % NPT == 0, "every producing thread stages whole slots");
  constexpr int PF = WCH / NPT;
  extern __shared__ float4 smem4[];
  uint4* w_s = reinterpret_cast<uint4*>(smem4);             // 2 W chunks
  float* xc_s = reinterpret_cast<float*>(w_s + 2 * WCH);    // 2 x TE x kLdX
  float* x_s = xc_s + 2 * TE * kLdX;                        // TE x ldx
  float* a_s = x_s + TE * f.ldx;                            // TE x lda
  float* sc_s = a_s + TE * f.lda;                           // TE

  const long long e0 = (long long)blockIdx.x * TE;
  if (!load_scale<TE>(mask, e0, g.e, sc_s)) return;
  const int chunks = (f.rows + kFK - 1) / kFK;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool producer = warp >= NC;
  const int pt = threadIdx.x - 32 * NC;  // producing thread, when producer
  float st[PF][2];
  if (producer) stage_w<NPT, PF>(wp, 0, f.kp, NTT, pt, st);

  // the tile: xj rows and [a | 1 | 0] rows, zero for a masked edge
  for (int r = warp; r < TE; r += NC + kPW) {
    const bool real = sc_s[r] != 0.f;
    const float* xr = xj + (e0 + r) * g.d;
    const float* ar = a + (e0 + r) * g.h;
    for (int c = lane; c < g.d; c += 32) {
      x_s[r * f.ldx + c] = real ? xr[c] : 0.f;
    }
    for (int c = lane; c < g.h + 2; c += 32) {
      a_s[r * f.lda + c] = !real || c > g.h ? 0.f : c == g.h ? 1.f : ar[c];
    }
  }
  __syncthreads();
  if (producer) {
    store_w<NPT, PF>(st, pt, w_s);
    build_x<TE, kPW, kBf16>(0, warp - NC, x_s, a_s, f, g, xc_s);
  }
  __syncthreads();

  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int row0 = (warp / WN) * 16 * MT;
  const int wn = warp % WN;
  float acc[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][i][q] = 0.f;

  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    if (producer) {
      if (ch + 1 < chunks) {
        stage_w<NPT, PF>(wp, ch + 1, f.kp, NTT, pt, st);
        store_w<NPT, PF>(st, pt, w_s + (buf ^ 1) * WCH);
        build_x<TE, kPW, kBf16>(ch + 1, warp - NC, x_s, a_s, f, g,
                                xc_s + (buf ^ 1) * TE * kLdX);
      }
    } else if (kBf16 && (ch + 1) * kFK <= g.h * g.d) {
      // a chunk of bf16 products only: one pass
      const uint4* ws = w_s + buf * WCH;
      const float* xs = xc_s + buf * TE * kLdX + (row0 + gr) * kLdX + tq;
#pragma unroll
      for (int ks = 0; ks < kFK / 8; ++ks) {
        uint32_t ahi[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* xr = xs + 16 * mt * kLdX + 8 * ks;
          ahi[mt][0] = tf32_rna(xr[0]);
          ahi[mt][1] = tf32_rna(xr[8 * kLdX]);
          ahi[mt][2] = tf32_rna(xr[4]);
          ahi[mt][3] = tf32_rna(xr[8 * kLdX + 4]);
        }
        uint32_t bhi[NTW][2];
#pragma unroll
        for (int i = 0; i < NTW; ++i) {
          const uint4 q = ws[(ks * NTT + wn + WN * i) * 32 + lane];
          bhi[i][0] = q.x;
          bhi[i][1] = q.y;
        }
        mma_tf32_tile<MT, NTW>(acc, ahi, bhi);
      }
    } else {
      const uint4* ws = w_s + buf * WCH;
      const float* xs = xc_s + buf * TE * kLdX + (row0 + gr) * kLdX + tq;
#pragma unroll
      for (int ks = 0; ks < kFK / 8; ++ks) {
        uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* xr = xs + 16 * mt * kLdX + 8 * ks;
          split_tf32(xr[0], ahi[mt][0], alo[mt][0]);
          split_tf32(xr[8 * kLdX], ahi[mt][1], alo[mt][1]);
          split_tf32(xr[4], ahi[mt][2], alo[mt][2]);
          split_tf32(xr[8 * kLdX + 4], ahi[mt][3], alo[mt][3]);
        }
        uint32_t bhi[NTW][2], blo[NTW][2];
#pragma unroll
        for (int i = 0; i < NTW; ++i) {
          const uint4 q = ws[(ks * NTT + wn + WN * i) * 32 + lane];
          bhi[i][0] = q.x;
          bhi[i][1] = q.y;
          blo[i][0] = q.z;
          blo[i][1] = q.w;
        }
        mma_3xtf32_tile<MT, NTW>(acc, ahi, alo, bhi, blo);
      }
    }
    __syncthreads();
  }

  if (producer) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = row0 + 16 * mt + gr + 8 * (q >> 1);
        const int c = 8 * (wn + WN * i) + 2 * tq + (q & 1);
        const float s = sc_s[row];
        if (s != 0.f && c < g.k) out[(e0 + row) * g.k + c] = s * acc[mt][i][q];
      }
    }
  }
}

template <int MT, int WM, int WN, int NTW, bool kBf16>
int launch_fwd_arm(const float* xj, const float* a, const float* wp,
                   const float* mask, float* out, const Geometry& g,
                   cudaStream_t s) {
  constexpr int TE = WM * 16 * MT;
  const FwdLayout f = fwd_layout(g, NTW * WN);
  const size_t smem = fwd_shared_bytes(f, TE);
  if (smem > (size_t)kMaxShared) return kBadShape;
  cudaError_t err = cudaFuncSetAttribute(
      bilinear_fwd_kernel<MT, WM, WN, NTW, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + TE - 1) / TE;
  bilinear_fwd_kernel<MT, WM, WN, NTW, kBf16>
      <<<(unsigned)tiles, 32 * (WM * WN + kPW), smem, s>>>(xj, a, wp, mask,
                                                           out, g, f);
  return (int)cudaGetLastError();
}

template <int MT, int WM, int WN, int NTW>
int launch_fwd(const float* xj, const float* a, const float* wp,
               const float* mask, float* out, const Geometry& g, bool bf16,
               cudaStream_t s) {
  return bf16
             ? launch_fwd_arm<MT, WM, WN, NTW, true>(xj, a, wp, mask, out, g, s)
             : launch_fwd_arm<MT, WM, WN, NTW, false>(xj, a, wp, mask, out, g, s);
}

// The forward's tile for these widths: 128 edges in 4 multiplying warps (2
// x 2, 64 edges x NTW n8-tiles each, NTW exactly half the tiles) where K <=
// 128 and it fits in shared memory, else 64 edges (2 x 2 warps of 32
// edges), else 32 (2 x 2 warps of 16), with NTW rounded up to an
// instantiated count; kPW producing warps besides. Returns kBadShape where
// none fits.
int fwd_dispatch(const float* xj, const float* a, const float* wp,
                 const float* mask, float* out, const Geometry& g, bool bf16,
                 cudaStream_t s) {
  const int ntiles = round8(g.k) / 8;
  auto fits = [&](int te, int ntt) {
    return fwd_shared_bytes(fwd_layout(g, ntt), te) <= (size_t)kMaxShared;
  };
  const int half = (ntiles + 1) / 2;
  if (ntiles <= 16 && fits(128, 2 * half)) {
    switch (half) {
      case 1: return launch_fwd<4, 2, 2, 1>(xj, a, wp, mask, out, g, bf16, s);
      case 2: return launch_fwd<4, 2, 2, 2>(xj, a, wp, mask, out, g, bf16, s);
      case 3: return launch_fwd<4, 2, 2, 3>(xj, a, wp, mask, out, g, bf16, s);
      case 4: return launch_fwd<4, 2, 2, 4>(xj, a, wp, mask, out, g, bf16, s);
      case 5: return launch_fwd<4, 2, 2, 5>(xj, a, wp, mask, out, g, bf16, s);
      case 6: return launch_fwd<4, 2, 2, 6>(xj, a, wp, mask, out, g, bf16, s);
      case 7: return launch_fwd<4, 2, 2, 7>(xj, a, wp, mask, out, g, bf16, s);
      default: return launch_fwd<4, 2, 2, 8>(xj, a, wp, mask, out, g, bf16, s);
    }
  }
  const int ntw = half <= 4 ? 4 : half <= 8 ? 8 : half <= 12 ? 12 : 16;
  if (fits(64, 2 * ntw)) {
    switch (ntw) {
      case 4: return launch_fwd<2, 2, 2, 4>(xj, a, wp, mask, out, g, bf16, s);
      case 8: return launch_fwd<2, 2, 2, 8>(xj, a, wp, mask, out, g, bf16, s);
      case 12: return launch_fwd<2, 2, 2, 12>(xj, a, wp, mask, out, g, bf16, s);
      default: return launch_fwd<2, 2, 2, 16>(xj, a, wp, mask, out, g, bf16, s);
    }
  }
  switch (ntw) {
    case 4: return launch_fwd<1, 2, 2, 4>(xj, a, wp, mask, out, g, bf16, s);
    case 8: return launch_fwd<1, 2, 2, 8>(xj, a, wp, mask, out, g, bf16, s);
    case 12: return launch_fwd<1, 2, 2, 12>(xj, a, wp, mask, out, g, bf16, s);
    default: return launch_fwd<1, 2, 2, 16>(xj, a, wp, mask, out, g, bf16, s);
  }
}

// ---- the weight gradient: dW = X^T (mask * g), split over the edges -------

constexpr int kWK = 32;      // edges of a chunk
constexpr int kWM = 128;     // flat dW rows of a block's tile
constexpr int kWN = 128;     // dW columns of a block's tile, at most

struct WgradLayout {
  int rows;    // (H+1)*D
  int units;   // most units of [a | 1] a tile's rows span
  int bn;      // dW columns of a tile (round8)
  int ncs;     // column splits: ceil(round8(K) / bn)
  int ntw;     // n8-tiles of a warp: ceil(bn / 16)
  int tiles;   // ceil(rows / kWM) * ncs
  int ldx;     // row stride of a chunk's xj rows (8 mod 16)
  int lda;     // row stride of its [a | 1] columns (8 mod 16)
  int ldg;     // row stride of its g columns (8 mod 16)
  int stage;   // floats of one chunk as loaded: xj, [a | 1], g, mask
  int cg;      // round4(K) / 4: micro-tile columns of the partial layout
  long long plane;  // floats of one split's partial (wgrad_reduce layout)
};

WgradLayout wgrad_layout(const Geometry& g) {
  WgradLayout w;
  w.rows = (g.h + 1) * g.d;
  const int span = (kWM - 1) / g.d + 2;
  w.units = span < g.h + 1 ? span : g.h + 1;
  const int kp = round8(g.k);
  w.ncs = (kp + kWN - 1) / kWN;
  w.bn = round8((kp + w.ncs - 1) / w.ncs);
  w.ntw = (w.bn / 8 + 1) / 2;
  w.tiles = ((w.rows + kWM - 1) / kWM) * w.ncs;
  w.ldx = stride_b(g.d);
  w.lda = stride_b(w.units);
  w.ldg = stride_b(16 * w.ntw);
  w.stage = kWK * (w.ldx + w.lda + w.ldg + 1);
  w.cg = round4(g.k) / 4;
  w.plane = (long long)(round4(w.rows) / 4) * w.cg * 16;
  return w;
}

// Two loaded chunks, an X^T chunk (kWM x kLdX) and a B chunk in fragment
// order (kWK / 8 * 2 * ntw * 32 uint4).
size_t wgrad_shared_bytes(const WgradLayout& w) {
  return sizeof(float) *
         (2 * (size_t)w.stage + (size_t)kWM * kLdX + (size_t)kWK * 32 * w.ntw);
}

// live[0] = the number of 32-edge chunks with a real edge, live[1 ..] their
// indices in increasing order: one block walks the chunks 1024 at a time,
// a thread a chunk, and places them by a prefix sum of the flags.
__global__ void __launch_bounds__(1024)
live_chunks_kernel(const float* __restrict__ mask, long long e,
                   int* __restrict__ live) {
  __shared__ int warp_s[32];
  __shared__ int base_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long chunks = (e + kWK - 1) / kWK;
  if (threadIdx.x == 0) base_s = 0;
  for (long long c0 = 0; c0 < chunks; c0 += 1024) {
    const long long ch = c0 + threadIdx.x;
    bool real = false;
    if ((ch + 1) * kWK <= e) {
      const float4* m4 = reinterpret_cast<const float4*>(mask + ch * kWK);
#pragma unroll
      for (int q = 0; q < kWK / 4; ++q) {
        const float4 v = m4[q];
        real |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
      }
    } else {
      for (long long i = ch * kWK; i < e; ++i) real |= mask[i] != 0.f;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, real);
    if (lane == 0) warp_s[warp] = __popc(ballot);
    __syncthreads();
    int before = base_s;
    for (int w = 0; w < warp; ++w) before += warp_s[w];
    before += __popc(ballot & ((1u << lane) - 1u));
    if (real) live[1 + before] = (int)ch;
    __syncthreads();
    if (threadIdx.x == 1023) base_s = before + (real ? 1 : 0);
    __syncthreads();
  }
  if (threadIdx.x == 0) live[0] = base_s;
}

// Block (split, tile): tile = blockIdx % tiles owns flat dW rows m0 ..
// m0 + 127 and columns n0 .. n0 + bn - 1; split = blockIdx / tiles walks
// the chunks of the live list (live_chunks_kernel) at split, split + S, ...
// in order. Each chunk's xj rows, its
// [a | 1] columns for the tile's units and its g columns (those straight
// into fragment order) come by 4-byte cp.async, two chunks ahead of the
// product; one chunk ahead, every thread builds its share of the chunk's
// X^T and of mask * g split into TF32 hi and lo, once for the block. 8
// warps in 4 (32 rows) x 2 (n8-tiles wn, wn + 2, ...). The block writes its
// tile into its split's partial in wgrad_reduce_kernel's layout. The bf16
// arm (kBf16) rounds every X^T entry (the bias unit's xj too) and mask * g
// to bf16 as it builds them, and multiplies in one TF32 pass (hi·hi).
template <int NTW, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
bilinear_wgrad_kernel(const float* __restrict__ xj,
                      const float* __restrict__ a,
                      const float* __restrict__ mask,
                      const float* __restrict__ gout,
                      const int* __restrict__ live,
                      float* __restrict__ partial, Geometry g, WgradLayout w,
                      int splits) {
  constexpr int NTT = 2 * NTW;            // n8-tiles of a chunk's B
  constexpr int BCH = kWK / 8 * NTT * 32;  // fragment slots of a B chunk
  static_assert(BCH % kThreads == 0, "every thread builds whole slots");
  extern __shared__ float4 smem4[];
  uint4* b_s = reinterpret_cast<uint4*>(smem4);            // B chunk
  float* xt_s = reinterpret_cast<float*>(b_s + BCH);        // X^T chunk
  float* ring = xt_s + kWM * kLdX;                          // 2 loaded

  const int tile = blockIdx.x % w.tiles;
  const int split = blockIdx.x / w.tiles;
  const int m0 = (tile / w.ncs) * kWM;
  const int n0 = (tile % w.ncs) * w.bn;
  const int u_first = m0 / g.d;
  const int units = min(w.units, g.h + 1 - u_first);
  const int ncols = min(w.bn, g.k - n0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int wm = (warp >> 1) * 32;
  const int wn = warp & 1;

  // the X^T build: this thread's rows 8 * (warp + 8 q) + gr (q < 2) of the
  // tile and edges 4 * kb + tq (kb < 8); the xj column and [a | 1] column
  // of each row (rows past the last stay in bounds; they are never written)
  int ox[2], oa[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int m = min(m0 + 8 * (warp + 8 * q) + gr, w.rows - 1);
    const int u = m / g.d;
    ox[q] = m - u * g.d;
    oa[q] = u - u_first;
  }

  // 16-byte copies of the xj and g rows where every row is whole float4
  const bool vec = (g.d & 3) == 0 && (g.k & 3) == 0 && (ncols & 3) == 0;

  // chunk ch → ring slot `slot`: xj rows, [a | 1] columns u_first .., g
  // columns n0 .. (zeros past the last edge) and the mask
  auto load_chunk = [&](long long ch, int slot) {
    float* x_s = ring + slot * w.stage;
    float* a_s = x_s + kWK * w.ldx;
    float* g_s = a_s + kWK * w.lda;
    float* sc_s = g_s + kWK * w.ldg;
    for (int r = warp; r < kWK; r += 8) {
      const long long e = ch * kWK + r;
      const bool in = e < g.e;
      const long long ee = in ? e : 0;
      const float* xr = xj + ee * g.d;
      const float* gg = gout + ee * g.k + n0;
      if (vec) {
        const int nb = in ? 16 : 0;
        for (int c = 4 * lane; c < g.d; c += 128) cp_async16(x_s + r * w.ldx + c, xr + c, nb);
        for (int c = 4 * lane; c < ncols; c += 128) cp_async16(g_s + r * w.ldg + c, gg + c, nb);
      } else {
        const int nb = in ? 4 : 0;
        for (int c = lane; c < g.d; c += 32) cp_async4(x_s + r * w.ldx + c, xr + c, nb);
        for (int c = lane; c < ncols; c += 32) cp_async4(g_s + r * w.ldg + c, gg + c, nb);
      }
      const int nb = in ? 4 : 0;
      const float* ar = a + ee * g.h + u_first;
      for (int c = lane; c < units; c += 32) {
        if (u_first + c < g.h) {
          cp_async4(a_s + r * w.lda + c, ar + c, nb);
        } else {
          a_s[r * w.lda + c] = 1.f;  // the bias unit
        }
      }
      if (lane == 0) sc_s[r] = in ? mask[e] : 0.f;
    }
  };

  // ring slot → X^T chunk and B chunk (mask * g, split, fragment order)
  auto build = [&](int slot, float* xt, uint4* bq) {
    const float* x_s = ring + slot * w.stage;
    const float* a_s = x_s + kWK * w.ldx;
    const float* g_s = a_s + kWK * w.lda;
    const float* sc_s = g_s + kWK * w.ldg;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float* xr = xt + (8 * (warp + 8 * q) + gr) * kLdX + tq;
#pragma unroll
      for (int kb = 0; kb < kWK / 4; ++kb) {
        const int k = 4 * kb + tq;
        const float v = a_s[k * w.lda + oa[q]] * x_s[k * w.ldx + ox[q]];
        xr[4 * kb] = kBf16 ? round_bf16(v) : v;
      }
    }
#pragma unroll
    for (int p = 0; p < BCH / kThreads; ++p) {
      const int slot_b = threadIdx.x + p * kThreads;
      const int tile = slot_b >> 5;
      const int ks = tile / NTT;
      const int k = 8 * ks + (slot_b & 3);
      const float* gr0 = g_s + k * w.ldg + 8 * (tile - ks * NTT) + ((slot_b & 31) >> 2);
      const float g0 = sc_s[k] * gr0[0];
      const float g1 = sc_s[k + 4] * gr0[4 * w.ldg];
      bq[slot_b] = kBf16 ? split_pair(round_bf16(g0), round_bf16(g1))
                         : split_pair(g0, g1);
    }
  };

  float acc[2][NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][i][q] = 0.f;

  // the next chunk to load, its index read one load ahead
  const int n_live = live[0];
  int pos = split;
  int next = pos < n_live ? live[1 + pos] : -1;
  int issued = 0;
  auto issue = [&](int slot) {
    if (next >= 0) {
      load_chunk(next, slot);
      ++issued;
      pos += splits;
      next = pos < n_live ? live[1 + pos] : -1;
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);
  cp_async_wait<1>();
  __syncthreads();
  if (issued > 0) build(0, xt_s, b_s);
  for (int j = 0; j < issued; ++j) {
    // chunk j is built and chunk j + 1 landed
    cp_async_wait<0>();
    __syncthreads();
    const bool more = j + 1 < issued;
    issue(j & 1);  // chunk j + 2, in the slot chunk j left
    const float* xs = xt_s + (wm + gr) * kLdX + tq;
#pragma unroll
    for (int ks = 0; ks < kWK / 8; ++ks) {
      if (kBf16) {
        uint32_t ahi[2][4], bhi[NTW][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* xr = xs + 16 * mt * kLdX + 8 * ks;
          ahi[mt][0] = tf32_rna(xr[0]);
          ahi[mt][1] = tf32_rna(xr[8 * kLdX]);
          ahi[mt][2] = tf32_rna(xr[4]);
          ahi[mt][3] = tf32_rna(xr[8 * kLdX + 4]);
        }
#pragma unroll
        for (int i = 0; i < NTW; ++i) {
          const uint4 q = b_s[(ks * NTT + wn + 2 * i) * 32 + lane];
          bhi[i][0] = q.x;
          bhi[i][1] = q.y;
        }
        mma_tf32_tile<2, NTW>(acc, ahi, bhi);
        continue;
      }
      // A = X^T: row m, column (edge) k; B = mask * g: row k, column n
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* xr = xs + 16 * mt * kLdX + 8 * ks;
        split_tf32(xr[0], ahi[mt][0], alo[mt][0]);
        split_tf32(xr[8 * kLdX], ahi[mt][1], alo[mt][1]);
        split_tf32(xr[4], ahi[mt][2], alo[mt][2]);
        split_tf32(xr[8 * kLdX + 4], ahi[mt][3], alo[mt][3]);
      }
      uint32_t bhi[NTW][2], blo[NTW][2];
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const uint4 q = b_s[(ks * NTT + wn + 2 * i) * 32 + lane];
        bhi[i][0] = q.x;
        bhi[i][1] = q.y;
        blo[i][0] = q.z;
        blo[i][1] = q.w;
      }
      mma_3xtf32_tile<2, NTW>(acc, ahi, alo, bhi, blo);
    }
    __syncthreads();  // every warp is done with chunk j's operands
    if (more) build((j + 1) & 1, xt_s, b_s);
  }
  cp_async_wait<0>();

  float* out = partial + split * w.plane;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm + 16 * mt + gr + 8 * (q >> 1);
        const int c = 8 * (wn + 2 * i) + 2 * tq + (q & 1);
        if (m < w.rows && c < ncols) {
          const int n = n0 + c;
          out[((m >> 2) * w.cg + (n >> 2)) * 16 + (m & 3) * 4 + (n & 3)] =
              acc[mt][i][q];
        }
      }
    }
  }
}

// Sets the kernel's shared-memory size and returns the blocks the card
// holds at once in *slots.
template <int NTW, bool kBf16>
int wgrad_slots(const WgradLayout& w, int* slots) {
  const size_t smem = wgrad_shared_bytes(w);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      bilinear_wgrad_kernel<NTW, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bilinear_wgrad_kernel<NTW, kBf16>, kThreads, smem);
  }
  *slots = sms * per_sm;
  return (int)err;
}

template <bool kBf16>
int wgrad_slots_arm(const WgradLayout& w, int* slots) {
  switch (w.ntw) {
    case 1: return wgrad_slots<1, kBf16>(w, slots);
    case 2: return wgrad_slots<2, kBf16>(w, slots);
    case 3: return wgrad_slots<3, kBf16>(w, slots);
    case 4: return wgrad_slots<4, kBf16>(w, slots);
    case 5: return wgrad_slots<5, kBf16>(w, slots);
    case 6: return wgrad_slots<6, kBf16>(w, slots);
    case 7: return wgrad_slots<7, kBf16>(w, slots);
    default: return wgrad_slots<8, kBf16>(w, slots);
  }
}

int wgrad_slots_for(const WgradLayout& w, bool bf16, int* slots) {
  return bf16 ? wgrad_slots_arm<true>(w, slots)
              : wgrad_slots_arm<false>(w, slots);
}

template <int NTW, bool kBf16>
int launch_wgrad_arm(const float* xj, const float* a, const float* mask,
                     const float* gout, const int* live, float* partial,
                     const Geometry& g, const WgradLayout& w, int splits,
                     cudaStream_t s) {
  int slots = 0;
  const int err = wgrad_slots<NTW, kBf16>(w, &slots);  // sets the shared size
  if (err != 0) return err;
  bilinear_wgrad_kernel<NTW, kBf16>
      <<<(unsigned)(w.tiles * splits), kThreads, wgrad_shared_bytes(w), s>>>(
          xj, a, mask, gout, live, partial, g, w, splits);
  return (int)cudaGetLastError();
}

template <int NTW>
int launch_wgrad(const float* xj, const float* a, const float* mask,
                 const float* gout, const int* live, float* partial,
                 const Geometry& g, const WgradLayout& w, int splits,
                 bool bf16, cudaStream_t s) {
  return bf16 ? launch_wgrad_arm<NTW, true>(xj, a, mask, gout, live, partial,
                                            g, w, splits, s)
              : launch_wgrad_arm<NTW, false>(xj, a, mask, gout, live, partial,
                                             g, w, splits, s);
}

// ---- the backward to the rows: U = ge @ W^T, then d_xj and d_a ----------

constexpr int kKS = 8;  // most k-steps (of 8 columns of W) a stage holds

struct BwdLayout {
  int kt;   // k-steps of U's reduction: round8(K) / 8
  int np;   // W rows of a unit in ws: the n8-tiles of all warpgroups x 8
  int ks;   // k-steps a stage holds (<= kKS)
  int nk;   // stages a unit: ceil(kt / ks)
  int ldg;  // row stride of the ge tile (8 mod 16)
  int ldx;  // row stride of the xj tile (8 mod 16)
};

// Two W stages, the ge and xj tiles, the d_a partials (two units x WN
// warpgroup columns) and the mask.
size_t bwd_shared_bytes(const BwdLayout& b, int te, int wn) {
  return sizeof(float) * (2 * (size_t)b.ks * kstep_words(b.np) +
                          (size_t)te * (b.ldg + b.ldx) + 2 * (size_t)wn * te +
                          te);
}

// The layout for a tile of te edges and np W rows a unit: the fewest
// stages a unit whose two-stage ring fits in shared memory, the k-steps
// dealt evenly. False where none fits.
bool bwd_layout(const Geometry& g, int np, int te, int wn, BwdLayout* b) {
  b->kt = round8(g.k) / 8;
  b->np = np;
  b->ldg = stride_b(8 * b->kt);
  b->ldx = stride_b(np);
  for (int most = kKS; most >= 1; --most) {
    b->nk = (b->kt + most - 1) / most;
    b->ks = (b->kt + b->nk - 1) / b->nk;
    if (bwd_shared_bytes(*b, te, wn) <= (size_t)kMaxShared) return true;
  }
  return false;
}

// W = [W1; b1] as the backward's B operand: unit u = s / kt, k-step
// s % kt; B row n < np of the unit is W row u*D + n, its columns the
// k-step's 8 of K (zero past D or K). split_kmajor_kernel (wgmma.cuh) lays
// it out in the descriptors' order, a unit's k-steps one after another.
struct BilinearB {
  const float* w;
  int d, k, kt;
  __device__ float operator()(long long s, int n, int c) const {
    const long long u = s / kt;
    const int col = 8 * (int)(s - u * kt) + c;
    return n < d && col < k ? w[(u * d + n) * k + col] : 0.f;
  }
};

// One tile of TE = 64 * 2 / WN edges, two warpgroups: with WN = 1 each owns
// 64 of the tile's 128 rows and all of a unit's 8 NTW columns; with WN = 2
// both own the tile's 64 rows, warpgroup wn the columns 8 NTW wn .. . The
// tile's ge = mask * g (columns interleaved, so that a lane's A pair {k, k
// + 4} is one 8-byte load) and xj rows are loaded once; ws streams through
// a two-stage ring of 16-byte cp.async (a stage: ks k-steps of one unit,
// one contiguous range of ws), one stage ahead, one barrier a stage. For
// each k-step a warp loads and splits its A fragment and its warpgroup
// issues three wgmma (lo·hi, hi·lo, hi·hi, f32 accumulation: 3xTF32) into
// the unit's U; the stage ends on wgmma_wait. After a unit's last stage
// the warp folds U into its d_xj accumulators (a[e, h] U, the bias unit by
// 1), reduces xj . U over its columns (a fixed fmaf chain a lane, then the
// lanes of the quad that share the row) into its d_a partial; the first
// wgmma of the next unit drops U. The first TE threads add a unit's WN
// partials in warpgroup order and write d_a one stage later. Real rows
// only are written.
//
// The bf16 arm (kBf16; the caller's W holds W1 rounded to bf16, b1 as it
// is): the xj tile is rounded to bf16 (it feeds d_a alone), ge is not, and
// the units h < H take two passes, lo·hi and hi·hi (their B has no lo
// part); the bias unit keeps three. So d_a[e, h] = bf16(xj) · (ge @
// bf16(W_h)^T) and d_xj = Σ_h a[e, h] (ge @ bf16(W_h)^T) + ge @ b1^T.
template <int NTW, int WN, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
bilinear_bwd_kernel(const float* __restrict__ xj, const float* __restrict__ a,
                    const uint32_t* __restrict__ ws,
                    const float* __restrict__ mask,
                    const float* __restrict__ gout, float* __restrict__ dxj,
                    float* __restrict__ da, Geometry g, BwdLayout b) {
  constexpr int TE = 64 * 2 / WN;
  const int stage_words = b.ks * kstep_words(b.np);
  extern __shared__ float4 smem4[];
  uint32_t* w_s = reinterpret_cast<uint32_t*>(smem4);  // 2 stages
  float* g_s = reinterpret_cast<float*>(w_s + 2 * stage_words);  // TE x ldg
  float* x_s = g_s + TE * b.ldg;                 // TE x ldx: xj
  float* p_s = x_s + TE * b.ldx;                 // 2 x WN x TE: d_a parts
  float* sc_s = p_s + 2 * WN * TE;               // TE: the mask

  const long long e0 = (long long)blockIdx.x * TE;
  if (!load_scale<TE>(mask, e0, g.e, sc_s)) return;
  const int stages = (g.h + 1) * b.nk;

  // stage s: unit s / nk, k-steps (s % nk) * ks .. of it
  auto load_stage = [&](int s) {
    if (s < stages) {
      const int u = s / b.nk;
      const int k0 = (s - u * b.nk) * b.ks;
      const int q = min(b.ks, b.kt - k0) * kstep_words(b.np) / 4;
      uint32_t* dst = w_s + (s & 1) * stage_words;
      const uint32_t* src =
          ws + ((long long)u * b.kt + k0) * kstep_words(b.np);
      for (int i = threadIdx.x; i < q; i += kThreads) {
        cp_async16(dst + 4 * i, src + 4 * i);
      }
    }
    cp_async_commit();
  };
  load_stage(0);

  // the ge tile (zero past K and on masked rows), interleaved: position p
  // of a row holds column (p & ~7) + (p & 7) / 2 + 4 * (p & 1)
  const int kp = 8 * b.kt;
  for (int i = threadIdx.x; i < TE * kp; i += kThreads) {
    const int r = i / kp;
    const int p = i - r * kp;
    const int k = (p & ~7) + ((p & 7) >> 1) + 4 * (p & 1);
    const float s = sc_s[r];
    g_s[r * b.ldg + p] =
        s != 0.f && k < g.k ? s * gout[(e0 + r) * g.k + k] : 0.f;
  }
  // the xj tile, zero past D and on masked rows
  for (int i = threadIdx.x; i < TE * b.np; i += kThreads) {
    const int r = i / b.np;
    const int c = i - r * b.np;
    const float v = sc_s[r] != 0.f && c < g.d ? xj[(e0 + r) * g.d + c] : 0.f;
    x_s[r * b.ldx + c] = kBf16 ? round_bf16(v) : v;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int wn = WN == 1 ? 0 : warp >> 2;       // warpgroup column
  const int row0 = 16 * (WN == 1 ? warp : warp & 3);
  const int col0 = wn * NTW * 8;  // the warpgroup's first column of a unit
  const int r0 = row0 + gr;       // the lane's rows r0 and r0 + 8
  const bool real0 = sc_s[r0] != 0.f;
  const bool real1 = sc_s[r0 + 8] != 0.f;
  const float* a0p = a + (real0 ? (e0 + r0) * g.h : 0);
  const float* a1p = a + (real1 ? (e0 + r0 + 8) * g.h : 0);
  const float* gs = g_s + r0 * b.ldg + 2 * tq;
  const float* xs = x_s + r0 * b.ldx + col0 + 2 * tq;
  // the warpgroup's B within a k-step: its first 8-row group, hi and lo
  const int b_hi = (col0 / 8) * 64;
  const int b_lo = b.np * 8 + b_hi;

  float u[NTW][4], dx[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) u[j][q] = dx[j][q] = 0.f;

  for (int s = 0; s < stages; ++s) {
    cp_async_wait<0>();
    // the landed stage is read by wgmma (the async proxy)
    fence_proxy_async();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    load_stage(s + 1);
    const int h = s / b.nk;
    const int c = s - h * b.nk;
    if (c == 0 && h > 0 && threadIdx.x < TE && sc_s[threadIdx.x] != 0.f) {
      // unit h - 1's d_a: its WN partials in warpgroup order
      const float* p = p_s + ((h - 1) & 1) * WN * TE + threadIdx.x;
      float v = p[0];
#pragma unroll
      for (int w = 1; w < WN; ++w) v += p[w * TE];
      da[(e0 + threadIdx.x) * g.h + h - 1] = v;
    }
    const bool last = c == b.nk - 1;
    const bool bias = h == g.h;
    float a0 = 1.f, a1 = 1.f;
    if (last && !bias) {
      a0 = real0 ? __ldg(a0p + h) : 0.f;
      a1 = real1 ? __ldg(a1p + h) : 0.f;
    }

    const uint32_t* wst = w_s + (s & 1) * stage_words;
    const float* gk = gs + 8 * c * b.ks;
    const int nks = min(b.ks, b.kt - c * b.ks);
    uint32_t ahi[kKS][4], alo[kKS][4];
    fence_acc(u);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      if (ks < nks) {  // uniform across the block
        // A = ge: rows r0, r0 + 8, columns {t, t + 4} of the k-step
        const float2 x0 = *reinterpret_cast<const float2*>(gk + 8 * ks);
        const float2 x1 =
            *reinterpret_cast<const float2*>(gk + 8 * b.ldg + 8 * ks);
        split_tf32(x0.x, ahi[ks][0], alo[ks][0]);
        split_tf32(x1.x, ahi[ks][1], alo[ks][1]);
        split_tf32(x0.y, ahi[ks][2], alo[ks][2]);
        split_tf32(x1.y, ahi[ks][3], alo[ks][3]);
        const uint32_t* wk = wst + ks * kstep_words(b.np);
        const uint64_t dhi = b_desc(wk + b_hi);
        const uint64_t dlo = b_desc(wk + b_lo);
        wgmma_fence();
        const int scale = c == 0 && ks == 0 ? 0 : 1;
        if (kBf16 && !bias) {  // B is bf16: no lo part
          WgmmaTf32<NTW>::mma(u, alo[ks], dhi, scale);
          WgmmaTf32<NTW>::mma(u, ahi[ks], dhi, 1);
        } else {
          wgmma_3xtf32(u, ahi[ks], alo[ks], dhi, dlo, scale);
        }
      }
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      if (ks < nks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fence_reg(ahi[ks][q]);
          fence_reg(alo[ks][q]);
        }
      }
    }
    fence_acc(u);

    if (!last) continue;
    // the epilogue of unit h: lane (gr, tq) holds U[r0][c], U[r0][c + 1],
    // U[r0 + 8][c], U[r0 + 8][c + 1] for c = col0 + 8 j + 2 tq
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      dx[j][0] = fmaf(a0, u[j][0], dx[j][0]);
      dx[j][1] = fmaf(a0, u[j][1], dx[j][1]);
      dx[j][2] = fmaf(a1, u[j][2], dx[j][2]);
      dx[j][3] = fmaf(a1, u[j][3], dx[j][3]);
      if (!bias) {
        const float2 v0 = *reinterpret_cast<const float2*>(xs + 8 * j);
        const float2 v1 = *reinterpret_cast<const float2*>(xs + 8 * b.ldx + 8 * j);
        dot0 = fmaf(v0.x, u[j][0], dot0);
        dot0 = fmaf(v0.y, u[j][1], dot0);
        dot1 = fmaf(v1.x, u[j][2], dot1);
        dot1 = fmaf(v1.y, u[j][3], dot1);
      }
    }
    if (!bias) {  // uniform across the block
      dot0 += __shfl_xor_sync(0xffffffffu, dot0, 1);
      dot0 += __shfl_xor_sync(0xffffffffu, dot0, 2);
      dot1 += __shfl_xor_sync(0xffffffffu, dot1, 1);
      dot1 += __shfl_xor_sync(0xffffffffu, dot1, 2);
      if (tq == 0) {
        float* p = p_s + ((h & 1) * WN + wn) * TE + r0;
        p[0] = dot0;
        p[8] = dot1;
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int c = col0 + 8 * j + 2 * tq;
    if (real0) {
      float* out = dxj + (e0 + r0) * g.d;
      if (c < g.d) out[c] = dx[j][0];
      if (c + 1 < g.d) out[c + 1] = dx[j][1];
    }
    if (real1) {
      float* out = dxj + (e0 + r0 + 8) * g.d;
      if (c < g.d) out[c] = dx[j][2];
      if (c + 1 < g.d) out[c + 1] = dx[j][3];
    }
  }
}

// The warpgroup layout for D: two row halves of a 128-edge tile, each with
// all of round8(D) in NTW = 8 or 13 n8-tiles, where D <= 104; else two
// column halves of a 64-edge tile, NTW = 13 up to D = 208 and 16 up to 256.
int bwd_warpgroups(int d, int* wn) {
  const int nt = round8(d) / 8;
  *wn = nt <= 13 ? 1 : 2;
  if (nt <= 8) return 8;
  if (nt <= 26) return 13;
  return 16;
}

template <int NTW, int WN, bool kBf16>
int launch_bwd_arm(const float* xj, const float* a, const uint32_t* ws,
                   const float* mask, const float* gout, float* dxj, float* da,
                   const Geometry& g, const BwdLayout& b, cudaStream_t s) {
  constexpr int TE = 64 * 2 / WN;
  const size_t smem = bwd_shared_bytes(b, TE, WN);
  cudaError_t err = cudaFuncSetAttribute(
      bilinear_bwd_kernel<NTW, WN, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (g.e + TE - 1) / TE;
  bilinear_bwd_kernel<NTW, WN, kBf16><<<(unsigned)tiles, kThreads, smem, s>>>(
      xj, a, ws, mask, gout, dxj, da, g, b);
  return (int)cudaGetLastError();
}

template <int NTW, int WN>
int launch_bwd(const float* xj, const float* a, const uint32_t* ws,
               const float* mask, const float* gout, float* dxj, float* da,
               const Geometry& g, const BwdLayout& b, bool bf16,
               cudaStream_t s) {
  return bf16 ? launch_bwd_arm<NTW, WN, true>(xj, a, ws, mask, gout, dxj, da,
                                              g, b, s)
              : launch_bwd_arm<NTW, WN, false>(xj, a, ws, mask, gout, dxj, da,
                                               g, b, s);
}

Geometry make_geometry(long long e, int d, int k, int h) {
  Geometry g;
  g.e = e; g.d = d; g.k = k; g.h = h;
  return g;
}

}  // namespace

extern "C" {

// Floats of one split's partial of the weight gradient (the 4 x 4
// micro-tiles of the ((h+1)*d x k) gradient).
long long mdl_fused_bilinear_partial_floats(int d, int k, int h) {
  return wgrad_layout(make_geometry(0, d, k, h)).plane;
}

// Edge splits S of the weight gradient for these shapes and arm (bf16 !=
// 0: the bf16 one) on the current device: of S = 1 .. max(16, slots /
// tiles) (at most one split per chunk), the one whose tiles x S blocks
// fill their last wave of the card's resident blocks best, the smaller on
// a tie. Returns S >= 1, or minus a
// cudaError_t (kBadShape for an unsupported width).
int mdl_fused_bilinear_wgrad_splits(long long e, int d, int k, int h,
                                    int bf16) {
  if (d < 1 || d > 256 || k < 1 || k > 256) return -kBadShape;
  const WgradLayout w = wgrad_layout(make_geometry(e, d, k, h));
  if (wgrad_shared_bytes(w) > (size_t)kMaxShared) return -kBadShape;
  int slots = 0;
  const int err = wgrad_slots_for(w, bf16 != 0, &slots);
  if (err != 0) return -err;
  if (slots < 1) return -kBadShape;
  const long long chunks = (e + kWK - 1) / kWK;
  const long long most = slots / w.tiles > 16 ? slots / w.tiles : 16;
  long long best = 1;
  double best_fill = 0.0;
  for (long long s = 1; s <= most && s <= chunks; ++s) {
    const long long blocks = w.tiles * s;
    const long long waves = (blocks + slots - 1) / slots;
    const double fill = (double)blocks / (double)(waves * slots);
    if (fill > best_fill + 1e-9) {
      best = s;
      best_fill = fill;
    }
  }
  return (int)best;
}

// All pointers are device pointers on the current device. xj (e x d), a
// (e x h), mask (e); wp is [W1; b1] ((h+1)*d x k, W1 as (h*d x k))
// zero-padded to a multiple of 32 rows and to round8(k) columns, its W1
// rows rounded to bf16 for the bf16 arm (bf16 != 0); out (e x k) holds
// zeros. Returns 0 or a cudaError_t (kBadShape for an unsupported width or
// shared-memory size).
int mdl_fused_bilinear_fwd(const void* xj, const void* a, const void* wp,
                           const void* mask, void* out, long long e, int d,
                           int k, int h, int bf16, void* stream) {
  if (d < 1 || d > 256 || k < 1 || k > 256) return kBadShape;
  return fwd_dispatch(static_cast<const float*>(xj),
                      static_cast<const float*>(a),
                      static_cast<const float*>(wp),
                      static_cast<const float*>(mask), static_cast<float*>(out),
                      make_geometry(e, d, k, h), bf16 != 0,
                      static_cast<cudaStream_t>(stream));
}

// Words of the backward's split weight (its ws argument) for these
// widths, or -kBadShape for an unsupported one.
long long mdl_fused_bilinear_split_words(int d, int k, int h) {
  if (d < 1 || d > 256 || k < 1 || k > 256 || h < 1) return -kBadShape;
  int wn = 1;
  const int np = 8 * bwd_warpgroups(d, &wn) * wn;
  return (long long)(h + 1) * (round8(k) / 8) * kstep_words(np);
}

// w ((h+1)*d x k) is [W1; b1] (W1 as (h*d x k)), its W1 rows rounded to
// bf16 for the bf16 arm (bf16 != 0); ws holds
// mdl_fused_bilinear_split_words(d, k, h) words, no initial value needed;
// gout (e x k); dxj (e x d) and da (e x h) hold zeros. Launches the weight
// split, then the tiles.
int mdl_fused_bilinear_bwd(const void* xj, const void* a, const void* w,
                           void* ws, const void* mask, const void* gout,
                           void* dxj, void* da, long long e, int d, int k,
                           int h, int bf16, void* stream) {
  if (d < 1 || d > 256 || k < 1 || k > 256 || h < 1) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = make_geometry(e, d, k, h);
  int wn = 1;
  const int ntw = bwd_warpgroups(d, &wn);
  BwdLayout b;
  if (!bwd_layout(g, 8 * ntw * wn, 64 * 2 / wn, wn, &b)) return kBadShape;
  uint32_t* wsp = static_cast<uint32_t*>(ws);
  const int err = launch_split(
      BilinearB{static_cast<const float*>(w), d, k, b.kt},
      (long long)(h + 1) * b.kt, b.np, wsp, s);
  if (err != 0) return err;
  const float* xp = static_cast<const float*>(xj);
  const float* ap = static_cast<const float*>(a);
  const float* mp = static_cast<const float*>(mask);
  const float* gp = static_cast<const float*>(gout);
  float* dxp = static_cast<float*>(dxj);
  float* dap = static_cast<float*>(da);
  const bool arm = bf16 != 0;
  switch (ntw * wn) {
    case 8:
      return launch_bwd<8, 1>(xp, ap, wsp, mp, gp, dxp, dap, g, b, arm, s);
    case 13:
      return launch_bwd<13, 1>(xp, ap, wsp, mp, gp, dxp, dap, g, b, arm, s);
    case 26:
      return launch_bwd<13, 2>(xp, ap, wsp, mp, gp, dxp, dap, g, b, arm, s);
    default:
      return launch_bwd<16, 2>(xp, ap, wsp, mp, gp, dxp, dap, g, b, arm, s);
  }
}

// dw ((h+1)*d x k) = [dW1; db1]. partial holds splits *
// mdl_fused_bilinear_partial_floats(d, k, h) floats and live 1 + ceil(e /
// 32) ints (neither needs an initial value); splits as
// mdl_fused_bilinear_wgrad_splits gives it for the same arm (any splits >=
// 1 is right); bf16 != 0 runs the bf16 arm. Launches the live-chunk list,
// the split kernel, then the fixed-order sum of the splits.
int mdl_fused_bilinear_wgrad(const void* xj, const void* a, const void* mask,
                             const void* gout, void* live, void* partial,
                             void* dw, long long e, int d, int k, int h,
                             int splits, int bf16, void* stream) {
  if (d < 1 || d > 256 || k < 1 || k > 256 || splits < 1) return kBadShape;
  const Geometry g = make_geometry(e, d, k, h);
  const WgradLayout w = wgrad_layout(g);
  if (wgrad_shared_bytes(w) > (size_t)kMaxShared) return kBadShape;
  const float* xp = static_cast<const float*>(xj);
  const float* ap = static_cast<const float*>(a);
  const float* mp = static_cast<const float*>(mask);
  const float* gp = static_cast<const float*>(gout);
  float* pp = static_cast<float*>(partial);
  int* lp = static_cast<int*>(live);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool arm = bf16 != 0;
  live_chunks_kernel<<<1, 1024, 0, s>>>(mp, e, lp);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  switch (w.ntw) {
    case 1:
      err = launch_wgrad<1>(xp, ap, mp, gp, lp, pp, g, w, splits, arm, s);
      break;
    case 2:
      err = launch_wgrad<2>(xp, ap, mp, gp, lp, pp, g, w, splits, arm, s);
      break;
    case 3:
      err = launch_wgrad<3>(xp, ap, mp, gp, lp, pp, g, w, splits, arm, s);
      break;
    case 4:
      err = launch_wgrad<4>(xp, ap, mp, gp, lp, pp, g, w, splits, arm, s);
      break;
    case 5:
      err = launch_wgrad<5>(xp, ap, mp, gp, lp, pp, g, w, splits, arm, s);
      break;
    case 6:
      err = launch_wgrad<6>(xp, ap, mp, gp, lp, pp, g, w, splits, arm, s);
      break;
    case 7:
      err = launch_wgrad<7>(xp, ap, mp, gp, lp, pp, g, w, splits, arm, s);
      break;
    default:
      err = launch_wgrad<8>(xp, ap, mp, gp, lp, pp, g, w, splits, arm, s);
      break;
  }
  if (err != 0) return err;
  return launch_wgrad_reduce(partial, dw, splits, (int)(w.plane / 16), w.cg,
                             w.rows, k, stream);
}

}  // extern "C"
