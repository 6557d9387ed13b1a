// Windowed segment-sum, SpMM and gather kernels for Hopper (sm_90a), with a
// plain C interface for ctypes (bound in matdeeplearn_torch/ops/windowed.py).
//
// mdl_windowed_segment_sum replaces the reference package's
// ops/pallas_segment.py:_seg_sum_kernel and, with weights, its
// :_seg_sum_weighted_kernel (the SpMM of GCN's normalised aggregation);
// mdl_windowed_gather replaces :_gather_kernel. The gather is the sums'
// backward and the sum the gather's (ops/windowed.py).
//
// The layout: nodes in windows of tw rows, edge slots in tiles of te, all
// real slots of tile t in window tile_window[t], each window's tiles
// consecutive with the first flagged in tile_first, pad slots with dst -1.
// A slot counts when its dst is a node below n inside its tile's window
// (node / tw == window); any other slot is skipped, never multiplied by 0,
// so whatever it holds (NaN included) never reaches an output.
//
//   segment_sum: out[v, :] = Σ_{counted e: dst[e] = v} w[e] * msg[e, :]
//                (w null: 1), for every node v < n of a window that has a
//                first tile; the caller zeroes out, so a window that owns
//                no tile stays zero.
//   gather:      out[e, :] = x[dst[e], :] on counted slots, zeros on the
//                rest.
//
// Both are bound by bytes: one read of each input, one write of each output,
// at most one multiply-add per element. The designs:
//
// segment_sum: the Pallas kernel keeps the window's (TW, D) output block in
// VMEM across the window's consecutive tiles, which only a grid that runs
// in order allows. Here one block of 16 warps owns a window (and a block
// of its columns: all D of them up to what its accumulators hold), so no
// atomics touch out and each output row is written once. The design
// follows the parent's phases, timed on the card: its fixed costs and a
// walk of one lane a warp at D 1 and two dependent loads a slot group
// were most of its time. The block:
// * finds its run of tiles (the window's first tile, then up to the next
//   first tile or another window) from one read of the tile flags, all
//   threads at once;
// * lists the run's counted slots, in slot order, in shared memory: the
//   threads read the dst words 16 bytes each, 16 loads in flight, and a
//   block prefix sum places the counted slots of each round of 2,048 that
//   has any. A batch of 32,768 slots with none counted (the tail capacity
//   tiles parked on the last used window can hold a third of a batch's
//   slots) costs two barriers. Up to kCap slots a pass: a longer run takes
//   several passes;
// * walks the list. If its nodes do not decrease (the layout's order),
//   each warp takes a slice of it cut at node boundaries, so each node's
//   slots are summed by one warp alone; else warp k takes the nodes k mod
//   16 and reads the whole list. Up to D 4 and sorted, the lanes take 32
//   slots at once and sum runs of equal dst in a fixed-order segmented
//   scan (5 shuffles); else each lane owns columns (float4 where D % 4 == 0
//   and the pointers are aligned) and loads 16 slots' values at once, every
//   load issued before the first add, runs of equal dst added in a
//   register. Runs are flushed into the block's accumulators (tw x its
//   columns in shared memory, each cell owned by one warp and one lane). At
//   D 100 that walk is held by the rate one SM pulls rows at;
// * writes its window's rows once.
// The order of every addition is fixed by the layout, so two calls give
// the same bits; it is not index_add_'s. Any order of dst inside a window
// is right; the layout's sorted order is the fast one.
//
// gather: one thread per output element, grid-striding, as float4 where
// D % 4 == 0 and both pointers are 16-byte aligned (the wrapper decides),
// scalar otherwise. The x rows are read through L2. Skipped slots get zero
// rows, written explicitly.
//
// The single-pass arm (kSP, the reference's hilo=False): the data operand
// of the reference's one-hot product rounded to bf16, to nearest with ties
// to even, as its MXU pass rounds it, the sums still in f32: the sum adds
// bf16(msg[e, c]), the SpMM bf16(w[e] * msg[e, c]) (the f32 product
// rounded), the gather writes bf16(x[dst[e], c]). Every load, store and
// order of addition is the f32 arm's, so the bound is the f32 arm's.
//
// Shapes the host checks (kBadShape): tw, te and d positive, te dividing e,
// the accumulators of 4 columns (1 where D % 4 != 0) of one window inside
// the shared memory. Tiles whose window lies outside [0, ceil(n / tw)) are
// skipped.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile.cuh"

namespace {

constexpr int kSumThreads = 512;  // threads of a block of the sum
constexpr int kWarps = kSumThreads / 32;
constexpr int kGroup = 16;   // list entries a lane loads at once (columns)
constexpr int kCap = 2048;   // counted slots a pass lists
constexpr int kBatch = 16;   // 4-slot dst loads a thread has in flight
constexpr int kNarrow = 4;   // widths whose lanes take slots, not columns
constexpr int kSpan = 4;     // tiles a thread reads at once for the run

__device__ __forceinline__ bool counted(int node, int win, int n, int tw) {
  const int l = node - win * tw;
  return node >= 0 && node < n && l >= 0 && l < tw;
}

// The exclusive prefix of v over the block's threads in thread order;
// *total gets the block's sum. Two barriers; red holds kWarps ints.
__device__ __forceinline__ int block_prefix(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int r = red[k];
    if (k < warp) before += r;
    sum += r;
  }
  __syncthreads();  // red is free again
  *total = sum;
  return before + x - v;
}

// Lists the counted slots of [pos, e1), in slot order, as ent_slot (offset
// from e0) and ent_node (node - win * tw), until the next round of
// kSumThreads * 4 slots would pass kCap; returns the count and advances pos
// past the listed rounds (both uniform across the block). vec: dst + e0 is
// 16-byte aligned and te % 4 == 0, so every round starts on a quad.
__device__ int list_counted(const int* __restrict__ dst, long long e0,
                            long long& pos, long long e1, int win, int n,
                            int tw, bool vec, int* ent_slot, int* ent_node,
                            int* red) {
  constexpr int R = kSumThreads * 4;
  int m = 0;
  while (pos < e1) {
    int nd[kBatch][4];
    unsigned mine = 0;  // bit b: this thread holds a counted slot in round b
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long s0 = pos + (long long)b * R + 4 * threadIdx.x;
      if (vec && s0 + 4 <= e1) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(dst + s0));
        nd[b][0] = q.x; nd[b][1] = q.y; nd[b][2] = q.z; nd[b][3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) nd[b][j] = s0 + j < e1 ? __ldg(dst + s0 + j) : -1;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (counted(nd[b][j], win, n, tw)) {
          mine |= 1u << b;
        } else {
          nd[b][j] = -1;
        }
      }
    }
    // the rounds with a counted slot anywhere in the block
    mine = __reduce_or_sync(0xffffffffu, mine);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = (int)mine;
    __syncthreads();
    unsigned rounds = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) rounds |= (unsigned)red[k];
    __syncthreads();  // red is free again
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if ((rounds >> b) & 1u) {  // uniform
        int c = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) c += nd[b][j] >= 0;
        int total;
        int at = m + block_prefix(c, red, &total);
        if (m + total > kCap) {
          pos += (long long)b * R;
          return m;
        }
        const long long s0 = pos + (long long)b * R + 4 * threadIdx.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (nd[b][j] >= 0) {
            ent_slot[at] = (int)(s0 + j - e0);
            ent_node[at] = nd[b][j] - win * tw;
            ++at;
          }
        }
        m += total;
      }
    }
    pos += (long long)kBatch * R;
  }
  return m;
}

template <int V> struct Cols;
template <> struct Cols<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static T scale(T v, float s) { return v * s; }
  __device__ static T round(T v) { return round_bf16(v); }
  __device__ static void add(T& a, T v) { a += v; }
  __device__ static void add_to(float* p, T v) { *p += v; }
};
template <> struct Cols<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static T scale(T v, float s) {
    return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
  }
  __device__ static T round(T v) {
    return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                       round_bf16(v.w));
  }
  __device__ static void add(T& a, T v) {
    a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
  }
  __device__ static void add_to(float* p, T v) {
    float4* q = reinterpret_cast<float4*>(p);
    T a = *q;
    add(a, v);
    *q = a;
  }
};

// The walk with lanes over columns: the warp's entries [lo, hi) of the
// list (own >= 0: only those whose node is own mod kWarps), lane l owning
// columns V l, V (l + 32), ... of the block's nc; kGroup entries' values
// loaded at once, runs of equal node added in a register and flushed into
// acc (row stride cw). SP: each (weighted) value rounded to bf16.
template <int V, bool SP>
__device__ void walk_columns(const float* __restrict__ msg,
                             const float* __restrict__ w, long long e0,
                             const int* ent_slot, const int* ent_node, int lo,
                             int hi, int own, int d, int c0, int nc, int cw,
                             float* acc) {
  using C = Cols<V>;
  for (int cc = V * (threadIdx.x & 31); cc < nc; cc += 32 * V) {
    int cur = -1;
    typename C::T a = C::zero();
    for (int g0 = lo; g0 < hi; g0 += kGroup) {
      typename C::T v[kGroup];
      int nd[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        // every load issued, none behind a branch: past hi the last
        // entry's row is read again (a counted slot) and not added
        const int i = g0 + j;
        int node = i < hi ? ent_node[i] : -1;
        if (own >= 0 && node % kWarps != own) node = -1;
        nd[j] = node;
        const long long e = e0 + ent_slot[i < hi ? i : hi - 1];
        v[j] = C::load(msg + e * d + c0 + cc);
        if (w != nullptr) v[j] = C::scale(v[j], __ldg(w + e));
        if (SP) v[j] = C::round(v[j]);
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (nd[j] < 0) continue;
        if (nd[j] != cur) {
          if (cur >= 0) C::add_to(acc + cur * cw + cc, a);
          a = C::zero();
          cur = nd[j];
        }
        C::add(a, v[j]);
      }
    }
    if (cur >= 0) C::add_to(acc + cur * cw + cc, a);
  }
}

// The walk with lanes over slots, for nc <= kNarrow columns and a sorted
// slice [lo, hi) of the list: 32 entries at once, runs of equal node
// summed by a segmented inclusive scan in a fixed order, the last lane of
// each run adding it into acc. SP: each (weighted) value rounded to bf16.
template <bool SP>
__device__ void walk_slots(const float* __restrict__ msg,
                           const float* __restrict__ w, long long e0,
                           const int* ent_slot, const int* ent_node, int lo,
                           int hi, int d, int c0, int nc, int cw,
                           float* acc) {
  const int lane = threadIdx.x & 31;
  for (int g0 = lo; g0 < hi; g0 += 32) {
    const int i = g0 + lane;
    const bool valid = i < hi;
    const int node = valid ? ent_node[i] : -1;
    const long long e = valid ? e0 + ent_slot[i] : 0;
    const float s = valid && w != nullptr ? __ldg(w + e) : 1.f;
    float v[kNarrow];
#pragma unroll
    for (int c = 0; c < kNarrow; ++c) {
      v[c] = valid && c < nc ? __ldg(msg + e * d + c0 + c) * s : 0.f;
      if (SP) v[c] = round_bf16(v[c]);
    }
    const int prev = __shfl_up_sync(0xffffffffu, node, 1);
    const int next = __shfl_down_sync(0xffffffffu, node, 1);
    const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || node != prev);
    const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < kNarrow; ++c) {
        if (c < nc) {  // uniform across the warp
          const float x = __shfl_up_sync(0xffffffffu, v[c], off);
          if (lane - off >= start) v[c] += x;
        }
      }
    }
    if (valid && (lane == 31 || next != node)) {
#pragma unroll
      for (int c = 0; c < kNarrow; ++c) {
        if (c < nc) acc[node * cw + c] += v[c];
      }
    }
    __syncwarp();
  }
}

// Block (window, column block): the window's sums over columns [c0, c0 +
// nc) of out, nc = min(cw, d - c0). Shared memory: the accumulators (tw x
// cw), then the list (kCap slots, kCap nodes).
template <int V, bool SP>
__global__ void __launch_bounds__(kSumThreads, 1)
windowed_sum_kernel(const float* __restrict__ msg, const float* __restrict__ w,
                    const int* __restrict__ dst,
                    const int* __restrict__ tile_window,
                    const int* __restrict__ tile_first,
                    float* __restrict__ out, int d, int n, int tw, int te,
                    int tiles, int cw, bool vec_dst) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  int* ent_slot = reinterpret_cast<int*>(acc + tw * cw);
  int* ent_node = ent_slot + kCap;
  __shared__ int span_s[2];  // the run's first tile and its end
  __shared__ int red_s[kWarps];
  __shared__ int cut_s[kWarps + 1];
  const int win = blockIdx.x;
  const int c0 = blockIdx.y * cw;
  const int nc = min(cw, d - c0);
  const int warp = threadIdx.x >> 5;

  // the run: the window's first tile t, up to the next first tile or
  // another window after it. Each pass reads kSpan tiles a thread (both
  // flags, all loads in flight) and finds both ends from them, t first.
  if (threadIdx.x == 0) span_s[0] = span_s[1] = tiles;
  for (int u0 = 0; u0 < tiles; u0 += kSpan * kSumThreads) {
    int first[kSpan], wid[kSpan];
#pragma unroll
    for (int k = 0; k < kSpan; ++k) {
      const int u = u0 + k * kSumThreads + threadIdx.x;
      first[k] = u < tiles ? __ldg(tile_first + u) : 1;
      wid[k] = u < tiles ? __ldg(tile_window + u) : -1;
    }
    __syncthreads();  // span_s holds the earlier passes' ends
#pragma unroll
    for (int k = 0; k < kSpan; ++k) {
      if (first[k] == 1 && wid[k] == win) {
        atomicMin(&span_s[0], u0 + k * kSumThreads + threadIdx.x);
      }
    }
    __syncthreads();
    const int t = span_s[0];
#pragma unroll
    for (int k = 0; k < kSpan; ++k) {
      const int u = u0 + k * kSumThreads + threadIdx.x;
      if (u > t && u <= tiles && (first[k] != 0 || wid[k] != win)) {
        atomicMin(&span_s[1], u);
      }
    }
    __syncthreads();
    if (span_s[1] < tiles || (t < tiles && u0 + kSpan * kSumThreads >= tiles)) {
      break;  // uniform: the end is found, or no tile is left to read
    }
  }
  const int t = span_s[0];
  if (t == tiles) return;  // no tile: the caller's zeros stand
  for (int i = threadIdx.x; i < tw * cw; i += kSumThreads) acc[i] = 0.f;
  __syncthreads();
  const long long e0 = (long long)t * te;
  const long long e1 = (long long)span_s[1] * te;

  long long pos = e0;
  while (pos < e1) {  // a pass: list, then walk
    const int m = list_counted(dst, e0, pos, e1, win, n, tw, vec_dst,
                               ent_slot, ent_node, red_s);
    __syncthreads();  // the list is complete
    if (m > 0) {
      bool down = false;
      for (int i = threadIdx.x + 1; i < m; i += kSumThreads) {
        down |= ent_node[i] < ent_node[i - 1];
      }
      const bool sorted = !__syncthreads_or(down);
      if (sorted && threadIdx.x <= kWarps) {
        // warp k's slice starts at the first node boundary at or after
        // k m / kWarps
        int b = (int)((long long)m * threadIdx.x / kWarps);
        while (b > 0 && b < m && ent_node[b] == ent_node[b - 1]) ++b;
        cut_s[threadIdx.x] = b;
      }
      __syncthreads();
      const int lo = sorted ? cut_s[warp] : 0;
      const int hi = sorted ? cut_s[warp + 1] : m;
      if (sorted && nc <= kNarrow) {
        walk_slots<SP>(msg, w, e0, ent_slot, ent_node, lo, hi, d, c0, nc, cw,
                       acc);
      } else {
        walk_columns<V, SP>(msg, w, e0, ent_slot, ent_node, lo, hi,
                        sorted ? -1 : warp, d, c0, nc, cw, acc);
      }
    }
    __syncthreads();  // every warp is done with the list and its flushes
  }

  const int base = win * tw;
  const int rows = min(tw, n - base);
  const int q = nc / V;  // column vectors of a row
  for (int i = threadIdx.x; i < rows * q; i += kSumThreads) {
    const int r = i / q;
    const int c = V * (i - r * q);
    const float* from = acc + r * cw + c;
    float* to = out + (long long)(base + r) * d + c0 + c;
    if (V == 4) {
      *reinterpret_cast<float4*>(to) = *reinterpret_cast<const float4*>(from);
    } else {
      *to = *from;
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int V, bool SP>
int launch_sum(const float* msg, const float* w, const int* dst,
               const int* tile_window, const int* tile_first, float* out,
               int e, int d, int n, int tw, int te, cudaStream_t s) {
  // columns a block's accumulators hold beside the list: all of D, or
  // column blocks of cw
  const long long list = 2LL * kCap * sizeof(int);
  const long long fixed = 256;  // the kernel's static shared memory, rounded up
  long long room = ((long long)kMaxShared - list - fixed) / (4LL * tw);
  room -= room % V;
  if (room < V) return kBadShape;
  const int blocks_y = (int)((d + room - 1) / room);
  int cw = (d + blocks_y - 1) / blocks_y;
  cw = (cw + V - 1) / V * V;
  const size_t smem = (size_t)tw * cw * sizeof(float) + list;
  cudaError_t err = cudaFuncSetAttribute(
      windowed_sum_kernel<V, SP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + tw - 1) / tw), (unsigned)blocks_y);
  windowed_sum_kernel<V, SP><<<grid, kSumThreads, smem, s>>>(
      msg, w, dst, tile_window, tile_first, out, d, n, tw, te, e / te, cw,
      te % 4 == 0 && aligned16(dst));
  return (int)cudaGetLastError();
}

template <bool SP>
__global__ void __launch_bounds__(kThreads)
windowed_gather_kernel_f4(const float4* __restrict__ x,
                          const int* __restrict__ dst,
                          const int* __restrict__ tile_window,
                          float4* __restrict__ out,
                          long long e, int d4, int n, int tw, int te) {
  const long long total = e * d4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long edge = i / d4;
    const int q = (int)(i - edge * d4);
    const int node = __ldg(dst + edge);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (counted(node, __ldg(tile_window + edge / te), n, tw)) {
      v = __ldg(x + (long long)node * d4 + q);
      if (SP) {
        v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                        round_bf16(v.w));
      }
    }
    out[i] = v;
  }
}

template <bool SP>
__global__ void __launch_bounds__(kThreads)
windowed_gather_kernel_f1(const float* __restrict__ x,
                          const int* __restrict__ dst,
                          const int* __restrict__ tile_window,
                          float* __restrict__ out,
                          long long e, int d, int n, int tw, int te) {
  const long long total = e * d;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long edge = i / d;
    const int c = (int)(i - edge * d);
    const int node = __ldg(dst + edge);
    float v = 0.f;
    if (counted(node, __ldg(tile_window + edge / te), n, tw)) {
      v = __ldg(x + (long long)node * d + c);
      if (SP) v = round_bf16(v);
    }
    out[i] = v;
  }
}

unsigned gather_blocks(long long total) {
  // Enough blocks to fill the card several times over; the kernels
  // grid-stride over the rest.
  const long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;
  return (unsigned)(blocks < cap ? blocks : cap);
}

template <bool SP>
int launch_sum_arm(const float* msg, const float* w, const int* dst,
                   const int* tile_window, const int* tile_first, float* out,
                   int e, int d, int n, int tw, int te, cudaStream_t s) {
  if (d % 4 == 0 && aligned16(msg) && aligned16(out)) {
    return launch_sum<4, SP>(msg, w, dst, tile_window, tile_first, out, e, d,
                             n, tw, te, s);
  }
  return launch_sum<1, SP>(msg, w, dst, tile_window, tile_first, out, e, d, n,
                           tw, te, s);
}

template <bool SP>
void launch_gather(const void* x, const void* dst, const void* tile_window,
                   void* out, int e, int d, int n, int tw, int te, int vec4,
                   cudaStream_t s) {
  if (vec4) {
    const int d4 = d / 4;
    windowed_gather_kernel_f4<SP><<<gather_blocks((long long)e * d4),
                                    kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const int*>(dst),
        static_cast<const int*>(tile_window), static_cast<float4*>(out), e, d4,
        n, tw, te);
  } else {
    windowed_gather_kernel_f1<SP><<<gather_blocks((long long)e * d), kThreads,
                                    0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(dst),
        static_cast<const int*>(tile_window), static_cast<float*>(out), e, d,
        n, tw, te);
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers on the current device; w may be null
// (every weight 1). out must hold n*d zeros. single_pass != 0 runs the
// single-pass arm. Returns 0 or a cudaError_t (kBadShape for a shape the
// kernel does not take).
int mdl_windowed_segment_sum(const void* msg, const void* w, const void* dst,
                             const void* tile_window, const void* tile_first,
                             void* out, int e, int d, int n, int tw, int te,
                             int single_pass, void* stream) {
  if (tw <= 0 || te <= 0 || d <= 0 || n <= 0 || e <= 0 || e % te != 0) {
    return kBadShape;
  }
  const float* mp = static_cast<const float*>(msg);
  const float* wp = static_cast<const float*>(w);
  const int* dp = static_cast<const int*>(dst);
  const int* twp = static_cast<const int*>(tile_window);
  const int* tfp = static_cast<const int*>(tile_first);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (single_pass) {
    return launch_sum_arm<true>(mp, wp, dp, twp, tfp, op, e, d, n, tw, te, s);
  }
  return launch_sum_arm<false>(mp, wp, dp, twp, tfp, op, e, d, n, tw, te, s);
}

// vec4 != 0 selects the float4 kernel: the caller guarantees d % 4 == 0 and
// 16-byte aligned x and out. Every element of out is written.
// single_pass != 0 runs the single-pass arm.
int mdl_windowed_gather(const void* x, const void* dst,
                        const void* tile_window, void* out, int e, int d,
                        int n, int tw, int te, int vec4, int single_pass,
                        void* stream) {
  if (tw <= 0 || te <= 0 || d <= 0 || e <= 0 || e % te != 0) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (single_pass) {
    launch_gather<true>(x, dst, tile_window, out, e, d, n, tw, te, vec4, s);
  } else {
    launch_gather<false>(x, dst, tile_window, out, e, d, n, tw, te, vec4, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
