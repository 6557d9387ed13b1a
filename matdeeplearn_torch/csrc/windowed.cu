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
// in order allows. Here a loop inside the block takes the place of that
// grid dimension. Block (t, y) exists for every tile t and 32-column chunk
// y; the blocks whose tile is not a first tile return at once. The block of
// a first tile walks that tile and the following ones up to the next first
// tile (or another window), so it owns its window alone: no atomics, and
// each output row is written once. The block first finds, with all its
// threads at once, where its window's tiles end and its last counted slot:
// the pad slots after it (the tail capacity tiles parked on the last used
// window can hold a third of a batch's slots) are read once, in parallel,
// and never walked. Then warp k takes the
// groups k, k + W, ... of 16 consecutive slots; lane l owns column
// 32y + l. A lane loads the group's 16 values first (16 loads in flight),
// then adds runs of equal dst in a register and flushes each run into its
// warp's own accumulator in shared memory (tw x 32 floats a warp, no bank
// conflicts, no atomics). At the end each thread sums the W accumulators of
// its (row, column) in warp order and writes the row. The order of every
// addition is fixed, so two calls give the same bits; it is not
// index_add_'s order. Any order of dst inside a window is right; a sorted
// one (the layout's) makes runs long. W = 8 warps while the accumulators fit
// in shared memory (tw = 64: 64 KB), fewer for larger windows (tw = 512: 3).
// At D = 1 (GCN's degree) one lane of each warp works.
//
// gather: one thread per output element, grid-striding, as float4 where
// D % 4 == 0 and both pointers are 16-byte aligned (the wrapper decides),
// scalar otherwise. The x rows are read through L2. Skipped slots get zero
// rows, written explicitly.
//
// Shapes the host checks (kBadShape): tw, te and d positive, te dividing e,
// the accumulators of one warp inside the shared memory. The kernels skip a
// tile whose window lies outside [0, ceil(n / tw)).

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile.cuh"

namespace {

constexpr int kGroup = 16;     // consecutive slots a warp loads at once
constexpr int kMaxWarps = 8;

__device__ __forceinline__ bool counted(int node, int win, int n, int tw) {
  const int l = node - win * tw;
  return node >= 0 && node < n && l >= 0 && l < tw;
}

__global__ void windowed_sum_kernel(const float* __restrict__ msg,
                                    const float* __restrict__ w,
                                    const int* __restrict__ dst,
                                    const int* __restrict__ tile_window,
                                    const int* __restrict__ tile_first,
                                    float* __restrict__ out,
                                    int d, int n, int tw, int te, int tiles) {
  extern __shared__ float acc[];  // [warps][tw][32]
  __shared__ int t_end_s;
  __shared__ long long e_end_s;
  const int t = blockIdx.x;
  if (tile_first[t] != 1) return;
  const int win = tile_window[t];
  const int nw = (n + tw - 1) / tw;
  if (win < 0 || win >= nw) return;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slab = tw * 32;
  const long long e0 = (long long)t * te;
  if (threadIdx.x == 0) {
    t_end_s = tiles;
    e_end_s = e0;
  }
  for (int i = threadIdx.x; i < warps * slab; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  // The window's tiles end at the next first tile or the next window: all
  // threads test consecutive tiles at once (the tail capacity tiles parked
  // on the last used window can number hundreds).
  for (int u0 = t + 1; u0 < tiles; u0 += blockDim.x) {
    const int u = u0 + threadIdx.x;
    const bool stop = u < tiles && (tile_first[u] != 0 || tile_window[u] != win);
    if (stop) atomicMin(&t_end_s, u);
    if (__syncthreads_or(stop)) break;
  }
  __syncthreads();
  // The walk ends after the last counted slot: pad slots past it (the
  // window's padding, the tail capacity tiles) are not visited. All threads
  // scan the dst words, 8 loads each in flight.
  const long long e_span = (long long)t_end_s * te;
  long long last = -1;
  for (long long i0 = e0 + threadIdx.x; i0 < e_span; i0 += 8LL * blockDim.x) {
    int node[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long i = i0 + (long long)k * blockDim.x;
      node[k] = i < e_span ? __ldg(dst + i) : -1;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (counted(node[k], win, n, tw)) last = i0 + (long long)k * blockDim.x;
    }
  }
  if (last >= 0) atomicMax(&e_end_s, last + 1);
  __syncthreads();

  const int base = win * tw;
  const int c = blockIdx.y * 32 + lane;
  const bool col_ok = c < d;
  float* mine = acc + warp * slab;
  const long long e1 = e_end_s;
  for (long long g0 = e0 + (long long)warp * kGroup; g0 < e1;
       g0 += (long long)warps * kGroup) {
    float v[kGroup];
    int loc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const long long i = g0 + j;
      int l = -1;
      if (i < e1) {
        // every lane reads the same dst word: one broadcast load, and the
        // branches below are uniform across the warp
        const int node = __ldg(dst + i);
        l = counted(node, win, n, tw) ? node - base : -1;
      }
      float val = 0.f;
      if (l >= 0 && col_ok) {
        val = __ldg(msg + i * d + c);
        if (w != nullptr) val *= __ldg(w + i);
      }
      loc[j] = l;
      v[j] = val;
    }
    int cur = -1;
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (loc[j] < 0) continue;
      if (loc[j] != cur) {
        if (cur >= 0) mine[cur * 32 + lane] += a;
        a = 0.f;
        cur = loc[j];
      }
      a += v[j];
    }
    if (cur >= 0) mine[cur * 32 + lane] += a;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < slab; i += blockDim.x) {
    const int node = base + (i >> 5);
    const int col = blockIdx.y * 32 + (i & 31);
    if (col >= d || node >= n) continue;
    float s = 0.f;
    for (int k = 0; k < warps; ++k) s += acc[k * slab + i];
    out[(long long)node * d + col] = s;
  }
}

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
    }
    out[i] = v;
  }
}

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

}  // namespace

extern "C" {

// All pointers are device pointers on the current device; w may be null
// (every weight 1). out must hold n*d zeros. Returns 0 or a cudaError_t
// (kBadShape for a shape the kernel does not take).
int mdl_windowed_segment_sum(const void* msg, const void* w, const void* dst,
                             const void* tile_window, const void* tile_first,
                             void* out, int e, int d, int n, int tw, int te,
                             void* stream) {
  if (tw <= 0 || te <= 0 || d <= 0 || n <= 0 || e <= 0 || e % te != 0) {
    return kBadShape;
  }
  const size_t slab_bytes = (size_t)tw * 32 * sizeof(float);
  int warps = (int)((size_t)kMaxShared / slab_bytes);
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (warps < 1) return kBadShape;
  const size_t smem = warps * slab_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      windowed_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = e / te;
  const dim3 grid((unsigned)tiles, (unsigned)((d + 31) / 32));
  windowed_sum_kernel<<<grid, warps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(msg), static_cast<const float*>(w),
      static_cast<const int*>(dst), static_cast<const int*>(tile_window),
      static_cast<const int*>(tile_first), static_cast<float*>(out), d, n, tw,
      te, tiles);
  return (int)cudaGetLastError();
}

// vec4 != 0 selects the float4 kernel: the caller guarantees d % 4 == 0 and
// 16-byte aligned x and out. Every element of out is written.
int mdl_windowed_gather(const void* x, const void* dst,
                        const void* tile_window, void* out, int e, int d,
                        int n, int tw, int te, int vec4, void* stream) {
  if (tw <= 0 || te <= 0 || d <= 0 || e <= 0 || e % te != 0) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    const int d4 = d / 4;
    windowed_gather_kernel_f4<<<gather_blocks((long long)e * d4), kThreads, 0,
                                s>>>(
        static_cast<const float4*>(x), static_cast<const int*>(dst),
        static_cast<const int*>(tile_window), static_cast<float4*>(out), e, d4,
        n, tw, te);
  } else {
    windowed_gather_kernel_f1<<<gather_blocks((long long)e * d), kThreads, 0,
                                s>>>(
        static_cast<const float*>(x), static_cast<const int*>(dst),
        static_cast<const int*>(tile_window), static_cast<float*>(out), e, d,
        n, tw, te);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
