// CSR segment-sum and gather kernels for Hopper (sm_90a), with a plain C
// interface for ctypes (bound in matdeeplearn_torch/ops/csr.py).
//
// mdl_csr_segment_sum replaces the reference package's
// ops/pallas_csr.py:_csr_sum_kernel, and mdl_csr_gather replaces
// ops/pallas_csr.py:_csr_gather_kernel. Each is the other's backward.
//
//   segment_sum: out[n, :] += mask[e] * msg[e, :] for every edge e with
//                dst[e] == n and mask[e] != 0 (out zeroed by the caller).
//   gather:      out[e, :] = mask[e] * x[dst[e], :] where mask[e] != 0,
//                a zero row otherwise.
//
// Both are bound by bytes: each moves every input and output element once
// and does at most one multiply-add per element. The designs:
//
// segment_sum: one warp walks a contiguous chunk of EDGES_PER_WARP edges;
// lane l owns columns l, l+32, ... of one 32*C column block (blockIdx.y).
// The warp adds runs of equal dst in registers, skips masked edges, and at
// each change of dst flushes with one atomicAdd per column. A run is a
// maximal sequence of real edges, each with the dst of the edge before it;
// the warp in whose chunk a run starts owns it: it skips the run that
// reaches into its chunk from before, and sums its own last run on past
// its chunk's end, 32 edges at a time (the lanes find with one ballot how
// far the run goes). So on a sorted edge list each row is summed in edge
// order by one warp and flushed by one atomicAdd onto the zeroed output:
// the result is the same bits every run, whatever the run's length (a
// graph's row, in the sum into B graph rows, takes hundreds of edges). Any
// other order stays correct and only costs more atomics, whose order then
// varies: there is no sortedness certificate and no second code path.
// Message rows are read with the lanes on consecutive columns, so each
// row read is coalesced. Accumulation is f32.
//
// gather: one thread per output element, as float4 where D % 4 == 0 and
// both pointers are 16-byte aligned (the wrapper decides), scalar
// otherwise. Pad edges (mask 0) write zeros without reading x.
//
// Edges whose dst lies outside [0, n) add nothing and gather a zero row.
//
// The single-pass arm (kSP, the reference's hilo=False): the data operand
// rounded to bf16, to nearest with ties to even, as that package's MXU
// pass rounds it: the sum adds bf16(mask[e] * msg[e, c]) in f32, the
// gather writes mask[e] * bf16(x[dst[e], c]). Everything else is the f32
// arm's, so its bound is the f32 arm's: the same bytes move.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// v rounded to bf16, to nearest with ties to even (cvt.rn.bf16.f32), as
// the reference's astype(jnp.bfloat16) and torch's .to(torch.bfloat16)
// round; back in f32, where it is exact.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The term edge weight w adds for value v in arm SP.
template <bool SP>
__device__ __forceinline__ float term(float w, float v) {
  return SP ? round_bf16(w * v) : w * v;
}

constexpr int kThreads = 256;
constexpr int kEdgesPerWarp = 32;

// Edge i (> 0) continues the run of edge i - 1: both are real and have the
// same dst.
__device__ __forceinline__ bool continues(const int* __restrict__ dst,
                                          const float* __restrict__ mask,
                                          long long i) {
  if (mask != nullptr && (__ldg(mask + i) == 0.f || __ldg(mask + i - 1) == 0.f))
    return false;
  return __ldg(dst + i) == __ldg(dst + i - 1);
}

template <int C, bool SP>
__device__ __forceinline__ void add_row(float (&acc)[C],
                                        const float* __restrict__ src,
                                        float w, int col0, int d) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = col0 + 32 * k;
    if (c < d) acc[k] += term<SP>(w, __ldg(src + c));
  }
}

template <int C>
__device__ __forceinline__ void flush(float (&acc)[C], float* __restrict__ row,
                                      int col0, int d) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = col0 + 32 * k;
    if (c < d) atomicAdd(row + c, acc[k]);
    acc[k] = 0.f;
  }
}

template <int C, bool SP>
__global__ void __launch_bounds__(kThreads)
csr_segment_sum_kernel(const float* __restrict__ msg,
                       const int* __restrict__ dst,
                       const float* __restrict__ mask,
                       float* __restrict__ out,
                       int e, int d, int n) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long begin = warp * kEdgesPerWarp;
  if (begin >= e) return;
  const long long end =
      begin + kEdgesPerWarp < (long long)e ? begin + kEdgesPerWarp : e;
  const int col0 = blockIdx.y * 32 * C + lane;

  float acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = 0.f;
  int cur = -1;

  // Skip the run that reaches into the chunk from before: lane l tests
  // edge begin + l, and the first edge that does not continue its
  // predecessor starts this warp's work (none: the whole chunk is skipped).
  const long long t = begin + lane;
  const unsigned stops = __ballot_sync(
      0xffffffffu, !(t > 0 && t < end && continues(dst, mask, t)));
  long long i = stops ? begin + (__ffs(stops) - 1) : end;

  for (; i < end; ++i) {
    // Every lane reads the same dst and mask word: one broadcast load, and
    // the branches below are uniform across the warp.
    const float w = mask != nullptr ? __ldg(mask + i) : 1.f;
    const int node = __ldg(dst + i);
    if (w == 0.f || node < 0 || node >= n) continue;
    if (node != cur) {
      if (cur >= 0) flush(acc, out + (long long)cur * d, col0, d);
      cur = node;
    }
    add_row<C, SP>(acc, msg + i * d, w, col0, d);
  }
  // The last run goes on past the chunk for as long as its edges continue:
  // 32 edges a step, the ballot giving how many of them do, each lane
  // holding one edge's mask, their rows read 8 at a time before the adds
  // (in edge order) so that the loads overlap.
  bool open = cur >= 0 && end < e && __ldg(dst + end - 1) == cur;
  while (open) {
    const long long j = i + lane;
    const bool cont = j < e && continues(dst, mask, j);
    const float wl = j < e && mask != nullptr ? __ldg(mask + j) : 1.f;
    const unsigned brk = __ballot_sync(0xffffffffu, !cont);
    const int m = brk ? __ffs(brk) - 1 : 32;
    int q = 0;
    for (; q + 8 <= m; q += 8) {
      float v[8][C];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* src = msg + (i + q + u) * d;
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const int c = col0 + 32 * k;
          v[u][k] = c < d ? __ldg(src + c) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float w = __shfl_sync(0xffffffffu, wl, q + u);
#pragma unroll
        for (int k = 0; k < C; ++k) acc[k] += term<SP>(w, v[u][k]);
      }
    }
    for (; q < m; ++q) {
      add_row<C, SP>(acc, msg + (i + q) * d, __shfl_sync(0xffffffffu, wl, q), col0,
              d);
    }
    i += m;
    open = m == 32;
  }
  if (cur >= 0) flush(acc, out + (long long)cur * d, col0, d);
}

template <bool SP>
__global__ void __launch_bounds__(kThreads)
csr_gather_kernel_f4(const float4* __restrict__ x,
                     const int* __restrict__ dst,
                     const float* __restrict__ mask,
                     float4* __restrict__ out,
                     int e, int d4, int n) {
  const long long total = (long long)e * d4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long edge = i / d4;
    const int q = (int)(i - edge * d4);
    const float w = mask != nullptr ? __ldg(mask + edge) : 1.f;
    const int node = __ldg(dst + edge);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (w != 0.f && node >= 0 && node < n) {
      float4 s = __ldg(x + (long long)node * d4 + q);
      if (SP) {
        s = make_float4(round_bf16(s.x), round_bf16(s.y), round_bf16(s.z),
                        round_bf16(s.w));
      }
      v = make_float4(w * s.x, w * s.y, w * s.z, w * s.w);
    }
    out[i] = v;
  }
}

template <bool SP>
__global__ void __launch_bounds__(kThreads)
csr_gather_kernel_f1(const float* __restrict__ x,
                     const int* __restrict__ dst,
                     const float* __restrict__ mask,
                     float* __restrict__ out,
                     int e, int d, int n) {
  const long long total = (long long)e * d;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long edge = i / d;
    const int c = (int)(i - edge * d);
    const float w = mask != nullptr ? __ldg(mask + edge) : 1.f;
    const int node = __ldg(dst + edge);
    float v = 0.f;
    if (w != 0.f && node >= 0 && node < n) {
      const float s = __ldg(x + (long long)node * d + c);
      v = w * (SP ? round_bf16(s) : s);
    }
    out[i] = v;
  }
}

template <int C, bool SP>
void launch_sum_arm(const float* msg, const int* dst, const float* mask,
                        float* out, int e, int d, int n, cudaStream_t stream) {
  const long long warps = ((long long)e + kEdgesPerWarp - 1) / kEdgesPerWarp;
  const int warps_per_block = kThreads / 32;
  const dim3 grid((unsigned)((warps + warps_per_block - 1) / warps_per_block),
                  (unsigned)((d + 32 * C - 1) / (32 * C)));
  csr_segment_sum_kernel<C, SP><<<grid, kThreads, 0, stream>>>(
      msg, dst, mask, out, e, d, n);
}

template <int C>
void launch_segment_sum(const float* msg, const int* dst, const float* mask,
                        float* out, int e, int d, int n, bool sp,
                        cudaStream_t stream) {
  if (sp) {
    launch_sum_arm<C, true>(msg, dst, mask, out, e, d, n, stream);
  } else {
    launch_sum_arm<C, false>(msg, dst, mask, out, e, d, n, stream);
  }
}

unsigned gather_blocks(long long total) {
  // Enough blocks to fill the card several times over; the kernels
  // grid-stride over the rest.
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;
  return (unsigned)(blocks < cap ? blocks : cap);
}

template <bool SP>
void launch_gather(const void* x, const void* dst, const void* mask,
                   void* out, int e, int d, int n, int vec4,
                   cudaStream_t s) {
  if (vec4) {
    const int d4 = d / 4;
    csr_gather_kernel_f4<SP><<<gather_blocks((long long)e * d4), kThreads, 0,
                               s>>>(
        static_cast<const float4*>(x), static_cast<const int*>(dst),
        static_cast<const float*>(mask), static_cast<float4*>(out), e, d4, n);
  } else {
    csr_gather_kernel_f1<SP><<<gather_blocks((long long)e * d), kThreads, 0,
                               s>>>(
        static_cast<const float*>(x), static_cast<const int*>(dst),
        static_cast<const float*>(mask), static_cast<float*>(out), e, d, n);
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers on the current device; mask may be
// null (every edge real). out must hold n*d zeros. single_pass != 0 runs
// the single-pass arm. Returns the launch's cudaError_t (0 on success).
// The caller launches nothing when e or d is 0.
int mdl_csr_segment_sum(const void* msg, const void* dst, const void* mask,
                        void* out, int e, int d, int n, int single_pass,
                        void* stream) {
  const float* m = static_cast<const float*>(msg);
  const int* ds = static_cast<const int*>(dst);
  const float* mk = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  const bool sp = single_pass != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) {
    launch_segment_sum<1>(m, ds, mk, o, e, d, n, sp, s);
  } else if (d <= 64) {
    launch_segment_sum<2>(m, ds, mk, o, e, d, n, sp, s);
  } else if (d <= 128) {
    launch_segment_sum<4>(m, ds, mk, o, e, d, n, sp, s);
  } else {
    launch_segment_sum<8>(m, ds, mk, o, e, d, n, sp, s);
  }
  return (int)cudaGetLastError();
}

// vec4 != 0 selects the float4 kernel: the caller guarantees d % 4 == 0 and
// 16-byte aligned x and out. single_pass != 0 runs the single-pass arm.
int mdl_csr_gather(const void* x, const void* dst, const void* mask,
                   void* out, int e, int d, int n, int vec4, int single_pass,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (single_pass) {
    launch_gather<true>(x, dst, mask, out, e, d, n, vec4, s);
  } else {
    launch_gather<false>(x, dst, mask, out, e, d, n, vec4, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
