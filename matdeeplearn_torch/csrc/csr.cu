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
// each change of dst (and at the chunk's end) flushes with one atomicAdd
// per column. On a dst-sorted edge list that is about one atomic per
// node-column plus one per chunk boundary. Any other order stays correct
// and only costs more atomics: there is no sortedness certificate and no
// second code path. Message rows are read with the lanes on consecutive
// columns, so each row read is coalesced. Accumulation is f32; atomics
// make the order of the additions vary from run to run.
//
// gather: one thread per output element, as float4 where D % 4 == 0 and
// both pointers are 16-byte aligned (the wrapper decides), scalar
// otherwise. Pad edges (mask 0) write zeros without reading x.
//
// Edges whose dst lies outside [0, n) add nothing and gather a zero row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEdgesPerWarp = 32;

template <int C>
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

  for (long long i = begin; i < end; ++i) {
    // Every lane reads the same dst and mask word: one broadcast load, and
    // the branches below are uniform across the warp.
    const float w = mask != nullptr ? __ldg(mask + i) : 1.f;
    const int node = __ldg(dst + i);
    if (w == 0.f || node < 0 || node >= n) continue;
    if (node != cur) {
      if (cur >= 0) {
        float* row = out + (long long)cur * d;
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const int c = col0 + 32 * k;
          if (c < d) atomicAdd(row + c, acc[k]);
          acc[k] = 0.f;
        }
      }
      cur = node;
    }
    const float* src = msg + i * d;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = col0 + 32 * k;
      if (c < d) acc[k] += w * __ldg(src + c);
    }
  }
  if (cur >= 0) {
    float* row = out + (long long)cur * d;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = col0 + 32 * k;
      if (c < d) atomicAdd(row + c, acc[k]);
    }
  }
}

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
      const float4 s = __ldg(x + (long long)node * d4 + q);
      v = make_float4(w * s.x, w * s.y, w * s.z, w * s.w);
    }
    out[i] = v;
  }
}

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
      v = w * __ldg(x + (long long)node * d + c);
    }
    out[i] = v;
  }
}

template <int C>
void launch_segment_sum(const float* msg, const int* dst, const float* mask,
                        float* out, int e, int d, int n, cudaStream_t stream) {
  const long long warps = ((long long)e + kEdgesPerWarp - 1) / kEdgesPerWarp;
  const int warps_per_block = kThreads / 32;
  const dim3 grid((unsigned)((warps + warps_per_block - 1) / warps_per_block),
                  (unsigned)((d + 32 * C - 1) / (32 * C)));
  csr_segment_sum_kernel<C><<<grid, kThreads, 0, stream>>>(
      msg, dst, mask, out, e, d, n);
}

unsigned gather_blocks(long long total) {
  // Enough blocks to fill the card several times over; the kernels
  // grid-stride over the rest.
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;
  return (unsigned)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

// All pointers are device pointers on the current device; mask may be
// null (every edge real). out must hold n*d zeros. Returns the launch's
// cudaError_t (0 on success). The caller launches nothing when e or d is 0.
int mdl_csr_segment_sum(const void* msg, const void* dst, const void* mask,
                        void* out, int e, int d, int n, void* stream) {
  const float* m = static_cast<const float*>(msg);
  const int* ds = static_cast<const int*>(dst);
  const float* mk = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) {
    launch_segment_sum<1>(m, ds, mk, o, e, d, n, s);
  } else if (d <= 64) {
    launch_segment_sum<2>(m, ds, mk, o, e, d, n, s);
  } else if (d <= 128) {
    launch_segment_sum<4>(m, ds, mk, o, e, d, n, s);
  } else {
    launch_segment_sum<8>(m, ds, mk, o, e, d, n, s);
  }
  return (int)cudaGetLastError();
}

// vec4 != 0 selects the float4 kernel: the caller guarantees d % 4 == 0 and
// 16-byte aligned x and out.
int mdl_csr_gather(const void* x, const void* dst, const void* mask,
                   void* out, int e, int d, int n, int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    const int d4 = d / 4;
    csr_gather_kernel_f4<<<gather_blocks((long long)e * d4), kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const int*>(dst),
        static_cast<const float*>(mask), static_cast<float4*>(out), e, d4, n);
  } else {
    csr_gather_kernel_f1<<<gather_blocks((long long)e * d), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(dst),
        static_cast<const float*>(mask), static_cast<float*>(out), e, d, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
