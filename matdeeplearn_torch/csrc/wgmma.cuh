// The TF32 wgmma primitives of the 3xTF32 kernels (fused_bilinear.cu,
// fused_cgconv.cu, fused_cfconv.cu): the warpgroup product with A from
// registers and B from shared memory by descriptor, its fences, the
// descriptor of a K-major B operand without swizzle, and the kernel that
// splits a weight once a call into TF32 hi and lo in the byte order those
// descriptors read; and the bf16 product, the mbarrier and the bulk copy
// of the bf16 kernels (fused_bilinear_bf16.cu). sm_90a only. Each .cu file builds into its own
// library, so the anonymous namespace gives every library its own copy.
//
// A kernel streams the split weight through shared memory a stage of
// k-steps at a time (16-byte cp.async, one contiguous range of words) and
// issues, for each k-step, three wgmma into one accumulator: lo·hi, hi·lo,
// hi·hi (3xTF32, f32 accuracy; edge_tile.cuh says why).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile.cuh"

namespace {

// wgmma in TF32: d (a warpgroup's 64 rows x 8 NTW columns, f32; lane (g, t)
// of warp w holds d[j] = {D[16w+g][8j+2t], D[16w+g][8j+2t+1],
// D[16w+g+8][8j+2t], D[16w+g+8][8j+2t+1]}, mma.sync's m16n8 layout) +=
// A · B over k = 8, with A from registers (m16n8k8's A fragment of the
// warp's 16 rows: {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}) and B (8 NTW
// x 8, K-major) from shared memory by descriptor; scale_d = 0 drops the old
// d. The instruction only issues: wgmma_wait retires it. Instantiated for
// NTW 4, 8, 13, 16, 19, 25 and 32.
template <int NTW> struct WgmmaTf32;

// The n8-tiles a warpgroup of the edge-tile kernels (fused_cgconv.cu,
// fused_cfconv.cu) spans for nt needed: the smallest of 4, 13, 19, 25 and
// 32 that is >= nt, or 0 past 32. (The bilinear backward picks 8, 13 or 16
// itself.)
__host__ __device__ inline int ntw_bucket(int nt) {
  if (nt <= 4) return 4;
  if (nt <= 13) return 13;
  if (nt <= 19) return 19;
  if (nt <= 25) return 25;
  if (nt <= 32) return 32;
  return 0;
}

#define MDL_F4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

template <> struct WgmmaTf32<4> {
  __device__ static void mma(float (&d)[4][4], const uint32_t (&a)[4],
                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : MDL_F4(0), MDL_F4(1), MDL_F4(2), MDL_F4(3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaTf32<8> {
  __device__ static void mma(float (&d)[8][4], const uint32_t (&a)[4],
                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : MDL_F4(0), MDL_F4(1), MDL_F4(2), MDL_F4(3), MDL_F4(4), MDL_F4(5),
          MDL_F4(6), MDL_F4(7)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaTf32<13> {
  __device__ static void mma(float (&d)[13][4], const uint32_t (&a)[4],
                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51"
        "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
        : MDL_F4(0), MDL_F4(1), MDL_F4(2), MDL_F4(3), MDL_F4(4), MDL_F4(5),
          MDL_F4(6), MDL_F4(7), MDL_F4(8), MDL_F4(9), MDL_F4(10), MDL_F4(11),
          MDL_F4(12)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaTf32<16> {
  __device__ static void mma(float (&d)[16][4], const uint32_t (&a)[4],
                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : MDL_F4(0), MDL_F4(1), MDL_F4(2), MDL_F4(3), MDL_F4(4), MDL_F4(5),
          MDL_F4(6), MDL_F4(7), MDL_F4(8), MDL_F4(9), MDL_F4(10), MDL_F4(11),
          MDL_F4(12), MDL_F4(13), MDL_F4(14), MDL_F4(15)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaTf32<19> {
  __device__ static void mma(float (&d)[19][4], const uint32_t (&a)[4],
                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %81, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n152k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75"
        "}, {%76, %77, %78, %79}, %80, p, 1, 1;\n}\n"
        : MDL_F4(0), MDL_F4(1), MDL_F4(2), MDL_F4(3), MDL_F4(4), MDL_F4(5),
          MDL_F4(6), MDL_F4(7), MDL_F4(8), MDL_F4(9), MDL_F4(10), MDL_F4(11),
          MDL_F4(12), MDL_F4(13), MDL_F4(14), MDL_F4(15), MDL_F4(16), MDL_F4(17),
          MDL_F4(18)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaTf32<25> {
  __device__ static void mma(float (&d)[25][4], const uint32_t (&a)[4],
                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %105, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n200k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99"
        "}, {%100, %101, %102, %103}, %104, p, 1, 1;\n}\n"
        : MDL_F4(0), MDL_F4(1), MDL_F4(2), MDL_F4(3), MDL_F4(4), MDL_F4(5),
          MDL_F4(6), MDL_F4(7), MDL_F4(8), MDL_F4(9), MDL_F4(10), MDL_F4(11),
          MDL_F4(12), MDL_F4(13), MDL_F4(14), MDL_F4(15), MDL_F4(16), MDL_F4(17),
          MDL_F4(18), MDL_F4(19), MDL_F4(20), MDL_F4(21), MDL_F4(22), MDL_F4(23),
          MDL_F4(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaTf32<32> {
  __device__ static void mma(float (&d)[32][4], const uint32_t (&a)[4],
                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : MDL_F4(0), MDL_F4(1), MDL_F4(2), MDL_F4(3), MDL_F4(4), MDL_F4(5),
          MDL_F4(6), MDL_F4(7), MDL_F4(8), MDL_F4(9), MDL_F4(10), MDL_F4(11),
          MDL_F4(12), MDL_F4(13), MDL_F4(14), MDL_F4(15), MDL_F4(16), MDL_F4(17),
          MDL_F4(18), MDL_F4(19), MDL_F4(20), MDL_F4(21), MDL_F4(22), MDL_F4(23),
          MDL_F4(24), MDL_F4(25), MDL_F4(26), MDL_F4(27), MDL_F4(28), MDL_F4(29),
          MDL_F4(30), MDL_F4(31)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// wgmma in bf16 (fused_bilinear_bf16.cu): d (64 x 8 NTW, f32, the layout
// above) += A · B over k = 16, A (64 x 16 bf16) from registers: warp w's
// 16 rows as mma.sync m16n8k16's A fragment, four bf16 pairs {A[g][2t, 2t+1],
// A[g+8][2t, 2t+1], A[g][2t+8, 2t+9], A[g+8][2t+8, 2t+9]} (the lower
// column in the lower half); B (8 NTW x 16, K-major, no transpose) from
// shared memory by b_desc, whose core matrices of 8 rows x 16 bytes hold 8
// bf16 where the TF32 ones hold 4. Instantiated for NTW 4, 13, 19, 25, 32.
template <int NTW> struct WgmmaBf16;

template <> struct WgmmaBf16<4> {
  __device__ static void mma(float (&d)[4][4], const uint32_t (&a)[4],
                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : MDL_F4(0), MDL_F4(1), MDL_F4(2), MDL_F4(3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaBf16<13> {
  __device__ static void mma(float (&d)[13][4], const uint32_t (&a)[4],
                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51"
        "}, {%52, %53, %54, %55}, %56, p, 1, 1, 0;\n}\n"
        : MDL_F4(0), MDL_F4(1), MDL_F4(2), MDL_F4(3), MDL_F4(4), MDL_F4(5),
          MDL_F4(6), MDL_F4(7), MDL_F4(8), MDL_F4(9), MDL_F4(10), MDL_F4(11),
          MDL_F4(12)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaBf16<19> {
  __device__ static void mma(float (&d)[19][4], const uint32_t (&a)[4],
                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %81, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75"
        "}, {%76, %77, %78, %79}, %80, p, 1, 1, 0;\n}\n"
        : MDL_F4(0), MDL_F4(1), MDL_F4(2), MDL_F4(3), MDL_F4(4), MDL_F4(5),
          MDL_F4(6), MDL_F4(7), MDL_F4(8), MDL_F4(9), MDL_F4(10), MDL_F4(11),
          MDL_F4(12), MDL_F4(13), MDL_F4(14), MDL_F4(15), MDL_F4(16),
          MDL_F4(17), MDL_F4(18)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaBf16<25> {
  __device__ static void mma(float (&d)[25][4], const uint32_t (&a)[4],
                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %105, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99"
        "}, {%100, %101, %102, %103}, %104, p, 1, 1, 0;\n}\n"
        : MDL_F4(0), MDL_F4(1), MDL_F4(2), MDL_F4(3), MDL_F4(4), MDL_F4(5),
          MDL_F4(6), MDL_F4(7), MDL_F4(8), MDL_F4(9), MDL_F4(10), MDL_F4(11),
          MDL_F4(12), MDL_F4(13), MDL_F4(14), MDL_F4(15), MDL_F4(16),
          MDL_F4(17), MDL_F4(18), MDL_F4(19), MDL_F4(20), MDL_F4(21),
          MDL_F4(22), MDL_F4(23), MDL_F4(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct WgmmaBf16<32> {
  __device__ static void mma(float (&d)[32][4], const uint32_t (&a)[4],
                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : MDL_F4(0), MDL_F4(1), MDL_F4(2), MDL_F4(3), MDL_F4(4), MDL_F4(5),
          MDL_F4(6), MDL_F4(7), MDL_F4(8), MDL_F4(9), MDL_F4(10), MDL_F4(11),
          MDL_F4(12), MDL_F4(13), MDL_F4(14), MDL_F4(15), MDL_F4(16),
          MDL_F4(17), MDL_F4(18), MDL_F4(19), MDL_F4(20), MDL_F4(21),
          MDL_F4(22), MDL_F4(23), MDL_F4(24), MDL_F4(25), MDL_F4(26),
          MDL_F4(27), MDL_F4(28), MDL_F4(29), MDL_F4(30), MDL_F4(31)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

#undef MDL_F4

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving a register's reads or writes across an
// asynchronous wgmma's issue or retirement.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <int NTW>
__device__ __forceinline__ void fence_acc(float (&d)[NTW][4]) {
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) fence_reg(d[j][q]);
}
// Shared memory that cp.async filled is read next by wgmma (the async
// proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarrier and the 1-D bulk copy (fused_bilinear_bf16.cu's rings) ----
//
// A stage of a ring lands by one cp.async.bulk (one thread issues it, the
// copy engine moves it and counts its bytes on the stage's `full`
// barrier); its readers wait on `full` and give the slot back by
// arriving on its `empty` barrier. A wait passes once the phase of the
// given parity has completed (a barrier starts in phase 0).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the other threads and to the
// copy engine (before the block barrier that follows the inits).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// One arrival that also adds `bytes` to the bytes the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nMDL_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra MDL_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory, completing on bar.
__device__ __forceinline__ void bulk_g2s(void* smem, const void* gmem,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The descriptor of a K-major B operand without swizzle at p: core
// matrices of 8 rows x 16 bytes (8 x 4 TF32 words, rows contiguous), the
// two of a k-step 128 bytes apart (leading byte offset) and successive
// 8-row groups 256 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// Words of one k-step of a split weight with np B rows: hi, then lo, each
// np rows x 8 words.
__host__ __device__ inline int kstep_words(int np) { return 2 * np * 8; }

// The three wgmma of one 3xTF32 k-step: d += a·b, a split into (hi, lo)
// and b's hi and lo by descriptor; scale_d = 0 on the first drops the old
// d.
template <int NTW>
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[NTW][4],
                                             const uint32_t (&ahi)[4],
                                             const uint32_t (&alo)[4],
                                             uint64_t dhi, uint64_t dlo,
                                             int scale_d) {
  WgmmaTf32<NTW>::mma(d, alo, dhi, scale_d);
  WgmmaTf32<NTW>::mma(d, ahi, dlo, 1);
  WgmmaTf32<NTW>::mma(d, ahi, dhi, 1);
}

// The A fragment {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]} split into
// TF32 hi and lo.
__device__ __forceinline__ void split_a(float a0, float a1, float a2,
                                        float a3, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

// A row stride >= n that is 8 mod 32 (floats): a warp's 8-byte accesses
// to an accumulator fragment's 8 rows x 4 column pairs then fall in
// distinct banks in each half-warp.
__host__ __device__ inline int stride_acc(int n) { return n + (40 - n % 32) % 32; }

// Epilogues leave the accumulator layout through a shared tile t (row
// stride ld): the lane's rows r0 and r0 + 8, columns col0 + 8j + 2tq and
// the next. Each is one 8-byte shared store a pair, so the code stays
// short at any NTW; the element-wise work then runs in a rolled loop over
// the tile.
template <int NTW>
__device__ __forceinline__ void acc_to_tile(const float (&d)[NTW][4],
                                            float* t, int ld, int r0,
                                            int col0, int tq) {
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    float* p = t + r0 * ld + col0 + 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(p) = make_float2(d[j][0], d[j][1]);
    *reinterpret_cast<float2*>(p + 8 * ld) = make_float2(d[j][2], d[j][3]);
  }
}

// ws = a weight split once into TF32 hi and lo in the order the B
// descriptors read it: for k-step s (of ksteps), part (hi, lo), 8-row group
// n8 of the np B rows, half kh of the k-step, row r and column c < 4, word
// (((s * 2 + part) * np / 8 + n8) * 2 + kh) * 32 + r * 4 + c holds that part
// of src(s, n, 4 kh + c) for B row n = 8 n8 + r. A stage of k-steps is
// then one contiguous range of words. src(s, n, c) is B's element at row n
// and column 8 s' + c of the k-step's unit (zero past its ends).
template <class Src>
__global__ void __launch_bounds__(kThreads)
split_kmajor_kernel(Src src, long long ksteps, int np,
                    uint32_t* __restrict__ ws) {
  const long long total = ksteps * np * 8;  // hi/lo pairs
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    // i = (s * np + n) * 8 + kk over the k-step s, B row n and column kk
    const int kk = (int)(i & 7);
    const long long sn = i >> 3;
    const int n = (int)(sn % np);
    const long long s = sn / np;
    uint32_t hi, lo;
    split_tf32(src(s, n, kk), hi, lo);
    const long long base = s * kstep_words(np);
    const long long at = ((long long)(n >> 3) * 2 + (kk >> 2)) * 32 +
                         (n & 7) * 4 + (kk & 3);
    ws[base + at] = hi;
    ws[base + np * 8 + at] = lo;
  }
}

// Launches split_kmajor_kernel on `s`; returns cudaGetLastError().
template <class Src>
int launch_split(const Src& src, long long ksteps, int np, uint32_t* ws,
                 cudaStream_t s) {
  const long long blocks = (ksteps * np * 8 + kThreads - 1) / kThreads;
  split_kmajor_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), kThreads,
                        0, s>>>(src, ksteps, np, ws);
  return (int)cudaGetLastError();
}

// The k-step position p < 8 of an A fragment built from an accumulator
// fragment: positions t and t + 4 hold the accumulator's columns 2t and
// 2t + 1, so the accumulators of one product's n8-tile j are the A
// fragment of the next product's k-step j, {d[j][0], d[j][2], d[j][1],
// d[j][3]}, once the next B's rows are taken in this order.
__host__ __device__ inline int pair_col(int p) {
  return p < 4 ? 2 * p : 2 * (p - 4) + 1;
}

}  // namespace
