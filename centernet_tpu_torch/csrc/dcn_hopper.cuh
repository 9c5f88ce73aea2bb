// Hopper (sm_90a) building blocks shared by the DCNv2 kernels: warpgroup
// matrix multiply (wgmma) on bf16 tiles in shared memory, the 128-byte
// swizzled tile layout it reads, cp.async, and small type helpers.
//
// Tile layout ("row panel"): R rows of 128 bytes (64 bf16), rows 128 bytes
// apart, 8-row groups 1024 bytes apart, the panel's base 1024-byte aligned.
// The 16-byte unit u (0..7) of row r is stored at unit u ^ (r & 7). One
// physical layout serves both operand kinds:
//  * K-major (the contiguous 64 elements run along the contraction): an
//    [M or N rows] x [64 k] panel; a k16 step advances the start by 32 bytes;
//    wider K takes one panel per 64 k.
//  * MN-major (the contiguous 64 elements run along M or N, rows along the
//    contraction; the instruction's transpose flag set): a [k rows] x [64 m
//    or n] panel; a k16 step advances the start by 16 rows (2048 bytes);
//    wider N takes one panel per 64 n, `lbo` bytes apart.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

namespace dcn {

// Raises a kernel's dynamic shared-memory limit to `bytes` (needed above 48
// KB) on the current device, once per (device, kernel) and size: later
// launches find it set. The attribute is kept per device.
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> allowed;
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = allowed[{device, kernel}];
  if (bytes <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

typedef __nv_bfloat16 bf16;

constexpr int kTaps = 9;
constexpr int kPanelRowBytes = 128;
constexpr int kGroupBytes = 1024;  // 8 rows of a panel

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the kernels' rounding points.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col), col in [0, 64), inside a row panel.
__device__ __forceinline__ int panel_off(int row, int col) {
  return row * kPanelRowBytes + ((((col >> 3) ^ row) & 7) << 4) +
         ((col & 7) << 1);
}

// Shared-memory matrix descriptor of a 128-byte swizzled panel: start
// address, leading and stride byte offsets (all in 16-byte units), layout
// type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t panel_desc(uint32_t smem_addr,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (uint64_t)((smem_addr & 0x3FFFFu) >> 4);
  d |= (uint64_t)((lbo_bytes & 0x3FFFFu) >> 4) << 16;
  d |= (uint64_t)((sbo_bytes & 0x3FFFFu) >> 4) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Makes shared-memory writes of this thread (st.shared, finished cp.async)
// visible to wgmma's reads; follow with a barrier.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem_dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N] on one warpgroup, f32 accumulators.
// TA / TB = 1 marks the operand MN-major. Thread t of the warpgroup (warp w
// = t / 32, lane l) holds, in d[4 j + 2 h + e]: row 16 w + l / 4 + 8 h,
// column 8 j + 2 (l % 4) + e.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

}  // namespace dcn
