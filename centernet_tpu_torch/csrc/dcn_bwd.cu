// Modulated deformable 3x3 convolution (DCNv2) backward for Hopper (sm_90a).
//
// Replaces the TPU kernel centernet_tpu/ops/dcn_pallas.py:414 (_bwd_kernel,
// launched by pallas_deform_conv_bwd -> _pallas_bwd_single). Given the
// forward's inputs (offsets already clamped, see dcn_fwd.cu) and the output
// cotangent g [B, H, W, Co] f32, it computes for every pixel p, tap k and
// input channel c, with col the bilinear sample of x and m the mask:
//
//   gk[p, k, c]   = sum_o W[k*Ci + c, o] * g[p, o]
//   dmask[p, k]   = sum_c col[p, k, c] * gk[p, k, c]
//   dty[p, k]     = sum_c (d col / d py)[p, k, c] * gk * m   (floor form: the
//   dtx[p, k]     = sum_c (d col / d px)[p, k, c] * gk * m    forward difference)
//   dx[corner, c] += w_corner * gk * m      over the sample's 4 corners
//   dW[k*Ci + c, o] = sum_p col[p, k, c] * m[p, k] * g[p, o]
//
// The four corners come from floor(y - 1 + k/3 + dy), floor(x - 1 + k%3 + dx),
// computed exactly as dcn_fwd.cu computes them, so the forward and the
// backward agree on every integer and bound offset. A corner outside the
// image has weight 0. Rounding points are the TPU kernel's: g is rounded to
// the compute type before both products, gk * m before the dx scatter,
// col * m before the dW product; every sum is f32. In f32 every product is a
// full f32 product (the TPU kernel's HIGHEST precision).
//
// Layouts: x [B, H, W, Ci] (bf16 or f32); offsets [B, H, W, 18] f32;
// mask [B, H, W, 9] f32; W [9*Ci, Co] tap-major in x's type; g [B, H, W, Co]
// f32. Outputs: dx [B, H, W, Ci] f32 (zeroed by the caller, accumulated with
// atomics), dty, dtx, dmask [B, H, W, 9] f32, dW [9*Ci, Co] f32 (zeroed by
// the caller, accumulated with atomics). Scratch: gk [B*H*W, 9*Ci] f32 and
// colm [B*H*W, 9*Ci] in x's type.
//
// Bound on the H100: memory. At 128x128 C64->64, B4, the inputs and outputs
// move about 48 MB (x and dx in bf16, g f32, offsets, mask and their
// gradients f32), 14 us at 3.35 TB/s, while the two contractions are 4.8
// GFLOP, 5 us on the bf16 tensor cores. What costs beyond the bound: the
// gather of 9 taps x 4 corners of a Ci vector per pixel (as in the forward),
// the scatter of the same into dx, and the reduction of dW over every pixel.
//
// Design (the first, simple version; three launches on one stream):
//  1. gk = g . W^T as a tiled product [P x Co] . [Co x 9*Ci] (P = B*H*W):
//     64x64 output tiles, g rounded to the compute type as it is staged in
//     shared memory; bf16 on the tensor cores (WMMA 16x16x16, f32
//     accumulators), f32 by FMA. gk goes to a scratch buffer in f32.
//  2. Sampling: one warp per (pixel, tap), lanes over channels. It gathers
//     the 4 corners, forms col and its two coordinate derivatives, reduces
//     dmask, dty and dtx over Ci with warp shuffles (the warp owns all Ci,
//     so no atomics), writes col * m rounded to the compute type to scratch,
//     and adds w_corner * round(gk * m) into dx with f32 atomics. Lanes cover
//     neighbouring channels, so each atomic instruction of a warp hits one
//     contiguous run. The order of the atomic sums changes from run to run.
//  3. dW = colm^T . g: the same tiled product, split over the pixels into
//     about four blocks per SM; each block adds its [64 x 64] partial into
//     dW with one f32 atomic per element.
// Later work: fuse 1-3 into one pass that keeps gk and colm on chip, wgmma
// and TMA, vector atomics for dx.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kSms = 132;

typedef __nv_bfloat16 bf16;

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

// ------------------------------------------------------- tiled product ---
//
// C[m, n] (+)= sum_k A(m, k) * B(k, n) over one [GM x GN] output tile and the
// block's share of k, with A(m, k) = a[m * a_m + k * a_k] and B(k, n) =
// b[k * b_k + n * b_n] read in their storage types and rounded to T as they
// are staged. The staging maps consecutive threads onto whichever index is
// contiguous in memory, so the loads coalesce.

constexpr int GM = 64;
constexpr int GN = 64;
constexpr int GK = 32;
constexpr int LDA = GK + 8;  // shared row strides (elements): multiples of 8
constexpr int LDB = GN + 8;  // for WMMA, and off the bank period
constexpr int LDC = GN + 4;

struct GemmArgs {
  const void* a;
  long long a_m, a_k;
  const void* b;
  long long b_k, b_n;
  float* c;
  long long ldc;
  int M, N, K;
  int k_per_block;  // blockIdx.z covers k in [z * k_per_block, ...)
  int accumulate;   // 1: atomicAdd into c, 0: store
};

__device__ __forceinline__ void emit(const GemmArgs& g, int m, int n,
                                     float v) {
  if (m >= g.M || n >= g.N) return;
  float* dst = g.c + (long long)m * g.ldc + n;
  if (g.accumulate)
    atomicAdd(dst, v);
  else
    *dst = v;
}

template <typename T, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) dcn_bwd_gemm_kernel(GemmArgs g) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kBytesAB = (GM * LDA + GK * LDB) * (int)sizeof(T);
  constexpr int kBytesC = kBf16 ? GM * LDC * 4 : 0;
  __shared__ __align__(128)
      unsigned char smem[kBytesAB > kBytesC ? kBytesAB : kBytesC];
  T* s_a = reinterpret_cast<T*>(smem);
  T* s_b = s_a + GM * LDA;

  const TA* A = static_cast<const TA*>(g.a);
  const TB* B = static_cast<const TB*>(g.b);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * GM;
  const int n0 = blockIdx.y * GN;
  const int kb = blockIdx.z * g.k_per_block;
  const int ke = min(g.K, kb + g.k_per_block);

  // bf16: warp (wm, wn) owns rows 16*wm.., columns 32*wn.. (two fragments).
  // f32: thread (tx, ty) owns rows 4*ty.., columns 4*tx...
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int tx = tid % 16;
  const int ty = tid / 16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2];
  float facc[4][4];
  if constexpr (kBf16) {
    nvcuda::wmma::fill_fragment(acc[0], 0.f);
    nvcuda::wmma::fill_fragment(acc[1], 0.f);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) facc[r][q] = 0.f;
  }

  for (int k0 = kb; k0 < ke; k0 += GK) {
    __syncthreads();  // the previous step's readers are done
#pragma unroll
    for (int r = 0; r < GM * GK / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int mm = g.a_k == 1 ? e / GK : e % GM;
      const int kk = g.a_k == 1 ? e % GK : e / GM;
      const int m = m0 + mm;
      const int k = k0 + kk;
      float v = 0.f;
      if (m < g.M && k < ke)
        v = to_f(A[(long long)m * g.a_m + (long long)k * g.a_k]);
      s_a[mm * LDA + kk] = from_f<T>(v);
    }
#pragma unroll
    for (int r = 0; r < GK * GN / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int nn = g.b_n == 1 ? e % GN : e / GK;
      const int kk = g.b_n == 1 ? e / GN : e % GK;
      const int n = n0 + nn;
      const int k = k0 + kk;
      float v = 0.f;
      if (n < g.N && k < ke)
        v = to_f(B[(long long)k * g.b_k + (long long)n * g.b_n]);
      s_b[kk * LDB + nn] = from_f<T>(v);
    }
    __syncthreads();
    if constexpr (kBf16) {
      using namespace nvcuda;
#pragma unroll
      for (int kk = 0; kk < GK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, s_a + wm * 16 * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, s_b + kk * LDB + wn * 32 + j * 16, LDB);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    } else {
#pragma unroll 8
      for (int kk = 0; kk < GK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = to_f(s_a[(ty * 4 + r) * LDA + kk]);
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = to_f(s_b[kk * LDB + tx * 4 + q]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) facc[r][q] += av[r] * bv[q];
      }
    }
  }

  if constexpr (kBf16) {
    float* s_c = reinterpret_cast<float*>(smem);
    __syncthreads();  // the last step's readers of s_a/s_b are done
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(s_c + wm * 16 * LDC + wn * 32 + j * 16,
                                      acc[j], LDC, nvcuda::wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < GM * GN / kThreads; ++r) {
      const int e = tid + r * kThreads;
      emit(g, m0 + e / GN, n0 + e % GN, s_c[(e / GN) * LDC + e % GN]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        emit(g, m0 + ty * 4 + r, n0 + tx * 4 + q, facc[r][q]);
  }
}

// ------------------------------------------------------------ sampling ---

template <typename T>
__global__ void __launch_bounds__(kThreads) dcn_bwd_sample_kernel(
    const T* __restrict__ x, const float* __restrict__ offsets,
    const float* __restrict__ mask, const float* __restrict__ gk,
    float* __restrict__ dx, float* __restrict__ dty, float* __restrict__ dtx,
    float* __restrict__ dmask, T* __restrict__ colm, int B, int H, int W,
    int Ci) {
  const long long pk =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pk >= (long long)B * H * W * kTaps) return;
  const long long p = pk / kTaps;
  const int k = (int)(pk % kTaps);
  const int xx = (int)(p % W);
  const int y = (int)((p / W) % H);
  const int b = (int)(p / ((long long)H * W));

  const float m = mask[pk];
  const float oy = offsets[2 * pk];
  const float ox = offsets[2 * pk + 1];
  // As dcn_fwd.cu: keep the float->int conversion defined; every corner of
  // a position beyond these limits lies outside the image.
  const float py =
      fminf(fmaxf((float)(y - 1 + k / 3) + oy, -2.f), (float)H + 1.f);
  const float px =
      fminf(fmaxf((float)(xx - 1 + k % 3) + ox, -2.f), (float)W + 1.f);
  const float y0f = floorf(py);
  const float x0f = floorf(px);
  const float ly = py - y0f;
  const float lx = px - x0f;
  const int y0 = (int)y0f;
  const int x0 = (int)x0f;

  long long base[4];  // corner's first channel in x and dx
  float vw[4];        // value weight  wy * wx
  float yw[4];        // d(value weight) / d py
  float xw[4];        // d(value weight) / d px
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int dy = c >> 1;
    const int dxc = c & 1;
    const int yc = y0 + dy;
    const int xc = x0 + dxc;
    const float v = (yc >= 0 && yc < H && xc >= 0 && xc < W) ? 1.f : 0.f;
    const float wy = dy ? ly : 1.f - ly;
    const float wx = dxc ? lx : 1.f - lx;
    base[c] = (((long long)b * H + min(max(yc, 0), H - 1)) * W +
               min(max(xc, 0), W - 1)) *
              Ci;
    vw[c] = v * wy * wx;
    yw[c] = v * (dy ? wx : -wx);
    xw[c] = v * (dxc ? wy : -wy);
  }

  const float* gkp = gk + pk * Ci;
  T* colp = colm + pk * Ci;
  float s_m = 0.f, s_y = 0.f, s_x = 0.f;
  for (int c = lane; c < Ci; c += 32) {
    float col = 0.f, uy = 0.f, ux = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float xv = to_f(x[base[j] + c]);
      col += vw[j] * xv;
      uy += yw[j] * xv;
      ux += xw[j] * xv;
    }
    const float gv = gkp[c];
    const float gm = gv * m;
    s_m += col * gv;
    s_y += uy * gm;
    s_x += ux * gm;
    colp[c] = from_f<T>(col * m);
    const float gd = to_f(from_f<T>(gm));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (vw[j] != 0.f) atomicAdd(dx + base[j] + c, vw[j] * gd);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    s_m += __shfl_xor_sync(0xffffffffu, s_m, s);
    s_y += __shfl_xor_sync(0xffffffffu, s_y, s);
    s_x += __shfl_xor_sync(0xffffffffu, s_x, s);
  }
  if (lane == 0) {
    dmask[pk] = s_m;
    dty[pk] = s_y;
    dtx[pk] = s_x;
  }
}

template <typename T>
int launch(const T* x, const float* offsets, const float* mask,
           const T* weight, const float* g, float* dx, float* dty,
           float* dtx, float* dmask, float* dw, float* gk, T* colm, int B,
           int H, int W, int Ci, int Co, cudaStream_t s) {
  const long long P = (long long)B * H * W;
  const int N9 = kTaps * Ci;

  // 1. gk [P, 9*Ci] = g [P, Co] . W^T
  GemmArgs g1{g, Co, 1, weight, 1, Co, gk, N9, (int)P, N9, Co, Co, 0};
  const dim3 grid1((unsigned)((P + GM - 1) / GM),
                   (unsigned)((N9 + GN - 1) / GN), 1);
  dcn_bwd_gemm_kernel<T, float, T><<<grid1, kThreads, 0, s>>>(g1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 2. sampling: one warp per (pixel, tap)
  const long long warps = P * kTaps;
  constexpr int kWarps = kThreads / 32;
  dcn_bwd_sample_kernel<T><<<(unsigned)((warps + kWarps - 1) / kWarps),
                             kThreads, 0, s>>>(x, offsets, mask, gk, dx, dty,
                                               dtx, dmask, colm, B, H, W, Ci);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 3. dW [9*Ci, Co] += colm^T . g, the pixels split over about
  // kBlocksPerSm blocks per SM
  const long long tiles =
      (long long)((N9 + GM - 1) / GM) * ((Co + GN - 1) / GN);
  long long splits = (kBlocksPerSm * kSms + tiles - 1) / tiles;
  splits = std::max(1LL, std::min(splits, (P + GK - 1) / GK));
  long long per = (P + splits - 1) / splits;
  per = (per + GK - 1) / GK * GK;
  splits = (P + per - 1) / per;
  GemmArgs g3{colm, 1, N9, g, Co, 1, dw, Co, N9, Co, (int)P, (int)per, 1};
  const dim3 grid3((unsigned)((N9 + GM - 1) / GM),
                   (unsigned)((Co + GN - 1) / GN), (unsigned)splits);
  dcn_bwd_gemm_kernel<T, T, float><<<grid3, kThreads, 0, s>>>(g3);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes (centernet_tpu_torch/ops/dcn_cuda.py).
// Launches on `stream` and returns the first cudaGetLastError() that is not
// cudaSuccess, or 0.
extern "C" int dcn_bwd(const void* x, const void* offsets, const void* mask,
                       const void* weight, const void* g, void* dx, void* dty,
                       void* dtx, void* dmask, void* dw, void* gk, void* colm,
                       int B, int H, int W, int Ci, int Co, int is_bf16,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  const float* gp = static_cast<const float*>(g);
  float* out[5] = {static_cast<float*>(dx), static_cast<float*>(dty),
                   static_cast<float*>(dtx), static_cast<float*>(dmask),
                   static_cast<float*>(dw)};
  if (is_bf16)
    return launch<bf16>(static_cast<const bf16*>(x), off, msk,
                        static_cast<const bf16*>(weight), gp, out[0], out[1],
                        out[2], out[3], out[4], static_cast<float*>(gk),
                        static_cast<bf16*>(colm), B, H, W, Ci, Co, s);
  return launch<float>(static_cast<const float*>(x), off, msk,
                       static_cast<const float*>(weight), gp, out[0], out[1],
                       out[2], out[3], out[4], static_cast<float*>(gk),
                       static_cast<float*>(colm), B, H, W, Ci, Co, s);
}
