// Modulated deformable 3x3 convolution (DCNv2) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel centernet_tpu/ops/dcn_pallas.py::_fwd_kernel
// (launched by pallas_deform_conv_fwd). It computes, for every output pixel
// p = (b, y, x) and output channel o:
//
//   out[p, o] = bias[o] + sum_k sum_c  mask[p, k] * bilinear(x[b, :, :, c],
//                 y - 1 + k/3 + dy[p, k], x - 1 + k%3 + dx[p, k]) * W[k*Ci + c, o]
//
// with exact DCNv2 bilinear sampling: the four corners come from
// floor(py), floor(px), and a corner outside the image contributes zero.
// The module (ops/dcn.py) has already clamped the offsets to
// [-r, r - 1/64], so plain sampling equals the TPU kernel's row-shift
// expansion and needs no radius argument.
//
// Layouts: x [B, H, W, Ci] (bf16 or f32, NHWC so a corner's Ci vector is
// contiguous); offsets [B, H, W, 18] f32, (dy, dx) interleaved per tap;
// mask [B, H, W, 9] f32 (already sigmoided); W [9*Ci, Co] tap-major, in
// x's type; bias [Co] f32; out [B, H, W, Co] f32.
//
// Bound on the H100: memory. At 128x128 C64->64, B16, one layer reads
// about 34 MB of x (bf16) and 28 MB of offsets and mask, writes 67 MB of
// f32 output, and does only about 19 GFLOP; 130 MB at 3.35 TB/s is about
// 39 us, while 19 GFLOP at the bf16 tensor-core rate is about 20 us. The
// sampling is what costs: each output pixel gathers 9 taps x 4 corners of a
// Ci vector, 36 times the bytes of x, which the L1 and L2 caches serve
// (neighbouring pixels share corners). In f32 the contraction has no tensor
// cores at full precision, and the 67 TFLOP/s of the f32 pipes bound it.
//
// Design. The contraction happens inside the kernel: no column buffer ever
// reaches device memory, which keeps the device-memory traffic at the
// bound's inputs and output. One block owns an 8x8 tile of output pixels
// of one image (a square tile's corners overlap more than a row's, so more
// of the gather hits L1) and TCO output channels. It first computes the
// corner indices and mask-folded bilinear weights of all 9 taps of its 64
// pixels, in shared memory (an outside corner gets weight 0 and a clamped
// index, so every gather is a plain load). Then, per tap and chunk of input
// channels:
//  * bf16 (the served path): threads gather the corners as 16-byte vectors
//    of 8 channels (8 neighbouring threads read one corner's contiguous
//    128 bytes), sum them in f32, round the sample to bf16 as the TPU kernel
//    rounds its sampled tile before the product, and store the [TP x 64]
//    tile in shared memory beside the matching [64 x TCO] slice of W; eight
//    warps contract the two on the tensor cores (WMMA 16x16x16, f32
//    accumulators in registers). Ci and Co must be multiples of 8.
//  * f32: a warp gathers one pixel's corners per channel chunk, and the
//    [TP x 32] tile is contracted with plain f32 FMA (full f32 products, as
//    the TPU kernel's HIGHEST precision).
// Later work: TMA staging, wgmma, a pipelined gather, and fusing the clamp
// and sigmoid of the offsets and mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int kTaps = 9;
constexpr int TP = 64;    // output pixels per block (an 8x8 tile)
constexpr int TCO = 64;   // output channels per block
constexpr int kThreads = 256;

constexpr int TY = 8;  // output tile rows
constexpr int TX = 8;  // output tile columns (TP = TY * TX)

struct Tile {
  int b, y0, x0;
};

// The block's image and tile origin: blocks walk the 8x8 tiles of image 0,
// then image 1, ...
__device__ __forceinline__ Tile block_tile(int H, int W) {
  const int tiles_x = (W + TX - 1) / TX;
  const int tiles = ((H + TY - 1) / TY) * tiles_x;
  const int t = (int)(blockIdx.x % tiles);
  return {(int)(blockIdx.x / tiles), (t / tiles_x) * TY, (t % tiles_x) * TX};
}

// Flat output pixel (b*H + y)*W + x of the tile's pixel i, or -1 past the
// image's edge.
__device__ __forceinline__ long long tile_pixel(const Tile& t, int i, int H,
                                                int W) {
  const int y = t.y0 + i / TX;
  const int x = t.x0 + i % TX;
  if (y >= H || x >= W) return -1;
  return ((long long)t.b * H + y) * W + x;
}

// Corner pixel indices into x and bilinear weights times the mask, for all
// 9 taps of the tile's TP pixels. A corner outside the image (or a pixel
// past the image's edge) gets weight 0 and a clamped index, as the plain
// version has it.
__device__ __forceinline__ void tile_corners(
    const float* __restrict__ offsets, const float* __restrict__ mask,
    const Tile& t, int H, int W, int (*s_idx)[TP][4],
    float (*s_cw)[TP][4]) {
  for (int it = threadIdx.x; it < kTaps * TP; it += blockDim.x) {
    const int k = it / TP;
    const int i = it % TP;
    const long long p = tile_pixel(t, i, H, W);
    const int y = t.y0 + i / TX;
    const int xx = t.x0 + i % TX;
    float m = 0.f, oy = 0.f, ox = 0.f;
    if (p >= 0) {
      m = mask[p * kTaps + k];
      oy = offsets[p * 2 * kTaps + 2 * k];
      ox = offsets[p * 2 * kTaps + 2 * k + 1];
    }
    // Keep the float->int conversion defined; every corner of a position
    // beyond these limits lies outside the image, so the result is equal.
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
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int yc = y0 + (c >> 1);
      const int xc = x0 + (c & 1);
      const float wy = (c >> 1) ? ly : 1.f - ly;
      const float wx = (c & 1) ? lx : 1.f - lx;
      const bool inside = yc >= 0 && yc < H && xc >= 0 && xc < W;
      s_idx[k][i][c] = (t.b * H + min(max(yc, 0), H - 1)) * W +
                       min(max(xc, 0), W - 1);
      s_cw[k][i][c] = inside ? wy * wx * m : 0.f;
    }
  }
}

// ---------------------------------------------------------------- bf16 ---

constexpr int KC = 64;        // input channels per chunk
constexpr int LDA = KC + 8;   // shared row strides (elements): multiples of
constexpr int LDB = TCO + 8;  // 8, as WMMA needs, and off the bank period
constexpr int LDC = TCO + 4;
constexpr int kBytesAB = (TP * LDA + KC * LDB) * 2;
constexpr int kBytesC = TP * LDC * 4;
constexpr int kBytesTile = kBytesAB > kBytesC ? kBytesAB : kBytesC;

__global__ void __launch_bounds__(kThreads)
dcn_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ offsets,
                    const float* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ weight,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int H, int W, int Ci, int Co) {
  using namespace nvcuda;
  __shared__ int s_idx[kTaps][TP][4];
  __shared__ float s_cw[kTaps][TP][4];
  // The sampled tile and the W slice while contracting; the f32 result
  // tile afterwards.
  __shared__ __align__(128) unsigned char s_tile[kBytesTile];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(s_tile);
  __nv_bfloat16* s_b = s_a + TP * LDA;
  float* s_c = reinterpret_cast<float*>(s_tile);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;   // 16-pixel row block of the tile
  const int warp_n = warp >> 2;  // 32-channel column block of the tile
  const Tile tile = block_tile(H, W);
  const int co0 = blockIdx.y * TCO;

  tile_corners(offsets, mask, tile, H, W, s_idx, s_cw);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int k = 0; k < kTaps; ++k) {
    for (int c0 = 0; c0 < Ci; c0 += KC) {
      // Previous chunk's readers of s_a/s_b are done (and, the first time,
      // the corners are written).
      __syncthreads();
      // Gather the sampled [TP x KC] tile, 8 channels per item; all loads of
      // a thread are independent, so they are in flight together.
#pragma unroll
      for (int r = 0; r < TP * (KC / 8) / kThreads; ++r) {
        const int it = tid + r * kThreads;
        const int pp = it / (KC / 8);
        const int v = it % (KC / 8);
        const int ch = c0 + v * 8;
        float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (ch < Ci) {
          uint4 raw[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            raw[c] = __ldg(reinterpret_cast<const uint4*>(
                x + (long long)s_idx[k][pp][c] * Ci + ch));
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float cw = s_cw[k][pp][c];
            const __nv_bfloat162* h =
                reinterpret_cast<const __nv_bfloat162*>(&raw[c]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(h[j]);
              s[2 * j] += cw * f.x;
              s[2 * j + 1] += cw * f.y;
            }
          }
        }
        uint4 packed;
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = __floats2bfloat162_rn(s[2 * j], s[2 * j + 1]);
        *reinterpret_cast<uint4*>(s_a + pp * LDA + v * 8) = packed;
      }
      // Stage W rows k*Ci + [c0, c0 + KC), columns [co0, co0 + TCO).
#pragma unroll
      for (int r = 0; r < KC * (TCO / 8) / kThreads; ++r) {
        const int it = tid + r * kThreads;
        const int row = it / (TCO / 8);
        const int v = it % (TCO / 8);
        const int wc = c0 + row;
        const int wo = co0 + v * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (wc < Ci && wo < Co)
          val = __ldg(reinterpret_cast<const uint4*>(
              weight + ((long long)k * Ci + wc) * Co + wo));
        *reinterpret_cast<uint4*>(s_b + row * LDB + v * 8) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, s_a + warp_m * 16 * LDA + kk * 16, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bfr;
          wmma::load_matrix_sync(
              bfr, s_b + kk * 16 * LDB + warp_n * 32 + j * 16, LDB);
          wmma::mma_sync(acc[j], a, bfr, acc[j]);
        }
      }
    }
  }

  // Park the result in the tile's memory and write it out with bias, as
  // float4 runs of each pixel's TCO channels.
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(s_c + warp_m * 16 * LDC + warp_n * 32 + j * 16,
                            acc[j], LDC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < TP * (TCO / 4) / kThreads; ++r) {
    const int it = tid + r * kThreads;
    const int pp = it / (TCO / 4);
    const int v = it % (TCO / 4);
    const long long p = tile_pixel(tile, pp, H, W);
    const int o = co0 + v * 4;
    if (p < 0 || o >= Co) continue;
    float4 val = *reinterpret_cast<const float4*>(s_c + pp * LDC + v * 4);
    val.x += bias[o];
    val.y += bias[o + 1];
    val.z += bias[o + 2];
    val.w += bias[o + 3];
    *reinterpret_cast<float4*>(out + p * Co + o) = val;
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int TC = 32;  // input channels per chunk

__global__ void __launch_bounds__(kThreads)
dcn_fwd_f32_kernel(const float* __restrict__ x,
                   const float* __restrict__ offsets,
                   const float* __restrict__ mask,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int W, int Ci, int Co) {
  __shared__ int s_idx[kTaps][TP][4];
  __shared__ float s_cw[kTaps][TP][4];
  __shared__ float s_col[TP][TC + 1];  // sampled tile (+1: no bank conflicts)
  __shared__ __align__(16) float s_w[TC][TCO];

  const int tid = threadIdx.x;
  const Tile tile = block_tile(H, W);
  const int co0 = blockIdx.y * TCO;

  // Product tile: thread (tx, ty) owns 4 pixels x 4 output channels.
  const int tx = tid % 16;
  const int ty = tid / 16;
  // Sampling: a warp owns one pixel at a time, lane = channel in the chunk.
  const int lane = tid & 31;
  const int warp = tid >> 5;

  tile_corners(offsets, mask, tile, H, W, s_idx, s_cw);

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  for (int k = 0; k < kTaps; ++k) {
    for (int c0 = 0; c0 < Ci; c0 += TC) {
      __syncthreads();  // the previous chunk's readers are done
      // Gather the sampled [TP x TC] tile.
      const int ci = c0 + lane;
#pragma unroll
      for (int j = 0; j < TP / 8; ++j) {
        const int pp = warp * (TP / 8) + j;
        float v = 0.f;
        if (ci < Ci) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            v += s_cw[k][pp][c] * x[(long long)s_idx[k][pp][c] * Ci + ci];
        }
        s_col[pp][lane] = v;
      }
      // Stage W rows k*Ci + [c0, c0 + TC), columns [co0, co0 + TCO).
#pragma unroll
      for (int r = 0; r < TC * TCO / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int i = e / TCO;
        const int j = e % TCO;
        const int wc = c0 + i;
        const int wo = co0 + j;
        s_w[i][j] = (wc < Ci && wo < Co)
                        ? weight[((long long)k * Ci + wc) * Co + wo]
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int i = 0; i < TC; ++i) {
        const float4 wv = *reinterpret_cast<const float4*>(&s_w[i][tx * 4]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = s_col[ty * 4 + r][i];
          acc[r][0] += a * wv.x;
          acc[r][1] += a * wv.y;
          acc[r][2] += a * wv.z;
          acc[r][3] += a * wv.w;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long p = tile_pixel(tile, ty * 4 + r, H, W);
    if (p < 0) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = co0 + tx * 4 + q;
      if (o < Co) out[p * Co + o] = acc[r][q] + bias[o];
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes (centernet_tpu_torch/ops/dcn_cuda.py).
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int dcn_fwd(const void* x, const void* offsets, const void* mask,
                       const void* weight, const void* bias, void* out, int B,
                       int H, int W, int Ci, int Co, int is_bf16,
                       void* stream) {
  const long long tiles =
      (long long)B * ((H + TY - 1) / TY) * ((W + TX - 1) / TX);
  const dim3 grid((unsigned)tiles, (unsigned)((Co + TCO - 1) / TCO));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dcn_fwd_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(offsets), static_cast<const float*>(mask),
        static_cast<const __nv_bfloat16*>(weight),
        static_cast<const float*>(bias), static_cast<float*>(out), H, W, Ci,
        Co);
  } else {
    dcn_fwd_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(offsets),
        static_cast<const float*>(mask), static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<float*>(out), H, W, Ci,
        Co);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dcn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
