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
// expansion; the radius r sizes the window of x that the fast path stages.
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
// bound's inputs and output. A block owns an 8x8 tile of output pixels of
// one image and precomputes the corners and mask-folded bilinear weights of
// all 9 taps of its 64 pixels in shared memory.
//
//  * The fast path (dcn_fwd_wgmma_kernel: bf16, Ci a multiple of 64, Co 64,
//    128 or 256) gathers once for all of Co. Per chunk of 64 input channels
//    it stages the window of x that the tile's samples can touch (the tile
//    plus r + 1 cells each side, r the offsets' clamp radius; cells outside
//    the image are zeros) in shared memory, once for all 9 taps. Per tap, a
//    thread builds 8 channels of one pixel's sample from 4 16-byte shared
//    loads (the 8 lanes of a pixel read one 128-byte run: no bank conflict),
//    rounds it to bf16 as the TPU kernel rounds its sampled tile, and stores
//    it into a 128-byte swizzled K-major A panel [64 px x 64 ch]; the W
//    slice [64 ch x Co] arrives by cp.async as the MN-major B panels. Two
//    warpgroups split Co (wgmma m64n64k16 or m64n128k16, f32 accumulators in
//    registers); the product of step n runs asynchronously while all
//    threads build step n + 1 in the second pair of buffers. On maps with
//    fewer tiles than the card has SMs, the channel chunks are split over
//    `split` blocks per tile (2, 4 or 8), launched as one thread block
//    cluster: each parks its partial sums in its shared memory, and the
//    blocks sum them through distributed shared memory, a slice of the
//    tile's rows each. (A first version added the parts into a zeroed output
//    with float2 atomics: one more kernel per call, and an order of summation
//    that changed from run to run.) A corner outside the window (only
//    possible for offsets beyond the clamp) gets weight 0 and a clamped
//    cell.
//  * The simple path (everything else): bf16 gathers 16-byte vectors from
//    device memory through L1 into a [64 x 64] tile per 64 output channels
//    and contracts on WMMA 16x16x16; f32 gathers per channel and contracts
//    with plain f32 FMA (full f32 products, as the TPU kernel's HIGHEST
//    precision).
// Later work: fusing the clamp and sigmoid of the offsets and mask.

#include <cooperative_groups.h>
#include <mma.h>

#include <cstdint>

#include "dcn_hopper.cuh"

namespace {

using dcn::kTaps;
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

// --------------------------------------------------------- bf16, wgmma ---

// Window cells and mask-folded bilinear weights of all 9 taps of the tile's
// pixels. A corner outside the image or the window (or a pixel past the
// image's edge) gets weight 0 and a clamped cell.
__device__ __forceinline__ void tile_corners_window(
    const float* __restrict__ offsets, const float* __restrict__ mask,
    const Tile& t, int H, int W, int wy0, int wx0, int ws,
    int (*s_cell)[TP][4], float (*s_cw)[TP][4]) {
  // three (tap, pixel) items a round, their loads started together: one trip
  // to device memory for the table
  constexpr int R = 3;
  for (int it0 = threadIdx.x; it0 < kTaps * TP; it0 += R * blockDim.x) {
    float m[R], oy[R], ox[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int it = it0 + j * blockDim.x;
      const long long p =
          it < kTaps * TP ? tile_pixel(t, it % TP, H, W) : -1;
      m[j] = oy[j] = ox[j] = 0.f;
      if (p >= 0) {
        const int k = it / TP;
        m[j] = __ldg(mask + p * kTaps + k);
        oy[j] = __ldg(offsets + p * 2 * kTaps + 2 * k);
        ox[j] = __ldg(offsets + p * 2 * kTaps + 2 * k + 1);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int it = it0 + j * blockDim.x;
      if (it >= kTaps * TP) break;
      const int k = it / TP;
      const int i = it % TP;
      const int y = t.y0 + i / TX;
      const int xx = t.x0 + i % TX;
      const float py =
          fminf(fmaxf((float)(y - 1 + k / 3) + oy[j], -2.f), (float)H + 1.f);
      const float px =
          fminf(fmaxf((float)(xx - 1 + k % 3) + ox[j], -2.f), (float)W + 1.f);
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
        const int cy = yc - wy0;
        const int cx = xc - wx0;
        const bool ok = yc >= 0 && yc < H && xc >= 0 && xc < W && cy >= 0 &&
                        cy < ws && cx >= 0 && cx < ws;
        s_cell[k][i][c] =
            min(max(cy, 0), ws - 1) * ws + min(max(cx, 0), ws - 1);
        s_cw[k][i][c] = ok ? wy * wx * m[j] : 0.f;
      }
    }
  }
}

constexpr int kPanel = TP * dcn::kPanelRowBytes;  // 64 rows of 128 bytes

inline size_t fwd_smem_bytes(int Co, int ws) {
  return 1024 + 2 * (size_t)kTaps * TP * 4 * 4 + (size_t)ws * ws * 128 +
         2 * ((size_t)kPanel + (size_t)64 * Co * 2);
}

// NB: 64-column blocks of Co per warpgroup (n64 or n128). THREADS: 256 (two
// pixels' samples per thread and step, two blocks per SM) or 512 (one; for
// Co = 256, whose buffers leave room for one block per SM). The first two
// warpgroups start the products.
template <int NB, int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS == 256 ? 2 : 1)
dcn_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ offsets,
                     const float* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ weight,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int H, int W, int Ci, int Co, int radius) {
  using namespace dcn;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + 1023) / 1024 * 1024);
  const int ws = TY + 2 * (radius + 1);
  const size_t b_bytes = (size_t)64 * Co * 2;
  unsigned char* s_a = base;                   // 2 x [64 px][128 B]
  unsigned char* s_b = s_a + 2 * kPanel;       // 2 x Co/64 x [64 ch][128 B]
  unsigned char* s_x = s_b + 2 * b_bytes;      // [ws*ws][128 B]
  int(*s_cell)[TP][4] =
      reinterpret_cast<int(*)[TP][4]>(s_x + (size_t)ws * ws * 128);
  float(*s_cw)[TP][4] = reinterpret_cast<float(*)[TP][4]>(
      reinterpret_cast<unsigned char*>(s_cell) + kTaps * TP * 4 * 4);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const bool active = wg * NB * 64 < Co;
  const Tile tile = block_tile(H, W);
  const int wy0 = tile.y0 - (radius + 1);
  const int wx0 = tile.x0 - (radius + 1);
  const int n_chunks = Ci / 64;
  const int split = gridDim.y;
  const int cg = tid & 7;
  const int p_lo = tid >> 3;

  tile_corners_window(offsets, mask, tile, H, W, wy0, wx0, ws, s_cell, s_cw);

  float acc[32 * NB];
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) acc[i] = 0.f;

  // W rows tap*Ci + [c0, c0 + 64), all Co, by cp.async: one [64 ch][64 co]
  // panel per 64 output channels, rows = input channels (MN-major B). Step
  // n's slice is requested right after step n - 1's product is started, so it
  // lands while step n's sample is built.
  const int lg_groups = 31 - __clz(Co / 8);  // Co / 8 is a power of two
  auto prefetch_w = [&](int step) {
    const int chunk = blockIdx.y + (step / kTaps) * split;
    if (chunk >= n_chunks) return;
    unsigned char* b_buf = s_b + (step & 1) * b_bytes;
    const __nv_bfloat16* src =
        weight + ((long long)(step % kTaps) * Ci + chunk * 64) * Co;
    for (int e = tid; e < (64 << lg_groups); e += THREADS) {
      const int c = e >> lg_groups;
      const int i = e & ((1 << lg_groups) - 1);
      cp_async16(b_buf + (i >> 3) * kPanel + panel_off(c, (i & 7) * 8),
                 src + (long long)c * Co + 8 * i);
    }
  };
  prefetch_w(0);

  int it = 0;
  for (int chunk = blockIdx.y; chunk < n_chunks; chunk += split) {
    const int c0 = chunk * 64;
    // The window of this chunk. Its last readers (the sample builds of the
    // previous chunk's last tap) passed that step's barrier already.
    // (four items a round, their loads started together: one trip to device
    // memory per round, not per item)
    for (int e0 = tid; e0 < ws * ws * 8; e0 += 4 * THREADS) {
      uint4 raw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = e0 + j * THREADS;
        const int cell = e >> 3;
        const int yy = wy0 + cell / ws;
        const int xx = wx0 + cell % ws;
        raw[j] = make_uint4(0u, 0u, 0u, 0u);
        if (e < ws * ws * 8 && yy >= 0 && yy < H && xx >= 0 && xx < W)
          raw[j] = __ldg(reinterpret_cast<const uint4*>(
              x + (((long long)tile.b * H + yy) * W + xx) * Ci + c0 +
              (e & 7) * 8));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = e0 + j * THREADS;
        if (e < ws * ws * 8)
          *reinterpret_cast<uint4*>(s_x + (size_t)e * 16) = raw[j];
      }
    }
    __syncthreads();
    for (int k = 0; k < kTaps; ++k, ++it) {
      unsigned char* a_buf = s_a + (it & 1) * kPanel;
      unsigned char* b_buf = s_b + (it & 1) * b_bytes;
      // the sampled tile: this thread's pixels, 8 channels each
#pragma unroll
      for (int p = p_lo; p < TP; p += THREADS / 8) {
        const int4 cell = *reinterpret_cast<const int4*>(s_cell[k][p]);
        const float4 cw = *reinterpret_cast<const float4*>(s_cw[k][p]);
        const int cells[4] = {cell.x, cell.y, cell.z, cell.w};
        const float cws[4] = {cw.x, cw.y, cw.z, cw.w};
        float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              s_x + (size_t)cells[c] * 128 + cg * 16);
          const __nv_bfloat162* h =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h[j]);
            sum[2 * j] += cws[c] * f.x;
            sum[2 * j + 1] += cws[c] * f.y;
          }
        }
        uint4 packed;
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = __floats2bfloat162_rn(sum[2 * j], sum[2 * j + 1]);
        *reinterpret_cast<uint4*>(a_buf + panel_off(p, cg * 8)) = packed;
      }
      // The previous step's product, still running on the other buffers
      // while these were filled, must be done before any thread refills
      // them after the barrier.
      if (active) wgmma_wait<0>();
      cp_async_wait_all();
      fence_async_proxy();
      __syncthreads();
      if (active) {
        const uint32_t a0 = smem_u32(a_buf);
        const uint32_t b0 = smem_u32(b_buf) + wg * NB * kPanel;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t da = panel_desc(a0 + ks * 32, 16, kGroupBytes);
          const uint64_t db =
              panel_desc(b0 + ks * 2 * kGroupBytes, kPanel, kGroupBytes);
          if constexpr (NB == 1)
            wgmma_n64<0, 1>(acc, da, db, 1);
          else
            wgmma_n128<0, 1>(acc, da, db, 1);
        }
        wgmma_commit();
      }
      // the other buffer's product finished before the barrier above
      prefetch_w(it + 1);
    }
  }

  if (active) wgmma_wait<0>();
  const int t = tid & 127;
  const int row = (t >> 5) * 16 + ((t & 31) >> 2);
  const int col = wg * NB * 64 + (t & 3) * 2;
  if (split == 1) {
    if (!active) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = tile_pixel(tile, row + 8 * h, H, W);
      if (p < 0) continue;
      float* dst = out + p * Co + col;
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * h] + bias[col + 8 * j],
                        acc[4 * j + 2 * h + 1] + bias[col + 8 * j + 1]);
    }
    return;
  }

  // The tile's `split` blocks are one thread block cluster: each parks its
  // partial [64 x Co] sums in its own shared memory (over the operand
  // buffers, which no product reads any more), and block r then sums rows
  // [64 r / split, 64 (r + 1) / split) over all the blocks through
  // distributed shared memory, adds the bias and writes them out. No
  // atomics, no zeroed output, and a fixed order of summation.
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  float* s_part = reinterpret_cast<float*>(base);  // [64][Co]
  __syncthreads();  // every warpgroup's products are done with the buffers
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j)
        *reinterpret_cast<float2*>(s_part + (row + 8 * h) * Co + col + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  cluster.sync();
  const int rows = TP / split;
  const int r0 = (int)cluster.block_rank() * rows;
  const int quads = Co / 4;
  for (int e = tid; e < rows * quads; e += THREADS) {
    const int pr = r0 + e / quads;
    const int c = (e % quads) * 4;
    const long long p = tile_pixel(tile, pr, H, W);
    if (p < 0) continue;
    float4 sum = *reinterpret_cast<const float4*>(bias + c);
    for (int q = 0; q < split; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(s_part, q) + pr * Co + c);
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    *reinterpret_cast<float4*>(out + p * Co + c) = sum;
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

template <int NB, int THREADS>
cudaError_t launch_wgmma(dim3 grid, int smem, cudaStream_t s,
                         const __nv_bfloat16* x, const float* offsets,
                         const float* mask, const __nv_bfloat16* weight,
                         const float* bias, float* out, int H, int W, int Ci,
                         int Co, int radius) {
  cudaError_t err =
      dcn::allow_smem((const void*)dcn_fwd_wgmma_kernel<NB, THREADS>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = grid.y;  // the tile's split: at most 8 blocks
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dcn_fwd_wgmma_kernel<NB, THREADS>, x, offsets,
                           mask, weight, bias, out, H, W, Ci, Co, radius);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes (centernet_tpu_torch/ops/dcn_cuda.py,
// whose launch_plan computes the ints after is_bf16). Launches on `stream`
// and returns cudaGetLastError() of the launch.
extern "C" int dcn_fwd(const void* x, const void* offsets, const void* mask,
                       const void* weight, const void* bias, void* out, int B,
                       int H, int W, int Ci, int Co, int is_bf16, int radius,
                       int fast, int split, int smem, void* stream) {
  const long long tiles =
      (long long)B * ((H + TY - 1) / TY) * ((W + TX - 1) / TX);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  const float* bs = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (fast) {
    const int ws = TY + 2 * (radius + 1);
    // the Python launch plan and this file must agree on the sizes
    if (!is_bf16 || Ci % 64 || !(Co == 64 || Co == 128 || Co == 256) ||
        radius < 1 || split < 1 || split > 8 || (Ci / 64) % split ||
        (size_t)smem != fwd_smem_bytes(Co, ws))
      return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles, (unsigned)split);
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(weight);
    if (Co == 256)
      return (int)launch_wgmma<2, 512>(grid, smem, s, xb, off, msk, wb, bs,
                                       o, H, W, Ci, Co, radius);
    return (int)launch_wgmma<1, 256>(grid, smem, s, xb, off, msk, wb, bs, o,
                                     H, W, Ci, Co, radius);
  }
  if (split != 1 || smem != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)((Co + TCO - 1) / TCO));
  if (is_bf16) {
    dcn_fwd_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), off, msk,
        static_cast<const __nv_bfloat16*>(weight), bs, o, H, W, Ci, Co);
  } else {
    dcn_fwd_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), off, msk,
        static_cast<const float*>(weight), bs, o, H, W, Ci, Co);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dcn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
