// Modulated deformable 3x3 convolution (DCNv2) backward for Hopper (sm_90a).
//
// Replaces the TPU kernel centernet_tpu/ops/dcn_pallas.py:414 (_bwd_kernel,
// launched by pallas_deform_conv_bwd -> _pallas_bwd_single). Given the
// forward's inputs (offsets already clamped to [-r, r - 1/64], see
// dcn_fwd.cu) and the output cotangent g [B, H, W, Co] f32, it computes for
// every pixel p, tap k and input channel c, with col the bilinear sample of
// x and m the mask:
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
// full f32 product (the TPU kernel's HIGHEST precision; no TF32).
//
// Layouts: x [B, H, W, Ci] (bf16 or f32); offsets [B, H, W, 18] f32;
// mask [B, H, W, 9] f32; W [9*Ci, Co] tap-major in x's type; g [B, H, W, Co]
// f32. Outputs, all f32: dx [B, H, W, Ci], dty, dtx, dmask [B, H, W, 9], zeroed
// by the caller, and dW [9*Ci, Co], zeroed by the first launch.
//
// Bound on the H100: at 128x128 C64->64, B4, the inputs and outputs move
// about 48 MB (14 us at 3.35 TB/s) and the sampling's multiply-adds take
// about 21 us on the f32 pipes; the two contractions are 4.8 GFLOP, 5 us on
// the bf16 tensor cores. What costs beyond the bound is the gather of 9 taps
// x 4 corners of a Ci vector per pixel, the scatter of the same into dx, and
// the reduction of dW over every pixel.
//
// Design: two launches, nothing of size [pixels, 9*Ci] ever leaves the chip.
//
//  1. dcn_bwd_dx_kernel (512 threads): a block owns an 8x8 tile of pixels of
//     one image and one chunk of KC input channels (64 in bf16, 32 in f32),
//     so the small maps with many channels still fill the card. It stages,
//     once: the tile's g (rounded to the compute type); a table of each
//     (pixel, tap)'s corner cells, fractions and mask; and the x window that
//     every sample of the tile can touch: the tile plus r + 1 cells each
//     side, r the offsets' clamp radius. Per tap it forms the gk tile
//     [64 x KC] = g_tile . W_k^T (bf16: wgmma m64n64k16 from 128-byte
//     swizzled shared memory, the next tap's W slice arriving by cp.async
//     meanwhile; f32 and odd shapes: FMA), parks it in shared memory in f32,
//     and samples: a thread owns a pixel and 16 bytes of channels, reads the
//     4 corners from the window with 16-byte loads (the 8 lanes of a pixel
//     read one 128-byte run: no bank conflict), sums dmask, dty, dtx over
//     its channels and then over the pixel's 8 lanes by shuffles, and keeps
//     round(gk * m) of all 9 taps in shared memory.
//     dx is then a gather, not a scatter: the tile's 4 * 9 * 64 corners were
//     sorted by window cell when the table was built (a counting sort with
//     integer shared-memory atomics), so a thread owns a window cell and 16
//     bytes of channels, sums w_corner * round(gk * m) over the cell's
//     entries in registers, and adds the sum to dx once with float4 atomics:
//     2 per cell and 8 channels, against 36 scalar atomics per pixel and
//     channel of a direct scatter. (A first version that scattered into an
//     f32 window with shared-memory float atomics took 1.44 ms at 128x128
//     C64, B4; the gather took 0.31 ms.) Neighbouring tiles' windows overlap,
//     so dx stays f32 in device memory: the overlapping sums have to be added
//     in f32 before the one rounding to x's type, which the wrapper applies.
//     A corner outside the window (only possible for offsets beyond the
//     clamp) is dropped like one outside the image: a defined result, never
//     an access outside shared memory. With more than one channel chunk,
//     dty, dtx and dmask are summed over the chunks' blocks by atomics
//     (Ci / KC per element). The launch also zeroes dW for the next one.
//  2. dcn_bwd_dw_kernel: a block owns one tap, one channel chunk and a
//     strided share of the pixel tiles. Per tile it samples col * m (rounded)
//     straight into the swizzled layout of an MN-major A operand [64 px x KC]
//     and stages g as the MN-major B operand [64 px x Co]; dW_k[chunk, :] +=
//     A^T . B runs on wgmma (m64, n64 or n128 per warpgroup, 4 k16 steps)
//     while the next tile is sampled into the other buffer. The accumulator
//     stays in registers over all the block's tiles and is flushed once, so
//     each dW element takes `splits` atomics (two blocks per SM; the launch
//     plan picks the splits that make waves x tiles per block least: one
//     wave over the 9 * Ci / KC (tap, chunk) pairs at the bf16 shapes, 29
//     splits at C64, 14 at C128, 7 at C256, 3 at C512 on 132 SMs). A warp
//     works out each of its 8 pixels' corners once and shares them by
//     shuffles; the offsets and mask are fetched a tile ahead. The sampling
//     is done a second time here rather than carried through device memory.
//
// The fast (wgmma) path takes bf16 with Ci a multiple of 64 and Co of 64,
// 128 or 256; everything else (f32, ragged channels) runs the same two
// kernels with FMA products, KC channels at a time, the next piece's or
// tile's operands fetched into registers while the current product runs.
// Both launches are bound by latency (one or two blocks per SM between
// barriers), so loads from device memory are started several at a time and
// consumed afterwards wherever a loop stages data.

#include "dcn_hopper.cuh"

#include <cstdint>
#include <type_traits>

namespace {

using namespace dcn;

constexpr int kThreads = 256;    // the dW launch
constexpr int kDxThreads = 512;  // the dx launch: a thread per (pixel, 16 B)
constexpr int TS = 8;        // tile side
constexpr int TP = TS * TS;  // pixels per tile
constexpr int COB = 64;      // output channels per piece of the FMA gk product
constexpr int LDP = COB + 4;  // its tiles' row stride: float4-aligned rows
constexpr int DWO = 64;      // output channels per block of the FMA dW product

template <typename T>
struct Cfg {
  static constexpr int V = 16 / (int)sizeof(T);  // channels per 16 bytes
  static constexpr int KC = 8 * V;               // channels per chunk
  static constexpr int GKS = KC + 4;               // row of the gk tile
  // FMA gk product: 16 outputs a thread, so TP * KC / 16 threads cover the
  // tile and the launch's 512 threads split the contraction KG ways
  static constexpr int KG = 128 / KC;
};

// One bilinear corner of one (pixel, tap) of a tile: its weight and the row
// p * 9 + k of the tile's gk * m table. Sorted by window cell, the entries
// turn the dx scatter into a gather.
struct Entry {
  float w;
  int row;
};
constexpr int kEntries = TP * kTaps * 4;

// One (pixel, tap) of a tile, computed once per block: the window cells of
// its 4 corners (kNoCell for a corner outside the image or the window), the
// sample point's fractions and the mask.
struct TapGeo {
  unsigned short cell[4];
  float ly, lx, m;
};
constexpr unsigned short kNoCell = 0xFFFF;

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(int t, int H, int W) {
  const int tiles_x = (W + TS - 1) / TS;
  const int tiles = ((H + TS - 1) / TS) * tiles_x;
  const int r = t % tiles;
  return {t / tiles, (r / tiles_x) * TS, (r % tiles_x) * TS};
}

// Flat pixel (b*H + y)*W + x of the tile's pixel i, or -1 past the edge.
__device__ __forceinline__ long long tile_pixel(const Tile& t, int i, int H,
                                                int W) {
  const int y = t.y0 + i / TS;
  const int x = t.x0 + i % TS;
  if (y >= H || x >= W) return -1;
  return ((long long)t.b * H + y) * W + x;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw,
                                       float (&out)[Cfg<T>::V]) {
  if constexpr (std::is_same<T, bf16>::value) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  } else {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&v)[Cfg<T>::V]) {
  uint4 raw;
  if constexpr (std::is_same<T, bf16>::value) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  } else {
    raw.x = __float_as_uint(v[0]);
    raw.y = __float_as_uint(v[1]);
    raw.z = __float_as_uint(v[2]);
    raw.w = __float_as_uint(v[3]);
  }
  return raw;
}

// 16 bytes of channels [c, c + V) of a pixel's row `p` (Ci channels) from
// device memory; channels at or past Ci read as 0. `vec_ok`: Ci is a multiple
// of V and the base is 16-byte aligned.
template <typename T>
__device__ __forceinline__ uint4 load_channels(const T* __restrict__ p, int c,
                                               int Ci, bool vec_ok) {
  constexpr int V = Cfg<T>::V;
  if (vec_ok)
    return c < Ci ? __ldg(reinterpret_cast<const uint4*>(p + c))
                  : make_uint4(0u, 0u, 0u, 0u);
  float v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = c + i < Ci ? to_f(p[c + i]) : 0.f;
  return pack<T>(v);
}

// The 4 bilinear corners of a sample at (py, px): whether each lies inside
// the image, its value weight wy * wx (0 outside), and the point's
// fractions, from which the sampling pass forms the weights' derivatives by
// py and px (-+wx and -+wy).
struct Corners {
  int yc[4], xc[4];
  bool valid[4];
  float ly, lx;
  float vw[4];
};

__device__ __forceinline__ Corners corners_at(float py, float px, int H,
                                              int W) {
  // Keep the float->int conversion defined; every corner of a position
  // beyond these limits lies outside the image (as dcn_fwd.cu).
  py = fminf(fmaxf(py, -2.f), (float)H + 1.f);
  px = fminf(fmaxf(px, -2.f), (float)W + 1.f);
  const float y0f = floorf(py);
  const float x0f = floorf(px);
  const float ly = py - y0f;
  const float lx = px - x0f;
  const int y0 = (int)y0f;
  const int x0 = (int)x0f;
  Corners c;
  c.ly = ly;
  c.lx = lx;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int dy = j >> 1;
    const int dxc = j & 1;
    c.yc[j] = y0 + dy;
    c.xc[j] = x0 + dxc;
    c.valid[j] = c.yc[j] >= 0 && c.yc[j] < H && c.xc[j] >= 0 && c.xc[j] < W;
    const float v = c.valid[j] ? 1.f : 0.f;
    const float wy = dy ? ly : 1.f - ly;
    const float wx = dxc ? lx : 1.f - lx;
    c.vw[j] = v * wy * wx;
  }
  return c;
}

// g tile [64 px x Co] f32 -> bf16 row panels (one per 64 channels), rows =
// pixels: the K-major A operand of gk = g . W^T and the MN-major B operand
// of dW = colm^T . g alike.
__device__ __forceinline__ void stage_g_panels(const float* __restrict__ g,
                                               const Tile& t, int H, int W,
                                               int Co, unsigned char* s_g) {
  const int lg = 31 - __clz(Co / 8);  // Co / 8 is a power of two here
  const int n = TP << lg;
  // two items a round, their loads started together: one trip to device
  // memory per round
  for (int it0 = threadIdx.x; it0 < n; it0 += 2 * blockDim.x) {
    float4 a[2], b[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int it = it0 + j * blockDim.x;
      a[j] = b[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      const long long pix = it < n ? tile_pixel(t, it >> lg, H, W) : -1;
      if (pix >= 0) {
        const float4* src = reinterpret_cast<const float4*>(
            g + pix * Co + 8 * (it & ((1 << lg) - 1)));
        a[j] = __ldg(src);
        b[j] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int it = it0 + j * blockDim.x;
      if (it >= n) break;
      const int p = it >> lg;
      const int i = it & ((1 << lg) - 1);
      const float v[8] = {a[j].x, a[j].y, a[j].z, a[j].w,
                          b[j].x, b[j].y, b[j].z, b[j].w};
      *reinterpret_cast<uint4*>(s_g + (i >> 3) * (TP * kPanelRowBytes) +
                                panel_off(p, (i & 7) * 8)) = pack<bf16>(v);
    }
  }
}

// 4 neighbouring output channels [o, o + 4) of pixel `pix`'s row of g; zeros
// for a pixel past the image's edge (pix < 0) and for channels at or past Co.
__device__ __forceinline__ float4 load_g4(const float* __restrict__ g,
                                          long long pix, int o, int Co) {
  float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (pix < 0) return gv;
  const float* src = g + pix * Co + o;
  if (Co % 4 == 0 && o < Co) return __ldg(reinterpret_cast<const float4*>(src));
  if (o < Co) gv.x = src[0];
  if (o + 1 < Co) gv.y = src[1];
  if (o + 2 < Co) gv.z = src[2];
  if (o + 3 < Co) gv.w = src[3];
  return gv;
}

inline __host__ __device__ size_t align_up(size_t v, size_t a) {
  return (v + a - 1) / a * a;
}

// ------------------------------------------------------------ dx kernel ---

template <typename T, bool FAST>
__host__ __device__ inline size_t dx_smem_bytes(int Co, int ws) {
  using C = Cfg<T>;
  const size_t g_bytes = FAST ? (size_t)TP * Co * 2 : (size_t)TP * LDP * 4;
  const size_t w_bytes =
      FAST ? (size_t)C::KC * Co * 2 : (size_t)C::KC * LDP * 4;
  return 1024 + align_up(g_bytes, 16) + align_up(w_bytes, 16) +
         (size_t)(FAST ? 1 : C::KG) * TP * C::GKS * 4 +
         (size_t)TP * kTaps * sizeof(TapGeo) +
         (size_t)ws * ws * C::KC * sizeof(T) +
         (size_t)TP * kTaps * C::KC * sizeof(T) + (size_t)kEntries * 8 +
         align_up((size_t)2 * ws * ws * 4, 16);
}

template <typename T, bool FAST>
__global__ void __launch_bounds__(kDxThreads, 1) dcn_bwd_dx_kernel(
    const T* __restrict__ x, const float* __restrict__ offsets,
    const float* __restrict__ mask, const T* __restrict__ weight,
    const float* __restrict__ g, float* __restrict__ dx,
    float* __restrict__ dty, float* __restrict__ dtx,
    float* __restrict__ dmask, float* __restrict__ dw, int H, int W, int Ci,
    int Co, int radius, int n_chunks) {
  using C = Cfg<T>;
  constexpr int V = C::V, KC = C::KC, GKS = C::GKS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      align_up(reinterpret_cast<size_t>(smem_raw), 1024));
  const int ws = TS + 2 * (radius + 1);
  const int cells = ws * ws;
  const size_t g_bytes =
      align_up(FAST ? (size_t)TP * Co * 2 : (size_t)TP * LDP * 4, 16);
  const size_t w_bytes = align_up(
      FAST ? (size_t)KC * Co * 2 : (size_t)KC * LDP * 4, 16);
  unsigned char* s_g = base;
  unsigned char* s_w = s_g + g_bytes;
  float* s_gk = reinterpret_cast<float*>(s_w + w_bytes);  // [TP][GKS]
  TapGeo* s_geo = reinterpret_cast<TapGeo*>(
      s_gk + (FAST ? 1 : C::KG) * TP * GKS);  // [TP * 9]
  T* s_x = reinterpret_cast<T*>(s_geo + TP * kTaps);           // [cells][KC]
  T* s_gd = s_x + cells * KC;                             // [TP * 9][KC]
  Entry* s_ent = reinterpret_cast<Entry*>(s_gd + TP * kTaps * KC);
  int* s_start = reinterpret_cast<int*>(s_ent + kEntries);  // [cells]
  int* s_end = s_start + cells;                             // [cells]

  const int tid = threadIdx.x;
  const Tile tile = tile_of(blockIdx.x, H, W);
  const int c0 = blockIdx.y * KC;
  const int wy0 = tile.y0 - (radius + 1);
  const int wx0 = tile.x0 - (radius + 1);
  const bool vec_ok = Ci % V == 0;

  // W_k rows [c0, c0 + KC) x Co as the K-major B operand (rows = input
  // channels, one panel per 64 output channels), by cp.async.
  auto prefetch_w = [&](int k) {
    if constexpr (FAST) {
      const int lg = 31 - __clz(Co / 8);  // Co / 8 is a power of two here
      for (int it = tid; it < (KC << lg); it += kDxThreads) {
        const int c = it >> lg;
        const int i = it & ((1 << lg) - 1);
        cp_async16(s_w + (i >> 3) * (KC * kPanelRowBytes) +
                       panel_off(c, (i & 7) * 8),
                   weight + ((long long)k * Ci + c0 + c) * Co + 8 * i);
      }
    }
  };

  // dW is accumulated by the next launch on the stream: zero it here
  {
    const long long n = (long long)kTaps * Ci * Co;
    const long long stride = (long long)gridDim.x * gridDim.y * kDxThreads;
    for (long long i = ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                           kDxThreads + tid;
         i < n; i += stride)
      dw[i] = 0.f;
  }

  // ---- stage the tile: x window, offsets and mask, g ----
  // (every loop below starts the loads of a round together and stores them
  // afterwards: one trip to device memory per round, not per item)
  for (int it = tid; it < cells; it += kDxThreads) s_end[it] = 0;
  constexpr int GR = (TP * kTaps + kDxThreads - 1) / kDxThreads;
  float oy[GR], ox[GR], mk[GR];
#pragma unroll
  for (int j = 0; j < GR; ++j) {
    const int it = tid + j * kDxThreads;
    const long long pix =
        it < TP * kTaps ? tile_pixel(tile, it / kTaps, H, W) : -1;
    oy[j] = ox[j] = mk[j] = 0.f;
    if (pix >= 0) {
      const long long pk = pix * kTaps + it % kTaps;
      oy[j] = __ldg(offsets + 2 * pk);
      ox[j] = __ldg(offsets + 2 * pk + 1);
      mk[j] = __ldg(mask + pk);
    }
  }
  constexpr int WR = 6;  // a round takes the whole window up to radius 4
  for (int it0 = tid; it0 < cells * 8; it0 += WR * kDxThreads) {
    uint4 raw[WR];
#pragma unroll
    for (int j = 0; j < WR; ++j) {
      const int it = it0 + j * kDxThreads;
      const int cell = it >> 3;
      const int yy = wy0 + cell / ws;
      const int xx = wx0 + cell % ws;
      raw[j] = make_uint4(0u, 0u, 0u, 0u);
      if (it < cells * 8 && yy >= 0 && yy < H && xx >= 0 && xx < W)
        raw[j] =
            load_channels<T>(x + (((long long)tile.b * H + yy) * W + xx) * Ci,
                             c0 + (it & 7) * V, Ci, vec_ok);
    }
#pragma unroll
    for (int j = 0; j < WR; ++j) {
      const int it = it0 + j * kDxThreads;
      if (it < cells * 8) *reinterpret_cast<uint4*>(s_x + it * V) = raw[j];
    }
  }
#pragma unroll
  for (int j = 0; j < GR; ++j) {
    const int it = tid + j * kDxThreads;
    if (it >= TP * kTaps) break;
    const int p = it / kTaps;
    const int k = it % kTaps;
    TapGeo geo{{kNoCell, kNoCell, kNoCell, kNoCell}, 0.f, 0.f, 0.f};
    if (tile_pixel(tile, p, H, W) >= 0) {
      const Corners cn =
          corners_at((float)(tile.y0 + p / TS - 1 + k / 3) + oy[j],
                     (float)(tile.x0 + p % TS - 1 + k % 3) + ox[j], H, W);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int wy = cn.yc[c] - wy0;
        const int wx = cn.xc[c] - wx0;
        if (cn.valid[c] && wy >= 0 && wy < ws && wx >= 0 && wx < ws)
          geo.cell[c] = (unsigned short)(wy * ws + wx);
      }
      geo.ly = cn.ly;
      geo.lx = cn.lx;
      geo.m = mk[j];
    }
    s_geo[it] = geo;
  }
  if constexpr (FAST) {
    stage_g_panels(g, tile, H, W, Co, s_g);
    prefetch_w(0);
  }
  __syncthreads();

  // ---- the tile's corners, sorted by window cell ----
  // `visit` calls f(cell, weight, row) for every corner with a weight of
  // every (pixel, tap) this thread owns; the same walk counts, then fills.
  auto visit = [&](auto f) {
    for (int it = tid; it < TP * kTaps; it += kDxThreads) {
      const TapGeo geo = s_geo[it];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = ((j >> 1) ? geo.ly : 1.f - geo.ly) *
                        ((j & 1) ? geo.lx : 1.f - geo.lx);
        if (geo.cell[j] != kNoCell && w != 0.f) f(geo.cell[j], w, it);
      }
    }
  };
  visit([&](int cell, float, int) { atomicAdd(s_end + cell, 1); });
  __syncthreads();
  if (tid < 32) {  // exclusive scan of the counts: a run per lane, then lanes
    const int per = (cells + 31) / 32;
    const int lo = min(tid * per, cells);
    const int hi = min(lo + per, cells);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += s_end[i];
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (tid >= d) incl += up;
    }
    int run = incl - sum;
    for (int i = lo; i < hi; ++i) {
      const int n = s_end[i];
      s_start[i] = run;
      s_end[i] = run;  // the fill's cursor; ends at the cell's end
      run += n;
    }
  }
  __syncthreads();
  visit([&](int cell, float w, int row) {
    s_ent[atomicAdd(s_end + cell, 1)] = Entry{w, row};
  });
  // (the tap loop's first barrier orders the entries before their readers)

  // sampling: this thread's pixel and its 16 bytes of channels
  const int cg = tid & 7;
  const int p = tid >> 3;

  // FMA products: this thread's float4s of the piece (tap kk, output channels
  // [oo, oo + COB)) of W [KC x COB] and, where g is staged per piece, of the
  // g tile [TP x COB], from device memory into registers.
  constexpr int NW = KC * COB / 4 / kDxThreads;
  constexpr int NG = TP * COB / 4 / kDxThreads;
  float4 w_next[NW], g_next[NG];
  auto fetch_piece = [&](int kk, int oo) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int it = tid + j * kDxThreads;
      const int c = c0 + it / (COB / 4);
      const int o = oo + (it % (COB / 4)) * 4;
      const T* src = weight + ((long long)kk * Ci + c) * Co + o;
      float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < Ci) {
        if (std::is_same<T, float>::value && Co % 4 == 0 && o < Co) {
          wv = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          if (o < Co) wv.x = to_f(src[0]);
          if (o + 1 < Co) wv.y = to_f(src[1]);
          if (o + 2 < Co) wv.z = to_f(src[2]);
          if (o + 3 < Co) wv.w = to_f(src[3]);
        }
      }
      w_next[j] = wv;
    }
    if (kk == 0 || Co > COB) {
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int it = tid + j * kDxThreads;
        g_next[j] = load_g4(g, tile_pixel(tile, it / (COB / 4), H, W),
                            oo + (it % (COB / 4)) * 4, Co);
      }
    }
  };

  for (int k = 0; k < kTaps; ++k) {
    // ---- gk tile [TP x KC] = g_tile . W_k^T -> s_gk (f32) ----
    if constexpr (FAST) {
      cp_async_wait_all();
      fence_async_proxy();
      __syncthreads();  // W_k and (k = 0) the staged tile are in place; the
                        // previous tap's readers of s_gk are done
      if (tid < 128) {
        // The first step overwrites the accumulators (scale_d = 0) and
        // nothing else defines them: registers set by other instructions
        // between the steps would make each wait for the one before.
        float acc[32];
        const uint32_t a0 = smem_u32(s_g);
        const uint32_t b0 = smem_u32(s_w);
        wgmma_fence();
        for (int j = 0; j < Co / 16; ++j) {
          const uint32_t off =
              (j >> 2) * (TP * kPanelRowBytes) + (j & 3) * 32;
          wgmma_n64<0, 0>(acc, panel_desc(a0 + off, 16, kGroupBytes),
                          panel_desc(b0 + off, 16, kGroupBytes), j > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        const int row = (tid >> 5) * 16 + ((tid & 31) >> 2);
        const int col = (tid & 3) * 2;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float2*>(s_gk + row * GKS + 8 * j + col) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(s_gk + (row + 8) * GKS + 8 * j + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      __syncthreads();
      if (k + 1 < kTaps) prefetch_w(k + 1);  // lands during the sampling
    } else {
      // A thread owns 4 pixels x 4 channels of the gk tile (pixels ty + 16 r,
      // channels tx + CG q: a warp's lanes read neighbouring rows of LDP
      // floats, which lie 4 banks apart, so its float4 loads do not collide)
      // and reads both operands as float4 runs along the contraction; the
      // launch's KG groups of TP * KC / 16 threads each take a share of the
      // contraction and their partial tiles are summed in shared memory. The
      // next piece's operands are fetched into registers before this piece's
      // product and stored after it, so their trip to device memory is
      // hidden behind the product (and the sampling, across taps).
      constexpr int CG = KC / 4;        // column groups
      constexpr int PT = TP * KC / 16;  // threads that cover the tile
      constexpr int KG = C::KG;
      constexpr int OSHARE = COB / KG;  // a group's share of a piece
      float* sg = reinterpret_cast<float*>(s_g);  // [TP][LDP]
      float* sw = reinterpret_cast<float*>(s_w);  // [KC][LDP]
      const int kg = tid / PT;
      const int ty = (tid % PT) / CG;
      const int tx = tid % CG;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      if (k == 0) fetch_piece(0, 0);
      for (int o0 = 0; o0 < Co; o0 += COB) {
        __syncthreads();  // the previous piece's (and tap's) readers are done
        const bool fresh_g = k == 0 || Co > COB;  // one piece: g stays
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int it = tid + j * kDxThreads;
          *reinterpret_cast<float4*>(sw + (it / (COB / 4)) * LDP +
                                     (it % (COB / 4)) * 4) = w_next[j];
        }
        if (fresh_g) {
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            const int it = tid + j * kDxThreads;
            *reinterpret_cast<float4*>(sg + (it / (COB / 4)) * LDP +
                                       (it % (COB / 4)) * 4) =
                make_float4(round_to<T>(g_next[j].x), round_to<T>(g_next[j].y),
                            round_to<T>(g_next[j].z), round_to<T>(g_next[j].w));
          }
        }
        __syncthreads();
        if (o0 + COB < Co)
          fetch_piece(k, o0 + COB);
        else if (k + 1 < kTaps)
          fetch_piece(k + 1, 0);
#pragma unroll 2
        for (int o = kg * OSHARE; o < (kg + 1) * OSHARE; o += 4) {
          float4 av[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            av[r] =
                *reinterpret_cast<const float4*>(sg + (ty + 16 * r) * LDP + o);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bv[q] =
                *reinterpret_cast<const float4*>(sw + (tx + CG * q) * LDP + o);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[r][q] += av[r].x * bv[q].x;
              acc[r][q] += av[r].y * bv[q].y;
              acc[r][q] += av[r].z * bv[q].z;
              acc[r][q] += av[r].w * bv[q].w;
            }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s_gk[(kg * TP + ty + 16 * r) * GKS + tx + CG * q] = acc[r][q];
      __syncthreads();
      for (int it = tid; it < TP * CG; it += kDxThreads) {
        float* dst = s_gk + (it / CG) * GKS + (it % CG) * 4;
        float4 sum = *reinterpret_cast<const float4*>(dst);
#pragma unroll
        for (int j = 1; j < KG; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(dst + j * TP * GKS);
          sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
        }
        *reinterpret_cast<float4*>(dst) = sum;
      }
      __syncthreads();
    }

    // ---- sampling: col and its derivatives against gk ----
    {
      const long long pix = tile_pixel(tile, p, H, W);
      const TapGeo geo = s_geo[p * kTaps + k];
      const float m = geo.m;
      float col[V], uy[V], ux[V];
#pragma unroll
      for (int i = 0; i < V; ++i) col[i] = uy[i] = ux[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = geo.cell[j] != kNoCell ? 1.f : 0.f;
        const int cell = geo.cell[j] != kNoCell ? geo.cell[j] : 0;
        const float wy = (j >> 1) ? geo.ly : 1.f - geo.ly;
        const float wx = (j & 1) ? geo.lx : 1.f - geo.lx;
        const float vw = v * wy * wx;
        const float yw = v * ((j >> 1) ? wx : -wx);
        const float xw = v * ((j & 1) ? wy : -wy);
        float xv[V];
        unpack<T>(*reinterpret_cast<const uint4*>(s_x + cell * KC + cg * V),
                  xv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          col[i] += vw * xv[i];
          uy[i] += yw * xv[i];
          ux[i] += xw * xv[i];
        }
      }
      float gd[V];
      float sum_m = 0.f, sum_y = 0.f, sum_x = 0.f;
      float gks[V];
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        const float4 q =
            *reinterpret_cast<const float4*>(s_gk + p * GKS + cg * V + i);
        gks[i] = q.x, gks[i + 1] = q.y, gks[i + 2] = q.z, gks[i + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float gv = gks[i];
        const float gm = gv * m;
        sum_m += col[i] * gv;
        sum_y += uy[i] * gm;
        sum_x += ux[i] * gm;
        gd[i] = gm;
      }
      // gk * m, rounded, for the dx gather below
      *reinterpret_cast<uint4*>(s_gd + (p * kTaps + k) * KC + cg * V) =
          pack<T>(gd);
#pragma unroll
      for (int s = 4; s > 0; s >>= 1) {
        sum_m += __shfl_xor_sync(0xffffffffu, sum_m, s);
        sum_y += __shfl_xor_sync(0xffffffffu, sum_y, s);
        sum_x += __shfl_xor_sync(0xffffffffu, sum_x, s);
      }
      if (cg == 0 && pix >= 0) {
        const long long pk = pix * kTaps + k;
        if (n_chunks > 1) {
          atomicAdd(dmask + pk, sum_m);
          atomicAdd(dty + pk, sum_y);
          atomicAdd(dtx + pk, sum_x);
        } else {
          dmask[pk] = sum_m;
          dty[pk] = sum_y;
          dtx[pk] = sum_x;
        }
      }
    }
  }

  // ---- dx: a thread owns a window cell and 16 bytes of channels, sums the
  // cell's entries in registers and adds the sum to dx once (neighbouring
  // tiles' windows overlap, so the add is atomic) ----
  __syncthreads();
  const bool dx_vec = Ci % V == 0;
  for (int it = tid; it < cells * 8; it += kDxThreads) {
    const int cell = it >> 3;
    const int c = c0 + (it & 7) * V;
    const int beg = s_start[cell];
    const int end = s_end[cell];
    if (beg == end || c >= Ci) continue;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    // four entries a round, their loads independent of each other: the
    // walk is bound by the latency of entry -> row -> sum
    for (int e = beg; e < end; e += 4) {
      Entry ent[4];
      uint4 raw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ent[j] = e + j < end ? s_ent[e + j] : Entry{0.f, 0};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        raw[j] = *reinterpret_cast<const uint4*>(s_gd + ent[j].row * KC +
                                                 (it & 7) * V);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (e + j >= end) break;
        float gd[V];
        unpack<T>(raw[j], gd);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += ent[j].w * gd[i];
      }
    }
    const int yy = wy0 + cell / ws;
    const int xx = wx0 + cell % ws;
    float* dst = dx + (((long long)tile.b * H + yy) * W + xx) * Ci + c;
    if (dx_vec) {
#pragma unroll
      for (int i = 0; i < V; i += 4)
        atomicAdd(reinterpret_cast<float4*>(dst + i),
                  make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]));
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (c + i < Ci) atomicAdd(dst + i, acc[i]);
    }
  }
}

// ------------------------------------------------------------ dW kernel ---

template <typename T, bool FAST>
__host__ __device__ inline size_t dw_smem_bytes(int Co) {
  using C = Cfg<T>;
  if (FAST)
    return 1024 + 2 * ((size_t)TP * kPanelRowBytes + (size_t)TP * Co * 2);
  return (size_t)TP * C::KC * 4 + (size_t)TP * DWO * 4;
}

// The 4 corners of tap k at the tile's pixel p as device-memory pixel indices
// (clamped into the image), their bilinear weights (0 outside the image)
// and the mask; all zeros for a pixel past the image's edge.
struct TapSample {
  int pix[4];
  float vw[4];
  float m;
};

// The offsets and mask of tap k at the tile's pixel p, as loaded: fetched a
// tile ahead of their use, so that the trip to device memory is hidden
// behind the current tile's work.
struct TapRaw {
  float oy, ox, m;
  bool inside;  // false for a pixel past the image's edge
};

__device__ __forceinline__ TapRaw load_tap(const float* __restrict__ offsets,
                                           const float* __restrict__ mask,
                                           const Tile& tile, int p, int k,
                                           int H, int W) {
  const long long pix = tile_pixel(tile, p, H, W);
  if (pix < 0) return {0.f, 0.f, 0.f, false};
  const long long pk = pix * kTaps + k;
  return {__ldg(offsets + 2 * pk), __ldg(offsets + 2 * pk + 1),
          __ldg(mask + pk), true};
}

__device__ __forceinline__ TapSample tap_sample(const TapRaw& raw,
                                                const Tile& tile, int p, int k,
                                                int H, int W) {
  TapSample t{{0, 0, 0, 0}, {0.f, 0.f, 0.f, 0.f}, 0.f};
  if (!raw.inside) return t;
  t.m = raw.m;
  const Corners cn =
      corners_at((float)(tile.y0 + p / TS - 1 + k / 3) + raw.oy,
                 (float)(tile.x0 + p % TS - 1 + k % 3) + raw.ox, H, W);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t.pix[j] = (tile.b * H + min(max(cn.yc[j], 0), H - 1)) * W +
               min(max(cn.xc[j], 0), W - 1);
    t.vw[j] = cn.vw[j];
  }
  return t;
}

// A warp samples 8 pixels of a tile (4 per half, 8 lanes each): lane s < 8
// works out pixel slot s once, and every lane fetches its pixel's slot by
// shuffles instead of repeating the geometry 8 times.
__device__ __forceinline__ TapSample share_tap_sample(const TapSample& mine,
                                                      int slot) {
  TapSample t;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t.pix[j] = __shfl_sync(0xffffffffu, mine.pix[j], slot);
    t.vw[j] = __shfl_sync(0xffffffffu, mine.vw[j], slot);
  }
  t.m = __shfl_sync(0xffffffffu, mine.m, slot);
  return t;
}

// col * m of a sampled tap, rounded to T, from the 4 corners' 16 bytes of
// channels as loaded.
template <typename T>
__device__ __forceinline__ void combine_colm(const uint4 (&raw)[4],
                                             const TapSample& t,
                                             float (&out)[Cfg<T>::V]) {
  constexpr int V = Cfg<T>::V;
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float xv[V];
    unpack<T>(raw[j], xv);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] += t.vw[j] * xv[i];
  }
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = round_to<T>(out[i] * t.m);
}

// The same for channels [c, c + V) of x.
template <typename T>
__device__ __forceinline__ void gather_colm(const T* __restrict__ x,
                                            const TapSample& t, int c, int Ci,
                                            bool vec_ok,
                                            float (&out)[Cfg<T>::V]) {
  uint4 raw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    raw[j] = load_channels<T>(x + (size_t)t.pix[j] * Ci, c, Ci, vec_ok);
  combine_colm<T>(raw, t, out);
}

// NB: 64-column blocks of Co per warpgroup on the fast path (n64 or n128).
template <typename T, bool FAST, int NB>
__global__ void __launch_bounds__(kThreads, 2) dcn_bwd_dw_kernel(
    const T* __restrict__ x, const float* __restrict__ offsets,
    const float* __restrict__ mask, const float* __restrict__ g,
    float* __restrict__ dw, int H, int W, int Ci, int Co, int n_chunks,
    int co_pieces, int n_tiles) {
  using C = Cfg<T>;
  constexpr int V = C::V, KC = C::KC;
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int k = blockIdx.x / (n_chunks * co_pieces);
  const int c0 = (blockIdx.x / co_pieces) % n_chunks * KC;
  const int o0 = (blockIdx.x % co_pieces) * DWO;
  const bool vec_ok = Ci % V == 0;
  const int cg = tid & 7;
  const int p_lo = tid >> 3;
  // the pixel whose geometry this lane works out for its warp: slot s =
  // lane & 7 is pixel 4 warp + (s & 3) of half s >> 2
  const int lane = tid & 31;
  const int slot_p = (tid >> 5) * 4 + (lane & 3) + ((lane >> 2) & 1) * 32;

  if constexpr (FAST) {
    unsigned char* base = reinterpret_cast<unsigned char*>(
        align_up(reinterpret_cast<size_t>(smem_raw), 1024));
    const size_t a_bytes = (size_t)TP * kPanelRowBytes;
    const size_t b_bytes = (size_t)TP * Co * 2;
    const int wg = tid >> 7;
    const int t = tid & 127;
    const bool active = wg * NB * 64 < Co;
    float acc[32 * NB];
#pragma unroll
    for (int i = 0; i < 32 * NB; ++i) acc[i] = 0.f;

    int it = 0;
    TapRaw raw =
        load_tap(offsets, mask, tile_of(blockIdx.y, H, W), slot_p, k, H, W);
    for (int tl = blockIdx.y; tl < n_tiles; tl += gridDim.y, ++it) {
      const Tile tile = tile_of(tl, H, W);
      unsigned char* s_a = base + (it & 1) * (a_bytes + b_bytes);
      unsigned char* s_b = s_a + a_bytes;
      // A: col * m, rows = pixels, 64 channels contiguous (MN-major)
      const TapSample mine = tap_sample(raw, tile, slot_p, k, H, W);
      if (tl + gridDim.y < n_tiles)
        raw = load_tap(offsets, mask, tile_of(tl + gridDim.y, H, W), slot_p, k,
                       H, W);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = p_lo + half * 32;
        float v[V];
        gather_colm<T>(x, share_tap_sample(mine, half * 4 + (lane >> 3)),
                       c0 + cg * V, Ci, vec_ok, v);
        *reinterpret_cast<uint4*>(s_a + panel_off(p, cg * V)) = pack<T>(v);
      }
      // B: g, rows = pixels, Co contiguous (MN-major)
      stage_g_panels(g, tile, H, W, Co, s_b);
      // the previous tile's product, still running on the other buffer while
      // this one was filled, must be done before any thread refills that
      // buffer after the barrier
      if (active) wgmma_wait<0>();
      fence_async_proxy();
      __syncthreads();
      if (active) {
        const uint32_t a0 = smem_u32(s_a);
        const uint32_t b0 = smem_u32(s_b) + wg * NB * (TP * kPanelRowBytes);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < TP / 16; ++ks) {
          const uint64_t da =
              panel_desc(a0 + ks * 2 * kGroupBytes, TP * kPanelRowBytes,
                         kGroupBytes);
          const uint64_t db =
              panel_desc(b0 + ks * 2 * kGroupBytes, TP * kPanelRowBytes,
                         kGroupBytes);
          if constexpr (NB == 1)
            wgmma_n64<1, 1>(acc, da, db, 1);
          else
            wgmma_n128<1, 1>(acc, da, db, 1);
        }
        wgmma_commit();
      }
    }
    if (active) {
      wgmma_wait<0>();
      const int row = (t >> 5) * 16 + ((t & 31) >> 2);
      const int col = wg * NB * 64 + (t & 3) * 2;
      float* dst = dw + ((long long)k * Ci + c0 + row) * Co + col;
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j) {
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                  make_float2(acc[4 * j], acc[4 * j + 1]));
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * (long long)Co + 8 * j),
                  make_float2(acc[4 * j + 2], acc[4 * j + 3]));
      }
    }
  } else {
    // A thread owns 4 channels x 4 output channels of the block's [KC x DWO]
    // piece of dW_k; a warp covers 32 channels x 16 outputs, so that its
    // lanes' float4 loads of a pixel's row fall into one 128-byte run of
    // col * m and one 64-byte run of g. With KC = 32 the piece has half as
    // many such positions as the block has threads, and the two halves of
    // the block each take half of the tile's pixels. (A 4 x 8 tile, three
    // loads per 32 multiply-adds instead of four, spilled registers beside
    // the prefetched operands and ran slower.)
    constexpr int POS = KC * DWO / 16;   // thread positions of a piece
    constexpr int PS = kThreads / POS;   // shares of a tile's pixels
    float* s_a = reinterpret_cast<float*>(smem_raw);  // [TP][KC]
    float* s_b = s_a + TP * KC;                       // [TP][DWO]
    const int pos = tid % POS;
    const int ps = tid / POS;
    const int ch = 32 * (pos >> 7) + 4 * ((pos & 31) >> 2);
    const int oc = 16 * ((pos >> 5) & 3) + 4 * (pos & 3);
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    // The next tile's operands are fetched into registers before this
    // tile's product and stored after it (and its offsets a tile earlier
    // still), so the trips to device memory are hidden behind the product.
    constexpr int NG = TP * DWO / 4 / kThreads;
    uint4 x_next[2][4];   // 4 corners of this thread's 2 pixels
    TapSample t_next[2];  // their weights and masks
    float4 g_next[NG];
    auto fetch = [&](const Tile& tile, const TapRaw& raw) {
      const TapSample mine = tap_sample(raw, tile, slot_p, k, H, W);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        t_next[half] = share_tap_sample(mine, half * 4 + (lane >> 3));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x_next[half][j] =
              load_channels<T>(x + (size_t)t_next[half].pix[j] * Ci,
                               c0 + cg * V, Ci, vec_ok);
      }
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int e = tid + i * kThreads;
        g_next[i] = load_g4(g, tile_pixel(tile, e / (DWO / 4), H, W),
                            o0 + (e % (DWO / 4)) * 4, Co);
      }
    };
    const int first = blockIdx.y;
    TapRaw raw = load_tap(offsets, mask, tile_of(first, H, W), slot_p, k, H, W);
    fetch(tile_of(first, H, W), raw);
    if (first + gridDim.y < n_tiles)
      raw = load_tap(offsets, mask, tile_of(first + gridDim.y, H, W), slot_p,
                     k, H, W);
    for (int tl = first; tl < n_tiles; tl += gridDim.y) {
      __syncthreads();  // the previous tile's readers are done
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[V];
        combine_colm<T>(x_next[half], t_next[half], v);
#pragma unroll
        for (int i = 0; i < V; i += 4)
          *reinterpret_cast<float4*>(s_a + (p_lo + half * 32) * KC + cg * V +
                                     i) =
              make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      }
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int e = tid + i * kThreads;
        *reinterpret_cast<float4*>(s_b + 4 * e) = make_float4(
            round_to<T>(g_next[i].x), round_to<T>(g_next[i].y),
            round_to<T>(g_next[i].z), round_to<T>(g_next[i].w));
      }
      __syncthreads();
      const int nx = tl + gridDim.y;
      if (nx < n_tiles) {
        fetch(tile_of(nx, H, W), raw);
        if (nx + gridDim.y < n_tiles)
          raw = load_tap(offsets, mask, tile_of(nx + gridDim.y, H, W), slot_p,
                         k, H, W);
      }
#pragma unroll 4
      for (int p = ps * (TP / PS); p < (ps + 1) * (TP / PS); ++p) {
        const float4 aq = *reinterpret_cast<const float4*>(s_a + p * KC + ch);
        const float4 bq = *reinterpret_cast<const float4*>(s_b + p * DWO + oc);
        const float a[4] = {aq.x, aq.y, aq.z, aq.w};
        const float b[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += a[r] * b[q];
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + ch + r;
        const int o = o0 + oc + q;
        if (c < Ci && o < Co)
          atomicAdd(dw + ((long long)k * Ci + c) * Co + o, acc[r][q]);
      }
  }
}

// --------------------------------------------------------------- launch ---

struct Plan {
  int radius, n_chunks, dw_splits, smem_dx, smem_dw;
};

template <typename T, bool FAST>
int launch(const T* x, const float* offsets, const float* mask,
           const T* weight, const float* g, float* dx, float* dty, float* dtx,
           float* dmask, float* dw, int B, int H, int W, int Ci, int Co,
           const Plan& pl, cudaStream_t s) {
  constexpr int KC = Cfg<T>::KC;
  const int ws = TS + 2 * (pl.radius + 1);
  const int n_tiles = B * ((H + TS - 1) / TS) * ((W + TS - 1) / TS);
  const int co_pieces = FAST ? 1 : (Co + DWO - 1) / DWO;
  // the Python launch plan and this file must agree on the sizes
  if (pl.radius < 1 || pl.n_chunks != (Ci + KC - 1) / KC ||
      pl.dw_splits < 1 || pl.dw_splits > n_tiles ||
      (size_t)pl.smem_dx != dx_smem_bytes<T, FAST>(Co, ws) ||
      (size_t)pl.smem_dw != dw_smem_bytes<T, FAST>(Co))
    return (int)cudaErrorInvalidValue;

  auto dxk = dcn_bwd_dx_kernel<T, FAST>;
  cudaError_t err = allow_smem((const void*)dxk, pl.smem_dx);
  if (err != cudaSuccess) return (int)err;
  dxk<<<dim3(n_tiles, pl.n_chunks), kDxThreads, pl.smem_dx, s>>>(
      x, offsets, mask, weight, g, dx, dty, dtx, dmask, dw, H, W, Ci, Co,
      pl.radius, pl.n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid(kTaps * pl.n_chunks * co_pieces, pl.dw_splits);
  auto run_dw = [&](auto dwk) {
    cudaError_t e = allow_smem((const void*)dwk, pl.smem_dw);
    if (e != cudaSuccess) return e;
    dwk<<<grid, kThreads, pl.smem_dw, s>>>(x, offsets, mask, g, dw, H, W, Ci,
                                            Co, pl.n_chunks, co_pieces,
                                            n_tiles);
    return cudaGetLastError();
  };
  if constexpr (FAST)
    if (Co == 256) return (int)run_dw(dcn_bwd_dw_kernel<T, FAST, 2>);
  return (int)run_dw(dcn_bwd_dw_kernel<T, FAST, 1>);
}

}  // namespace

// Plain C interface, loaded with ctypes (centernet_tpu_torch/ops/dcn_cuda.py,
// whose launch_plan computes the ints after Co). Launches on `stream` and
// returns the first cudaGetLastError() that is not cudaSuccess, or 0.
extern "C" int dcn_bwd(const void* x, const void* offsets, const void* mask,
                       const void* weight, const void* g, void* dx, void* dty,
                       void* dtx, void* dmask, void* dw, int B, int H, int W,
                       int Ci, int Co, int is_bf16, int radius, int fast,
                       int n_chunks, int dw_splits, int smem_dx, int smem_dw,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  const float* gp = static_cast<const float*>(g);
  float* out[5] = {static_cast<float*>(dx), static_cast<float*>(dty),
                   static_cast<float*>(dtx), static_cast<float*>(dmask),
                   static_cast<float*>(dw)};
  const Plan pl{radius, n_chunks, dw_splits, smem_dx, smem_dw};
  if (fast &&
      !(is_bf16 && Ci % 64 == 0 && (Co == 64 || Co == 128 || Co == 256)))
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(weight);
    if (fast)
      return launch<bf16, true>(xb, off, msk, wb, gp, out[0], out[1], out[2],
                                out[3], out[4], B, H, W, Ci, Co, pl, s);
    return launch<bf16, false>(xb, off, msk, wb, gp, out[0], out[1], out[2],
                               out[3], out[4], B, H, W, Ci, Co, pl, s);
  }
  return launch<float, false>(static_cast<const float*>(x), off, msk,
                              static_cast<const float*>(weight), gp, out[0],
                              out[1], out[2], out[3], out[4], B, H, W, Ci, Co,
                              pl, s);
}
