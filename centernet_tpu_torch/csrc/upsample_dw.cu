// Depthwise transposed convolution of DLA's IDA up path (the up_i layers of
// models/dla.py::IDAUp), forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this layer with
// lax.conv_general_dilated (lhs_dilation = f, feature_group_count = C), in
// centernet_tpu/models/layers.py::BilinearConvTranspose, and leaves it to
// XLA. It was added because cuDNN ran the port's F.conv_transpose2d of the
// layer as a depthwise dgrad (dgrad2d_c1_k1_nhwc) that took 7.1 ms of each
// 34.9 ms B32 dla_34 serving replay at 512x512 on an H100 80GB HBM3 (700 W),
// about 46 times the bytes' bound, and its backward as a grouped direct
// convolution (~5.8 ms a train step) plus a weight gradient.
//
// What it computes, for x [B, H, W, C] (NHWC), w [C, 1, K, K] (K = 2f, in
// x's type), stride f in {2, 4} and paddings (ph, pw), in PyTorch's
// ConvTranspose2d orientation (groups = C, no flip):
//
//   y[b, oy, ox, c] = sum x[b, iy, ix, c] * w[c, ky, kx]
//                     over oy = iy f - ph + ky, ox = ix f - pw + kx,
//
// y [B, OH, OW, C] with OH = (H - 1) f - 2 ph + K (the module passes ph = pw
// = f / 2, so OH = H f; a halo band passes ph = 0). With t = oy + ph, exactly
// two input rows feed an output row: iy = t / f (ky = t % f) and iy - 1
// (ky = t % f + f); columns alike. So every output takes 2 x 2 taps per
// channel, and its phase (t_y % f, t_x % f) picks 4 of the K * K weights.
// Sums are f32, rounded once to x's type.
//
// Bound on the H100: bytes. There are 4 multiply-adds an output element, so
// the forward moves x (read) and y (written, f^2 times x's size); at B32 the
// eight dla_34 layers read 92 MB and write 419 MB of bf16, 0.153 ms at 3.35
// TB/s. The backward reads g (y's size) and x and writes dx (x's size) and
// dW (K * K * C): the same bound.
//
// Design. A thread owns one phase and 8 channels (16 bytes of bf16) and
// walks kRows rows of one column:
//  * both: a block first stages w in shared memory as [K * K, C] (16-byte
//    loads), so that a thread's 4 taps are 4 vectors it keeps in registers.
//  * forward: a column of output cells (a cell is the f x f outputs that
//    share their four input pixels). The thread reads its cell's 2 x 2
//    input pixels as 16-byte vectors (the row above carried over from the
//    previous row), sums in f32 and stores its output pixel's 16 bytes.
//    Consecutive lanes hold consecutive channel chunks, then the
//    neighbouring phases, so a warp
//    writes whole 128-byte lines; the inputs, f^2 times smaller, come from
//    L1 and L2 (the lanes of the other phases read the same vectors, the
//    neighbouring columns' threads the shared pixel).
//  * backward, one pass over g and x: a column of input pixels. For input
//    pixel (iy, ix) the thread's phase (ry, rx) reads the 4 outputs
//    g[(iy + a) f - ph + ry, (ix + b) f - pw + rx] (a, b in {0, 1}; the
//    a = 1 pair is the next row's a = 0 pair, kept in registers). Then
//      dx[iy, ix] = sum over phases and (a, b) of g * w, summed over the
//                   pixel's f^2 phase lanes by warp shuffles (a fixed
//                   reduce-scatter: each lane stores 2 or 1 of the 8
//                   channels);
//      dW[c, ry + a f, rx + b f] += x * g in f32 registers through the walk,
//                   then summed over the block's copies of each (phase,
//                   chunk) in a fixed order in shared memory into one
//                   partial per block; a second launch sums the partials in
//                   a fixed order into the weight's type.
//    No atomics: two replays of a train graph give bitwise-equal dW.
// C must be a multiple of 8 (the Python wrapper refuses other counts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dcn_hopper.cuh"

namespace {

using dcn::bf16;

constexpr int kVec = 8;        // channels a thread owns
constexpr int kRows = 4;       // rows a thread walks per slot
constexpr int kThreads = 256;  // threads a block (forward and backward)

// 8 channels of one pixel, as loaded: bf16 stays packed (16 bytes).
template <typename T>
struct Vec8;

template <>
struct Vec8<bf16> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void load_shared(const bf16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  // element i (i a constant after unrolling): bf16 is the top half of f32
  __device__ __forceinline__ float operator[](int i) const {
    const uint32_t word = i < 2 ? u.x : i < 4 ? u.y : i < 6 ? u.z : u.w;
    return __uint_as_float(i % 2 ? (word & 0xffff0000u) : (word << 16));
  }
};

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void load_shared(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ float operator[](int i) const {
    const int j = i % 4;
    return i < 4 ? (j == 0 ? a.x : j == 1 ? a.y : j == 2 ? a.z : a.w)
                 : (j == 0 ? b.x : j == 1 ? b.y : j == 2 ? b.z : b.w);
  }
};

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The pixel (row, col) of a [rows, cols, C] map at `base` (already offset to
// the image and the thread's channels), or zeros outside it / when !ok.
// Offsets are int: the wrapper keeps every map under 2^31 elements.
template <typename T>
__device__ __forceinline__ void load_px(Vec8<T>& v, const T* base, bool ok,
                                        int row, int col, int rows, int cols,
                                        int C) {
  if (ok && row >= 0 && row < rows && col >= 0 && col < cols)
    v.load(base + (row * cols + col) * C);
  else
    v.zero();
}

// Stages w [C, 1, K, K] into shared memory as [K * K, C], so that a
// thread's 8 channels of a tap are one vector: 16-byte global loads of 8
// taps of one channel (K * K is a multiple of 8), scattered per element.
template <typename T, int F>
__device__ __forceinline__ void stage_taps(T* ws, const T* w, int C) {
  constexpr int KK = 4 * F * F;
  for (int v = threadIdx.x; v < KK * C / kVec; v += kThreads) {
    Vec8<T> val;
    val.load(w + (size_t)v * kVec);
    const int c = v * kVec / KK, tap = v * kVec % KK;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      ws[(tap + i) * C + c] = dcn::from_f<T>(val[i]);
  }
  __syncthreads();
}

// The thread's 4 tap weights for its 8 channels from the staged [K * K, C]:
// wr[a][b] = w[c0.., ry + a f, rx + b f].
template <typename T, int F>
__device__ __forceinline__ void load_taps(Vec8<T> (&wr)[2][2], const T* ws,
                                          int C, int c0, int ry, int rx) {
  constexpr int K = 2 * F;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      wr[a][b].load_shared(ws + ((ry + a * F) * K + rx + b * F) * C + c0);
}

// Sums v over the L lanes of each aligned group of a warp (L a power of 2,
// 4 to 32) by a reduce-scatter: at the offsets 1, 2, 4 a lane keeps one half
// of its values and adds its partner's sum of that half, so after
// min(log2 L, 3) rounds it holds kVec / L of the channels (one, from L =
// 8 on, then summed over the remaining offsets). Returns the first kept
// channel; the kept sums are v[0..]. Every lane of the warp must call it.
template <int L>
__device__ __forceinline__ int sum_lanes(float (&v)[kVec], int q) {
  int at = 0;
#pragma unroll
  for (int o = 1, n = kVec; o < L && n > 1; o <<= 1, n >>= 1) {
    const bool hi = q & o;
#pragma unroll
    for (int j = 0; j < n / 2; ++j) {
      const float keep = hi ? v[j + n / 2] : v[j];
      const float send = hi ? v[j] : v[j + n / 2];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    at += hi ? n / 2 : 0;
  }
#pragma unroll
  for (int o = kVec; o < L; o <<= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  return at;
}

template <int N>
__device__ __forceinline__ void store_n(bf16* p, const float* v) {
  if constexpr (N == 2)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  else
    *p = __float2bfloat16_rn(v[0]);
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float* v) {
  if constexpr (N == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// A launch's (phase, chunk) pairs ("combos") are split over grid.y; a block
// holds cb of them, kThreads / cb copies of each over consecutive slots.
__host__ __device__ __forceinline__ int combos_per_block(int combos) {
  return combos < kThreads ? combos : kThreads;
}

// ------------------------------------------------------------- forward --
// Combo m = chunk + nc * phase (channel chunks fastest). A slot is one
// column of output cells over kRows cell rows of one image.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads, 4) up_dw_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
    int B, int H, int W, int C, int OH, int OW, int ph, int pw) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);  // [K * K, C]
  stage_taps<T, F>(ws, w, C);
  const int nc = C / kVec;
  const int combos = F * F * nc;
  const int cb = combos_per_block(combos);
  const int per_block = kThreads / cb;
  const int s = threadIdx.x / cb;
  const int m = blockIdx.y * cb + threadIdx.x % cb;
  if (s >= per_block || m >= combos) return;  // no block-wide step follows
  const int chunk = m % nc, q = m / nc;
  const int ry = q / F, rx = q % F, c0 = chunk * kVec;
  // wr[d][e]: input row cy - d (ky = ry + d f), column cx - e (kx = rx + e f)
  Vec8<T> wr[2][2];
  load_taps<T, F>(wr, ws, C, c0, ry, rx);

  // cells whose outputs reach [0, OH) x [0, OW)
  const int cy_lo = ph / F, cy_hi = (OH - 1 + ph) / F + 1;
  const int cx_lo = pw / F, cx_hi = (OW - 1 + pw) / F + 1;
  const int wc = cx_hi - cx_lo;
  const int tiles = (cy_hi - cy_lo + kRows - 1) / kRows;
  const int slots = B * tiles * wc;
  for (int slot = blockIdx.x * per_block + s; slot < slots;
       slot += gridDim.x * per_block) {
    const int r = slot / wc;
    const int cx = cx_lo + (slot - r * wc);
    const int b = r / tiles;
    const int cy0 = cy_lo + (r - b * tiles) * kRows;
    const int ox = cx * F - pw + rx;
    const bool col_ok = ox >= 0 && ox < OW;
    const T* xb = x + b * H * W * C + c0;
    T* yb = y + b * OH * OW * C + c0;
    Vec8<T> xr[2][2];  // [d][e] as wr
    load_px(xr[1][0], xb, true, cy0 - 1, cx, H, W, C);
    load_px(xr[1][1], xb, true, cy0 - 1, cx - 1, H, W, C);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int cy = cy0 + k;
      load_px(xr[0][0], xb, true, cy, cx, H, W, C);
      load_px(xr[0][1], xb, true, cy, cx - 1, H, W, C);
      const int oy = cy * F - ph + ry;
      if (col_ok && cy < cy_hi && oy >= 0 && oy < OH) {
        float acc[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          float v = xr[0][0][i] * wr[0][0][i];
          v = fmaf(xr[0][1][i], wr[0][1][i], v);
          v = fmaf(xr[1][0][i], wr[1][0][i], v);
          acc[i] = fmaf(xr[1][1][i], wr[1][1][i], v);
        }
        store8(yb + (oy * OW + ox) * C, acc);
      }
      xr[1][0] = xr[0][0];
      xr[1][1] = xr[0][1];
    }
  }
}

// ------------------------------------------------------------ backward --
// Combo m = phase + f^2 * chunk (phases fastest, so a pixel's L = f^2 phase
// lanes are neighbours in a warp for the dx shuffles). A slot is one column
// of input pixels over kRows rows of one image. Every thread runs the same
// number of steps (the shuffles take the whole warp); idle ones carry
// zeros.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads, 2) up_dw_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ g,
    T* __restrict__ dx, float* __restrict__ partial, int B, int H, int W,
    int C, int OH, int OW, int ph, int pw) {
  constexpr int K = 2 * F, L = F * F;
  constexpr int kKeep = L >= kVec ? 1 : kVec / L;  // channels a lane stores
  constexpr int kAcc = 4 * kVec;  // a thread's dW sums: (a, b) x 8
  // the staged weights, then (after the walk) the block's dW sums
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [kThreads, kAcc + 1]
  stage_taps<T, F>(reinterpret_cast<T*>(smem), w, C);
  const int nc = C / kVec;
  const int combos = L * nc;
  const int cb = combos_per_block(combos);  // a multiple of L
  const int per_block = kThreads / cb;
  const int s = threadIdx.x / cb, ml = threadIdx.x % cb;
  const int m = blockIdx.y * cb + ml;
  const bool active = s < per_block && m < combos;
  const int q = m % L, chunk = active ? m / L : 0;
  const int ry = q / F, rx = q % F, c0 = chunk * kVec;
  Vec8<T> wr[2][2];  // [a][b]: tap (ry + a f, rx + b f)
  load_taps<T, F>(wr, reinterpret_cast<const T*>(smem), C, c0, ry, rx);
  __syncthreads();  // every thread has its taps: the buffer is red's now

  const int tiles = (H + kRows - 1) / kRows;
  const int slots = B * tiles * W;
  const int stride = gridDim.x * per_block;
  const int steps = (slots + stride - 1) / stride;
  float acc[2][2][kVec];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[a][b][i] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int slot = step * stride + blockIdx.x * per_block + s;
    const bool slot_ok = active && slot < slots;
    const int t = slot_ok ? slot / W : 0;
    const int ix = slot_ok ? slot - t * W : 0;
    const int img = t / tiles, iy0 = (t - img * tiles) * kRows;
    const int ox = ix * F - pw + rx;  // b = 0; b = 1 is ox + F
    const bool col0 = ox >= 0 && ox < OW;
    const bool col1 = ox + F >= 0 && ox + F < OW;
    int oy = iy0 * F - ph + ry;  // a = 0 of row iy0
    int goff = ((img * OH + oy) * OW + ox) * C + c0;
    int xoff = ((img * H + iy0) * W + ix) * C + c0;
    Vec8<T> gr[2][2];  // [a][b]; the a = 1 pair is the next row's a = 0
    {
      const bool row = slot_ok && oy >= 0 && oy < OH;
      if (row && col0) gr[0][0].load(g + goff); else gr[0][0].zero();
      if (row && col1) gr[0][1].load(g + goff + F * C); else gr[0][1].zero();
    }
    // (two rows at a time: the loads of four would not fit the registers
    // of two blocks an SM)
#pragma unroll 2
    for (int k = 0; k < kRows; ++k) {
      const bool ok = slot_ok && iy0 + k < H;
      oy += F;
      goff += F * OW * C;
      const bool row = ok && oy >= 0 && oy < OH;
      if (row && col0) gr[1][0].load(g + goff); else gr[1][0].zero();
      if (row && col1) gr[1][1].load(g + goff + F * C); else gr[1][1].zero();
      Vec8<T> xv;
      if (ok) xv.load(x + xoff); else xv.zero();
      float part[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float g00 = gr[0][0][i], g01 = gr[0][1][i];
        const float g10 = gr[1][0][i], g11 = gr[1][1][i];
        float v = g00 * wr[0][0][i];
        v = fmaf(g01, wr[0][1][i], v);
        v = fmaf(g10, wr[1][0][i], v);
        part[i] = fmaf(g11, wr[1][1][i], v);
        const float xi = xv[i];
        acc[0][0][i] = fmaf(xi, g00, acc[0][0][i]);
        acc[0][1][i] = fmaf(xi, g01, acc[0][1][i]);
        acc[1][0][i] = fmaf(xi, g10, acc[1][0][i]);
        acc[1][1][i] = fmaf(xi, g11, acc[1][1][i]);
      }
      // dx: the sum over the pixel's L phase lanes, each lane left with
      // kKeep of the 8 channels (at c0 + at)
      const int at = sum_lanes<L>(part, q);
      if (ok && q < kVec / kKeep) store_n<kKeep>(dx + xoff + at, part);
      xoff += W * C;
      gr[0][0] = gr[1][0];
      gr[0][1] = gr[1][1];
    }
  }

  // the block's dW: its copies of each combo summed in order of s
  float* mine = red + ml * (kAcc + 1);
  for (int j = 0; j < per_block; ++j) {
    if (s == j && m < combos) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const int e = (a * 2 + b) * kVec + i;
            mine[e] = (j ? mine[e] : 0.f) + acc[a][b][i];
          }
    }
    __syncthreads();
  }
  // ... written to this block's partial [K * K, C] (grid.y blocks fill
  // disjoint entries of it)
  float* out = partial + (size_t)blockIdx.x * K * K * C;
  for (int e = threadIdx.x; e < cb * kAcc; e += kThreads) {
    const int l = e / kAcc, k = e % kAcc;
    const int mm = blockIdx.y * cb + l;
    if (mm >= combos) continue;
    const int qq = mm % L, c = (mm / L) * kVec + k % kVec;
    const int a = k / (2 * kVec), b = (k / kVec) % 2;
    const int tap = (qq / F + a * F) * K + qq % F + b * F;
    out[tap * C + c] = red[l * (kAcc + 1) + k];
  }
}

// dW[c, tap] = the sum of the parts' partial[p, tap, c], in a fixed order:
// warp v of a block sums parts v, v + 32, ... for 32 entries, then warp 0
// adds the 32 sums.
constexpr int kSumThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kSumThreads) up_dw_wgrad_kernel(
    const float* __restrict__ partial, T* __restrict__ dw, int parts, int KK,
    int C) {
  constexpr int kWarps = kSumThreads / 32;
  __shared__ float sums[kWarps][33];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = KK * C;
  const int e = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (e < n) {
#pragma unroll 4
    for (int p = warp; p < parts; p += kWarps) v += partial[(size_t)p * n + e];
  }
  sums[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && e < n) {
    float t = sums[0][lane];
#pragma unroll
    for (int j = 1; j < kWarps; ++j) t += sums[j][lane];
    dw[(size_t)(e % C) * KK + e / C] = dcn::from_f<T>(t);
  }
}

// The launch plan (ops/upsample.py::up_dw_plan) and this file must agree: a
// call is refused unless its geometry is one the kernels take and grid_x
// lies between 1 and the blocks its slots fill (a forward slot is a column
// of kRows output-cell rows, a backward slot a column of kRows input rows;
// a block walks per_block of them at a time).
bool plan_ok(int B, int H, int W, int C, int stride, int pad_h, int pad_w,
             int grid_x, bool backward) {
  const int OH = (H - 1) * stride - 2 * pad_h + 2 * stride;
  const int OW = (W - 1) * stride - 2 * pad_w + 2 * stride;
  if (!(B >= 1 && H >= 1 && W >= 1 && C >= kVec && C % kVec == 0 &&
        (stride == 2 || stride == 4) && pad_h >= 0 && pad_w >= 0 &&
        OH >= 1 && OW >= 1 && grid_x >= 1))
    return false;
  const int per_block = kThreads / combos_per_block(stride * stride *
                                                    (C / kVec));
  long long slots;
  if (backward) {
    slots = (long long)B * ((H + kRows - 1) / kRows) * W;
  } else {
    const int rows = (OH - 1 + pad_h) / stride + 1 - pad_h / stride;
    const int cols = (OW - 1 + pad_w) / stride + 1 - pad_w / stride;
    slots = (long long)B * ((rows + kRows - 1) / kRows) * cols;
  }
  return grid_x <= (slots + per_block - 1) / per_block;
}

dim3 grid_of(int grid_x, int combos) {
  const int cb = combos_per_block(combos);
  return dim3((unsigned)grid_x, (unsigned)((combos + cb - 1) / cb));
}

// Dynamic shared memory: the staged weights; the backward's also holds the
// block's dW sums after the walk.
template <typename T, int F>
size_t fwd_smem(int C) {
  return (size_t)4 * F * F * C * sizeof(T);
}
template <typename T, int F>
size_t bwd_smem(int C) {
  const size_t red = (size_t)kThreads * (4 * kVec + 1) * sizeof(float);
  const size_t taps = fwd_smem<T, F>(C);
  return taps > red ? taps : red;
}

template <typename T, int F>
cudaError_t launch_fwd(const void* x, const void* w, void* y, int B, int H,
                       int W, int C, int ph, int pw, int grid_x,
                       cudaStream_t s) {
  const int OH = (H - 1) * F - 2 * ph + 2 * F;
  const int OW = (W - 1) * F - 2 * pw + 2 * F;
  const size_t smem = fwd_smem<T, F>(C);
  cudaError_t err =
      dcn::allow_smem((const void*)up_dw_fwd_kernel<T, F>, smem);
  if (err != cudaSuccess) return err;
  up_dw_fwd_kernel<T, F><<<grid_of(grid_x, F * F * (C / kVec)), kThreads,
                           smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      B, H, W, C, OH, OW, ph, pw);
  return cudaGetLastError();
}

template <typename T, int F>
cudaError_t launch_bwd(const void* x, const void* w, const void* g, void* dx,
                       void* partial, void* dw, int B, int H, int W, int C,
                       int ph, int pw, int grid_x, cudaStream_t s) {
  constexpr int K = 2 * F;
  const int OH = (H - 1) * F - 2 * ph + K;
  const int OW = (W - 1) * F - 2 * pw + K;
  float* part = static_cast<float*>(partial);
  const size_t smem = bwd_smem<T, F>(C);
  cudaError_t err =
      dcn::allow_smem((const void*)up_dw_bwd_kernel<T, F>, smem);
  if (err != cudaSuccess) return err;
  up_dw_bwd_kernel<T, F><<<grid_of(grid_x, F * F * (C / kVec)), kThreads,
                           smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), part, B, H, W, C, OH,
      OW, ph, pw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = K * K * C;
  up_dw_wgrad_kernel<T><<<(n + 31) / 32, kSumThreads, 0, s>>>(
      part, static_cast<T*>(dw), grid_x, K * K, C);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes (centernet_tpu_torch/ops/upsample.py
// checks the tensors and computes grid_x, ops/dcn_cuda.py loads the
// library). Both launch on `stream` and return the first cudaGetLastError()
// that is not cudaSuccess, or 0; a geometry this file was not written for,
// or a plan it does not arrive at itself (plan_ok), returns
// cudaErrorInvalidValue and launches nothing.
//
// up_dw_fwd: x [B, H, W, C], w [C, 1, 2s, 2s] -> y [B, OH, OW, C], all of
// one type (bf16 if is_bf16, else f32).
extern "C" int up_dw_fwd(const void* x, const void* w, void* y, int B, int H,
                         int W, int C, int stride, int pad_h, int pad_w,
                         int is_bf16, int grid_x, void* stream) {
  if (!plan_ok(B, H, W, C, stride, pad_h, pad_w, grid_x, false))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)(stride == 2 ? launch_fwd<bf16, 2> : launch_fwd<bf16, 4>)(
        x, w, y, B, H, W, C, pad_h, pad_w, grid_x, s);
  return (int)(stride == 2 ? launch_fwd<float, 2> : launch_fwd<float, 4>)(
      x, w, y, B, H, W, C, pad_h, pad_w, grid_x, s);
}

// up_dw_bwd: the forward's x and w and the cotangent g [B, OH, OW, C] ->
// dx [B, H, W, C] and dw [C, 1, 2s, 2s], in x's type; `partial` is f32
// scratch of `partial_floats` = grid_x * 4 s^2 * C floats, every entry
// written before it is read.
extern "C" int up_dw_bwd(const void* x, const void* w, const void* g,
                         void* dx, void* partial, void* dw, int B, int H,
                         int W, int C, int stride, int pad_h, int pad_w,
                         int is_bf16, int grid_x, int partial_floats,
                         void* stream) {
  if (!plan_ok(B, H, W, C, stride, pad_h, pad_w, grid_x, true) ||
      (long long)partial_floats != (long long)grid_x * 4 * stride * stride * C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)(stride == 2 ? launch_bwd<bf16, 2> : launch_bwd<bf16, 4>)(
        x, w, g, dx, partial, dw, B, H, W, C, pad_h, pad_w, grid_x, s);
  return (int)(stride == 2 ? launch_bwd<float, 2> : launch_bwd<float, 4>)(
      x, w, g, dx, partial, dw, B, H, W, C, pad_h, pad_w, grid_x, s);
}
