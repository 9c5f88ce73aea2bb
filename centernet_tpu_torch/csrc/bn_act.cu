// Inference BatchNorm, optional residual, optional ReLU and the cast to the
// output type as one pass over an NHWC map (the epilogue of a convolution
// block when serving), for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves BatchNorm, ReLU and the
// residual sum to XLA, which fuses them into the convolution's consumers. It
// was added because the port ran them as PyTorch's own kernels, each
// reading and writing a whole map: on an H100 80GB HBM3 (700 W) a served
// Hourglass-104 B32 request spent ~7.5 ms in inference BatchNorm and ~13.6
// ms in elementwise kernels (ReLU, residual sums, casts), a dla_34 one ~4.3
// ms and ~6.9 ms, beside convolutions near the bf16 peak.
//
// What it computes, per pixel p and channel c of x [P, C] (P = B H W):
//
//   out[p, c] = act(x[p, c] s[c] + t[c]  [+ r[p, c] sr[c] + tr[c] | + r[p, c]])
//   s = w / sqrt(var + eps),  t = b - mean s    (per channel, f32)
//
// with the residual r absent (mode 0), added as it is (mode 1) or through a
// BatchNorm of its own (mode 2), act ReLU or the identity, all in f32 and
// rounded once to the output type. x is bf16 or f32 (the DCN's output is
// f32); r, when given, and out share one type (bf16 or f32). The four
// statistics vectors of each BatchNorm are f32 and are read at every launch:
// nothing derived from them is kept, so a replayed CUDA graph reads them as
// they stand.
//
// Bound on the H100: bytes. Every element is read once and written once (a
// few flops each), so the least time is (x bytes + r bytes + out bytes) /
// 3.35 TB/s.
//
// Design. A thread moves 16 bytes of the wider of x and out a step (V = 8
// bf16 channels, or 4 where x or out is f32) where C % V == 0 and the maps
// are 16-byte aligned; otherwise one element a step (V = 1). The grid walks
// the map in strides of gridDim * kThreads vectors, and the launch rounds
// the grid so that a stride covers a whole number of pixels: a thread then
// sees the same V channels at every step, computes their s and t once into
// registers, and keeps kUnroll vectors of x (and r) in flight. The grid
// holds as many blocks as the SMs keep resident (one wave) or fewer for a
// small map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dcn_hopper.cuh"

namespace {

using dcn::bf16;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors a thread keeps in flight
constexpr int kMaxChannels = 4096;

template <int Bytes>
struct Raw;
template <>
struct Raw<16> {
  typedef uint4 type;
};
template <>
struct Raw<8> {
  typedef uint2 type;
};
template <>
struct Raw<4> {
  typedef uint32_t type;
};
template <>
struct Raw<2> {
  typedef uint16_t type;
};

// V consecutive elements of T as one load or store (16 bytes at most).
template <typename T, int V>
struct Pack {
  typedef typename Raw<sizeof(T) * V>::type R;
  R raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = *reinterpret_cast<const R*>(p);
  }
  __device__ __forceinline__ void store(T* p) const {
    *reinterpret_cast<R*>(p) = raw;
  }
  __device__ __forceinline__ float get(int i) const {
    return dcn::to_f(reinterpret_cast<const T*>(&raw)[i]);
  }
  __device__ __forceinline__ void set(int i, float v) {
    reinterpret_cast<T*>(&raw)[i] = dcn::from_f<T>(v);
  }
};

struct Norm {  // one BatchNorm's f32 vectors [C] and eps
  const float* w;
  const float* b;
  const float* mean;
  const float* var;
  float eps;
};

__device__ __forceinline__ void scale_shift(const Norm& n, int c, float& s,
                                            float& t) {
  s = n.w[c] / sqrtf(n.var[c] + n.eps);
  t = n.b[c] - n.mean[c] * s;
}

// TX: x's type; TO: r's and out's type; V: elements a step. n_vec = P C / V.
template <typename TX, typename TO, int V>
__global__ void __launch_bounds__(kThreads)
    bn_act_kernel(const TX* __restrict__ x, const TO* __restrict__ r,
                  TO* __restrict__ out, Norm nx, Norm nr, int n_vec, int C,
                  int mode, int relu) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  // the launch makes stride * V a multiple of C: fixed channels a thread
  const int c0 = (int)(((long long)tid * V) % C);
  float s[V], t[V], sr[V], tr[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    scale_shift(nx, c0 + k, s[k], t[k]);
    sr[k] = 1.f;
    tr[k] = 0.f;
    if (mode == 2) scale_shift(nr, c0 + k, sr[k], tr[k]);
  }
  for (long long base = tid; base < n_vec; base += stride * kUnroll) {
    Pack<TX, V> xv[kUnroll];
    Pack<TO, V> rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < n_vec) {
        xv[u].load(x + i * V);
        if (mode) rv[u].load(r + i * V);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < n_vec) {
        Pack<TO, V> ov;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float y = fmaf(xv[u].get(k), s[k], t[k]);
          if (mode) y += fmaf(rv[u].get(k), sr[k], tr[k]);
          if (relu) y = y < 0.f ? 0.f : y;  // (NaN stays NaN, as F.relu)
          ov.set(k, y);
        }
        ov.store(out + i * V);
      }
    }
  }
}

int gcd_of(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename TX, typename TO, int V>
cudaError_t launch(const void* x, const void* r, void* out, const Norm& nx,
                   const Norm& nr, int pixels, int C, int mode, int relu,
                   cudaStream_t s) {
  static int per_sm = 0;  // blocks of this kernel an SM holds at once
  cudaError_t err = cudaSuccess;
  if (per_sm == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bn_act_kernel<TX, TO, V>, kThreads, 0);
    if (err != cudaSuccess) return err;
    per_sm = n > 0 ? n : 1;
  }
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int n_vec = (int)((long long)pixels * C / V);
  // blocks come in multiples of `step`, so that a stride of the grid is a
  // whole number of pixels
  const int step = C / gcd_of(C, kThreads * V);
  const long long want =
      ((long long)n_vec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long wave = (long long)sms * per_sm;
  long long grid = (want < wave ? want : wave) / step * step;
  if (grid < step) grid = step;
  bn_act_kernel<TX, TO, V><<<(unsigned)grid, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TO*>(r),
      static_cast<TO*>(out), nx, nr, n_vec, C, mode, relu);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// bn_act: x [pixels, C] (bf16 if x_bf16, else f32), r [pixels, C] or null
// (mode 0), out [pixels, C] (r's and out's type: bf16 if out_bf16, else
// f32); the BatchNorm of x (w, b, mean, var, eps) and of r (rw, rb, rmean,
// rvar, r_eps; mode 2 only, else null), all f32 [C]; mode 0 no residual, 1
// the residual as it is, 2 through its BatchNorm; relu 0 or 1; vec 1 for
// 16-byte steps (C a multiple of the step's elements and the maps 16-byte
// aligned, refused otherwise), 0 for one element a step. Returns a
// cudaError_t.
extern "C" int bn_act(const void* x, const void* r, void* out, const void* w,
                      const void* b, const void* mean, const void* var,
                      const void* rw, const void* rb, const void* rmean,
                      const void* rvar, float eps, float r_eps, int pixels,
                      int C, int x_bf16, int out_bf16, int mode, int relu,
                      int vec, void* stream) {
  const int v = vec ? (x_bf16 && out_bf16 ? 8 : 4) : 1;
  if (pixels < 1 || C < 1 || C > kMaxChannels || mode < 0 || mode > 2 ||
      (long long)pixels * C >= (1LL << 31) ||
      (mode != 0) != (r != nullptr) ||
      (mode == 2 && !(rw && rb && rmean && rvar)) || C % v ||
      (vec && !(aligned16(x) && aligned16(r) && aligned16(out))))
    return (int)cudaErrorInvalidValue;
  const Norm nx{static_cast<const float*>(w), static_cast<const float*>(b),
                static_cast<const float*>(mean),
                static_cast<const float*>(var), eps};
  const Norm nr{static_cast<const float*>(rw), static_cast<const float*>(rb),
                static_cast<const float*>(rmean),
                static_cast<const float*>(rvar), r_eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16)
    return (int)(vec ? launch<bf16, bf16, 8> : launch<bf16, bf16, 1>)(
        x, r, out, nx, nr, pixels, C, mode, relu, s);
  if (x_bf16)
    return (int)(vec ? launch<bf16, float, 4> : launch<bf16, float, 1>)(
        x, r, out, nx, nr, pixels, C, mode, relu, s);
  if (out_bf16)
    return (int)(vec ? launch<float, bf16, 4> : launch<float, bf16, 1>)(
        x, r, out, nx, nr, pixels, C, mode, relu, s);
  return (int)(vec ? launch<float, float, 4> : launch<float, float, 1>)(
      x, r, out, nx, nr, pixels, C, mode, relu, s);
}
