// Soft-NMS native core (C++), TPU-framework host-side component.
//
// Re-implements the greedy soft-NMS used for multi-scale TTA merging
// (reference: CenterNet/utils/nms.py:6-206, a Numba-JIT host loop).
// Same in-place swap/prune contract: rows are [x1, y1, x2, y2, score, ...];
// the first `returned N` rows of the mutated buffer are the survivors.
//
// `swap_hi` controls how many columns are carried through swaps beyond the
// first 5 (soft_nms: 0 extra; soft_nms_39: columns 5..38).
//
// Methods: 0 = hard NMS, 1 = linear, 2 = gaussian exp(-iou^2 / sigma).
//
// Built as a shared library, bound via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// boxes: [n, ncols] row-major float32, mutated in place. Returns surviving N.
int64_t soft_nms(float* boxes, int64_t n, int64_t ncols, float sigma, float Nt,
                 float threshold, int method, int64_t swap_lo, int64_t swap_hi) {
  int64_t N = n;
  const int64_t stride = ncols;
  auto row = [&](int64_t i) { return boxes + i * stride; };

  auto swap_rows = [&](int64_t a, int64_t b) {
    if (a == b) return;
    float* ra = row(a);
    float* rb = row(b);
    for (int64_t j = 0; j < 5; ++j) std::swap(ra[j], rb[j]);
    for (int64_t j = swap_lo; j < swap_hi; ++j) std::swap(ra[j], rb[j]);
  };

  for (int64_t i = 0; i < N; ++i) {
    // Find the max-score box in [i, N) and swap it to position i.
    int64_t maxpos = i;
    float maxscore = row(i)[4];
    for (int64_t pos = i + 1; pos < N; ++pos) {
      if (maxscore < row(pos)[4]) {
        maxscore = row(pos)[4];
        maxpos = pos;
      }
    }
    swap_rows(i, maxpos);

    const float tx1 = row(i)[0], ty1 = row(i)[1];
    const float tx2 = row(i)[2], ty2 = row(i)[3];
    const float tarea = (tx2 - tx1 + 1) * (ty2 - ty1 + 1);

    for (int64_t pos = i + 1; pos < N; ++pos) {
      float* r = row(pos);
      const float area = (r[2] - r[0] + 1) * (r[3] - r[1] + 1);
      const float iw = std::min(tx2, r[2]) - std::max(tx1, r[0]) + 1;
      if (iw <= 0) continue;
      const float ih = std::min(ty2, r[3]) - std::max(ty1, r[1]) + 1;
      if (ih <= 0) continue;
      const float ua = tarea + area - iw * ih;
      const float ov = iw * ih / ua;

      float weight = 1.0f;
      if (method == 1) {
        weight = (ov > Nt) ? 1.0f - ov : 1.0f;
      } else if (method == 2) {
        weight = std::exp(-(ov * ov) / sigma);
      } else {
        weight = (ov > Nt) ? 0.0f : 1.0f;
      }
      r[4] *= weight;

      if (r[4] < threshold) {
        swap_rows(pos, N - 1);
        --N;
        --pos;
      }
    }
  }
  return N;
}

}  // extern "C"
