// Greedy IoU NMS and greedy OKS-NMS on the host, in C++.
//
// Port of flowtrack_tpu/native/nms.cc, the same code: classic greedy
// suppression in descending-score order with the lineage's +1 pixel-area
// convention (lib/nms/cpu_nms.pyx), and the lineage's oks_nms. It serves
// host-side eval loops, where candidate sets are small and a trip to the
// device would cost more than the work; the tensor NMS of ops/nms.py is the
// device's.
//
// Built by flowtrack_tpu_torch/native/__init__.py with g++ -O3 -shared
// -fPIC into build/flowtrack_tpu_torch/ and bound through ctypes: a plain C
// interface, no Python.h.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// dets: n x 4 (x1, y1, x2, y2), scores: n. keep: caller-allocated n ints.
// Returns the number of kept indices (written in descending-score order).
int cpu_nms(const float* dets, const float* scores, int n, float thresh,
            int* keep) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  // Ties break by HIGHEST index first — the convention of the numpy twin's
  // argsort()[::-1] (stable ascending sort, reversed) and the device scan
  // (ops/nms.py). A plain descending stable_sort would keep the LOWEST
  // index and survive a different candidate on equal scores.
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return scores[a] != scores[b] ? scores[a] > scores[b] : a > b;
  });

  std::vector<float> areas(n);
  for (int i = 0; i < n; ++i) {
    const float* b = dets + 4 * i;
    areas[i] = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
  }

  std::vector<char> suppressed(n, 0);
  int num_keep = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep[num_keep++] = i;
    const float* bi = dets + 4 * i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = dets + 4 * j;
      float xx1 = std::max(bi[0], bj[0]);
      float yy1 = std::max(bi[1], bj[1]);
      float xx2 = std::min(bi[2], bj[2]);
      float yy2 = std::min(bi[3], bj[3]);
      float w = std::max(0.0f, xx2 - xx1 + 1.0f);
      float h = std::max(0.0f, yy2 - yy1 + 1.0f);
      float inter = w * h;
      float ovr = inter / (areas[i] + areas[j] - inter);
      if (ovr > thresh) suppressed[j] = 1;
    }
  }
  return num_keep;
}

// Greedy OKS-NMS (reference utils/nms.py oks_nms): kpts: n x (3K) flat
// [x, y, v]*K; areas: n; sigmas: K. keep: caller-allocated n ints.
int cpu_oks_nms(const float* kpts, const float* scores, const float* areas,
                int n, int k, const float* sigmas, float thresh,
                float in_vis_thre, int use_vis_thre, int* keep) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  // Tie convention: highest index first (see cpu_nms above).
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return scores[a] != scores[b] ? scores[a] > scores[b] : a > b;
  });

  std::vector<float> vars(k);
  for (int j = 0; j < k; ++j) vars[j] = 4.0f * sigmas[j] * sigmas[j];

  std::vector<char> suppressed(n, 0);
  int num_keep = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep[num_keep++] = i;
    const float* g = kpts + 3 * k * i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      const float* d = kpts + 3 * k * j;
      // np.spacing(1): the lineage's epsilon (guards exact zero area only)
      double norm = (areas[i] + areas[j]) / 2.0 + 2.220446049250313e-16;
      double sum = 0.0;
      int cnt = 0;
      for (int q = 0; q < k; ++q) {
        // lineage quirk: `list(vg>t) and list(vd>t)` == the vd list, so the
        // filter is by the CANDIDATE's visibility, no fallback (ops/oks.py)
        if (use_vis_thre && d[3 * q + 2] <= in_vis_thre) continue;
        double dx = d[3 * q] - g[3 * q];
        double dy = d[3 * q + 1] - g[3 * q + 1];
        double e = (dx * dx + dy * dy) / vars[q] / norm / 2.0;
        sum += std::exp(-e);
        ++cnt;
      }
      double oks = cnt > 0 ? sum / cnt : 0.0;
      if (oks > thresh) suppressed[j] = 1;
    }
  }
  return num_keep;
}

}  // extern "C"
