// Host point-cloud ops, loaded through ctypes by
// mla_tpu_torch/native/pointops_host.py: the eval entry's preparation of a
// raw sensor cloud (voxel-grid subsampling) and host tooling (farthest
// point sampling, brute-force kNN, the chamfer distance). A plain C ABI
// over contiguous float32 and int32 buffers.
//
// Built with -ffp-contract=off: a squared distance rounds after every
// multiply and every add, (dx*dx + dy*dy) + dz*dz, so each function equals
// its plain numpy version bit for bit.

#include <cmath>
#include <cstdint>
#include <limits>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

inline float sq_dist(const float* p, const float* q) {
  const float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
  return dx * dx + dy * dy + dz * dz;
}

}  // namespace

extern "C" {

// Voxel-grid subsampling: the first point (in input order) of each voxel
// of side `cell`. Writes at most max_out indices, returns their count. The
// voxel coordinates are packed into 21 bits an axis around a 2^20 offset,
// so the caller keeps |coordinate| / cell below 2^20 - 1.
int grid_subsample(const float* pts, int n, float cell, int* out_idx, int max_out) {
  if (n <= 0 || cell <= 0.f || max_out <= 0) return 0;
  std::unordered_map<uint64_t, int> seen;
  seen.reserve(static_cast<size_t>(n));
  int count = 0;
  for (int i = 0; i < n && count < max_out; ++i) {
    const float* p = pts + 3 * i;
    uint64_t key = 0;
    for (int a = 0; a < 3; ++a) {
      const int64_t g = static_cast<int64_t>(std::floor(p[a] / cell)) + (1 << 20);
      key |= (static_cast<uint64_t>(g) & 0x1FFFFF) << (21 * a);
    }
    if (seen.emplace(key, i).second) out_idx[count++] = i;
  }
  return count;
}

// Farthest point sampling from index `start` (0 when start >= n): each step
// takes the point whose distance to the chosen set is largest, the first
// such index on ties.
void fps(const float* pts, int n, int m, int start, int* out_idx) {
  if (n <= 0 || m <= 0) return;
  std::vector<float> dist(static_cast<size_t>(n), std::numeric_limits<float>::max());
  int farthest = start < n ? start : 0;
  for (int s = 0; s < m; ++s) {
    out_idx[s] = farthest;
    const float* c = pts + 3 * farthest;
    float best = -1.f;
    int best_i = 0;
    for (int i = 0; i < n; ++i) {
      const float d = sq_dist(pts + 3 * i, c);
      if (d < dist[i]) dist[i] = d;
      if (dist[i] > best) {
        best = dist[i];
        best_i = i;
      }
    }
    farthest = best_i;
  }
}

// Brute-force kNN: out_idx [q, k] row-major, the k nearest of n points to
// each query by ascending squared distance, the earlier index first on
// ties; with k > n the row is padded with its farthest neighbour.
void knn(const float* pts, int n, const float* queries, int q, int k, int* out_idx) {
  if (n <= 0 || q <= 0 || k <= 0) return;
  const int kk = k < n ? k : n;
  std::vector<std::pair<float, int>> best(static_cast<size_t>(kk));
  for (int j = 0; j < q; ++j) {
    const float* Q = queries + 3 * j;
    int filled = 0;
    for (int i = 0; i < n; ++i) {
      const float d = sq_dist(pts + 3 * i, Q);
      int pos;
      if (filled < kk) {
        pos = filled++;
      } else if (d < best[kk - 1].first) {
        pos = kk - 1;
      } else {
        continue;
      }
      // insertion after every entry <= d keeps equal distances in index order
      while (pos > 0 && best[pos - 1].first > d) {
        best[pos] = best[pos - 1];
        --pos;
      }
      best[pos] = {d, i};
    }
    for (int s = 0; s < k; ++s) out_idx[j * k + s] = best[s < kk ? s : kk - 1].second;
  }
}

// Bidirectional chamfer distance, mean of the nearest Euclidean distances
// each way; the square roots are taken and summed in double, in order.
float chamfer(const float* a, int n, const float* b, int m) {
  if (n <= 0 || m <= 0) return 0.f;
  double fwd = 0.0, bwd = 0.0;
  std::vector<float> min_b(static_cast<size_t>(m), std::numeric_limits<float>::max());
  for (int i = 0; i < n; ++i) {
    const float* p = a + 3 * i;
    float nearest = std::numeric_limits<float>::max();
    for (int j = 0; j < m; ++j) {
      const float d = sq_dist(p, b + 3 * j);
      if (d < nearest) nearest = d;
      if (d < min_b[j]) min_b[j] = d;
    }
    fwd += std::sqrt(static_cast<double>(nearest));
  }
  for (int j = 0; j < m; ++j) bwd += std::sqrt(static_cast<double>(min_b[j]));
  return static_cast<float>(fwd / n + bwd / m);
}

}  // extern "C"
