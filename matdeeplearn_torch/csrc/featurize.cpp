// Native graph featurizer: MIC distance matrices + radius/kNN trimming.
//
// This is the host-side hot loop of preprocessing (the reference spends it
// in ase.get_all_distances + scipy rankdata per structure,
// process/process.py:284-297). Semantics are bit-compatible with
// matdeeplearn_torch/data/graphs.py:build_graph (the numpy featurizer):
//   * minimum-image distances: fractional deltas wrapped to [-0.5, 0.5)
//     on periodic axes, minimum over the 3^p neighboring-image shifts
//   * per-row ordinal ranking by distance (ties -> lower column), entries
//     beyond `radius` excluded, keep ranks <= max_neighbors+1
//   * row-major edge emission of kept nonzero entries, then self-loops
//     (i, i, 0) appended for every atom
//
// Parallelism: OpenMP over structures. Exposed via a C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// 3x3 inverse; returns false if singular.
bool invert3(const double* m, double* inv) {
  double a = m[0], b = m[1], c = m[2];
  double d = m[3], e = m[4], f = m[5];
  double g = m[6], h = m[7], i = m[8];
  double det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
  if (std::fabs(det) < 1e-12) return false;
  double id = 1.0 / det;
  inv[0] = (e * i - f * h) * id;
  inv[1] = (c * h - b * i) * id;
  inv[2] = (b * f - c * e) * id;
  inv[3] = (f * g - d * i) * id;
  inv[4] = (a * i - c * g) * id;
  inv[5] = (c * d - a * f) * id;
  inv[6] = (d * h - e * g) * id;
  inv[7] = (b * g - a * h) * id;
  inv[8] = (a * e - b * d) * id;
  return true;
}

void mic_distances(const double* pos, int n, const double* cell,
                   const uint8_t* pbc, std::vector<double>& d) {
  double inv[9];
  bool periodic = (pbc[0] || pbc[1] || pbc[2]) && invert3(cell, inv);
  int ra = pbc[0] && periodic ? 1 : 0;
  int rb = pbc[1] && periodic ? 1 : 0;
  int rc = pbc[2] && periodic ? 1 : 0;

  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      double dx = pos[3 * j + 0] - pos[3 * i + 0];
      double dy = pos[3 * j + 1] - pos[3 * i + 1];
      double dz = pos[3 * j + 2] - pos[3 * i + 2];
      if (!periodic) {
        d[(size_t)i * n + j] = std::sqrt(dx * dx + dy * dy + dz * dz);
        continue;
      }
      // fractional
      double fx = dx * inv[0] + dy * inv[3] + dz * inv[6];
      double fy = dx * inv[1] + dy * inv[4] + dz * inv[7];
      double fz = dx * inv[2] + dy * inv[5] + dz * inv[8];
      if (pbc[0]) fx -= std::round(fx);
      if (pbc[1]) fy -= std::round(fy);
      if (pbc[2]) fz -= std::round(fz);
      double best = 1e300;
      for (int sa = -ra; sa <= ra; ++sa)
        for (int sb = -rb; sb <= rb; ++sb)
          for (int sc = -rc; sc <= rc; ++sc) {
            double gx = fx + sa, gy = fy + sb, gz = fz + sc;
            double cx = gx * cell[0] + gy * cell[3] + gz * cell[6];
            double cy = gx * cell[1] + gy * cell[4] + gz * cell[7];
            double cz = gx * cell[2] + gy * cell[5] + gz * cell[8];
            double dist2 = cx * cx + cy * cy + cz * cz;
            if (dist2 < best) best = dist2;
          }
      d[(size_t)i * n + j] = std::sqrt(best);
    }
  }
}

}  // namespace

extern "C" {

// Featurize one batch of structures into edge lists.
//
// positions: (total_atoms, 3) row-major; cells: (n_structs, 9);
// pbcs: (n_structs, 3); atom_ptr: (n_structs+1) prefix offsets.
// Outputs are preallocated by the caller with capacity
// atom_count_i * (max_neighbors + 2) edges per structure, laid out
// back-to-back at offsets edge_ptr (computed here): edge_ptr must have
// n_structs+1 slots. Returns 0 on success.
int featurize_graphs(const double* positions, const double* cells,
                     const uint8_t* pbcs, const int64_t* atom_ptr,
                     int64_t n_structs, double radius, int max_neighbors,
                     int32_t* edge_src, int32_t* edge_dst, double* edge_dist,
                     int64_t* edge_ptr) {
  // Capacity per structure (worst case): n * (k+1) kept entries + n loops.
  std::vector<int64_t> counts(n_structs, 0);

#pragma omp parallel for schedule(dynamic)
  for (int64_t s = 0; s < n_structs; ++s) {
    int n = (int)(atom_ptr[s + 1] - atom_ptr[s]);
    const double* pos = positions + 3 * atom_ptr[s];
    std::vector<double> d((size_t)n * n);
    mic_distances(pos, n, cells + 9 * s, pbcs + 3 * s, d);

    // Row-wise trim: ordinal rank by (distance, column), keep <= k+1 among
    // entries with d <= radius.
    std::vector<uint8_t> keep((size_t)n * n, 0);
    std::vector<int> order(n);
    for (int i = 0; i < n; ++i) {
      const double* row = d.data() + (size_t)i * n;
      int m = 0;
      for (int j = 0; j < n; ++j)
        if (row[j] <= radius) order[m++] = j;
      int kkeep = std::min(m, max_neighbors + 1);
      std::partial_sort(
          order.begin(), order.begin() + kkeep, order.begin() + m,
          [row](int a, int b) {
            if (row[a] != row[b]) return row[a] < row[b];
            return a < b;  // stable tie-break by column
          });
      for (int t = 0; t < kkeep; ++t) keep[(size_t)i * n + order[t]] = 1;
    }

    // Emit: row-major nonzero kept entries, then self loops.
    int64_t base = atom_ptr[s] * (int64_t)(max_neighbors + 2);
    int64_t c = 0;
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) {
        double val = d[(size_t)i * n + j];
        if (keep[(size_t)i * n + j] && val != 0.0) {
          edge_src[base + c] = i;
          edge_dst[base + c] = j;
          edge_dist[base + c] = val;
          ++c;
        }
      }
    for (int i = 0; i < n; ++i) {
      edge_src[base + c] = i;
      edge_dst[base + c] = i;
      edge_dist[base + c] = 0.0;
      ++c;
    }
    counts[s] = c;
  }

  edge_ptr[0] = 0;
  for (int64_t s = 0; s < n_structs; ++s) edge_ptr[s + 1] = edge_ptr[s] + counts[s];

  // Compact edges to be contiguous (they were written at capacity offsets).
  int64_t write = 0;
  for (int64_t s = 0; s < n_structs; ++s) {
    int64_t base = atom_ptr[s] * (int64_t)(max_neighbors + 2);
    int64_t c = counts[s];
    if (write != base) {
      std::memmove(edge_src + write, edge_src + base, c * sizeof(int32_t));
      std::memmove(edge_dst + write, edge_dst + base, c * sizeof(int32_t));
      std::memmove(edge_dist + write, edge_dist + base, c * sizeof(double));
    }
    write += c;
  }
  return 0;
}

// Version tag for cache invalidation from Python.
int featurize_abi_version() { return 3; }
}
