// Exact linear-sum-assignment (Jonker-Volgenant shortest augmenting path).
//
// The host-side solver of the JAX package's native/lsap.cpp, copied: an
// independent oracle for the card's K5 (csrc/lsa.cu) and a solver for host
// tooling.  The reference relied on scipy's C extension for the same role
// (the reference's polyphonic/funcs/assigner.py:511-533).
//
// C ABI for ctypes:
//   int lsap_solve(const float* cost, int n_rows, int n_cols, int* row2col)
// Requires n_rows <= n_cols; assigns every row a distinct column minimizing
// total cost. Returns 0 on success, 1 for bad sizes, 2 if infeasible.

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {
constexpr float kInf = std::numeric_limits<float>::infinity();
}

extern "C" int lsap_solve(const float* cost, int n_rows, int n_cols,
                          int* row2col) {
  if (n_rows <= 0 || n_cols <= 0 || n_rows > n_cols) return 1;
  std::vector<float> u(n_rows, 0.f), v(n_cols, 0.f);
  std::vector<int> col4row(n_rows, -1), row4col(n_cols, -1);
  std::vector<float> shortest(n_cols);
  std::vector<int> path(n_cols);
  std::vector<char> sr(n_rows), sc(n_cols);

  for (int cur_row = 0; cur_row < n_rows; ++cur_row) {
    std::fill(shortest.begin(), shortest.end(), kInf);
    std::fill(path.begin(), path.end(), -1);
    std::fill(sr.begin(), sr.end(), 0);
    std::fill(sc.begin(), sc.end(), 0);

    int sink = -1;
    int i = cur_row;
    float min_val = 0.f;
    while (sink == -1) {
      sr[i] = 1;
      const float* row = cost + static_cast<int64_t>(i) * n_cols;
      float lowest = kInf;
      int j_min = -1;
      for (int j = 0; j < n_cols; ++j) {
        if (sc[j]) continue;
        float r = min_val + row[j] - u[i] - v[j];
        if (r < shortest[j]) {
          shortest[j] = r;
          path[j] = i;
        }
        if (shortest[j] < lowest ||
            (shortest[j] == lowest && row4col[j] == -1)) {
          lowest = shortest[j];
          j_min = j;
        }
      }
      if (j_min < 0 || lowest == kInf) return 2;  // infeasible
      min_val = lowest;
      sc[j_min] = 1;
      if (row4col[j_min] == -1) {
        sink = j_min;
      } else {
        i = row4col[j_min];
      }
    }

    u[cur_row] += min_val;
    for (int k = 0; k < n_rows; ++k) {
      if (sr[k] && k != cur_row) u[k] += min_val - shortest[col4row[k]];
    }
    for (int j = 0; j < n_cols; ++j) {
      if (sc[j]) v[j] -= min_val - shortest[j];
    }

    int j = sink;
    while (true) {
      int pi = path[j];
      row4col[j] = pi;
      int next = col4row[pi];
      col4row[pi] = j;
      if (pi == cur_row) break;
      j = next;
    }
  }
  std::memcpy(row2col, col4row.data(), sizeof(int) * n_rows);
  return 0;
}
