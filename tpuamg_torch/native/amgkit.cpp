// amgkit: native host-side kernels for AMG setup graph work.
//
// A copy of the JAX package's native/amgkit.cpp, built and loaded by
// tpuamg_torch/native/__init__.py.  AMG setup runs on the host; this
// library holds the C++ versions of the setup's graph algorithms where
// vectorized numpy is weakest:
//   - coo_to_csr      COO -> coalesced CSR (bucket sort)
//   - csr_spgemm      Gustavson sparse matrix-matrix product
//   - greedy_color    distance-1 greedy graph coloring (capped)
//   - vmb_aggregation Vanek-Mandel-Brezina 3-pass standard aggregation
//   - hem_matching    greedy heavy-edge matching over weight-sorted edges
//   - greedy_mis      ordered maximal independent set
//
// Exposed with a plain C ABI, loaded from Python via ctypes; the numpy
// implementations remain as the plain route and the oracle.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// SpGEMM (Gustavson). Two-pass: count then fill. Returns nnz(C);
// caller allocates. Pass phase=0 to compute row counts into c_indptr
// (length n+1, caller zeroed), phase=1 to fill c_indices/c_data given
// finished c_indptr.
// ---------------------------------------------------------------------
void csr_spgemm_count(
    int64_t n_rows, int64_t n_cols_b,
    const int64_t* a_indptr, const int32_t* a_indices,
    const int64_t* b_indptr, const int32_t* b_indices,
    int64_t* c_indptr /* out, len n_rows+1 */) {
  std::vector<int64_t> marker(n_cols_b, -1);
  c_indptr[0] = 0;
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t count = 0;
    for (int64_t jp = a_indptr[i]; jp < a_indptr[i + 1]; ++jp) {
      const int32_t j = a_indices[jp];
      for (int64_t kp = b_indptr[j]; kp < b_indptr[j + 1]; ++kp) {
        const int32_t k = b_indices[kp];
        if (marker[k] != i) {
          marker[k] = i;
          ++count;
        }
      }
    }
    c_indptr[i + 1] = c_indptr[i] + count;
  }
}

void csr_spgemm_fill(
    int64_t n_rows, int64_t n_cols_b,
    const int64_t* a_indptr, const int32_t* a_indices, const double* a_data,
    const int64_t* b_indptr, const int32_t* b_indices, const double* b_data,
    const int64_t* c_indptr, int32_t* c_indices, double* c_data) {
  std::vector<int64_t> marker(n_cols_b, -1);
  std::vector<double> sums(n_cols_b, 0.0);
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t head = c_indptr[i];
    int64_t count = head;
    for (int64_t jp = a_indptr[i]; jp < a_indptr[i + 1]; ++jp) {
      const int32_t j = a_indices[jp];
      const double av = a_data[jp];
      for (int64_t kp = b_indptr[j]; kp < b_indptr[j + 1]; ++kp) {
        const int32_t k = b_indices[kp];
        if (marker[k] < head) {
          marker[k] = count;
          c_indices[count] = k;
          sums[k] = av * b_data[kp];
          ++count;
        } else {
          sums[k] += av * b_data[kp];
        }
      }
    }
    // sort the row's column indices for canonical CSR
    std::sort(c_indices + head, c_indices + count);
    for (int64_t p = head; p < count; ++p) c_data[p] = sums[c_indices[p]];
  }
}

// ---------------------------------------------------------------------
// COO -> canonical CSR with duplicate summation.  Bucket by row
// (counting sort, O(nnz)), per-row sort by column, compact duplicates
// in place.  Returns the coalesced nnz; indptr is rewritten to the
// compacted layout.  This is the assembly hot path (FE scatter
// produces ~(d+1)^2 duplicates per cell; np.lexsort was the profile's
// top cost at n=512 — host.py::_coalesce_coo).
// ---------------------------------------------------------------------
int64_t coo_to_csr(
    int64_t n, int64_t nnz,
    const int64_t* rows, const int64_t* cols, const double* vals,
    int64_t* indptr /* out, len n+1 */,
    int32_t* out_cols /* out, len nnz */, double* out_vals) {
  std::vector<int64_t> cnt(n + 1, 0);
  for (int64_t k = 0; k < nnz; ++k) ++cnt[rows[k] + 1];
  for (int64_t i = 0; i < n; ++i) cnt[i + 1] += cnt[i];
  std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
  std::vector<int32_t> tc(nnz);
  std::vector<double> tv(nnz);
  for (int64_t k = 0; k < nnz; ++k) {
    const int64_t p = cur[rows[k]]++;
    tc[p] = static_cast<int32_t>(cols[k]);
    tv[p] = vals[k];
  }
  int64_t w = 0;
  indptr[0] = 0;
  std::vector<std::pair<int32_t, double>> buf;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = cnt[i], hi = cnt[i + 1];
    const int64_t len = hi - lo;
    int32_t* rc = tc.data() + lo;
    double* rv = tv.data() + lo;
    if (len <= 32) {
      // insertion sort on (col, val) pairs: FE rows are ~(d+1)^2 long
      // and the perm+std::sort indirection dominated the profile
      for (int64_t a = 1; a < len; ++a) {
        const int32_t ca = rc[a];
        const double va = rv[a];
        int64_t b = a - 1;
        for (; b >= 0 && rc[b] > ca; --b) {
          rc[b + 1] = rc[b];
          rv[b + 1] = rv[b];
        }
        rc[b + 1] = ca;
        rv[b + 1] = va;
      }
    } else {
      buf.resize(len);
      for (int64_t a = 0; a < len; ++a) buf[a] = {rc[a], rv[a]};
      std::sort(buf.begin(), buf.end(),
                [](const std::pair<int32_t, double>& x,
                   const std::pair<int32_t, double>& y) {
                  return x.first < y.first;
                });
      for (int64_t a = 0; a < len; ++a) {
        rc[a] = buf[a].first;
        rv[a] = buf[a].second;
      }
    }
    int64_t p = 0;
    while (p < len) {
      const int32_t c = rc[p];
      double s = 0.0;
      while (p < len && rc[p] == c) s += rv[p++];
      out_cols[w] = c;
      out_vals[w++] = s;
    }
    indptr[i + 1] = w;
  }
  return w;
}

// ---------------------------------------------------------------------
// Greedy coloring (largest-degree-first), overflow color = max_colors.
// ---------------------------------------------------------------------
void greedy_color(
    int64_t n, const int64_t* indptr, const int32_t* indices,
    int32_t max_colors, int32_t* colors /* out len n */) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return (indptr[a + 1] - indptr[a]) > (indptr[b + 1] - indptr[b]);
  });
  std::fill(colors, colors + n, -1);
  std::vector<int32_t> used(max_colors + 1, -1);
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = indices[p];
      if (j != i && colors[j] >= 0 && colors[j] < max_colors)
        used[colors[j]] = (int32_t)oi;
    }
    int32_t c = 0;
    while (c < max_colors && used[c] == (int32_t)oi) ++c;
    colors[i] = std::min(c, max_colors);
  }
}

// ---------------------------------------------------------------------
// VMB standard aggregation (3 passes) on a strength graph.
// agg out: aggregate id per node (>= 0). Returns number of aggregates.
// ---------------------------------------------------------------------
int64_t vmb_aggregation(
    int64_t n, const int64_t* indptr, const int32_t* indices,
    int64_t max_agg, int64_t* agg /* out len n */) {
  std::fill(agg, agg + n, (int64_t)-1);
  int64_t nagg = 0;
  // pass 1
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    bool free_nbhd = true;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (agg[indices[p]] >= 0) { free_nbhd = false; break; }
    if (!free_nbhd) continue;
    agg[i] = nagg;
    int64_t taken = 1;
    for (int64_t p = indptr[i]; p < indptr[i + 1] && taken < max_agg; ++p) {
      agg[indices[p]] = nagg;
      ++taken;
    }
    ++nagg;
  }
  // pass 2: attach to a neighboring aggregate
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (agg[indices[p]] >= 0) { agg[i] = agg[indices[p]]; break; }
    }
  }
  // pass 3: new aggregates from leftovers
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    agg[i] = nagg;
    int64_t taken = 1;
    for (int64_t p = indptr[i]; p < indptr[i + 1] && taken < max_agg; ++p) {
      if (agg[indices[p]] < 0) { agg[indices[p]] = nagg; ++taken; }
    }
    ++nagg;
  }
  return nagg;
}

// ---------------------------------------------------------------------
// Heavy-edge matching: greedy over edges sorted by descending weight
// (serial quality reference for the vectorized hand-shaking version).
// match out: partner (or -1). Returns number of matched pairs.
// ---------------------------------------------------------------------
int64_t hem_matching(
    int64_t n, int64_t nnz,
    const int64_t* rows, const int32_t* cols, const double* weights,
    int64_t* match /* out len n */) {
  std::vector<int64_t> order(nnz);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return weights[a] > weights[b];
  });
  std::fill(match, match + n, (int64_t)-1);
  int64_t pairs = 0;
  for (int64_t e = 0; e < nnz; ++e) {
    const int64_t i = rows[order[e]];
    const int64_t j = cols[order[e]];
    if (i == j || match[i] >= 0 || match[j] >= 0) continue;
    match[i] = j;
    match[j] = i;
    ++pairs;
  }
  return pairs;
}

// ---------------------------------------------------------------------
// Ordered greedy MIS restricted to candidate set (1 = candidate).
// out: 1 if seed. Returns seed count.
// ---------------------------------------------------------------------
int64_t greedy_mis(
    int64_t n, const int64_t* indptr, const int32_t* indices,
    const uint8_t* candidate, uint8_t* seed /* out len n */) {
  std::vector<uint8_t> state(n, 0);  // 0 free, 1 seed, 2 blocked
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    seed[i] = 0;
    if (!candidate[i] || state[i] != 0) continue;
    state[i] = 1;
    seed[i] = 1;
    ++count;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = indices[p];
      if (state[j] == 0) state[j] = 2;
    }
  }
  return count;
}

}  // extern "C"
