// pst_native: host-side setup kernels for pysolvers_tpu.
//
// The reference delegates its native work to SuperLU/scipy C kernels
// (SURVEY §2.1); this library is the framework's equivalent runtime:
// everything latency-critical in the *setup phase* — incomplete
// factorization, SpGEMM for Galerkin products, aggregation, level
// scheduling, bandwidth-reducing reordering, MatrixMarket parsing — runs
// here, producing the static plans the device kernels consume.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Buffers are caller-allocated numpy arrays unless noted; functions that
// produce variable-size output use an opaque result handle + copy-out.
//
// Build: see native/build.sh (g++ -O3 -march=native -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cctype>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Opaque variable-size result: {indptr, indices, data}
// ---------------------------------------------------------------------------

struct CsrResult {
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<double> data;
};

void* csr_result_new() { return new CsrResult(); }
void csr_result_free(void* h) { delete static_cast<CsrResult*>(h); }
int64_t csr_result_nnz(void* h) {
  return static_cast<int64_t>(static_cast<CsrResult*>(h)->indices.size());
}
int64_t csr_result_nrows(void* h) {
  return static_cast<int64_t>(static_cast<CsrResult*>(h)->indptr.size()) - 1;
}
void csr_result_copy(void* h, int64_t* indptr, int32_t* indices,
                     double* data) {
  auto* r = static_cast<CsrResult*>(h);
  std::memcpy(indptr, r->indptr.data(), r->indptr.size() * sizeof(int64_t));
  std::memcpy(indices, r->indices.data(),
              r->indices.size() * sizeof(int32_t));
  std::memcpy(data, r->data.data(), r->data.size() * sizeof(double));
}

// ---------------------------------------------------------------------------
// SpGEMM: C = A * B  (Gustavson, dense accumulator)
// ---------------------------------------------------------------------------

static void spgemm_rows(int64_t i0, int64_t i1, int64_t k,
                        const int64_t* a_indptr, const int32_t* a_indices,
                        const double* a_data, const int64_t* b_indptr,
                        const int32_t* b_indices, const double* b_data,
                        std::vector<int64_t>& row_nnz,
                        std::vector<int32_t>& out_idx,
                        std::vector<double>& out_val) {
  std::vector<double> acc(k, 0.0);
  std::vector<int64_t> mark(k, -1);
  std::vector<int32_t> cols;
  cols.reserve(64);
  for (int64_t i = i0; i < i1; ++i) {
    cols.clear();
    for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      const int32_t a_col = a_indices[p];
      const double a_val = a_data[p];
      for (int64_t q = b_indptr[a_col]; q < b_indptr[a_col + 1]; ++q) {
        const int32_t c = b_indices[q];
        if (mark[c] != i) {
          mark[c] = i;
          acc[c] = 0.0;
          cols.push_back(c);
        }
        acc[c] += a_val * b_data[q];
      }
    }
    std::sort(cols.begin(), cols.end());
    for (int32_t c : cols) {
      out_idx.push_back(c);
      out_val.push_back(acc[c]);
    }
    row_nnz[i - i0] = static_cast<int64_t>(cols.size());
  }
}

// Parallel Gustavson: contiguous row ranges per thread, each with its
// own dense accumulator/mark table and output buffers, stitched in row
// order afterwards.  The SA-AMG triple products R·(A·P) are the setup
// wall at n >= 1e6 (SURVEY §2.1 "scipy SpGEMM"); Gustavson is
// embarrassingly row-parallel.
void spgemm(int64_t n, int64_t m, int64_t k, const int64_t* a_indptr,
            const int32_t* a_indices, const double* a_data,
            const int64_t* b_indptr, const int32_t* b_indices,
            const double* b_data, void* out) {
  auto* r = static_cast<CsrResult*>(out);
  const int64_t flops_hint = a_indptr[n];
  unsigned hw = std::thread::hardware_concurrency();
  int nt = (flops_hint > 200000 && hw > 1)
               ? static_cast<int>(std::min<unsigned>(hw, 8))
               : 1;
  if (nt > 1 && n < nt * 64) nt = 1;

  std::vector<std::vector<int64_t>> rn(nt);
  std::vector<std::vector<int32_t>> oi(nt);
  std::vector<std::vector<double>> ov(nt);
  std::vector<std::thread> ts;
  const int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int64_t i0 = t * chunk;
    const int64_t i1 = std::min<int64_t>(n, i0 + chunk);
    rn[t].assign(std::max<int64_t>(i1 - i0, 0), 0);
    if (i0 >= i1) continue;
    if (nt == 1) {
      spgemm_rows(i0, i1, k, a_indptr, a_indices, a_data, b_indptr,
                  b_indices, b_data, rn[t], oi[t], ov[t]);
    } else {
      ts.emplace_back(spgemm_rows, i0, i1, k, a_indptr, a_indices,
                      a_data, b_indptr, b_indices, b_data,
                      std::ref(rn[t]), std::ref(oi[t]), std::ref(ov[t]));
    }
  }
  for (auto& th : ts) th.join();

  int64_t total = 0;
  for (int t = 0; t < nt; ++t)
    total += static_cast<int64_t>(oi[t].size());
  r->indptr.clear();
  r->indptr.reserve(n + 1);
  r->indptr.push_back(0);
  r->indices.reserve(total);
  r->data.reserve(total);
  for (int t = 0; t < nt; ++t) {
    for (int64_t c : rn[t])
      r->indptr.push_back(r->indptr.back() + c);
    r->indices.insert(r->indices.end(), oi[t].begin(), oi[t].end());
    r->data.insert(r->data.end(), ov[t].begin(), ov[t].end());
  }
  (void)m;
}

// ---------------------------------------------------------------------------
// CSR SpMV: y = A x (f64).  The host-side high-precision residual oracle
// of the mixed-precision refinement loop (linear/refine.py) — numpy's
// add.at/fancy-gather route costs ~10 s at 7e6 nnz on slow-memory hosts;
// this sequential C loop is memory-latency bound only.
// ---------------------------------------------------------------------------

void csr_matvec(int64_t n, const int64_t* indptr, const int32_t* indices,
                const double* data, const double* x, double* y) {
  for (int64_t i = 0; i < n; ++i) {
    double acc = 0.0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      acc += data[p] * x[indices[p]];
    y[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// ILUT factorization (Saad dual-threshold), CSR in, L/U CSR out.
// L has unit diagonal stored explicitly; U holds the diagonal first.
// ---------------------------------------------------------------------------

void ilut(int64_t n, const int64_t* indptr, const int32_t* indices,
          const double* data, double drop_tol, double fill_factor,
          void* l_out, void* u_out) {
  auto* L = static_cast<CsrResult*>(l_out);
  auto* U = static_cast<CsrResult*>(u_out);
  L->indptr.assign(1, 0);
  U->indptr.assign(1, 0);

  // U rows (needed for elimination): store per-row slices into U arrays.
  std::vector<int64_t> u_row_start(n, 0), u_row_end(n, 0);
  std::vector<double> u_diag(n, 0.0);

  std::vector<double> w(n, 0.0);      // dense work row
  std::vector<uint8_t> in_w(n, 0);
  std::vector<int32_t> touched;
  touched.reserve(256);

  struct CV {
    int32_t c;
    double v;
  };
  std::vector<CV> lower, upper;

  for (int64_t i = 0; i < n; ++i) {
    touched.clear();
    double row_norm = 0.0;
    int64_t row_nnz = indptr[i + 1] - indptr[i];
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t c = indices[p];
      w[c] = data[p];
      in_w[c] = 1;
      touched.push_back(c);
      row_norm += data[p] * data[p];
    }
    row_norm = std::sqrt(row_norm);
    const double tau_i = drop_tol * row_norm;
    const int64_t cap =
        std::max<int64_t>(static_cast<int64_t>(fill_factor * row_nnz),
                          row_nnz ? row_nnz : 1);

    // eliminate ascending k < i using a small heap over touched lower cols
    std::priority_queue<int32_t, std::vector<int32_t>,
                        std::greater<int32_t>>
        heap;
    for (int32_t c : touched)
      if (c < i) heap.push(c);
    lower.clear();
    while (!heap.empty()) {
      const int32_t kk = heap.top();
      heap.pop();
      if (!in_w[kk]) continue;
      const double wk = w[kk];
      in_w[kk] = 0;
      w[kk] = 0.0;
      const double piv = u_diag[kk];
      if (piv == 0.0) continue;
      const double lik = wk / piv;
      if (std::fabs(lik) <= tau_i) continue;
      lower.push_back({kk, lik});
      for (int64_t q = u_row_start[kk]; q < u_row_end[kk]; ++q) {
        const int32_t c = U->indices[q];
        if (c == kk) continue;
        const double upd = lik * U->data[q];
        if (in_w[c]) {
          w[c] -= upd;
        } else if (std::fabs(upd) > tau_i) {
          w[c] = -upd;
          in_w[c] = 1;
          touched.push_back(c);
          if (c < i) heap.push(c);
        }
      }
    }

    // gather upper part + diagonal
    double diag = 0.0;
    upper.clear();
    for (int32_t c : touched) {
      if (!in_w[c]) continue;
      const double v = w[c];
      in_w[c] = 0;
      w[c] = 0.0;
      if (c == i) {
        diag = v;
      } else if (c > i && std::fabs(v) > tau_i) {
        upper.push_back({c, v});
      }
    }
    if (diag == 0.0) diag = (tau_i > 0.0) ? tau_i : 1e-12;

    auto keep_largest = [cap](std::vector<CV>& vec) {
      if (static_cast<int64_t>(vec.size()) > cap) {
        std::nth_element(vec.begin(), vec.begin() + cap, vec.end(),
                         [](const CV& a, const CV& b) {
                           return std::fabs(a.v) > std::fabs(b.v);
                         });
        vec.resize(cap);
      }
      std::sort(vec.begin(), vec.end(),
                [](const CV& a, const CV& b) { return a.c < b.c; });
    };
    keep_largest(lower);
    keep_largest(upper);

    for (const CV& cv : lower) {
      L->indices.push_back(cv.c);
      L->data.push_back(cv.v);
    }
    L->indices.push_back(static_cast<int32_t>(i));
    L->data.push_back(1.0);
    L->indptr.push_back(static_cast<int64_t>(L->indices.size()));

    u_row_start[i] = static_cast<int64_t>(U->indices.size());
    U->indices.push_back(static_cast<int32_t>(i));
    U->data.push_back(diag);
    u_diag[i] = diag;
    for (const CV& cv : upper) {
      U->indices.push_back(cv.c);
      U->data.push_back(cv.v);
    }
    u_row_end[i] = static_cast<int64_t>(U->indices.size());
    U->indptr.push_back(static_cast<int64_t>(U->indices.size()));
  }
}

// ---------------------------------------------------------------------------
// Topological levels of a triangular factor (for level-scheduled trisolve)
// ---------------------------------------------------------------------------

void levelize(int64_t n, const int64_t* indptr, const int32_t* indices,
              int32_t lower, int64_t* level_out) {
  if (lower) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t lv = 0;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        const int32_t c = indices[p];
        if (c < i) lv = std::max(lv, level_out[c] + 1);
      }
      level_out[i] = lv;
    }
  } else {
    for (int64_t i = n - 1; i >= 0; --i) {
      int64_t lv = 0;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        const int32_t c = indices[p];
        if (c > i) lv = std::max(lv, level_out[c] + 1);
      }
      level_out[i] = lv;
    }
  }
}

// ---------------------------------------------------------------------------
// Greedy 3-phase aggregation on a strength graph (SA-AMG setup)
// graph: CSR adjacency of strong off-diagonal connections
// ---------------------------------------------------------------------------

int64_t aggregate(int64_t n, const int64_t* indptr, const int32_t* indices,
                  int64_t* agg_out) {
  std::fill(agg_out, agg_out + n, -1);
  int64_t n_agg = 0;
  for (int64_t i = 0; i < n; ++i) {  // phase 1
    if (agg_out[i] != -1) continue;
    bool clean = true;
    for (int64_t p = indptr[i]; p < indptr[i + 1] && clean; ++p)
      clean = agg_out[indices[p]] == -1;
    if (clean) {
      agg_out[i] = n_agg;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
        agg_out[indices[p]] = n_agg;
      ++n_agg;
    }
  }
  for (int64_t i = 0; i < n; ++i) {  // phase 2
    if (agg_out[i] != -1) continue;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (agg_out[indices[p]] != -1) {
        agg_out[i] = agg_out[indices[p]];
        break;
      }
    }
  }
  for (int64_t i = 0; i < n; ++i)  // phase 3
    if (agg_out[i] == -1) agg_out[i] = n_agg++;
  return n_agg;
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee reordering (bandwidth reduction for windowed SpMV)
// ---------------------------------------------------------------------------

static void rcm_core(int64_t n, const int64_t* indptr, const int32_t* indices,
                     int64_t* perm_out) {
  std::vector<int64_t> deg(n);
  for (int64_t i = 0; i < n; ++i) deg[i] = indptr[i + 1] - indptr[i];
  std::vector<uint8_t> seen(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> frontier;
  // component starts in min-degree order via one upfront sort + rolling
  // cursor — a per-component O(n) rescan makes RCM O(n * #components),
  // quadratic on graphs that disconnect into many islands
  std::vector<int64_t> by_deg(n);
  for (int64_t i = 0; i < n; ++i) by_deg[i] = i;
  std::sort(by_deg.begin(), by_deg.end(),
            [&deg](int64_t a, int64_t b) { return deg[a] < deg[b]; });
  size_t cursor = 0;
  while (static_cast<int64_t>(order.size()) < n) {
    while (cursor < by_deg.size() && seen[by_deg[cursor]]) ++cursor;
    if (cursor >= by_deg.size()) break;
    const int64_t s = by_deg[cursor];
    seen[s] = 1;
    order.push_back(s);
    size_t head = order.size() - 1;
    while (head < order.size()) {
      const int64_t u = order[head++];
      frontier.clear();
      for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
        const int32_t v = indices[p];
        if (!seen[v]) {
          seen[v] = 1;
          frontier.push_back(v);
        }
      }
      std::sort(frontier.begin(), frontier.end(),
                [&deg](int64_t a, int64_t b) { return deg[a] < deg[b]; });
      for (int64_t v : frontier) order.push_back(v);
    }
  }
  // reverse
  for (int64_t i = 0; i < n; ++i) perm_out[i] = order[n - 1 - i];
}

void rcm(int64_t n, const int64_t* indptr, const int32_t* indices,
         int64_t* perm_out) {
  rcm_core(n, indptr, indices, perm_out);
}

// ---------------------------------------------------------------------------
// Symmetric-permutation reorder plan: P·A·Pᵀ symbolic pass.
// new row i = old row perm[i]; emits the CSR-ordered gather `order`
// (new data = old data[order]) plus the permuted indptr/indices, so the
// Python layer's symbolic/numeric cache split (HostCSR.permute_symmetric)
// re-permutes same-structure matrices with a single value gather.
// Replaces a 2-key numpy lexsort over nnz (~6 s at 29M nnz): each new
// row is a segment copy + one small std::sort by new column, parallel
// over row chunks.  Caller allocates out arrays (sizes known: n+1, nnz).
// ---------------------------------------------------------------------------

static void permute_rows(int64_t i0, int64_t i1, const int64_t* indptr,
                         const int32_t* indices, const int64_t* perm,
                         const int64_t* iperm, const int64_t* out_indptr,
                         int32_t* out_indices, int64_t* out_order) {
  std::vector<std::pair<int32_t, int64_t>> seg;
  for (int64_t i = i0; i < i1; ++i) {
    const int64_t p = perm[i];
    const int64_t b = indptr[p], e = indptr[p + 1];
    seg.clear();
    for (int64_t j = b; j < e; ++j)
      seg.emplace_back((int32_t)iperm[indices[j]], j);
    std::sort(seg.begin(), seg.end());
    int64_t o = out_indptr[i];
    for (const auto& cj : seg) {
      out_indices[o] = cj.first;
      out_order[o] = cj.second;
      ++o;
    }
  }
}

void csr_permute_plan(int64_t n, const int64_t* indptr,
                      const int32_t* indices, const int64_t* perm,
                      int64_t* out_indptr, int32_t* out_indices,
                      int64_t* out_order) {
  std::vector<int64_t> iperm(n);
  for (int64_t i = 0; i < n; ++i) iperm[perm[i]] = i;
  out_indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i)
    out_indptr[i + 1] = out_indptr[i] + (indptr[perm[i] + 1] - indptr[perm[i]]);
  const int64_t nnz = indptr[n];
  unsigned hw = std::thread::hardware_concurrency();
  int nt = (nnz > 200000 && hw > 1) ? (int)std::min<unsigned>(hw, 8) : 1;
  if (nt > 1 && n < nt * 64) nt = 1;
  if (nt == 1) {
    permute_rows(0, n, indptr, indices, perm, iperm.data(), out_indptr,
                 out_indices, out_order);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int64_t i0 = t * chunk;
    const int64_t i1 = std::min<int64_t>(n, i0 + chunk);
    if (i0 >= i1) continue;
    ts.emplace_back(permute_rows, i0, i1, indptr, indices, perm,
                    iperm.data(), out_indptr, out_indices, out_order);
  }
  for (auto& th : ts) th.join();
}

// RCM of the symmetrized adjacency A + A^T, built here in O(nnz) by
// counting-sort instead of a host CSR add (which costs two numpy
// lexsorts — ~70 ms on DH-15, over half the whole pack-geometry pass).
// Edges are NOT dedup'd: mutual edges (and diagonals) count twice toward
// a node's degree while one-directional edges count once, so degree
// tie-breaking can differ from RCM on a dedup'd A+A^T — both are valid
// bandwidth-reducing orderings (the pack treats the permutation as an
// input, not a canonical form); BFS correctness is unaffected (the
// `seen` flag absorbs repeats).
void sym_rcm(int64_t n, const int64_t* indptr, const int32_t* indices,
             int64_t* perm_out) {
  const int64_t nnz = indptr[n];
  std::vector<int64_t> sp(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) sp[i + 1] = indptr[i + 1] - indptr[i];
  for (int64_t p = 0; p < nnz; ++p) sp[indices[p] + 1]++;
  for (int64_t i = 0; i < n; ++i) sp[i + 1] += sp[i];
  std::vector<int32_t> adj(2 * nnz);
  std::vector<int64_t> pos(sp.begin(), sp.end() - 1);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = indices[p];
      adj[pos[i]++] = j;       // forward edge i -> j
      adj[pos[j]++] = (int32_t)i;  // reverse edge j -> i
    }
  rcm_core(n, sp.data(), adj.data(), perm_out);
}

// ---------------------------------------------------------------------------
// MatrixMarket coordinate parser (fast path for the DH suite)
// returns nnz read (or a negative error -> Python fallback); caller
// allocates rows/cols/vals with capacity ``cap`` >= header nnz
// ---------------------------------------------------------------------------

static bool read_full_line(FILE* f, char* buf, size_t cap) {
  // fgets + drain: a line longer than the buffer (legal in comments)
  // must not leak its tail into the next parse as a phantom line
  if (!std::fgets(buf, cap, f)) return false;
  if (!std::strchr(buf, '\n') && !std::feof(f)) {
    int ch;
    while ((ch = std::fgetc(f)) != EOF && ch != '\n') {
    }
  }
  return true;
}

int64_t mtx_read(const char* path, int64_t* rows, int64_t* cols, double* vals,
                 int64_t cap, int64_t* shape_out, int32_t* symmetric_out) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char line[4096];
  if (!read_full_line(f, line, sizeof line)) {
    std::fclose(f);
    return -1;
  }
  // banner keywords are case-insensitive per the MTX spec (the Python
  // fallback lowercases) — normalize before matching
  for (char* q = line; *q; ++q)
    *q = static_cast<char>(std::tolower(static_cast<unsigned char>(*q)));
  // only 'coordinate real/integer general|symmetric' handled here; the
  // Python fallback raises clear errors for everything else
  if (!std::strstr(line, "%%matrixmarket") ||
      !std::strstr(line, "coordinate") ||
      std::strstr(line, "skew-symmetric") || std::strstr(line, "hermitian") ||
      std::strstr(line, "complex") || std::strstr(line, "pattern")) {
    std::fclose(f);
    return -3;
  }
  *symmetric_out = std::strstr(line, "symmetric") != nullptr;
  do {
    if (!read_full_line(f, line, sizeof line)) {
      std::fclose(f);
      return -1;
    }
  } while (line[0] == '%');
  long long n = 0, m = 0, nnz = 0;
  if (std::sscanf(line, "%lld %lld %lld", &n, &m, &nnz) != 3) {
    std::fclose(f);
    return -3;
  }
  shape_out[0] = n;
  shape_out[1] = m;
  if (nnz > cap) {
    std::fclose(f);
    return -2;
  }
  int64_t got = 0;
  while (got < nnz && read_full_line(f, line, sizeof line)) {
    long long r, c;
    double v = 1.0;
    const int k = std::sscanf(line, "%lld %lld %lf", &r, &c, &v);
    if (k < 2) continue;
    rows[got] = r - 1;
    cols[got] = c - 1;
    vals[got] = v;
    ++got;
  }
  std::fclose(f);
  // a truncated/corrupt file must fail loudly (Python fallback path),
  // not hand the solver a partial operator
  if (got != nnz) return -4;
  return got;
}

}  // extern "C"
