// Native host runtime for markovmodels_tpu.
//
// This is the TPU build's analog of the reference's native layer: where
// MarkovModels.jl leans on CUSPARSE C routines for sparse format conversion
// (reference src/linalg.jl:12-67) and on CUDA array-assembly kernels for
// blockdiag/vcat batching (reference src/linalg.jl:69-157), the TPU engine's
// *device* math is JAX/XLA/Pallas, and the host-side graph compiler's hot
// paths live here: semiring COO->CSR assembly with duplicate coalescing,
// O(nnz) CSR transpose, and OpenFST-text graph parsing (the format emitted by
// reference misc/benchmark/generatefsm.jl:42-57).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// All index arrays are int64, all values float64 (the host compiler works in
// float64; the device path converts on upload).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <vector>

#if defined(_OPENMP)
#include <parallel/algorithm>
#endif

extern "C" {

// Semiring ⊕ codes for duplicate coalescing.
enum MMAddOp : int32_t {
  MM_ADD_LOGSUMEXP = 0,  // log semiring
  MM_ADD_MAX = 1,        // tropical / bool semirings
  MM_ADD_SUM = 2,        // prob semiring
};

// ---------------------------------------------------------------------------
// COO -> CSR with semiring duplicate coalescing
// ---------------------------------------------------------------------------

// Sorts (rows, cols, data) by (row, col), ⊕-combines duplicate coordinates,
// and emits CSR. Stored semiring-zero entries are preserved (Julia
// SparseArrays semantics; the reference's tests count nnz to catch
// stored-zero regressions, test/test_fsms.jl:96-98).
//
// out_indptr: nrows+1; out_cols / out_data: capacity >= nnz.
// Returns the coalesced nnz, or -1 on invalid arguments.
int64_t mm_coo_to_csr(int64_t nnz, int64_t nrows, const int64_t* rows,
                      const int64_t* cols, const double* data, int32_t op,
                      int64_t* out_indptr, int64_t* out_cols,
                      double* out_data) {
  if (nnz < 0 || nrows < 0) return -1;
  std::vector<int64_t> perm(static_cast<size_t>(nnz));
  std::iota(perm.begin(), perm.end(), int64_t{0});
  auto cmp = [rows, cols](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  };
#if defined(_OPENMP)
  if (nnz > 1 << 16) {
    __gnu_parallel::sort(perm.begin(), perm.end(), cmp);
  } else {
    std::sort(perm.begin(), perm.end(), cmp);
  }
#else
  std::sort(perm.begin(), perm.end(), cmp);
#endif

  std::vector<int64_t> counts(static_cast<size_t>(nrows) + 1, 0);
  int64_t out_n = 0;
  int64_t g = 0;
  while (g < nnz) {
    const int64_t r = rows[perm[g]];
    const int64_t c = cols[perm[g]];
    if (r < 0 || r >= nrows) return -1;
    int64_t h = g + 1;
    while (h < nnz && rows[perm[h]] == r && cols[perm[h]] == c) ++h;
    double v;
    switch (op) {
      case MM_ADD_LOGSUMEXP: {
        // exact groupwise logsumexp: max-shift, guard the all -inf group
        double m = -HUGE_VAL;
        for (int64_t k = g; k < h; ++k) m = std::max(m, data[perm[k]]);
        if (std::isinf(m) && m < 0) {
          v = -HUGE_VAL;
        } else {
          double s = 0.0;
          for (int64_t k = g; k < h; ++k) s += std::exp(data[perm[k]] - m);
          v = m + std::log(s);
        }
        break;
      }
      case MM_ADD_MAX: {
        double m = data[perm[g]];
        for (int64_t k = g + 1; k < h; ++k) m = std::max(m, data[perm[k]]);
        v = m;
        break;
      }
      case MM_ADD_SUM: {
        double s = 0.0;
        for (int64_t k = g; k < h; ++k) s += data[perm[k]];
        v = s;
        break;
      }
      default:
        return -1;
    }
    out_cols[out_n] = c;
    out_data[out_n] = v;
    ++counts[static_cast<size_t>(r) + 1];
    ++out_n;
    g = h;
  }
  out_indptr[0] = 0;
  for (int64_t i = 0; i < nrows; ++i) out_indptr[i + 1] = out_indptr[i] + counts[i + 1];
  return out_n;
}

// ---------------------------------------------------------------------------
// CSR transpose (counting pass; O(nnz + ncols))
// ---------------------------------------------------------------------------

// Input must have unique, row-sorted coordinates (every SpMat does by
// construction). Output rows come out with ascending column indices because
// input rows are scanned in ascending order — the same pointer-reinterpret
// "free transpose" economics as reference src/linalg.jl:55-67, done once on
// host. Returns 0 on success.
int32_t mm_csr_transpose(int64_t nrows, int64_t ncols, int64_t nnz,
                         const int64_t* indptr, const int64_t* indices,
                         const double* data, int64_t* out_indptr,
                         int64_t* out_indices, double* out_data) {
  if (nrows < 0 || ncols < 0 || nnz < 0) return -1;
  std::memset(out_indptr, 0, sizeof(int64_t) * (static_cast<size_t>(ncols) + 1));
  for (int64_t k = 0; k < nnz; ++k) {
    const int64_t c = indices[k];
    if (c < 0 || c >= ncols) return -1;
    ++out_indptr[c + 1];
  }
  for (int64_t j = 0; j < ncols; ++j) out_indptr[j + 1] += out_indptr[j];
  std::vector<int64_t> next(out_indptr, out_indptr + ncols);
  for (int64_t i = 0; i < nrows; ++i) {
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int64_t pos = next[indices[k]]++;
      out_indices[pos] = i;
      out_data[pos] = data[k];
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// OpenFST text parsing
// ---------------------------------------------------------------------------
//
// Grammar (whitespace-separated, one record per line):
//   src dst ilabel olabel [weight]   arc (5 or 4 fields)
//   state [weight]                   final state (2 or 1 fields)
// Matches the graphs the reference benchmark emits
// (misc/benchmark/generatefsm.jl:42-57, e.g. den_fsm_wsj.txt).

namespace {

struct FstText {
  std::vector<int64_t> src, dst, ilab, olab, fstate;
  std::vector<double> w, fw;
  bool ok = false;
};

FstText parse_fst(const char* path) {
  FstText out;
  FILE* f = std::fopen(path, "rb");
  if (!f) return out;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (size > 0 && std::fread(buf.data(), 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return out;
  }
  std::fclose(f);
  buf[static_cast<size_t>(size)] = '\0';

  char* p = buf.data();
  char* end = p + size;
  double fields[5];
  while (p < end) {
    char* eol = static_cast<char*>(std::memchr(p, '\n', end - p));
    if (!eol) eol = end;
    *eol = '\0';
    int nf = 0;
    char* q = p;
    while (nf < 5) {
      char* next = nullptr;
      const double v = std::strtod(q, &next);
      if (next == q) break;
      fields[nf++] = v;
      q = next;
    }
    // trailing garbage (a 6th field or non-numeric text) -> skip the line
    while (*q == ' ' || *q == '\t' || *q == '\r') ++q;
    if (*q == '\0' && nf > 0) {
      if (nf >= 4) {
        out.src.push_back(static_cast<int64_t>(fields[0]));
        out.dst.push_back(static_cast<int64_t>(fields[1]));
        out.ilab.push_back(static_cast<int64_t>(fields[2]));
        out.olab.push_back(static_cast<int64_t>(fields[3]));
        out.w.push_back(nf == 5 ? fields[4] : 0.0);
      } else if (nf <= 2) {
        out.fstate.push_back(static_cast<int64_t>(fields[0]));
        out.fw.push_back(nf == 2 ? fields[1] : 0.0);
      }
    }
    p = eol + 1;
  }
  out.ok = true;
  return out;
}

}  // namespace

// Two-call protocol: count, then fill caller-allocated arrays (the file is
// parsed twice; OS page cache makes the second pass cheap and the protocol
// keeps all allocation on the numpy side).
int32_t mm_fst_text_count(const char* path, int64_t* n_arcs,
                          int64_t* n_finals) {
  FstText t = parse_fst(path);
  if (!t.ok) return -1;
  *n_arcs = static_cast<int64_t>(t.src.size());
  *n_finals = static_cast<int64_t>(t.fstate.size());
  return 0;
}

int32_t mm_fst_text_fill(const char* path, int64_t* src, int64_t* dst,
                         int64_t* ilab, int64_t* olab, double* w,
                         int64_t* fstate, double* fw) {
  FstText t = parse_fst(path);
  if (!t.ok) return -1;
  std::memcpy(src, t.src.data(), t.src.size() * sizeof(int64_t));
  std::memcpy(dst, t.dst.data(), t.dst.size() * sizeof(int64_t));
  std::memcpy(ilab, t.ilab.data(), t.ilab.size() * sizeof(int64_t));
  std::memcpy(olab, t.olab.data(), t.olab.size() * sizeof(int64_t));
  std::memcpy(w, t.w.data(), t.w.size() * sizeof(double));
  std::memcpy(fstate, t.fstate.data(), t.fstate.size() * sizeof(int64_t));
  std::memcpy(fw, t.fw.data(), t.fw.size() * sizeof(double));
  return 0;
}

// ---------------------------------------------------------------------------
// Segment ⊕-reduction (CSR row reduce of grouped contributions)
// ---------------------------------------------------------------------------

// out[i] = ⊕_{k in [indptr[i], indptr[i+1])} contrib[k]; empty rows get the
// semiring zero. The host analog of the reference's warp-reduce SpMV row sum
// (src/linalg.jl:204-233), used by the AOT compiler's spmv on big graphs.
int32_t mm_segment_reduce(int64_t nrows, const int64_t* indptr,
                          const double* contrib, int32_t op, double zero,
                          double* out) {
  for (int64_t i = 0; i < nrows; ++i) {
    const int64_t lo = indptr[i], hi = indptr[i + 1];
    if (lo >= hi) {
      out[i] = zero;
      continue;
    }
    switch (op) {
      case MM_ADD_LOGSUMEXP: {
        double m = -HUGE_VAL;
        for (int64_t k = lo; k < hi; ++k) m = std::max(m, contrib[k]);
        if (std::isinf(m) && m < 0) {
          out[i] = -HUGE_VAL;
        } else {
          double s = 0.0;
          for (int64_t k = lo; k < hi; ++k) s += std::exp(contrib[k] - m);
          out[i] = m + std::log(s);
        }
        break;
      }
      case MM_ADD_MAX: {
        double m = contrib[lo];
        for (int64_t k = lo + 1; k < hi; ++k) m = std::max(m, contrib[k]);
        out[i] = m;
        break;
      }
      case MM_ADD_SUM: {
        double s = 0.0;
        for (int64_t k = lo; k < hi; ++k) s += contrib[k];
        out[i] = s;
        break;
      }
      default:
        return -1;
    }
  }
  return 0;
}

int32_t mm_native_abi_version() { return 1; }

}  // extern "C"
