// Native ELL-pattern / scatter-map construction.
//
// The port's own copy of femcy_tpu/native/pattern.cpp (same algorithm, same
// exports), built with g++ by femcy_tpu_torch/native/loader.py.  The port's
// loader reads the ELL arrays and the node-block map only; the dof-level
// targets (pattern_export's targets argument) and pattern_export_sorted are
// kept so that the two copies stay one algorithm with one interface.
//
// Replaces the numpy path in topology.build_pattern for large meshes: instead
// of two global sorts of E*edof^2 keys (np.unique + np.argsort), this does a
// counting sort by row (two linear passes) followed by tiny per-row sorts --
// O(n) for the bulk of the work.  Exposed through ctypes (see loader.py).
//
// The sort work runs at NODE level (E*npe^2 contributions), not dof level
// (E*(npe*dm)^2): a node pair couples as a dense dm x dm block, so the dof
// pattern is exactly the node pattern with each entry expanded by a dm x dm
// Kronecker block.  For dm=3 that is 9x less bucketing/sorting; the dof-level
// arrays the callers consume are produced by linear expansion passes in
// pattern_export (measured: 16 s -> ~2 s at 0.5M C3D4 elements, single core).
//
// Reference behaviour being accelerated: the sparsity pattern the reference
// builds per-row on the host in pure Python (stiffnessMtrx.py:79-107).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>
#include <utility>
#include <vector>

namespace {

struct Pattern {
  int64_t n_ele = 0;
  int32_t npe = 0;
  int32_t dm = 0;
  int64_t n_nodes = 0;
  int64_t n_dof = 0;
  int64_t nnz = 0;       // dof-level nnz
  int32_t width = 0;     // dof-level ELL width (= node width * dm)
  int32_t nwidth = 0;    // node-level ELL width
  int64_t node_nnz = 0;  // node-level nnz
  // node-level contributions bucketed by node row, each row's slice sorted
  // by (node col, original node-contribution index)
  std::vector<int32_t> col_b;      // node column of each contribution
  std::vector<int32_t> idx_b;      // original node-contribution index
  std::vector<int64_t> offsets;    // node row -> bucket start (n_nodes + 1)
  std::vector<int32_t> row_counts; // unique node columns per node row
  // compacted unique sorted columns per node row (for the element-order
  // targets export: binary-searchable, cache-resident per row)
  std::vector<int32_t> col_u;      // node_nnz entries
  std::vector<int64_t> uoff;       // node row -> col_u start (n_nodes + 1)
  std::vector<int32_t> conn;       // copy of the element connectivity
};

}  // namespace

extern "C" {

void* pattern_build(const int32_t* elements, int64_t n_ele, int32_t npe,
                    int32_t dm, int64_t n_dof) {
  auto* p = new (std::nothrow) Pattern();
  if (!p) return nullptr;
  p->n_ele = n_ele;
  p->npe = npe;
  p->dm = dm;
  p->n_dof = n_dof;
  p->n_nodes = n_dof / dm;
  const int64_t n_nodes = p->n_nodes;
  const int64_t n_contrib = n_ele * (int64_t)npe * npe;

  // pass 1: count node-pair contributions per node row
  p->offsets.assign(n_nodes + 1, 0);
  for (int64_t e = 0; e < n_ele; ++e) {
    const int32_t* conn = elements + e * npe;
    for (int32_t a = 0; a < npe; ++a) p->offsets[conn[a] + 1] += npe;
  }
  for (int64_t r = 0; r < n_nodes; ++r) p->offsets[r + 1] += p->offsets[r];

  // pass 2: bucket (node col, original node-contribution index) by node row
  p->col_b.resize(n_contrib);
  p->idx_b.resize(n_contrib);
  {
    std::vector<int64_t> cursor(p->offsets.begin(), p->offsets.end() - 1);
    for (int64_t e = 0; e < n_ele; ++e) {
      const int32_t* conn = elements + e * npe;
      const int64_t base = e * (int64_t)npe * npe;
      for (int32_t a = 0; a < npe; ++a) {
        int64_t& c = cursor[conn[a]];
        const int64_t orig0 = base + (int64_t)a * npe;
        for (int32_t b = 0; b < npe; ++b) {
          p->col_b[c] = conn[b];
          p->idx_b[c] = (int32_t)(orig0 + b);
          ++c;
        }
      }
    }
  }

  // per node row: sort slice by (col, original index); count unique cols
  p->row_counts.assign(n_nodes, 0);
  std::vector<std::pair<int32_t, int32_t>> tmp;
  int32_t nwidth = 0;
  for (int64_t r = 0; r < n_nodes; ++r) {
    const int64_t lo = p->offsets[r], hi = p->offsets[r + 1];
    tmp.resize(hi - lo);
    for (int64_t k = lo; k < hi; ++k)
      tmp[k - lo] = {p->col_b[k], p->idx_b[k]};
    std::sort(tmp.begin(), tmp.end());
    int32_t uniq = 0;
    int32_t prev = -1;
    for (size_t k = 0; k < tmp.size(); ++k) {
      p->col_b[lo + k] = tmp[k].first;
      p->idx_b[lo + k] = tmp[k].second;
      if (tmp[k].first != prev) {
        ++uniq;
        prev = tmp[k].first;
      }
    }
    p->row_counts[r] = uniq;
    nwidth = std::max(nwidth, uniq);
    p->node_nnz += uniq;
  }
  // compacted unique sorted columns per row (element-order targets export)
  p->uoff.assign(n_nodes + 1, 0);
  for (int64_t r = 0; r < n_nodes; ++r)
    p->uoff[r + 1] = p->uoff[r] + p->row_counts[r];
  p->col_u.resize(p->node_nnz);
  for (int64_t r = 0; r < n_nodes; ++r) {
    const int64_t lo = p->offsets[r], hi = p->offsets[r + 1];
    int64_t out = p->uoff[r];
    int32_t prev = -1;
    for (int64_t k = lo; k < hi; ++k) {
      if (p->col_b[k] != prev) {
        prev = p->col_b[k];
        p->col_u[out++] = prev;
      }
    }
  }
  p->conn.assign(elements, elements + n_ele * (int64_t)npe);
  p->nwidth = nwidth;
  p->width = nwidth * dm;
  p->nnz = p->node_nnz * dm * dm;
  return p;
}

int64_t pattern_nnz(void* h) { return static_cast<Pattern*>(h)->nnz; }
int32_t pattern_width(void* h) { return static_cast<Pattern*>(h)->width; }
int32_t pattern_nwidth(void* h) { return static_cast<Pattern*>(h)->nwidth; }

// Node-block scatter map: for each node-level contribution (e, a, b), in
// element order, the flat node-ELL slot conn[a]*nwidth + pos(conn[b]).
// dm^2 x smaller than the dof-level targets (68 MB vs 607 MB at 1M C3D4
// elements) -- the device scatter (kernels/ell_scatter.py) reads the dof
// slots of each node block from it directly.
void pattern_export_block_targets(void* h, int32_t* btargets) {
  Pattern* p = static_cast<Pattern*>(h);
  const int32_t npe = p->npe;
  const int32_t* conn_all = p->conn.data();
  int64_t out = 0;
  for (int64_t e = 0; e < p->n_ele; ++e) {
    const int32_t* conn = conn_all + e * npe;
    for (int32_t a = 0; a < npe; ++a) {
      const int32_t r = conn[a];
      const int32_t* cu = p->col_u.data() + p->uoff[r];
      const int32_t ncols = p->row_counts[r];
      const int64_t slot0 = (int64_t)r * p->nwidth;
      for (int32_t b = 0; b < npe; ++b) {
        const int32_t* it = std::lower_bound(cu, cu + ncols, conn[b]);
        btargets[out++] = (int32_t)(slot0 + (it - cu));
      }
    }
  }
}
int64_t pattern_n_contrib(void* h) {
  Pattern* p = static_cast<Pattern*>(h);
  const int64_t edof = (int64_t)p->npe * p->dm;
  return p->n_ele * edof * edof;
}

// Fill caller-allocated buffers (all DOF-level):
//   targets: [n_contrib] int32 -- flat slot of each contribution, in the
//            original (element-stiffness layout) order
//   colidx: [n_dof*width] int32 (zero-padded), row_counts: [n_dof] int32
//   diag_slot: [n_dof] int64
//   csr_indices: [nnz] int32, csr_slots: [nnz] int64, csr_indptr: [n_dof+1] int64
// Returns 0 on success, nonzero if a row is missing its diagonal.
int32_t pattern_export(void* h, int32_t* targets,
                       int32_t* colidx, int32_t* row_counts, int64_t* diag_slot,
                       int32_t* csr_indices, int64_t* csr_slots,
                       int64_t* csr_indptr) {
  Pattern* p = static_cast<Pattern*>(h);
  const int64_t n_nodes = p->n_nodes;
  const int32_t dm = p->dm;
  const int32_t npe = p->npe;
  const int32_t edof = npe * dm;
  const int32_t width = p->width;
  std::memset(colidx, 0, sizeof(int32_t) * (size_t)p->n_dof * width);

  int32_t status = 0;
  int64_t csr_pos = 0;
  csr_indptr[0] = 0;
  for (int64_t n = 0; n < n_nodes; ++n) {
    const int64_t lo = p->offsets[n], hi = p->offsets[n + 1];
    const int32_t ncols = p->row_counts[n];
    // node row -> the dm dof rows n*dm+di, each with ncols*dm sorted columns
    // (node cols are sorted, so c*dm+dj is sorted too)
    for (int32_t di = 0; di < dm; ++di) {
      const int64_t r = n * dm + di;
      row_counts[r] = ncols * dm;
      int64_t slot0 = r * (int64_t)width;
      int64_t diag = -1;
      int32_t pos = -1;
      for (int64_t k = lo; k < hi; ++k) {
        const int32_t col = p->col_b[k];
        if (k == lo || col != p->col_b[k - 1]) {
          ++pos;
          for (int32_t dj = 0; dj < dm; ++dj) {
            const int32_t c = col * dm + dj;
            const int64_t s = slot0 + (int64_t)pos * dm + dj;
            colidx[s] = c;
            csr_indices[csr_pos] = c;
            csr_slots[csr_pos] = s;
            ++csr_pos;
            if (c == (int32_t)r) diag = s;
          }
        }
      }
      if (diag < 0) status = 1;
      diag_slot[r] = diag;
      csr_indptr[r + 1] = csr_pos;
    }
  }

  // targets, in ELEMENT order: for each contribution (e, a, b) binary-
  // search conn[b] in node row conn[a]'s compacted unique columns (small,
  // cache-resident) and write the dm x dm slots SEQUENTIALLY.  The former
  // node-row-order walk scattered writes randomly across the (E*edof^2)
  // int32 buffer -- 600 MB of cache-missing stores at the 1M-element
  // scale (measured 19 s vs ~2 s for this layout on the 1-core host).
  // NULL skips the export (callers on the block-target fast path).
  if (targets) {
    const int32_t* conn_all = p->conn.data();
    int64_t out = 0;
    for (int64_t e = 0; e < p->n_ele; ++e) {
      const int32_t* conn = conn_all + e * npe;
      for (int32_t a = 0; a < npe; ++a) {
        const int32_t r = conn[a];
        const int32_t* cu = p->col_u.data() + p->uoff[r];
        const int32_t ncols = p->row_counts[r];
        for (int32_t di = 0; di < dm; ++di) {
          const int64_t slot0 = ((int64_t)r * dm + di) * width;
          for (int32_t b = 0; b < npe; ++b) {
            const int32_t* it =
                std::lower_bound(cu, cu + ncols, conn[b]);
            const int64_t s = slot0 + (int64_t)(it - cu) * dm;
            for (int32_t dj = 0; dj < dm; ++dj)
              targets[out++] = (int32_t)(s + dj);
          }
        }
      }
    }
  }
  return status;
}

// Optional second export (ELLPattern.sorted_perm / csr_counts):
//   perm_sorted: [n_contrib] int32 -- original dof-contribution index of each
//                entry in (dof row, dof col, original)-sorted order
//   csr_counts: [nnz] int32 -- contributions per unique (row, col) entry
void pattern_export_sorted(void* h, int32_t* perm_sorted, int32_t* csr_counts) {
  Pattern* p = static_cast<Pattern*>(h);
  const int64_t n_nodes = p->n_nodes;
  const int32_t dm = p->dm;
  const int32_t npe = p->npe;
  const int32_t edof = npe * dm;
  int64_t out = 0;
  int64_t csr_pos = 0;
  for (int64_t n = 0; n < n_nodes; ++n) {
    const int64_t lo = p->offsets[n], hi = p->offsets[n + 1];
    for (int32_t di = 0; di < dm; ++di) {
      // dof row n*dm+di: walk node cols in sorted order; for each unique
      // node col, each dj produces one unique dof entry whose contributions
      // are the node pair's, in original order (orig dof index is monotonic
      // in the orig node index for fixed di,dj)
      int64_t k = lo;
      while (k < hi) {
        int64_t k2 = k;
        const int32_t col = p->col_b[k];
        while (k2 < hi && p->col_b[k2] == col) ++k2;
        const int32_t cnt = (int32_t)(k2 - k);
        for (int32_t dj = 0; dj < dm; ++dj) {
          csr_counts[csr_pos++] = cnt;
          for (int64_t kk = k; kk < k2; ++kk) {
            const int64_t v = p->idx_b[kk];
            const int64_t e = v / ((int64_t)npe * npe);
            const int32_t a = (int32_t)((v / npe) % npe);
            const int32_t b = (int32_t)(v % npe);
            perm_sorted[out++] = (int32_t)(
                e * (int64_t)edof * edof + ((int64_t)a * dm + di) * edof +
                (int64_t)b * dm + dj);
          }
        }
        k = k2;
      }
    }
  }
}

void pattern_free(void* h) { delete static_cast<Pattern*>(h); }

}  // extern "C"
