// Native AMG setup-phase kernels.
//
// SParSH-AMG implements its entire setup phase (strength-of-connection,
// Ruge-Stuben / aggregation coarsening, interpolation construction) in
// C/C++ with OpenMP (SURVEY.md section 2, C9-C12).  These are irregular
// graph algorithms that do not map onto the TPU; in this framework they run
// on the host as native code, producing a static padded hierarchy that the
// device solve phase consumes.
//
// All CSR inputs use int64 indptr and int32 indices (setup runs on
// row-partitioned shards, so local n stays well under 2^31).
//
// Build: g++ -O3 -fopenmp -shared -fPIC amg_core.cpp -o amg_core.so
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <omp.h>

extern "C" {

// ---------------------------------------------------------------------------
// Strength of connection
// ---------------------------------------------------------------------------

// Classical SoC: entry (i,j) is strong iff -a_ij >= theta * max_{k!=i}(-a_ik).
// Diagonal entries are never strong.  strong[] is a per-nonzero mask.
// row0: global index of local row 0 — the diagonal of local row i sits at
// column row0 + i.  Lets the blocked per-host setup run strength on a
// row-block CSR with GLOBAL column ids (row0 = 0 is the classic case).
void soc_classical_rows(int64_t n, int64_t row0, const int64_t* indptr,
                        const int32_t* indices, const double* data,
                        double theta, uint8_t* strong) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int32_t gi = (int32_t)(row0 + i);
    double maxoff = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      if (indices[k] != gi) maxoff = std::max(maxoff, -data[k]);
    }
    const double cut = theta * maxoff;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      strong[k] = (indices[k] != gi && maxoff > 0.0 && -data[k] >= cut &&
                   -data[k] > 0.0)
                      ? 1
                      : 0;
    }
  }
}

// indptr of the strong-mask-compressed CSR: out[i+1]-out[i] = kept entries
// of row i.  Parallel per-row counts + a serial n-length scan — avoids the
// nnz-length numpy cumsum (pathologically slow on the deploy VM's memory
// subsystem; see RESULTS.md round 2).
void mask_indptr(int64_t n, const int64_t* indptr, const uint8_t* mask,
                 int64_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t c = 0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) c += mask[k];
    out[i + 1] = c;
  }
  out[0] = 0;
  for (int64_t i = 0; i < n; ++i) out[i + 1] += out[i];
}

// Compress indices under the mask into a pre-sized CSR (out_indptr from
// mask_indptr) — replaces a boolean fancy-index + astype pass in numpy.
void mask_compress(int64_t n, const int64_t* indptr, const int32_t* indices,
                   const uint8_t* mask, const int64_t* out_indptr,
                   int32_t* out_indices) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t w = out_indptr[i];
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
      if (mask[k]) out_indices[w++] = indices[k];
  }
}

// ---------------------------------------------------------------------------
// Test-problem assembly (SURVEY.md section 2, C3)
// ---------------------------------------------------------------------------

// Direct CSR assembly of the 3-D 7-point Dirichlet Laplacian on an
// nx*ny*nz interior grid (index = (iz*ny + iy)*nx + ix).  The numpy
// stencil path materializes ~1 GB of index/diag temporaries and a dia->csr
// conversion, all faulting fresh pages serially (~35 s at 192^3 on the
// deploy VM); here the only writes are the output arrays, faulted in
// parallel by the writing threads (~1-2 s at 192^3, scales to 100M rows).
// Pass 1 (indices==nullptr): fill indptr row counts + serial scan.
// Pass 2: fill indices/data.
void poisson3d_fill(int64_t nx, int64_t ny, int64_t nz, int64_t* indptr,
                    int32_t* indices, double* data) {
  const int64_t n = nx * ny * nz, nxy = nx * ny;
  if (indices == nullptr) {
#pragma omp parallel for schedule(static)
    for (int64_t k = 0; k < n; ++k) {
      const int64_t ix = k % nx, iy = (k / nx) % ny, iz = k / nxy;
      indptr[k + 1] = 1 + (ix > 0) + (ix < nx - 1) + (iy > 0) +
                      (iy < ny - 1) + (iz > 0) + (iz < nz - 1);
    }
    indptr[0] = 0;
    for (int64_t k = 0; k < n; ++k) indptr[k + 1] += indptr[k];
    return;
  }
#pragma omp parallel for schedule(static)
  for (int64_t k = 0; k < n; ++k) {
    const int64_t ix = k % nx, iy = (k / nx) % ny, iz = k / nxy;
    int64_t w = indptr[k];
    if (iz > 0)      { indices[w] = (int32_t)(k - nxy); data[w++] = -1.0; }
    if (iy > 0)      { indices[w] = (int32_t)(k - nx);  data[w++] = -1.0; }
    if (ix > 0)      { indices[w] = (int32_t)(k - 1);   data[w++] = -1.0; }
    indices[w] = (int32_t)k; data[w++] = 6.0;
    if (ix < nx - 1) { indices[w] = (int32_t)(k + 1);   data[w++] = -1.0; }
    if (iy < ny - 1) { indices[w] = (int32_t)(k + nx);  data[w++] = -1.0; }
    if (iz < nz - 1) { indices[w] = (int32_t)(k + nxy); data[w++] = -1.0; }
  }
}

// Row-range variant for the per-host blocked setup: fills rows
// [r0, r1) with GLOBAL column ids (indptr has r1-r0+1 entries,
// indptr[0] = 0) — no rank ever materializes the global matrix.
void poisson3d_fill_rows(int64_t nx, int64_t ny, int64_t nz, int64_t r0,
                         int64_t r1, int64_t* indptr, int32_t* indices,
                         double* data) {
  const int64_t nxy = nx * ny;
  const int64_t m = r1 - r0;
  if (indices == nullptr) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
      const int64_t k = r0 + i;
      const int64_t ix = k % nx, iy = (k / nx) % ny, iz = k / nxy;
      indptr[i + 1] = 1 + (ix > 0) + (ix < nx - 1) + (iy > 0) +
                      (iy < ny - 1) + (iz > 0) + (iz < nz - 1);
    }
    indptr[0] = 0;
    for (int64_t i = 0; i < m; ++i) indptr[i + 1] += indptr[i];
    return;
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    const int64_t k = r0 + i;
    const int64_t ix = k % nx, iy = (k / nx) % ny, iz = k / nxy;
    int64_t w = indptr[i];
    if (iz > 0)      { indices[w] = (int32_t)(k - nxy); data[w++] = -1.0; }
    if (iy > 0)      { indices[w] = (int32_t)(k - nx);  data[w++] = -1.0; }
    if (ix > 0)      { indices[w] = (int32_t)(k - 1);   data[w++] = -1.0; }
    indices[w] = (int32_t)k; data[w++] = 6.0;
    if (ix < nx - 1) { indices[w] = (int32_t)(k + 1);   data[w++] = -1.0; }
    if (iy < ny - 1) { indices[w] = (int32_t)(k + nx);  data[w++] = -1.0; }
    if (iz < nz - 1) { indices[w] = (int32_t)(k + nxy); data[w++] = -1.0; }
  }
}

// ---------------------------------------------------------------------------
// DIA layout builders (device-upload path, SURVEY.md section 2 C1/C23)
// ---------------------------------------------------------------------------

// Distinct diagonal offsets (col - row) of a square CSR, sorted ascending.
// Returns the count, or -1 if it exceeds cap (caller falls back to
// ELL/GELL).  Replaces numpy's rows/offs materialization + np.unique — an
// nnz-length sort (~400 MB at 5e7 nnz) on the deploy VM's slow memory.
int64_t dia_offsets(int64_t n, const int64_t* indptr, const int32_t* indices,
                    int64_t cap, int64_t* offsets_out) {
  bool over = false;
  std::vector<std::vector<int64_t>> tl;
#pragma omp parallel
  {
#pragma omp single
    tl.resize(omp_get_num_threads());
    std::vector<int64_t>& mine = tl[omp_get_thread_num()];
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      if (over) continue;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        const int64_t off = (int64_t)indices[k] - i;
        auto it = std::lower_bound(mine.begin(), mine.end(), off);
        if (it == mine.end() || *it != off) {
          if ((int64_t)mine.size() > cap) { over = true; break; }
          mine.insert(it, off);
        }
      }
    }
  }
  std::vector<int64_t> all;
  for (auto& v : tl) all.insert(all.end(), v.begin(), v.end());
  std::sort(all.begin(), all.end());
  all.erase(std::unique(all.begin(), all.end()), all.end());
  if (over || (int64_t)all.size() > cap) return -1;
  std::copy(all.begin(), all.end(), offsets_out);
  return (int64_t)all.size();
}

// Fill an fp32 double-float DIA band pair from a float64 CSR in ONE pass:
// hi = (float)a, lo = (float)(a - (double)hi) — the standard error-free
// split.  bands_* are (K, n_pad) row-major float32, zeroed here in
// parallel (np.zeros would fault its pages serially on first scatter).
// Replaces two csr_matrix copies, two astype passes, a data subtraction,
// and two f64 band scatters + f64->f32 casts (~38 s -> ~1 s at 5e7 nnz).
void dia_fill_df64(int64_t n, int64_t n_pad, int64_t K,
                   const int64_t* indptr, const int32_t* indices,
                   const double* data, const int64_t* offsets,
                   float* bands_hi, float* bands_lo) {
#pragma omp parallel
  {
#pragma omp for schedule(static)
    for (int64_t d = 0; d < K; ++d) {
      std::memset(bands_hi + d * n_pad, 0, sizeof(float) * n_pad);
      std::memset(bands_lo + d * n_pad, 0, sizeof(float) * n_pad);
    }
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        const int64_t off = (int64_t)indices[k] - i;
        const int64_t d = std::lower_bound(offsets, offsets + K, off)
                          - offsets;
        const double a = data[k];
        const float hi = (float)a;
        bands_hi[d * n_pad + i] = hi;
        bands_lo[d * n_pad + i] = (float)(a - (double)hi);
      }
    }
  }
}

// Single-precision variant of dia_fill_df64 (plain device DIA upload).
void dia_fill_f32(int64_t n, int64_t n_pad, int64_t K,
                  const int64_t* indptr, const int32_t* indices,
                  const double* data, const int64_t* offsets, float* bands) {
#pragma omp parallel
  {
#pragma omp for schedule(static)
    for (int64_t d = 0; d < K; ++d)
      std::memset(bands + d * n_pad, 0, sizeof(float) * n_pad);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        const int64_t off = (int64_t)indices[k] - i;
        const int64_t d = std::lower_bound(offsets, offsets + K, off)
                          - offsets;
        bands[d * n_pad + i] = (float)data[k];
      }
    }
  }
}

// Symmetric SoC (used for aggregation / smoothed aggregation, Vanek 1996):
// (i,j) strong iff |a_ij| >= theta * sqrt(|a_ii| * |a_jj|).
void soc_symmetric(int64_t n, const int64_t* indptr, const int32_t* indices,
                   const double* data, double theta, uint8_t* strong) {
  std::vector<double> diag(n, 0.0);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      if (indices[k] == i) diag[i] = std::fabs(data[k]);
    }
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t j = indices[k];
      if (j == i) {
        strong[k] = 0;
        continue;
      }
      const double cut = theta * std::sqrt(diag[i] * diag[j]);
      strong[k] = (std::fabs(data[k]) >= cut && cut > 0.0) ? 1 : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Classical Ruge-Stuben C/F splitting (two-pass)
// ---------------------------------------------------------------------------
// S: strength CSR (row i lists the points i strongly depends on).
// ST: transpose (row i lists points that strongly depend on i).
// cf[i]: 0 = F-point, 1 = C-point.  Returns the number of C-points.
//
// Pass 1 is the standard greedy max-lambda selection with a bucket queue
// (lambda_i = |ST_i| + (#new F neighbours)); pass 2 enforces the RS
// condition that every strong F-F pair shares a common interpolating
// C-point (Ruge & Stuben 1987).
int64_t rs_cf(int64_t n, const int64_t* S_indptr, const int32_t* S_indices,
              const int64_t* ST_indptr, const int32_t* ST_indices, int8_t* cf,
              int second_pass) {
  const int8_t UNASSIGNED = -1, FPT = 0, CPT = 1;
  std::memset(cf, UNASSIGNED, n);

  // lambda_i = number of points that strongly depend on i.
  std::vector<int64_t> lambda(n);
  int64_t max_lambda = 0;
  for (int64_t i = 0; i < n; ++i) {
    lambda[i] = ST_indptr[i + 1] - ST_indptr[i];
    max_lambda = std::max(max_lambda, lambda[i]);
  }
  // Bucket queue: doubly linked list per lambda value.
  // Capacity: lambda can grow by at most n during updates; cap to 2n+1.
  const int64_t nbuckets = 2 * n + 2;
  std::vector<int64_t> head(nbuckets, -1), nxt(n, -1), prv(n, -1);
  auto bucket_insert = [&](int64_t i) {
    int64_t l = lambda[i];
    nxt[i] = head[l];
    prv[i] = -1;
    if (head[l] >= 0) prv[head[l]] = i;
    head[l] = i;
  };
  auto bucket_remove = [&](int64_t i) {
    int64_t l = lambda[i];
    if (prv[i] >= 0)
      nxt[prv[i]] = nxt[i];
    else
      head[l] = nxt[i];
    if (nxt[i] >= 0) prv[nxt[i]] = prv[i];
  };
  for (int64_t i = 0; i < n; ++i) bucket_insert(i);

  int64_t n_c = 0;
  int64_t cur = max_lambda;
  int64_t remaining = n;
  while (remaining > 0) {
    while (cur > 0 && head[cur] < 0) --cur;
    if (cur <= 0) {
      // everything left has no influence; mark all F
      for (int64_t i = 0; i < n; ++i)
        if (cf[i] == UNASSIGNED) {
          cf[i] = FPT;
          --remaining;
        }
      break;
    }
    const int64_t c = head[cur];
    bucket_remove(c);
    cf[c] = CPT;
    ++n_c;
    --remaining;
    // Every unassigned point that strongly depends on c becomes F.
    for (int64_t k = ST_indptr[c]; k < ST_indptr[c + 1]; ++k) {
      const int32_t f = ST_indices[k];
      if (cf[f] != UNASSIGNED) continue;
      bucket_remove(f);
      cf[f] = FPT;
      --remaining;
      // New F point: boost lambda of its unassigned strong dependencies.
      for (int64_t k2 = S_indptr[f]; k2 < S_indptr[f + 1]; ++k2) {
        const int32_t j = S_indices[k2];
        if (cf[j] != UNASSIGNED) continue;
        bucket_remove(j);
        if (lambda[j] + 1 < nbuckets) ++lambda[j];
        bucket_insert(j);
        if (lambda[j] > cur) cur = lambda[j];
      }
    }
    // Decrement lambda of unassigned points c strongly depends on
    // (they are now less useful as C-points).
    for (int64_t k = S_indptr[c]; k < S_indptr[c + 1]; ++k) {
      const int32_t j = S_indices[k];
      if (cf[j] != UNASSIGNED) continue;
      bucket_remove(j);
      if (lambda[j] > 0) --lambda[j];
      bucket_insert(j);
    }
  }

  if (second_pass) {
    // RS pass 2: each strong F-F pair must share a C-point in the
    // intersection of their strong neighbourhoods.
    std::vector<int8_t> in_Ci(n, 0);
    for (int64_t i = 0; i < n; ++i) {
      if (cf[i] != FPT) continue;
      // mark C_i
      for (int64_t k = S_indptr[i]; k < S_indptr[i + 1]; ++k)
        if (cf[S_indices[k]] == CPT) in_Ci[S_indices[k]] = 1;
      int64_t tentative = -1;  // tentatively promoted neighbour
      for (int64_t k = S_indptr[i]; k < S_indptr[i + 1]; ++k) {
        const int32_t j = S_indices[k];
        if (cf[j] != FPT) continue;
        bool shared = false;
        for (int64_t k2 = S_indptr[j]; k2 < S_indptr[j + 1]; ++k2) {
          if (in_Ci[S_indices[k2]]) {
            shared = true;
            break;
          }
        }
        if (!shared) {
          if (tentative < 0) {
            tentative = j;   // tentatively promote j
            cf[j] = CPT;
            in_Ci[j] = 1;
          } else {
            // second failure: make i itself a C point, undo j's promotion
            cf[tentative] = FPT;
            in_Ci[tentative] = 0;
            cf[i] = CPT;
            tentative = -1;
            break;
          }
        }
      }
      // clear marks
      for (int64_t k = S_indptr[i]; k < S_indptr[i + 1]; ++k)
        in_Ci[S_indices[k]] = 0;
      if (tentative >= 0) in_Ci[tentative] = 0;
    }
    n_c = 0;
    for (int64_t i = 0; i < n; ++i) n_c += (cf[i] == CPT);
  }
  return n_c;
}

// ---------------------------------------------------------------------------
// PMIS C/F splitting (parallel-friendly, deterministic)
// ---------------------------------------------------------------------------
// De Sterck, Yang & Heys 2006.  Uses a deterministic per-node hash as the
// random tiebreaker so results are reproducible across runs/shards.
static inline double hash01(uint64_t x, uint64_t seed) {
  x ^= seed + 0x9e3779b97f4a7c15ULL;
  x ^= x >> 30; x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27; x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return (double)(x >> 11) * (1.0 / 9007199254740992.0);
}

int64_t pmis_cf(int64_t n, const int64_t* S_indptr, const int32_t* S_indices,
                const int64_t* ST_indptr, const int32_t* ST_indices,
                uint64_t seed, int8_t* cf) {
  const int8_t UNASSIGNED = -1, FPT = 0, CPT = 1;
  std::memset(cf, UNASSIGNED, n);
  // weight = |ST_i| + rand(i)
  std::vector<double> w(n);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    w[i] = (double)(ST_indptr[i + 1] - ST_indptr[i]) + hash01((uint64_t)i, seed);
  // points with no strong connections at all become F immediately
  // (they neither need nor provide interpolation)
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    if (S_indptr[i + 1] == S_indptr[i] && ST_indptr[i + 1] == ST_indptr[i])
      cf[i] = FPT;
  }
  // Frontier-based rounds: only unassigned points are (re)visited, so
  // rounds after the first touch a shrinking vertex set instead of
  // re-streaming the whole graph (the full-scan version spent ~9 s of a
  // 40 s 192^3 setup here; the selection logic itself is unchanged, so
  // the resulting C/F split is bit-identical).
  std::vector<int32_t> frontier;
  frontier.reserve(n);
  for (int64_t i = 0; i < n; ++i)
    if (cf[i] == UNASSIGNED) frontier.push_back((int32_t)i);
  std::vector<int32_t> next;
  next.reserve(frontier.size());
  std::vector<uint8_t> newc(n, 0);
  while (!frontier.empty()) {
    const int64_t fn = (int64_t)frontier.size();
    // select: i becomes C if w_i > w_j for all unassigned strong neighbours
    // (in the symmetrized graph S union ST)
#pragma omp parallel for schedule(dynamic, 512)
    for (int64_t idx = 0; idx < fn; ++idx) {
      const int32_t i = frontier[idx];
      bool best = true;
      for (int64_t k = S_indptr[i]; k < S_indptr[i + 1] && best; ++k) {
        const int32_t j = S_indices[k];
        if (cf[j] == UNASSIGNED && w[j] >= w[i] && j != i) best = false;
      }
      for (int64_t k = ST_indptr[i]; k < ST_indptr[i + 1] && best; ++k) {
        const int32_t j = ST_indices[k];
        if (cf[j] == UNASSIGNED && w[j] >= w[i] && j != i) best = false;
      }
      if (best) newc[i] = 1;
    }
#pragma omp parallel for schedule(static)
    for (int64_t idx = 0; idx < fn; ++idx)
      if (newc[frontier[idx]]) cf[frontier[idx]] = CPT;
    // F-assignment: unassigned point strongly depending on a new C becomes F
#pragma omp parallel for schedule(dynamic, 512)
    for (int64_t idx = 0; idx < fn; ++idx) {
      const int32_t i = frontier[idx];
      if (cf[i] != UNASSIGNED) continue;
      for (int64_t k = S_indptr[i]; k < S_indptr[i + 1]; ++k) {
        if (cf[S_indices[k]] == CPT) {
          cf[i] = FPT;
          break;
        }
      }
    }
    next.clear();
    for (int64_t idx = 0; idx < fn; ++idx) {
      const int32_t i = frontier[idx];
      newc[i] = 0;
      if (cf[i] == UNASSIGNED) next.push_back(i);
    }
    if ((int64_t)next.size() == fn) break;  // stall guard (disconnected ties)
    frontier.swap(next);
  }
  // safety: anything left unassigned becomes C (isolated in strength graph)
  int64_t n_c = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (cf[i] == UNASSIGNED) cf[i] = CPT;
    n_c += (cf[i] == CPT);
  }
  return n_c;
}

void set_omp_threads(int64_t n) { omp_set_num_threads((int)n); }

// Release libgomp's thread team before fork(): forking a process whose
// OpenMP pool has ever run deadlocks the child's first parallel region
// (classic libgomp fork hazard — bisected via run_blocked_procs after a
// ThreadComm run).  omp_pause_hard tears the team down; it respawns
// lazily on the next parallel region in parent and child alike.
void omp_fork_prepare(void) { omp_pause_resource_all(omp_pause_hard); }

// ---------------------------------------------------------------------------
// Blocked-PMIS round kernels (setup/blocked.py)
// ---------------------------------------------------------------------------
// The per-round select / F-assign bodies of pmis_cf, operating on the
// rank-local EXTENDED layout (owned rows [0, nloc) followed by ghost
// columns >= nloc; cf_ext covers both, refreshed between rounds by the
// Python comm loop).  These replace the np.maximum.at / logical_or.at
// full-nnz passes that made the blocked PMIS ~10x the native one
// (measured 30 of 54 rank-seconds at 96^3/8 ranks).  Selection math is
// identical to pmis_cf, so the C/F split stays bit-identical.

void pmis_round_select(int64_t nf, const int32_t* frontier,
                       const int64_t* S_indptr, const int32_t* S_e,
                       const int64_t* ST_indptr, const int32_t* ST_e,
                       const double* w_ext, const int8_t* cf_ext,
                       uint8_t* newc) {
  const int8_t UNASSIGNED = -1;
#pragma omp parallel for schedule(dynamic, 512)
  for (int64_t idx = 0; idx < nf; ++idx) {
    const int32_t i = frontier[idx];
    const double wi = w_ext[i];
    bool best = true;
    for (int64_t k = S_indptr[i]; k < S_indptr[i + 1] && best; ++k) {
      const int32_t j = S_e[k];
      if (j != i && cf_ext[j] == UNASSIGNED && w_ext[j] >= wi) best = false;
    }
    for (int64_t k = ST_indptr[i]; k < ST_indptr[i + 1] && best; ++k) {
      const int32_t j = ST_e[k];
      if (j != i && cf_ext[j] == UNASSIGNED && w_ext[j] >= wi) best = false;
    }
    newc[idx] = best ? 1 : 0;
  }
}

void pmis_round_fassign(int64_t nf, const int32_t* frontier,
                        const int64_t* S_indptr, const int32_t* S_e,
                        int8_t* cf_ext) {
  const int8_t UNASSIGNED = -1, FPT = 0, CPT = 1;
  // two phases (mark, then commit) so no iteration writes cf_ext while
  // another reads it — the single-phase form raced UNASSIGNED->FPT
  // stores against neighbour reads (benign outcome today, UB per the
  // memory model and fragile under any future state change)
  std::vector<uint8_t> newf(nf, 0);
#pragma omp parallel for schedule(dynamic, 512)
  for (int64_t idx = 0; idx < nf; ++idx) {
    const int32_t i = frontier[idx];
    if (cf_ext[i] != UNASSIGNED) continue;
    for (int64_t k = S_indptr[i]; k < S_indptr[i + 1]; ++k) {
      if (cf_ext[S_e[k]] == CPT) {
        newf[idx] = 1;
        break;
      }
    }
  }
#pragma omp parallel for schedule(static)
  for (int64_t idx = 0; idx < nf; ++idx)
    if (newf[idx]) cf_ext[frontier[idx]] = FPT;
}

// Stable counting sort: order such that keys[order] is ascending and
// equal keys keep input order.  Replaces np.argsort(kind="stable") in
// the blocked-setup exchanges (1.0 s -> ~50 ms at 5.3M keys/rank; the
// key domains there are tiny: rank owners <= 64, coarse-local rows).
// Returns 0, or 1 (order untouched) when a key lies outside [0, nkeys):
// the writes are indexed by key, so a bad key is refused before any of
// them, and the caller raises instead of the process aborting.
int stable_counting_order(int64_t n, const int64_t* keys, int64_t nkeys,
                          int64_t* order) {
  for (int64_t i = 0; i < n; ++i)
    if (keys[i] < 0 || keys[i] >= nkeys) return 1;
  std::vector<int64_t> offs(nkeys + 1, 0);
  for (int64_t i = 0; i < n; ++i) ++offs[keys[i] + 1];
  for (int64_t k = 0; k < nkeys; ++k) offs[k + 1] += offs[k];
  for (int64_t i = 0; i < n; ++i) order[offs[keys[i]]++] = i;
  return 0;
}

// COO pattern -> CSR with sorted rows (the blocked PMIS ST build:
// scipy's coo_tocsr + sort_indices was ~0.7 s/rank at 5.3M entries).
// indptr must be zero-initialized (nr+1).  Returns 0, or 1 (outputs
// untouched) when a row lies outside [0, nr).
int coo_to_csr_pattern(int64_t nr, int64_t nnz, const int64_t* rows,
                       const int64_t* cols, int64_t* indptr,
                       int32_t* out_cols) {
  for (int64_t k = 0; k < nnz; ++k)
    if (rows[k] < 0 || rows[k] >= nr) return 1;
  for (int64_t k = 0; k < nnz; ++k) ++indptr[rows[k] + 1];
  for (int64_t i = 0; i < nr; ++i) indptr[i + 1] += indptr[i];
  std::vector<int64_t> cur(indptr, indptr + nr);
  for (int64_t k = 0; k < nnz; ++k)
    out_cols[cur[rows[k]]++] = (int32_t)cols[k];
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t i = 0; i < nr; ++i)
    std::sort(out_cols + indptr[i], out_cols + indptr[i + 1]);
  return 0;
}

// Extended-local-index maps for the blocked ghost spaces: one parallel
// pass with a binary search over the sorted ghost list, replacing the
// numpy boolean-fancy-index passes over 12M-entry column arrays
// (setup/blocked.py ecol/_local_pos: 2.5 of the 14.7 s rank wall at
// 192^3/4, round-5 profile).
// ecol:      own -> col-r0;            ghost -> nloc + lb(ghosts, col)
// local_pos: col<r0 -> lb(ghosts,col); own -> n_left + col - r0;
//            col>=r1 -> nloc + lb(ghosts, col)
void ext_col_map_ecol(int64_t nnz, const int64_t* cols, int64_t r0,
                      int64_t r1, const int64_t* ghosts, int64_t ng,
                      int32_t* out) {
  const int64_t nloc = r1 - r0;
#pragma omp parallel for schedule(static)
  for (int64_t k = 0; k < nnz; ++k) {
    const int64_t c = cols[k];
    if (c >= r0 && c < r1) {
      out[k] = (int32_t)(c - r0);
    } else {
      const int64_t lb = std::lower_bound(ghosts, ghosts + ng, c) - ghosts;
      out[k] = (int32_t)(nloc + lb);
    }
  }
}

void ext_col_map_local(int64_t nnz, const int64_t* cols, int64_t r0,
                       int64_t r1, const int64_t* ghosts, int64_t ng,
                       int64_t n_left, int64_t* out) {
  const int64_t nloc = r1 - r0;
#pragma omp parallel for schedule(static)
  for (int64_t k = 0; k < nnz; ++k) {
    const int64_t c = cols[k];
    if (c >= r0 && c < r1) {
      out[k] = n_left + (c - r0);
    } else {
      const int64_t lb = std::lower_bound(ghosts, ghosts + ng, c) - ghosts;
      out[k] = (c < r0) ? lb : nloc + lb;
    }
  }
}

// ---------------------------------------------------------------------------
// Greedy aggregation (Vanek, Mandel & Brezina 1996)
// ---------------------------------------------------------------------------
// agg[i] = aggregate id, or -1 on input.  Returns the number of aggregates.
int64_t aggregate_greedy(int64_t n, const int64_t* S_indptr,
                         const int32_t* S_indices, int32_t* agg) {
  for (int64_t i = 0; i < n; ++i) agg[i] = -1;
  int64_t next_agg = 0;
  // Pass 1: root nodes whose strong neighbourhood is fully unaggregated.
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    bool free_nbhd = true;
    for (int64_t k = S_indptr[i]; k < S_indptr[i + 1]; ++k)
      if (agg[S_indices[k]] != -1) {
        free_nbhd = false;
        break;
      }
    if (!free_nbhd) continue;
    agg[i] = (int32_t)next_agg;
    for (int64_t k = S_indptr[i]; k < S_indptr[i + 1]; ++k)
      agg[S_indices[k]] = (int32_t)next_agg;
    ++next_agg;
  }
  // Pass 2: attach remaining nodes to a neighbouring aggregate.
  std::vector<int32_t> agg2(agg, agg + n);
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    for (int64_t k = S_indptr[i]; k < S_indptr[i + 1]; ++k) {
      const int32_t j = S_indices[k];
      if (agg[j] != -1) {
        agg2[i] = agg[j];
        break;
      }
    }
  }
  std::memcpy(agg, agg2.data(), n * sizeof(int32_t));
  // Pass 3: leftovers form their own aggregates (chains of weak points).
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    agg[i] = (int32_t)next_agg;
    for (int64_t k = S_indptr[i]; k < S_indptr[i + 1]; ++k)
      if (agg[S_indices[k]] == -1) agg[S_indices[k]] = (int32_t)next_agg;
    ++next_agg;
  }
  return next_agg;
}

// ---------------------------------------------------------------------------
// Classical direct interpolation (BoomerAMG-style, with +/- splitting)
// ---------------------------------------------------------------------------
// For F-point i:  w_ij = -alpha * a_ij / d_ii  (j in C_i, a_ij < 0)
//                 w_ij = -beta  * a_ij / d_ii  (j in C_i, a_ij > 0)
// alpha = sum of all negative off-diag a_ik / sum of negative a_ij over C_i,
// beta likewise for positive entries; if no positive C connections exist the
// positive off-diagonal mass is lumped into the diagonal d_ii.
// C-points interpolate by injection.  cmap[i] = coarse index of C-point i.
// Caller allocates P_indices / P_data with capacity >= nnz(A) + n.
// Returns nnz(P).
int64_t direct_interp(int64_t n, const int64_t* indptr, const int32_t* indices,
                      const double* data, const uint8_t* strong,
                      const int8_t* cf, const int32_t* cmap, int64_t* P_indptr,
                      int32_t* P_indices, double* P_data) {
  int64_t nnz = 0;
  P_indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (cf[i] == 1) {  // C-point: injection
      P_indices[nnz] = cmap[i];
      P_data[nnz] = 1.0;
      ++nnz;
    } else {
      double diag = 0.0;
      double sum_neg_all = 0.0, sum_pos_all = 0.0;
      double sum_neg_C = 0.0, sum_pos_C = 0.0;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        const int32_t j = indices[k];
        const double v = data[k];
        if (j == (int32_t)i) {
          diag += v;
          continue;
        }
        if (v < 0)
          sum_neg_all += v;
        else
          sum_pos_all += v;
        if (strong[k] && cf[j] == 1) {
          if (v < 0)
            sum_neg_C += v;
          else
            sum_pos_C += v;
        }
      }
      const double alpha = (sum_neg_C != 0.0) ? sum_neg_all / sum_neg_C : 0.0;
      double beta = 0.0;
      if (sum_pos_C != 0.0)
        beta = sum_pos_all / sum_pos_C;
      else
        diag += sum_pos_all;  // lump positive mass into diagonal
      if (diag != 0.0) {
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
          const int32_t j = indices[k];
          if (j == (int32_t)i || !strong[k] || cf[j] != 1) continue;
          const double v = data[k];
          const double w = (v < 0) ? -alpha * v / diag : -beta * v / diag;
          if (w != 0.0) {
            P_indices[nnz] = cmap[j];
            P_data[nnz] = w;
            ++nnz;
          }
        }
      }
    }
    P_indptr[i + 1] = nnz;
  }
  return nnz;
}

// ---------------------------------------------------------------------------
// Extended+i (distance-two) interpolation (De Sterck/Falgout/Nolting/Yang
// NLAA 2008; hypre interp_type 6) — the standard pairing for aggressive
// PMIS/HMIS coarsening, where an F-point's nearest C-point can be two hops
// away.  Chat_i = strong C-neighbours of i plus those of i's strong
// F-neighbours; each strong F-neighbour k distributes a_ik over
// Chat_i ∪ {i} weighted by the sign-opposite part of row k.  Two-phase
// (symbolic row counts, then parallel numeric fill); rows independent.
// ---------------------------------------------------------------------------

int64_t extpi_symbolic(int64_t n, const int64_t* indptr,
                       const int32_t* indices, const uint8_t* strong,
                       const int8_t* cf, int64_t* P_indptr) {
  std::vector<int64_t> counts(n, 0);
#pragma omp parallel
  {
    std::vector<int64_t> mark(n, -1);
#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
      if (cf[i] == 1) {  // C-point: injection
        counts[i] = 1;
        continue;
      }
      int64_t cnt = 0;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        const int32_t j = indices[k];
        if (!strong[k] || j == (int32_t)i) continue;
        if (cf[j] == 1) {
          if (mark[j] != i) { mark[j] = i; ++cnt; }
        } else {
          for (int64_t k2 = indptr[j]; k2 < indptr[j + 1]; ++k2) {
            const int32_t j2 = indices[k2];
            if (!strong[k2] || cf[j2] != 1) continue;
            if (mark[j2] != i) { mark[j2] = i; ++cnt; }
          }
        }
      }
      counts[i] = cnt;
    }
  }
  P_indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) P_indptr[i + 1] = P_indptr[i] + counts[i];
  return P_indptr[n];
}

void extpi_numeric(int64_t n, const int64_t* indptr, const int32_t* indices,
                   const double* data, const uint8_t* strong,
                   const int8_t* cf, const int32_t* cmap,
                   const int64_t* P_indptr, int32_t* P_indices,
                   double* P_data) {
#pragma omp parallel
  {
    std::vector<int64_t> pos(n, -1);   // column -> slot in Chat (row-local)
    std::vector<double> acc;
    std::vector<int32_t> chat;
#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
      const int64_t start = P_indptr[i];
      if (cf[i] == 1) {
        P_indices[start] = cmap[i];
        P_data[start] = 1.0;
        continue;
      }
      // pass 1: Chat_i (identical enumeration to extpi_symbolic)
      chat.clear();
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        const int32_t j = indices[k];
        if (!strong[k] || j == (int32_t)i) continue;
        if (cf[j] == 1) {
          if (pos[j] < 0) { pos[j] = (int64_t)chat.size(); chat.push_back(j); }
        } else {
          for (int64_t k2 = indptr[j]; k2 < indptr[j + 1]; ++k2) {
            const int32_t j2 = indices[k2];
            if (!strong[k2] || cf[j2] != 1) continue;
            if (pos[j2] < 0) {
              pos[j2] = (int64_t)chat.size();
              chat.push_back(j2);
            }
          }
        }
      }
      acc.assign(chat.size(), 0.0);
      double D = 0.0;
      // pass 2: accumulate numerators and the denominator
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        const int32_t j = indices[k];
        const double a_ij = data[k];
        if (j == (int32_t)i) {
          D += a_ij;                           // a_ii
          continue;
        }
        if (strong[k] && cf[j] != 1) {
          // strong F-neighbour: distribute over Chat ∪ {i}
          double a_jj = 0.0;
          for (int64_t k2 = indptr[j]; k2 < indptr[j + 1]; ++k2)
            if (indices[k2] == j) { a_jj = data[k2]; break; }
          double d = 0.0;
          for (int64_t k2 = indptr[j]; k2 < indptr[j + 1]; ++k2) {
            const int32_t l = indices[k2];
            const double v = data[k2];
            if (v * a_jj >= 0.0) continue;     // abar: opposite-sign part
            if (l == (int32_t)i || pos[l] >= 0) d += v;
          }
          if (d == 0.0) {
            D += a_ij;                         // no path back into Chat: lump
            continue;
          }
          const double f = a_ij / d;
          for (int64_t k2 = indptr[j]; k2 < indptr[j + 1]; ++k2) {
            const int32_t l = indices[k2];
            const double v = data[k2];
            if (v * a_jj >= 0.0) continue;
            if (l == (int32_t)i)
              D += f * v;
            else if (pos[l] >= 0)
              acc[pos[l]] += f * v;
          }
        } else if (pos[j] >= 0) {
          acc[pos[j]] += a_ij;                 // direct term, j in Chat
        } else {
          D += a_ij;                           // weak outside Chat: lump
        }
      }
      const double inv = (D != 0.0) ? (-1.0 / D) : 0.0;
      for (size_t s = 0; s < chat.size(); ++s) {
        P_indices[start + (int64_t)s] = cmap[chat[s]];
        P_data[start + (int64_t)s] = inv * acc[s];
        pos[chat[s]] = -1;                     // row-local reset
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Interpolation truncation (hypre P_max_elmts): keep the max_per_row
// largest-|w| entries per row, rescaling so positive and negative row sums
// are separately preserved.  Output row sizes are min(nnz_i, max_per_row),
// known up front, so the fill is one parallel pass.  Ties keep the
// lower slot (matches the numpy stable argsort oracle).
// ---------------------------------------------------------------------------
void truncate_interp(int64_t n, const int64_t* indptr,
                     const int32_t* indices, const double* data,
                     int64_t max_per_row, int64_t* P_indptr,
                     int32_t* P_indices, double* P_data) {
  P_indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t len = indptr[i + 1] - indptr[i];
    P_indptr[i + 1] = P_indptr[i] + (len < max_per_row ? len : max_per_row);
  }
#pragma omp parallel
  {
    std::vector<int64_t> slots;
#pragma omp for schedule(dynamic, 1024)
    for (int64_t i = 0; i < n; ++i) {
      const int64_t a0 = indptr[i], a1 = indptr[i + 1];
      const int64_t len = a1 - a0;
      int64_t out = P_indptr[i];
      if (len <= max_per_row) {
        for (int64_t k = a0; k < a1; ++k) {
          P_indices[out] = indices[k];
          P_data[out] = data[k];
          ++out;
        }
        continue;
      }
      slots.resize(len);
      for (int64_t s = 0; s < len; ++s) slots[s] = a0 + s;
      std::sort(slots.begin(), slots.end(), [&](int64_t a, int64_t b) {
        const double fa = std::fabs(data[a]), fb = std::fabs(data[b]);
        if (fa != fb) return fa > fb;
        return a < b;
      });
      slots.resize(max_per_row);
      std::sort(slots.begin(), slots.end());   // restore original order
      double pos_all = 0.0, neg_all = 0.0, pos_kept = 0.0, neg_kept = 0.0;
      for (int64_t k = a0; k < a1; ++k)
        (data[k] > 0 ? pos_all : neg_all) += data[k];
      for (int64_t s : slots)
        (data[s] > 0 ? pos_kept : neg_kept) += data[s];
      const double s_pos = (pos_kept != 0.0) ? pos_all / pos_kept : 1.0;
      const double s_neg = (neg_kept != 0.0) ? neg_all / neg_kept : 1.0;
      for (int64_t s : slots) {
        P_indices[out] = indices[s];
        P_data[out] = data[s] * (data[s] > 0 ? s_pos : s_neg);
        ++out;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Galerkin operator filtering (ML-style): drop |a_ij| < tol*sqrt(|a_ii a_jj|)
// and lump the dropped mass into the diagonal.  Two-pass over a CSR that
// already contains its diagonal entries.
// ---------------------------------------------------------------------------
// SPD-safety guard for ML-style filtering: lumping the dropped entries
// must not collapse or flip the row's diagonal.  High-contrast
// jump-coefficient operators hit this for real (round 3): a coarse row's
// weak-relative entries carried most of the diagonal's mass, lumping
// them produced an EXACTLY zero diagonal and a singular coarse level.
// A row whose post-lump diagonal would fall below RAP_DIAG_FLOOR of the
// original keeps ALL its entries instead.
static const double RAP_DIAG_FLOOR = 0.1;
static inline bool rap_keep_whole_row(double diag, double lump) {
  const double nd = diag + lump;
  if (diag > 0.0) return nd < RAP_DIAG_FLOOR * diag;
  if (diag < 0.0) return nd > RAP_DIAG_FLOOR * diag;
  return true;  // zero diagonal: nothing safe to lump into
}

int64_t rap_filter_symbolic(int64_t n, const int64_t* indptr,
                            const int32_t* indices, const double* data,
                            double drop_tol, double* diag_abs,
                            int64_t* C_indptr) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    diag_abs[i] = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
      if (indices[k] == (int32_t)i) {
        diag_abs[i] = std::fabs(data[k]);
        break;
      }
  }
  std::vector<int64_t> counts(n, 0);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t cnt = 0;
    double lump = 0.0, diag = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t j = indices[k];
      if (j == (int32_t)i) {
        diag = data[k];
        ++cnt;
      } else if (std::fabs(data[k]) >=
                 drop_tol * std::sqrt(diag_abs[i] * diag_abs[j])) {
        ++cnt;
      } else {
        lump += data[k];
      }
    }
    counts[i] = rap_keep_whole_row(diag, lump)
                    ? (indptr[i + 1] - indptr[i])
                    : cnt;
  }
  C_indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) C_indptr[i + 1] = C_indptr[i] + counts[i];
  return C_indptr[n];
}

void rap_filter_numeric(int64_t n, const int64_t* indptr,
                        const int32_t* indices, const double* data,
                        double drop_tol, const double* diag_abs,
                        const int64_t* C_indptr, int32_t* C_indices,
                        double* C_data) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    // the symbolic pass already decided whether this row keeps all its
    // entries (diagonal-collapse guard): detect it from the kept width
    if (C_indptr[i + 1] - C_indptr[i] == indptr[i + 1] - indptr[i]) {
      int64_t out = C_indptr[i];
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        C_indices[out] = indices[k];
        C_data[out++] = data[k];
      }
      continue;
    }
    int64_t out = C_indptr[i];
    int64_t diag_slot = -1;
    double lump = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t j = indices[k];
      if (j == (int32_t)i) {
        diag_slot = out;
        C_indices[out] = j;
        C_data[out] = data[k];
        ++out;
      } else if (std::fabs(data[k]) >=
                 drop_tol * std::sqrt(diag_abs[i] * diag_abs[j])) {
        C_indices[out] = j;
        C_data[out] = data[k];
        ++out;
      } else {
        lump += data[k];
      }
    }
    if (diag_slot >= 0) C_data[diag_slot] += lump;
  }
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering (bandwidth reduction for device layouts)
// ---------------------------------------------------------------------------
int64_t rcm_order(int64_t n, const int64_t* indptr, const int32_t* indices,
                  int32_t* perm) {
  std::vector<int32_t> deg(n);
  for (int64_t i = 0; i < n; ++i)
    deg[i] = (int32_t)(indptr[i + 1] - indptr[i]);
  std::vector<uint8_t> visited(n, 0);
  std::vector<int32_t> order;
  order.reserve(n);
  std::vector<int32_t> frontier;
  for (int64_t start_scan = 0; (int64_t)order.size() < n;) {
    // find unvisited node of minimum degree
    int64_t best = -1;
    for (int64_t i = start_scan; i < n; ++i) {
      if (!visited[i] && (best < 0 || deg[i] < deg[best])) best = i;
      if (!visited[i] && best >= 0 && deg[best] <= 1) break;
    }
    if (best < 0) break;
    visited[best] = 1;
    order.push_back((int32_t)best);
    size_t qhead = order.size() - 1;
    while (qhead < order.size()) {
      const int32_t u = order[qhead++];
      frontier.clear();
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        const int32_t v = indices[k];
        if (!visited[v]) {
          visited[v] = 1;
          frontier.push_back(v);
        }
      }
      std::sort(frontier.begin(), frontier.end(),
                [&](int32_t a, int32_t b) { return deg[a] < deg[b]; });
      for (int32_t v : frontier) order.push_back(v);
    }
  }
  // reverse
  for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
  return n;
}

// ---------------------------------------------------------------------------
// SpGEMM: C = A (n x k) * B (k x m), CSR, OpenMP row-parallel (SURVEY.md
// C6: the setup-phase hot spot — Galerkin RAP; scipy's single-threaded
// product dominates setup time at n >= 10^7).  Two-phase: symbolic row
// counts, then numeric fill into preallocated arrays; rows come out
// sorted and duplicate-free.
//
// Round-2 rewrite (this VM has 4 cores and small caches): the original
// Gustavson dense per-thread accumulators (m-length mark/pos/acc arrays,
// 17-35 MB per thread at m=2.2M) missed cache on every probe.  Symbolic
// now marks an m-bit bitmap (m/8 bytes: 270 KB at 2.2M columns — L2-
// resident) with a touched-list reset; numeric accumulates each row in an
// L1-resident open-addressing hash sized from the row's (known) unique
// count (Nagasaka/Matsuoka/Buluc-style hash SpGEMM).  Rows too dense for
// a 2^21-slot hash fall back to a dense accumulator.
// ---------------------------------------------------------------------------

int64_t spgemm_symbolic(int64_t n, int64_t m,
                        const int64_t* A_indptr, const int32_t* A_indices,
                        const int64_t* B_indptr, const int32_t* B_indices,
                        int64_t* C_indptr) {
  std::vector<int64_t> counts(n, 0);
  const int64_t nwords = (m + 63) / 64;
#pragma omp parallel
  {
    std::vector<uint64_t> bits(nwords, 0);
    std::vector<int32_t> touched;
    touched.reserve(1024);
#pragma omp for schedule(dynamic, 64)
    for (int64_t i = 0; i < n; ++i) {
      touched.clear();
      for (int64_t ka = A_indptr[i]; ka < A_indptr[i + 1]; ++ka) {
        const int32_t j = A_indices[ka];
        for (int64_t kb = B_indptr[j]; kb < B_indptr[j + 1]; ++kb) {
          const int32_t c = B_indices[kb];
          uint64_t& w = bits[(uint32_t)c >> 6];
          const uint64_t bit = 1ULL << (c & 63);
          if (!(w & bit)) {
            w |= bit;
            touched.push_back(c);
          }
        }
      }
      counts[i] = (int64_t)touched.size();
      for (const int32_t c : touched) bits[(uint32_t)c >> 6] = 0;
      // clearing the whole word is safe: every set bit in it belongs to
      // this row (the touched list covers all of them) — but a word may
      // be cleared more than once, which is idempotent.
    }
  }
  C_indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) C_indptr[i + 1] = C_indptr[i] + counts[i];
  return C_indptr[n];
}

namespace {

// dense-accumulator fallback for rows too wide for the L1 hash
void spgemm_row_dense(int64_t i, int64_t m, const int64_t* A_indptr,
                      const int32_t* A_indices, const double* A_data,
                      const int64_t* B_indptr, const int32_t* B_indices,
                      const double* B_data, const int64_t* C_indptr,
                      int32_t* C_indices, double* C_data,
                      std::vector<double>& acc, std::vector<uint8_t>& used) {
  if ((int64_t)acc.size() < m) {
    acc.assign(m, 0.0);
    used.assign(m, 0);
  }
  const int64_t start = C_indptr[i];
  int64_t cnt = 0;
  for (int64_t ka = A_indptr[i]; ka < A_indptr[i + 1]; ++ka) {
    const int32_t j = A_indices[ka];
    const double va = A_data[ka];
    for (int64_t kb = B_indptr[j]; kb < B_indptr[j + 1]; ++kb) {
      const int32_t c = B_indices[kb];
      if (!used[c]) {
        used[c] = 1;
        C_indices[start + cnt++] = c;
        acc[c] = va * B_data[kb];
      } else {
        acc[c] += va * B_data[kb];
      }
    }
  }
  std::sort(C_indices + start, C_indices + start + cnt);
  for (int64_t s = start; s < start + cnt; ++s) {
    C_data[s] = acc[C_indices[s]];
    used[C_indices[s]] = 0;
  }
}

}  // namespace

void spgemm_numeric(int64_t n, int64_t m,
                    const int64_t* A_indptr, const int32_t* A_indices,
                    const double* A_data,
                    const int64_t* B_indptr, const int32_t* B_indices,
                    const double* B_data,
                    const int64_t* C_indptr, int32_t* C_indices,
                    double* C_data) {
  // hash capacity: next pow2 >= 2x the widest row's unique count
  int64_t max_cnt = 0;
#pragma omp parallel for schedule(static) reduction(max : max_cnt)
  for (int64_t i = 0; i < n; ++i)
    max_cnt = std::max(max_cnt, C_indptr[i + 1] - C_indptr[i]);
  int64_t cap = 16;
  while (cap < 2 * max_cnt && cap < (1LL << 21)) cap <<= 1;
  const bool hash_ok = cap >= 2 * max_cnt;
#pragma omp parallel
  {
    std::vector<int32_t> keys(hash_ok ? cap : 0, -1);
    std::vector<double> hval(hash_ok ? cap : 0);
    std::vector<double> acc;       // dense fallback, lazily sized
    std::vector<uint8_t> used;
    const uint64_t mask = (uint64_t)cap - 1;
#pragma omp for schedule(dynamic, 64)
    for (int64_t i = 0; i < n; ++i) {
      const int64_t start = C_indptr[i];
      const int64_t row_cnt = C_indptr[i + 1] - start;
      if (!hash_ok && row_cnt > (1LL << 20)) {
        spgemm_row_dense(i, m, A_indptr, A_indices, A_data, B_indptr,
                         B_indices, B_data, C_indptr, C_indices, C_data,
                         acc, used);
        continue;
      }
      if (!hash_ok && keys.empty()) {
        keys.assign(cap, -1);
        hval.resize(cap);
      }
      int64_t cnt = 0;
      for (int64_t ka = A_indptr[i]; ka < A_indptr[i + 1]; ++ka) {
        const int32_t j = A_indices[ka];
        const double va = A_data[ka];
        for (int64_t kb = B_indptr[j]; kb < B_indptr[j + 1]; ++kb) {
          const int32_t c = B_indices[kb];
          uint64_t h = ((uint64_t)(uint32_t)c * 2654435761ULL) & mask;
          for (;;) {
            const int32_t k = keys[h];
            if (k == c) {
              hval[h] += va * B_data[kb];
              break;
            }
            if (k < 0) {
              keys[h] = c;
              hval[h] = va * B_data[kb];
              C_indices[start + cnt++] = c;
              break;
            }
            h = (h + 1) & mask;
          }
        }
      }
      std::sort(C_indices + start, C_indices + start + cnt);
      for (int64_t s = start; s < start + cnt; ++s) {
        const int32_t c = C_indices[s];
        uint64_t h = ((uint64_t)(uint32_t)c * 2654435761ULL) & mask;
        while (keys[h] != c) h = (h + 1) & mask;
        C_data[s] = hval[h];
        keys[h] = -1;
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused Galerkin triple product C = R * A * P with the ML-style drop/lump
// filter folded in (SURVEY.md §2 C13).  The two-SpGEMM route materializes
// the A*P intermediate (76.6M nnz = 0.92 GB at 192^3; fresh-page faults
// dominate this VM's setup time) and re-reads the unfiltered RAP for the
// filter pass.  This kernel accumulates each coarse row's complete triple
// sum in an L1-resident hash, stages rows in per-thread arenas (kept
// allocated across calls so their pages stay faulted), and applies
// |c_ij| < tol*sqrt(|c_ii c_jj|) with dropped mass lumped to the diagonal
// during emission, once every diagonal is known.
//
// Three-call protocol (ctypes cannot return growable arrays); the caller
// is single-threaded (Python GIL) and must run the calls in order:
//   rap_fused_compute(...)            -> unfiltered nnz (rows staged)
//   rap_fused_extract(tol, C_indptr)  -> filtered nnz   (indptr filled)
//   rap_fused_emit(C_indptr, C_indices, C_data)
// ---------------------------------------------------------------------------

namespace {

struct RapState {
  int64_t nc = 0;
  std::vector<std::vector<int32_t>> idx;  // per-thread staged entries
  std::vector<std::vector<double>> val;
  std::vector<int32_t> row_thread;
  std::vector<int64_t> row_base;          // offset of row i in its arena
  std::vector<int64_t> row_len;           // unfiltered length of row i
  std::vector<double> diag_abs;           // |c_ii| (0 if absent)
  double drop_tol = 0.0;
};
// thread_local: each blocked-setup rank (a Python thread under
// ThreadComm, a process under PipeComm/GlooComm) owns its arena, so the
// fused RAP is safe on every transport; the compute/extract/emit
// sequence always runs on one calling thread, and the inner OpenMP
// region binds the caller's instance by reference.
thread_local RapState g_rap;

}  // namespace

extern "C" {

int64_t rap_fused_compute(int64_t nc, int64_t m,
                          const int64_t* R_indptr, const int32_t* R_indices,
                          const double* R_data,
                          const int64_t* A_indptr, const int32_t* A_indices,
                          const double* A_data,
                          const int64_t* P_indptr, const int32_t* P_indices,
                          const double* P_data) {
  (void)m;
  RapState& st = g_rap;
  st.nc = nc;
  const int nt = omp_get_max_threads();
  if ((int)st.idx.size() != nt) {
    st.idx.resize(nt);
    st.val.resize(nt);
  }
  st.row_thread.resize(nc);
  st.row_base.resize(nc);
  st.row_len.resize(nc);
  st.diag_abs.assign(nc, 0.0);
  int64_t total = 0;
#pragma omp parallel reduction(+ : total)
  {
    const int t = omp_get_thread_num();
    auto& aidx = st.idx[t];
    auto& aval = st.val[t];
    aidx.clear();   // keeps capacity: arena pages stay faulted across calls
    aval.clear();
    int64_t cap = 256;
    std::vector<int32_t> keys(cap, -1);
    std::vector<double> hval(cap);
    std::vector<int32_t> touched;
    touched.reserve(256);
#pragma omp for schedule(dynamic, 64)
    for (int64_t i = 0; i < nc; ++i) {
      touched.clear();
      for (;;) {  // retry the row with a larger table on overflow
        const uint64_t mask = (uint64_t)cap - 1;
        bool overflow = false;
        for (int64_t kr = R_indptr[i]; kr < R_indptr[i + 1] && !overflow;
             ++kr) {
          const int32_t j = R_indices[kr];
          const double vr = R_data[kr];
          for (int64_t ka = A_indptr[j]; ka < A_indptr[j + 1] && !overflow;
               ++ka) {
            const double vra = vr * A_data[ka];
            const int32_t k = A_indices[ka];
            for (int64_t kp = P_indptr[k]; kp < P_indptr[k + 1]; ++kp) {
              const int32_t c = P_indices[kp];
              uint64_t h = ((uint64_t)(uint32_t)c * 2654435761ULL) & mask;
              for (;;) {
                const int32_t key = keys[h];
                if (key == c) {
                  hval[h] += vra * P_data[kp];
                  break;
                }
                if (key < 0) {
                  if (2 * (int64_t)touched.size() >= cap) {
                    overflow = true;
                    break;
                  }
                  keys[h] = c;
                  hval[h] = vra * P_data[kp];
                  touched.push_back(c);
                  break;
                }
                h = (h + 1) & mask;
              }
              if (overflow) break;
            }
          }
        }
        if (!overflow) break;
        for (const int32_t c : touched) {
          uint64_t h = ((uint64_t)(uint32_t)c * 2654435761ULL) & mask;
          while (keys[h] != c) h = (h + 1) & mask;
          keys[h] = -1;
        }
        touched.clear();
        cap <<= 2;
        keys.assign(cap, -1);
        hval.resize(cap);
      }
      std::sort(touched.begin(), touched.end());
      st.row_thread[i] = t;
      st.row_base[i] = (int64_t)aidx.size();
      st.row_len[i] = (int64_t)touched.size();
      const uint64_t mask = (uint64_t)cap - 1;
      for (const int32_t c : touched) {
        uint64_t h = ((uint64_t)(uint32_t)c * 2654435761ULL) & mask;
        while (keys[h] != c) h = (h + 1) & mask;
        aidx.push_back(c);
        aval.push_back(hval[h]);
        if (c == (int32_t)i) st.diag_abs[i] = std::fabs(hval[h]);
        keys[h] = -1;   // cleared during extraction: table empty for next row
      }
      total += st.row_len[i];
    }
  }
  return total;
}

int64_t rap_fused_extract(double drop_tol, int64_t* C_indptr) {
  RapState& st = g_rap;
  st.drop_tol = drop_tol;
  const int64_t nc = st.nc;
  std::vector<int64_t> keep(nc);
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t i = 0; i < nc; ++i) {
    const int64_t len = st.row_len[i];
    if (drop_tol <= 0.0) {
      keep[i] = len;
      continue;
    }
    const int32_t* ci = st.idx[st.row_thread[i]].data() + st.row_base[i];
    const double* cv = st.val[st.row_thread[i]].data() + st.row_base[i];
    const double di = st.diag_abs[i];
    int64_t k = 0;
    double lump = 0.0, diag = 0.0;
    for (int64_t s = 0; s < len; ++s) {
      if (ci[s] == (int32_t)i) {
        diag = cv[s];
        ++k;
      } else if (std::fabs(cv[s]) >=
                 drop_tol * std::sqrt(di * st.diag_abs[ci[s]])) {
        ++k;
      } else {
        lump += cv[s];
      }
    }
    // diagonal-collapse guard (see rap_keep_whole_row)
    keep[i] = rap_keep_whole_row(diag, lump) ? len : k;
  }
  C_indptr[0] = 0;
  for (int64_t i = 0; i < nc; ++i) C_indptr[i + 1] = C_indptr[i] + keep[i];
  return C_indptr[nc];
}

void rap_fused_emit(const int64_t* C_indptr, int32_t* C_indices,
                    double* C_data) {
  RapState& st = g_rap;
  const int64_t nc = st.nc;
  const double drop_tol = st.drop_tol;
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t i = 0; i < nc; ++i) {
    const int32_t* ci = st.idx[st.row_thread[i]].data() + st.row_base[i];
    const double* cv = st.val[st.row_thread[i]].data() + st.row_base[i];
    const int64_t len = st.row_len[i];
    int64_t w = C_indptr[i];
    if (drop_tol <= 0.0) {
      for (int64_t s = 0; s < len; ++s) {
        C_indices[w] = ci[s];
        C_data[w++] = cv[s];
      }
      continue;
    }
    if (C_indptr[i + 1] - C_indptr[i] == len) {
      // guard row (or nothing dropped): emit verbatim, no lumping
      for (int64_t s = 0; s < len; ++s) {
        C_indices[w] = ci[s];
        C_data[w++] = cv[s];
      }
      continue;
    }
    const double di = st.diag_abs[i];
    double lump = 0.0;
    int64_t diag_slot = -1;
    for (int64_t s = 0; s < len; ++s) {
      const int32_t c = ci[s];
      if (c == (int32_t)i) {
        diag_slot = w;
        C_indices[w] = c;
        C_data[w++] = cv[s];
      } else if (std::fabs(cv[s]) >=
                 drop_tol * std::sqrt(di * st.diag_abs[c])) {
        C_indices[w] = c;
        C_data[w++] = cv[s];
      } else {
        lump += cv[s];
      }
    }
    if (diag_slot >= 0) C_data[diag_slot] += lump;
  }
  // row metadata freed; arenas keep their capacity (page reuse)
  st.row_thread.clear();
  st.row_base.clear();
  st.row_len.clear();
  st.diag_abs.clear();
}

// Slot-major ELL fill: cols/vals are (K, n_pad) row-major arrays (slot k
// contiguous over rows — the layout ops/formats.EllMatrix gathers with one
// 2-D take).  numpy's cols[slot, rows] = ... fancy-index scatter took 11 s
// for the 192^3 restriction operator; this fills block-by-block so writes
// stay cache-resident, zero-padding included (parallel first-touch).
void ell_fill_f32(int64_t n, int64_t n_pad, int64_t K,
                  const int64_t* indptr, const int32_t* indices,
                  const double* data, int32_t* cols, float* vals) {
  const int64_t BLK = 4096;
  const int64_t nblk = (n_pad + BLK - 1) / BLK;
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < nblk; ++b) {
    const int64_t r0 = b * BLK, r1 = std::min(n_pad, r0 + BLK);
    for (int64_t k = 0; k < K; ++k) {
      int32_t* c = cols + k * n_pad;
      float* v = vals + k * n_pad;
      for (int64_t r = r0; r < r1; ++r) {
        if (r < n && k < indptr[r + 1] - indptr[r]) {
          c[r] = indices[indptr[r] + k];
          v[r] = (float)data[indptr[r] + k];
        } else {
          c[r] = 0;
          v[r] = 0.0f;
        }
      }
    }
  }
}

// Row order of the sliced ELL layout (ops/formats.py::pack_ell): perm of
// [0, n) that orders each window of sigma rows by descending length, ties
// in row order (a stable sort), windows in parallel.
void ell_sort_windows(int64_t n, int64_t sigma, const int64_t* lens,
                      int64_t* perm) {
  const int64_t nw = (n + sigma - 1) / sigma;
#pragma omp parallel for schedule(static)
  for (int64_t w = 0; w < nw; ++w) {
    const int64_t lo = w * sigma, hi = std::min(n, lo + sigma);
    for (int64_t i = lo; i < hi; ++i) perm[i] = i;
    std::stable_sort(perm + lo, perm + hi, [lens](int64_t a, int64_t b) {
      return lens[a] > lens[b];
    });
  }
}

// Slot tables of the sliced ELL layout: slice s holds width[s] slots of
// each of its 32 / lanes rows from entry off[s]; slot q of packed row
// r = s * c + rl lies at off[s] + ((q / tv) * 32 + rl * lanes +
// (q / vec) % lanes) * vec + q % vec, tv = lanes * vec, and comes from
// the ELL-T tables (K, n_pad) at row perm[r] (r where perm is null);
// col fill, val 0 past the tables.  Slices in parallel.
extern "C++" template <typename T>
void ell_pack(int64_t n_pad, int64_t K, int64_t n_slices,
                     int64_t lanes, int64_t vec, const int64_t* perm,
                     const int64_t* width, const int64_t* off,
                     const int32_t* cols, const T* vals, int32_t fill,
                     int32_t* pcols, T* pvals) {
  const int64_t c = 32 / lanes, tv = lanes * vec;
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t s = 0; s < n_slices; ++s) {
    for (int64_t q = 0; q < width[s]; ++q) {
      const int64_t at = off[s] + ((q / tv) * 32 + (q / vec) % lanes) * vec
                         + q % vec;
      for (int64_t rl = 0; rl < c; ++rl) {
        const int64_t r = s * c + rl, pos = at + rl * tv;
        if (r < n_pad && q < K) {
          const int64_t src = q * n_pad + (perm ? perm[r] : r);
          pcols[pos] = cols[src];
          pvals[pos] = vals[src];
        } else {
          pcols[pos] = fill;
          pvals[pos] = 0;
        }
      }
    }
  }
}

void ell_pack_f32(int64_t n_pad, int64_t K, int64_t n_slices, int64_t lanes,
                  int64_t vec, const int64_t* perm, const int64_t* width,
                  const int64_t* off, const int32_t* cols, const float* vals,
                  int32_t fill, int32_t* pcols, float* pvals) {
  ell_pack(n_pad, K, n_slices, lanes, vec, perm, width, off, cols, vals,
           fill, pcols, pvals);
}

void ell_pack_f64(int64_t n_pad, int64_t K, int64_t n_slices, int64_t lanes,
                  int64_t vec, const int64_t* perm, const int64_t* width,
                  const int64_t* off, const int32_t* cols, const double* vals,
                  int32_t fill, int32_t* pcols, double* pvals) {
  ell_pack(n_pad, K, n_slices, lanes, vec, perm, width, off, cols, vals,
           fill, pcols, pvals);
}


// Parallel first-touch of fresh pages.  Measured on the deploy VM:
// single-threaded first-touch runs at ~0.9 GB/s and a compute kernel
// faulting its output as it writes sustains only ~0.2 GB/s effective,
// while a dedicated 4-thread page-touch pass reaches ~3.2 GB/s — so big
// np.empty outputs are prefaulted before the filling kernel runs.
// (MADV_HUGEPAGE was measured at 17 MB/s on this kernel config — do NOT
// switch this to hugepage hints.)
void prefault(char* p, int64_t nbytes) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nbytes; i += 4096) p[i] = 0;
}

// Row sums of |a_ij| (l1-Jacobi diagonal + Gershgorin lambda_max bound)
// without np.abs(A)'s full-CSR copy (0.4 GB at 192^3).
void abs_row_sum(int64_t n, const int64_t* indptr, const double* data,
                 double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double s = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) s += std::fabs(data[k]);
    out[i] = s;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Parallel CSR transpose (SURVEY.md §2 C7: R = P^T; also the S^T graphs for
// the splitting kernels).  scipy's .T.tocsr() is a serial two-pass scatter
// whose fresh-page allocations run at this VM's 0.1-1 GB/s fault rate —
// measured 4-14 s for the 42M-edge fine strength graph at 192^3.  This
// version is block-parallel and deterministic: source rows are split into
// `nblk` ordered blocks, each block's per-column histogram is exclusive-
// scanned across blocks, so every output row comes out sorted by source
// row with no atomics.
// ---------------------------------------------------------------------------

namespace {

template <bool kHasData>
void csr_transpose_impl(int64_t n, int64_t m, const int64_t* indptr,
                        const int32_t* indices, const double* data,
                        int64_t* T_indptr, int32_t* T_indices,
                        double* T_data) {
  const int64_t nblk = std::min<int64_t>(omp_get_max_threads(),
                                         std::max<int64_t>(n, 1));
  // int32 block histograms: a single block's per-column count is bounded
  // by the column's total degree < 2^31
  std::vector<int32_t> hist((size_t)nblk * (size_t)m);
#pragma omp parallel for schedule(static, 1)
  for (int64_t b = 0; b < nblk; ++b) {
    int32_t* h = hist.data() + (size_t)b * m;
    std::memset(h, 0, sizeof(int32_t) * (size_t)m);
    const int64_t r0 = n * b / nblk, r1 = n * (b + 1) / nblk;
    for (int64_t i = r0; i < r1; ++i)
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) ++h[indices[k]];
  }
  // per-column exclusive scan over blocks; T_indptr[c+1] = column degree
  T_indptr[0] = 0;
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < m; ++c) {
    int32_t run = 0;
    for (int64_t b = 0; b < nblk; ++b) {
      int32_t* h = hist.data() + (size_t)b * m + c;
      const int32_t v = *h;
      *h = run;
      run += v;
    }
    T_indptr[c + 1] = run;
  }
  for (int64_t c = 0; c < m; ++c) T_indptr[c + 1] += T_indptr[c];
#pragma omp parallel for schedule(static, 1)
  for (int64_t b = 0; b < nblk; ++b) {
    int32_t* h = hist.data() + (size_t)b * m;
    const int64_t r0 = n * b / nblk, r1 = n * (b + 1) / nblk;
    for (int64_t i = r0; i < r1; ++i)
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        const int32_t c = indices[k];
        const int64_t pos = T_indptr[c] + (int64_t)(h[c]++);
        T_indices[pos] = (int32_t)i;
        if (kHasData) T_data[pos] = data[k];
      }
  }
}

}  // namespace

extern "C" {

// T = A^T with values, for an (n x m) CSR.  Output rows sorted.
void csr_transpose_f64(int64_t n, int64_t m, const int64_t* indptr,
                       const int32_t* indices, const double* data,
                       int64_t* T_indptr, int32_t* T_indices,
                       double* T_data) {
  csr_transpose_impl<true>(n, m, indptr, indices, data, T_indptr, T_indices,
                           T_data);
}

// Pattern-only transpose (the splitting kernels read only the graph).
void csr_transpose_pattern(int64_t n, int64_t m, const int64_t* indptr,
                           const int32_t* indices, int64_t* T_indptr,
                           int32_t* T_indices) {
  csr_transpose_impl<false>(n, m, indptr, indices, nullptr, T_indptr,
                            T_indices, nullptr);
}

}  // extern "C"

extern "C" {

// Gather permuted sub-row slices into a new CSR (the window-grouped
// SplitGell packer's data movement): out[dst_start[s] .. +lens[s]) =
// in[src_start[s] .. +lens[s]).  Replaces an nnz-length np.repeat +
// np.arange + two fancy-index gathers — ~2 s of fresh-page int64
// temporaries per packed operator at 192^3 on the deploy VM.
extern "C" void gather_subrows(int64_t n_sub, const int64_t* src_start,
                               const int64_t* dst_start,
                               const int64_t* lens, const int32_t* indices,
                               const double* data, int32_t* out_indices,
                               double* out_data) {
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t s = 0; s < n_sub; ++s) {
    const int64_t a = src_start[s], b = dst_start[s], L = lens[s];
    std::memcpy(out_indices + b, indices + a, (size_t)L * sizeof(int32_t));
    std::memcpy(out_data + b, data + a, (size_t)L * sizeof(double));
  }
}

// Pattern-only variant (blocked-setup ghost-row replies on strength
// CSRs, whose .data is a broadcast view — no value stream to copy).
extern "C" void gather_subrows_pattern(int64_t n_sub,
                                       const int64_t* src_start,
                                       const int64_t* dst_start,
                                       const int64_t* lens,
                                       const int32_t* indices,
                                       int32_t* out_indices) {
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t s = 0; s < n_sub; ++s) {
    const int64_t a = src_start[s], b = dst_start[s], L = lens[s];
    std::memcpy(out_indices + b, indices + a, (size_t)L * sizeof(int32_t));
  }
}

// Masked CSR compress WITH values (the pattern-only variant lives in
// mask_compress): out rows keep entries where mask != 0.
void mask_compress_data(int64_t n, const int64_t* indptr,
                        const int32_t* indices, const double* data,
                        const uint8_t* mask, const int64_t* out_indptr,
                        int32_t* out_indices, double* out_data) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t o = out_indptr[i];
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      if (mask[k]) {
        out_indices[o] = indices[k];
        out_data[o] = data[k];
        ++o;
      }
    }
  }
}

// data[k] *= scale[row(k)] — in place row scaling without an nnz-length
// rows array.
void csr_row_scale(int64_t n, const int64_t* indptr, double* data,
                   const double* scale) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double s = scale[i];
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) data[k] *= s;
  }
}

// out[i] = sum of NON-strong off-diagonal entries of row i (the lumped
// mass of strength filtering) — replaces two serial scipy matvecs.
void weak_row_sum(int64_t n, const int64_t* indptr, const int32_t* indices,
                  const double* data, const uint8_t* strong, double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double s = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
      if (!strong[k] && indices[k] != (int32_t)i) s += data[k];
    out[i] = s;
  }
}

// C = alpha*A + beta*B for same-shape CSRs with SORTED column indices —
// scipy's csr_binop is single-threaded (measured 2.4 s on the fine-level
// P smoothing merge at 96^3).  Two-phase: symbolic row sizes, then fill.
void csr_add_symbolic(int64_t n, const int64_t* Ap, const int32_t* Ai,
                      const int64_t* Bp, const int32_t* Bi,
                      int64_t* counts) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t ka = Ap[i], kb = Bp[i], c = 0;
    while (ka < Ap[i + 1] && kb < Bp[i + 1]) {
      const int32_t ca = Ai[ka], cb = Bi[kb];
      ka += (ca <= cb);
      kb += (cb <= ca);
      ++c;
    }
    counts[i] = c + (Ap[i + 1] - ka) + (Bp[i + 1] - kb);
  }
}

void csr_add_fill(int64_t n, double alpha, const int64_t* Ap,
                  const int32_t* Ai, const double* Ax, double beta,
                  const int64_t* Bp, const int32_t* Bi, const double* Bx,
                  const int64_t* Cp, int32_t* Ci, double* Cx) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t ka = Ap[i], kb = Bp[i], o = Cp[i];
    while (ka < Ap[i + 1] && kb < Bp[i + 1]) {
      const int32_t ca = Ai[ka], cb = Bi[kb];
      if (ca < cb) {
        Ci[o] = ca; Cx[o++] = alpha * Ax[ka++];
      } else if (cb < ca) {
        Ci[o] = cb; Cx[o++] = beta * Bx[kb++];
      } else {
        Ci[o] = ca; Cx[o++] = alpha * Ax[ka++] + beta * Bx[kb++];
      }
    }
    for (; ka < Ap[i + 1]; ++ka) { Ci[o] = Ai[ka]; Cx[o++] = alpha * Ax[ka]; }
    for (; kb < Bp[i + 1]; ++kb) { Ci[o] = Bi[kb]; Cx[o++] = beta * Bx[kb]; }
  }
}

// ---------------------------------------------------------------------------
// Aggressive coarsening via a second PMIS round on the distance-2 C-C
// graph (hypre BoomerAMG agg_num_levels; De Sterck/Yang/Heys 2006).
// Replaces the composed-coarsening path's throwaway intermediate RAP:
// c1 ~ c2 iff c2 in S(c1) or exists F-point f with f in S(c1), c2 in
// S(f).  Rows are C-local (cmap).  Two-phase symbolic/fill.
//
// Row-local L1-resident hash accumulators throughout (same idea as the
// hash SpGEMM above): an n-length mark array is 800 MB PER THREAD at
// the 100M north star, and random scatter into it is DRAM-latency-bound
// (measured: dist2 46 s, multipass+smooth 236 s at 100M on 4 cores).
// touched[] records SLOTS, so clearing is O(row).
// ---------------------------------------------------------------------------

namespace {

struct LocalHashMap {
  std::vector<int32_t> keys;
  std::vector<double> vals;
  uint64_t mask = 0;
  void init(int64_t cap_pow2, bool with_vals) {
    keys.assign(cap_pow2, -1);
    if (with_vals) vals.assign(cap_pow2, 0.0);
    mask = (uint64_t)cap_pow2 - 1;
  }
  // returns the slot for key k; *fresh set when newly inserted
  inline int64_t slot(int32_t k, bool* fresh) {
    uint64_t h = ((uint64_t)(uint32_t)k * 0x9E3779B1u) & mask;
    while (true) {
      const int32_t cur = keys[h];
      if (cur == k) { *fresh = false; return (int64_t)h; }
      if (cur == -1) { keys[h] = k; *fresh = true; return (int64_t)h; }
      h = (h + 1) & mask;
    }
  }
};

inline int64_t pow2_at_least(int64_t x) {
  int64_t c = 64;
  while (c < x) c <<= 1;
  return c;
}

}  // namespace

namespace {

// candidate-count bound over C rows (sizes the per-thread hash)
int64_t dist2_row_bound(int64_t n, const int64_t* S_indptr,
                        const int32_t* S_indices, const int8_t* cf) {
  int64_t bound = 1;
#pragma omp parallel for schedule(static) reduction(max : bound)
  for (int64_t i = 0; i < n; ++i) {
    if (cf[i] != 1) continue;
    int64_t b = 0;
    for (int64_t k = S_indptr[i]; k < S_indptr[i + 1]; ++k) {
      const int32_t j = S_indices[k];
      b += (cf[j] == 1) ? 1 : (S_indptr[j + 1] - S_indptr[j]);
    }
    bound = std::max(bound, b);
  }
  return bound;
}

// scans one C row's distance-2 candidates; returns the unique count and,
// when out != nullptr, writes cmap[candidate] in discovery order
inline int64_t dist2_row_scan(int64_t i, const int64_t* S_indptr,
                              const int32_t* S_indices, const int8_t* cf,
                              const int32_t* cmap, LocalHashMap& hs,
                              std::vector<int64_t>& touched, int32_t* out) {
  touched.clear();
  int64_t cnt = 0;
  bool fresh;
  for (int64_t k = S_indptr[i]; k < S_indptr[i + 1]; ++k) {
    const int32_t j = S_indices[k];
    if (j == (int32_t)i) continue;
    if (cf[j] == 1) {
      const int64_t s = hs.slot(j, &fresh);
      if (fresh) {
        touched.push_back(s);
        if (out) out[cnt] = cmap[j];
        ++cnt;
      }
    } else {
      for (int64_t k2 = S_indptr[j]; k2 < S_indptr[j + 1]; ++k2) {
        const int32_t j2 = S_indices[k2];
        if (cf[j2] != 1 || j2 == (int32_t)i) continue;
        const int64_t s = hs.slot(j2, &fresh);
        if (fresh) {
          touched.push_back(s);
          if (out) out[cnt] = cmap[j2];
          ++cnt;
        }
      }
    }
  }
  for (const int64_t s : touched) hs.keys[s] = -1;
  return cnt;
}

}  // namespace

int64_t dist2_cc_symbolic(int64_t n, const int64_t* S_indptr,
                          const int32_t* S_indices, const int8_t* cf,
                          const int32_t* cmap, int64_t n_c,
                          int64_t* S2_indptr) {
  std::vector<int64_t> counts(n_c, 0);
  const int64_t cap = pow2_at_least(
      2 * dist2_row_bound(n, S_indptr, S_indices, cf));
#pragma omp parallel
  {
    LocalHashMap hs;
    hs.init(cap, false);
    std::vector<int64_t> touched;
    touched.reserve(1024);
#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
      if (cf[i] != 1) continue;
      counts[cmap[i]] = dist2_row_scan(i, S_indptr, S_indices, cf, cmap,
                                       hs, touched, nullptr);
    }
  }
  S2_indptr[0] = 0;
  for (int64_t r = 0; r < n_c; ++r)
    S2_indptr[r + 1] = S2_indptr[r] + counts[r];
  return S2_indptr[n_c];
}

void dist2_cc_fill(int64_t n, const int64_t* S_indptr,
                   const int32_t* S_indices, const int8_t* cf,
                   const int32_t* cmap, const int64_t* S2_indptr,
                   int32_t* S2_indices) {
  const int64_t cap = pow2_at_least(
      2 * dist2_row_bound(n, S_indptr, S_indices, cf));
#pragma omp parallel
  {
    LocalHashMap hs;
    hs.init(cap, false);
    std::vector<int64_t> touched;
    touched.reserve(1024);
#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
      if (cf[i] != 1) continue;
      dist2_row_scan(i, S_indptr, S_indices, cf, cmap, hs, touched,
                     S2_indices + S2_indptr[cmap[i]]);
    }
  }
}

// ---------------------------------------------------------------------------
// Multipass interpolation (Stuben 2001; hypre agg_interp_type 4) — the
// standard partner of aggressive coarsening: builds P directly from the
// fine A and the final C/F split, no intermediate operator.  Pass 1 =
// F-points with a strong C neighbour (direct interpolation, the
// alpha/beta sign-separated scheme of direct_interp); pass p>=2 =
// F-points with a strong pass<p neighbour, whose rows distribute a_ij
// over the neighbour's already-built P row; weak/unreached connections
// lump into the diagonal.  Rows are truncated to `cap` entries as built
// (pos/neg row sums separately preserved, as truncate_interp).
//
// Output is slot layout: P_cols/P_vals (n, cap) + P_len (n).  Returns
// total nnz, or -1 if some F-point was unreachable AND had strong
// connections (should not happen: BFS covers every point reachable in
// the strength graph; isolated points get empty rows).
// ---------------------------------------------------------------------------

static inline void mp_truncate_row(std::vector<int32_t>& cols,
                                   std::vector<double>& vals, int64_t cap,
                                   int32_t* out_cols, double* out_vals,
                                   int32_t* out_len,
                                   std::vector<int64_t>& order) {
  const int64_t len = (int64_t)cols.size();
  if (len <= cap) {
    for (int64_t s = 0; s < len; ++s) {
      out_cols[s] = cols[s];
      out_vals[s] = vals[s];
    }
    *out_len = (int32_t)len;
    return;
  }
  order.resize(len);
  for (int64_t s = 0; s < len; ++s) order[s] = s;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    const double fa = std::fabs(vals[a]), fb = std::fabs(vals[b]);
    if (fa != fb) return fa > fb;
    return a < b;
  });
  double pos_all = 0.0, neg_all = 0.0, pos_kept = 0.0, neg_kept = 0.0;
  for (int64_t s = 0; s < len; ++s)
    (vals[s] > 0 ? pos_all : neg_all) += vals[s];
  for (int64_t s = 0; s < cap; ++s) {
    const double v = vals[order[s]];
    (v > 0 ? pos_kept : neg_kept) += v;
  }
  const double s_pos = (pos_kept != 0.0) ? pos_all / pos_kept : 1.0;
  const double s_neg = (neg_kept != 0.0) ? neg_all / neg_kept : 1.0;
  order.resize(cap);
  std::sort(order.begin(), order.end());
  for (int64_t s = 0; s < cap; ++s) {
    const double v = vals[order[s]];
    out_cols[s] = cols[order[s]];
    out_vals[s] = v * (v > 0 ? s_pos : s_neg);
  }
  *out_len = (int32_t)cap;
}

// One multipass round, pass 1: direct interpolation from strong C
// neighbours for the listed rows.  Shared by the single-host driver
// (multipass_interp) and the blocked per-pass driver (multipass_step) —
// the blocked path runs it on a ghost-extended LOCAL matrix, exchanging
// boundary P rows between passes, and both produce bit-identical rows
// (scan order is row order, truncation tie-breaks on slot position).
static void mp_pass1_compute(const int64_t* indptr, const int32_t* indices,
                             const double* data, const uint8_t* strong,
                             const int8_t* cf, const int32_t* cmap,
                             int64_t cap, const int32_t* cur, int64_t cn,
                             int32_t* P_cols, double* P_vals,
                             int32_t* P_len) {
#pragma omp parallel
  {
    std::vector<int32_t> cols;
    std::vector<double> vals;
    std::vector<int64_t> order;
#pragma omp for schedule(dynamic, 256)
    for (int64_t idx = 0; idx < cn; ++idx) {
      const int32_t i = cur[idx];
      double diag = 0.0, sneg_all = 0.0, spos_all = 0.0;
      double sneg_C = 0.0, spos_C = 0.0;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        const int32_t j = indices[k];
        const double v = data[k];
        if (j == i) { diag += v; continue; }
        (v < 0 ? sneg_all : spos_all) += v;
        if (strong[k] && cf[j] == 1) (v < 0 ? sneg_C : spos_C) += v;
      }
      const double alpha = (sneg_C != 0.0) ? sneg_all / sneg_C : 0.0;
      double beta = 0.0;
      if (spos_C != 0.0) beta = spos_all / spos_C;
      else diag += spos_all;
      cols.clear();
      vals.clear();
      if (diag != 0.0) {
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
          const int32_t j = indices[k];
          if (j == i || !strong[k] || cf[j] != 1) continue;
          const double v = data[k];
          const double w = (v < 0 ? -alpha : -beta) * v / diag;
          if (w != 0.0) { cols.push_back(cmap[j]); vals.push_back(w); }
        }
      }
      mp_truncate_row(cols, vals, cap, P_cols + (int64_t)i * cap,
                      P_vals + (int64_t)i * cap, P_len + i, order);
    }
  }
}

// One multipass round, pass p > 1: distribute a_ij over neighbours'
// already-built rows; weak/unreachable connections lump into the
// diagonal.  Row-local hash accumulator: an n_c-length acc is
// DRAM-scatter-bound (47 MB/thread at the 100M north star).
static void mp_passk_compute(const int64_t* indptr, const int32_t* indices,
                             const double* data, const uint8_t* strong,
                             int64_t cap, int32_t p, const int32_t* pass,
                             const int32_t* cur, int64_t cn,
                             int32_t* P_cols, double* P_vals,
                             int32_t* P_len) {
  int64_t max_deg = 1;
#pragma omp parallel for schedule(static) reduction(max : max_deg)
  for (int64_t idx = 0; idx < cn; ++idx) {
    const int32_t i = cur[idx];
    max_deg = std::max(max_deg, indptr[i + 1] - indptr[i]);
  }
  const int64_t hcap = pow2_at_least(2 * max_deg * cap);
#pragma omp parallel
  {
    LocalHashMap hm;
    hm.init(hcap, true);
    std::vector<int64_t> touched;
    std::vector<int32_t> cols;
    std::vector<double> vals;
    std::vector<int64_t> order;
#pragma omp for schedule(dynamic, 256)
    for (int64_t idx = 0; idx < cn; ++idx) {
      const int32_t i = cur[idx];
      touched.clear();
      double denom = 0.0;
      bool fresh;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        const int32_t j = indices[k];
        const double a_ij = data[k];
        if (j == i) { denom += a_ij; continue; }
        if (strong[k] && pass[j] >= 0 && pass[j] < p && P_len[j] > 0) {
          const int64_t base = (int64_t)j * cap;
          for (int32_t s = 0; s < P_len[j]; ++s) {
            const int64_t hs = hm.slot(P_cols[base + s], &fresh);
            if (fresh) { hm.vals[hs] = 0.0; touched.push_back(hs); }
            hm.vals[hs] += a_ij * P_vals[base + s];
          }
        } else {
          denom += a_ij;    // weak / unusable: lump
        }
      }
      cols.clear();
      vals.clear();
      if (denom != 0.0) {
        const double inv = -1.0 / denom;
        for (const int64_t hs : touched) {
          const double w = inv * hm.vals[hs];
          if (w != 0.0) {
            cols.push_back(hm.keys[hs]);
            vals.push_back(w);
          }
          hm.keys[hs] = -1;
        }
      } else {
        for (const int64_t hs : touched) hm.keys[hs] = -1;
      }
      mp_truncate_row(cols, vals, cap, P_cols + (int64_t)i * cap,
                      P_vals + (int64_t)i * cap, P_len + i, order);
    }
  }
}

// Ready-row classification for one multipass round: rows[i] is ready at
// pass p iff it has a strong off-diagonal neighbour assigned in an
// earlier pass.
void multipass_ready(int64_t n_rows, const int32_t* rows,
                     const int64_t* indptr, const int32_t* indices,
                     const uint8_t* strong, int32_t p, const int32_t* pass,
                     uint8_t* ready) {
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t idx = 0; idx < n_rows; ++idx) {
    const int32_t i = rows[idx];
    bool r = false;
    for (int64_t k = indptr[i]; k < indptr[i + 1] && !r; ++k)
      r = strong[k] && indices[k] != i && pass[indices[k]] >= 0 &&
          pass[indices[k]] < p;
    ready[idx] = r;
  }
}

// One multipass round for an explicit row list (blocked per-host setup:
// the driver exchanges boundary P rows + pass numbers between rounds).
void multipass_step(int32_t p, const int64_t* indptr, const int32_t* indices,
                    const double* data, const uint8_t* strong,
                    const int8_t* cf, const int32_t* cmap, int64_t cap,
                    const int32_t* pass, const int32_t* rows, int64_t n_rows,
                    int32_t* P_cols, double* P_vals, int32_t* P_len) {
  if (p == 1)
    mp_pass1_compute(indptr, indices, data, strong, cf, cmap, cap, rows,
                     n_rows, P_cols, P_vals, P_len);
  else
    mp_passk_compute(indptr, indices, data, strong, cap, p, pass, rows,
                     n_rows, P_cols, P_vals, P_len);
}

int64_t multipass_interp(int64_t n, const int64_t* indptr,
                         const int32_t* indices, const double* data,
                         const uint8_t* strong, const int8_t* cf,
                         const int32_t* cmap, int64_t n_c, int64_t cap,
                         int32_t* P_cols, double* P_vals, int32_t* P_len) {
  std::vector<int32_t> pass(n, -1);
  std::vector<int32_t> frontier, next, cur;
  frontier.reserve(n);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    P_len[i] = 0;
    if (cf[i] == 1) {
      pass[i] = 0;
      P_cols[i * cap] = cmap[i];
      P_vals[i * cap] = 1.0;
      P_len[i] = 1;
    }
  }
  for (int64_t i = 0; i < n; ++i)
    if (cf[i] != 1) frontier.push_back((int32_t)i);

  int32_t p = 1;
  std::vector<uint8_t> ready_flag(n, 0);
  while (!frontier.empty()) {
    const int64_t fn = (int64_t)frontier.size();
    cur.clear();
    next.clear();
    // classify this round (read-only wrt pass; flags in parallel)
    multipass_ready(fn, frontier.data(), indptr, indices, strong, p,
                    pass.data(), ready_flag.data());   // ready[idx] is
    for (int64_t idx = 0; idx < fn; ++idx) {           // list-positional
      const int32_t i = frontier[idx];
      (ready_flag[idx] ? cur : next).push_back(i);
    }
    if (cur.empty()) break;    // isolated remainder: empty rows
    const int64_t cn = (int64_t)cur.size();
    if (p == 1)
      mp_pass1_compute(indptr, indices, data, strong, cf, cmap, cap,
                       cur.data(), cn, P_cols, P_vals, P_len);
    else
      mp_passk_compute(indptr, indices, data, strong, cap, p, pass.data(),
                       cur.data(), cn, P_cols, P_vals, P_len);
    // commit pass numbers AFTER the rows are built (rows of pass p must
    // not read other pass-p rows)
    for (int64_t idx = 0; idx < cn; ++idx) pass[cur[idx]] = p;
    frontier.swap(next);
    ++p;
  }
  int64_t nnz = 0;
  for (int64_t i = 0; i < n; ++i) nnz += P_len[i];
  return nnz;
}

// Slot-layout (n, cap) + lengths -> CSR arrays, row-parallel (the numpy
// boolean-mask compaction writes ~6 GB of fresh temporaries at 100M).
void slot_compact(int64_t n, int64_t cap, const int32_t* P_cols,
                  const double* P_vals, const int32_t* P_len,
                  const int64_t* indptr, int32_t* out_idx,
                  double* out_val) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t base = i * cap;
    int64_t o = indptr[i];
    for (int32_t s = 0; s < P_len[i]; ++s) {
      out_idx[o] = P_cols[base + s];
      out_val[o] = P_vals[base + s];
      ++o;
    }
  }
}

// One damped-Jacobi pass over a slot-layout interpolation, against the
// strength-filtered operator, truncating back to cap:
//   P'_i = (1-omega) P_i - (omega / D_i) sum_{j strong} a_ij P_j,
//   D_i  = a_ii + sum_{k weak offdiag} a_ik.
// Row-local flat merges (rows are <= ~deg*cap entries) — the generic
// hash SpGEMM paid 10 s at 192^3 in per-row setup for these tiny rows;
// this fused form runs in the multipass kernel's own layout with no CSR
// materialisation.  Reads P_cols/P_vals/P_len, writes Q_*.  Returns nnz.
int64_t interp_jacobi_smooth(int64_t n, const int64_t* indptr,
                             const int32_t* indices, const double* data,
                             const uint8_t* strong, double omega,
                             int64_t n_c, int64_t cap,
                             const int32_t* P_cols, const double* P_vals,
                             const int32_t* P_len, int32_t* Q_cols,
                             double* Q_vals, int32_t* Q_len) {
  (void)n_c;
  int64_t max_deg = 1;
#pragma omp parallel for schedule(static) reduction(max : max_deg)
  for (int64_t i = 0; i < n; ++i)
    max_deg = std::max(max_deg, indptr[i + 1] - indptr[i]);
  const int64_t hcap = pow2_at_least(2 * (max_deg + 1) * cap);
#pragma omp parallel
  {
    LocalHashMap hm;
    hm.init(hcap, true);
    std::vector<int64_t> touched;
    std::vector<int32_t> cols;
    std::vector<double> vals;
    std::vector<int64_t> order;
#pragma omp for schedule(dynamic, 512)
    for (int64_t i = 0; i < n; ++i) {
      touched.clear();
      double D = 0.0;
      bool fresh;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        const int32_t j = indices[k];
        const double v = data[k];
        if (j == (int32_t)i) { D += v; continue; }
        if (strong[k]) {
          const int64_t base = (int64_t)j * cap;
          for (int32_t s = 0; s < P_len[j]; ++s) {
            const int64_t hs = hm.slot(P_cols[base + s], &fresh);
            if (fresh) { hm.vals[hs] = 0.0; touched.push_back(hs); }
            hm.vals[hs] += v * P_vals[base + s];
          }
        } else {
          D += v;   // weak off-diagonal lumps into the diagonal
        }
      }
      const double s0 = (D != 0.0) ? -omega / D : 0.0;
      // scale the strong-neighbour sum by -omega/D in place (a zero
      // filtered diagonal drops it — nothing sane to divide by)
      for (const int64_t hs : touched) hm.vals[hs] *= s0;
      // merge the (1-omega) own-row term
      {
        const int64_t base = (int64_t)i * cap;
        for (int32_t s = 0; s < P_len[i]; ++s) {
          const double w = (1.0 - omega) * P_vals[base + s];
          if (w == 0.0) continue;
          const int64_t hs = hm.slot(P_cols[base + s], &fresh);
          if (fresh) { hm.vals[hs] = 0.0; touched.push_back(hs); }
          hm.vals[hs] += w;
        }
      }
      cols.clear();
      vals.clear();
      for (const int64_t hs : touched) {
        const double w = hm.vals[hs];
        if (w != 0.0) { cols.push_back(hm.keys[hs]); vals.push_back(w); }
        hm.keys[hs] = -1;
      }
      mp_truncate_row(cols, vals, cap, Q_cols + (int64_t)i * cap,
                      Q_vals + (int64_t)i * cap, Q_len + i, order);
    }
  }
  int64_t nnz = 0;
  for (int64_t i = 0; i < n; ++i) nnz += Q_len[i];
  return nnz;
}

}  // extern "C"
