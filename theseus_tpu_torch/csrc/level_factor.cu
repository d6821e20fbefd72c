// Per-level elimination of the level-scheduled block-sparse Cholesky.
//
// Replaces the Pallas kernel `_level_kernel` of
// theseus_tpu/sparse/pallas_factorize.py (pallas_call at :118, entry
// level_eliminate_soa). For every column c of one elimination-tree level
// and every batch element b:
//   upd[r]   = sum_u ks[u, r] kj[u]^T                    (left-looking update)
//   C_r      = A_r - upd[r]
//   L        = chol(0.5 (C_0 + C_0^T))                   (POTRF, d x d)
//   out[0]   = L
//   out[r>0] = C_r L^{-T}                                (TRSM)
// The symmetrised diagonal read matches cholesky._factorize_levels
// (cholesky.py:611). A non-positive pivot gives sqrt of a negative number,
// i.e. NaN, which is NOT clamped: LM detects a failed solve through
// non-finite deltas (optim/normal.py:76-77).
//
// The kernel reads its operands in place, through the level's int32 record
// (common.cuh LevelRecord): A_r from AtA's slot a_src (transposed where the
// slot is negative), ks[u, r] and kj[u] from the factor's slots upd_slots and
// jk_slots, and writes each valid row's block straight into the factor at
// col_slots. Only a column's nupd updates and nrow rows are read and
// formed: a padded update would add 0 * 0 (a no-op on a sum that starts at
// +0), and a padded row is not written, so slot 0 stays the zero block.
// Within a level every column reads slots of earlier levels and writes its
// own, so reads and writes never alias.
//
// What bounds it on the H100: memory in principle (at PGO 256 x 128 float32
// a sweep reads and writes 67 MB: 0.020 ms), latency in practice. A level
// has few columns (C = 32 down to 1 at 256 poses) and each column's work is
// a chain (ul x d FMAs per entry, then the POTRF, then the TRSM), so the
// work is spread over the entries of a column, not over columns alone.
//
// Design: one block per (column c, batch tile), and the level's work split
// across the block in whole_factor.cu's three phases:
//   1. the update: C_r[i][j] = A_r[i][j] - s, s summed over u (outer) and k
//      (inner) from zero, the order of whole_factor.cu's phase 1, so the
//      factor stays bit-identical to the whole-sweep kernel's (no fast-math:
//      s += a*b contracts to the same FMA in both). A thread forms one entry
//      (r, b, i, j) on levels with few entries, where the chain over u is
//      long (the deep levels), or a whole block row (r, b, i) on levels with
//      more entries than one wave of threads holds (the wide levels, where a
//      thread per entry would need several waves of the whole chain). The
//      (u, r, batch-tile) blocks of ks and kj are staged in shared memory by
//      cp.async (16-byte copies where aligned), double-buffered over chunks
//      of u, so each byte is read from device memory once, coalesced, and
//      A's loads are issued with them, so the level pays one memory round
//      trip before its update; C_r goes to shared memory;
//   2. one thread per batch element runs the POTRF (whole_factor.cu's
//      statements: inv = 1/ljj, a product by inv);
//   3. one thread per block row (r >= 1, b, i) runs its TRSM, a division by
//      l[j][j];
// then the rows are written out, entries fastest, batch next. Rows beyond
// what one block's threads hold are done in further passes of the same
// block (the diagonal once). The launcher picks the geometry per launch from
// (C, rl, ul, B): the mapping, the batch tile (8, halved while a tile's
// rows exceed ~256 threads or the grid has fewer than 264 blocks, two per
// SM), the rows per pass and the u chunk (up to min(ul, 16), shared memory
// within 48 KB). No tensor cores: the d x d blocks are far below a wgmma
// tile, and TF32 would break the float32 tolerance and the bit equality.
//
// Layout: AoS ata (n_slots, B, d, d), lflat (nnz_l + 1, B, d, d): a slot's
// batch tile is one contiguous run, which the staging copies.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int LF_TILE_MAX = 8;
constexpr int LF_THREADS_MAX = 1024;
// about 256 threads a block, so that several blocks share an SM and one
// block's barriers and POTRF overlap the others' update phase
constexpr int LF_THREADS_TARGET = 256;
constexpr int LF_MIN_BLOCKS = 264;  // two per SM of the H100's 132
// a level with more entries than this (about one wave of threads on 132
// SMs) forms a block row per thread, else an entry per thread
constexpr long long LF_ROW_ENTRIES = 131072;
constexpr int LF_U_CHUNK_MAX = 16;
constexpr size_t LF_SMEM_MAX = 48 * 1024;

struct Geometry {
  int tile, rc, uc, threads;
  size_t smem;
};

// shared memory: L (tile) + C rows (rc x tile) + 2 stages x uc x (rc + 1) x tile blocks
template <typename T, int D>
size_t smem_bytes(int tile, int rc, int uc) {
  const size_t blk = static_cast<size_t>(tile) * D * D;
  return sizeof(T) * (blk + rc * blk + 2 * static_cast<size_t>(uc) * (rc + 1) * blk);
}

// ROWS: one thread per block row (r, b, i); else one per entry (r, b, i, j)
template <typename T, int D, bool ROWS>
__global__ void level_factor_kernel(const T* __restrict__ ata, T* lflat, const int* __restrict__ rec,
                                    int C, int rl, int ul, int B, int tile, int rc, int uc, bool vec) {
  constexpr int DD = D * D;
  // 16-byte copies: a slot's run of tb d x d blocks starts 16-byte aligned
  // when d^2 elements are a multiple of 16 bytes and the factor is aligned
  constexpr int V = (DD * sizeof(T)) % 16 == 0 ? 16 / static_cast<int>(sizeof(T)) : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nbt = (B + tile - 1) / tile;
  const int c = blockIdx.x / nbt;
  const int b0 = (blockIdx.x % nbt) * tile;
  const int tb = min(tile, B - b0);
  const int blk = tile * DD;         // one (r or u) row of the tile in shared memory
  const int per_u = (rc + 1) * blk;  // rc ks rows + the kj row
  T* lbuf = reinterpret_cast<T*>(smem_raw);
  T* cbuf = lbuf + blk;
  T* stage = cbuf + rc * blk;
  const int stage_sz = uc * per_u;

  const LevelRecord lr(rec, C, rl, ul);
  const int nrow = lr.nrow[c];
  const int nupd = lr.nupd[c];
  const int* a_src = lr.a_src + static_cast<long long>(c) * rl;
  const int* col_slots = lr.col_slots + static_cast<long long>(c) * rl;
  const int* jk = lr.jk_slots + static_cast<long long>(c) * ul;
  const int* upd = lr.upd_slots + static_cast<long long>(c) * ul * rl;
  const long long rowB = static_cast<long long>(B) * DD;  // stride of a slot
  const long long boff = static_cast<long long>(b0) * DD;

  // phase 1: entries j0 .. j0 + J - 1 of block row (rr, bt, i), i fastest
  constexpr int J = ROWS ? D : 1;
  const int j0 = ROWS ? 0 : static_cast<int>(threadIdx.x % D);
  const int t1 = ROWS ? threadIdx.x : threadIdx.x / D;
  const int i = t1 % D;
  const int bt = (t1 / D) % tile;
  const int rr = t1 / (D * tile);
  // phase 3: block row (r3, bt3, a3)
  const int a3 = threadIdx.x % D;
  const int bt3 = (threadIdx.x / D) % tile;
  const int r3 = threadIdx.x / (D * tile);
  const int nq = (nupd + uc - 1) / uc;

  for (int r0 = 0; r0 < nrow; r0 += rc) {
    const int nr = min(rc, nrow - r0);
    const int run = tb * DD;  // contiguous elements of one slot's tile
    // cp.async of u chunk q into stage buffer q & 1: nr ks rows and the kj
    // row per u, w elements (16 bytes when aligned, else one) per copy
    const int w = vec ? V : 1;
    auto issue = [&](int q) {
      const int u0 = q * uc;
      const int nu = min(uc, nupd - u0);
      T* dst = stage + (q & 1) * stage_sz;
      const int runw = run / w;
      const int n = nu * (nr + 1) * runw;
      for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
        const int uu = idx / ((nr + 1) * runw);
        const int rem = idx % ((nr + 1) * runw);
        const int row = rem / runw;
        const int x = (rem % runw) * w;
        const int slot = row < nr ? upd[(u0 + uu) * rl + r0 + row] : jk[u0 + uu];
        const T* src = lflat + slot * rowB + boff + x;
        T* to = dst + uu * per_u + (row < nr ? row : rc) * blk + x;
        if (w == V && V > 1)
          __pipeline_memcpy_async(to, src, 16);
        else
          __pipeline_memcpy_async(to, src, sizeof(T));
      }
      __pipeline_commit();
    };

    // ---- phase 1: C = A - sum_u ks_u kj_u^T ------------------------------
    const bool mine = rr < nr && bt < tb;
    const int e0 = bt * DD + i * D + j0;
    T s[J], av[J];
#pragma unroll
    for (int j = 0; j < J; ++j) s[j] = T(0);
    if (nq > 0) issue(0);
    // A's loads go out with the staging copies, not after them
    if (mine) {
      const int sa = a_src[r0 + rr];
      const T* ap = ata + (sa < 0 ? -sa : sa) * rowB + boff + bt * DD;
#pragma unroll
      for (int j = 0; j < J; ++j) av[j] = sa < 0 ? ap[(j0 + j) * D + i] : ap[i * D + j0 + j];
    }
    for (int q = 0; q < nq; ++q) {
      if (q + 1 < nq) {
        issue(q + 1);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      if (mine) {
        const T* buf = stage + (q & 1) * stage_sz;
        const int nu = min(uc, nupd - q * uc);
        for (int uu = 0; uu < nu; ++uu) {
          const T* kr = buf + uu * per_u + rr * blk + bt * DD + i * D;
          const T* kjb = buf + uu * per_u + rc * blk + bt * DD + j0 * D;
          T kv[D];
#pragma unroll
          for (int k = 0; k < D; ++k) kv[k] = kr[k];
#pragma unroll
          for (int j = 0; j < J; ++j)
#pragma unroll
            for (int k = 0; k < D; ++k) s[j] += kv[k] * kjb[j * D + k];
        }
      }
      __syncthreads();  // before the next issue overwrites this buffer
    }
    if (mine) {
#pragma unroll
      for (int j = 0; j < J; ++j) cbuf[rr * blk + e0 + j] = av[j] - s[j];
    }
    __syncthreads();

    // ---- phase 2: POTRF of the symmetrised diagonal block ------------------
    if (r0 == 0) {
      if (threadIdx.x < tb) {
        T* blkp = cbuf + threadIdx.x * DD;
        T cm[D][D];
#pragma unroll
        for (int a = 0; a < D; ++a)
#pragma unroll
          for (int k = 0; k < D; ++k) cm[a][k] = blkp[a * D + k];
        T l[D][D];
#pragma unroll
        for (int jj = 0; jj < D; ++jj) {
          T sd = cm[jj][jj];
#pragma unroll
          for (int k = 0; k < jj; ++k) sd -= l[jj][k] * l[jj][k];
          const T ljj = sqrt(sd);
          l[jj][jj] = ljj;
          const T inv = T(1) / ljj;
#pragma unroll
          for (int a = jj + 1; a < D; ++a) {
            T t = T(0.5) * (cm[a][jj] + cm[jj][a]);
#pragma unroll
            for (int k = 0; k < jj; ++k) t -= l[a][k] * l[jj][k];
            l[a][jj] = t * inv;
          }
        }
        T* lp = lbuf + threadIdx.x * DD;
#pragma unroll
        for (int a = 0; a < D; ++a)
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const T v = k <= a ? l[a][k] : T(0);
            lp[a * D + k] = v;
            blkp[a * D + k] = v;
          }
      }
      __syncthreads();
    }

    // ---- phase 3: TRSM, X_r = C_r L^{-T}, one block row per thread -------
    if (r3 < nr && bt3 < tb && r0 + r3 >= 1) {
      T* row = cbuf + r3 * blk + bt3 * DD + a3 * D;
      const T* ldp = lbuf + bt3 * DD;
      T ld[D][D];
#pragma unroll
      for (int jj = 0; jj < D; ++jj)
#pragma unroll
        for (int k = 0; k <= jj; ++k) ld[jj][k] = ldp[jj * D + k];
      T x[D];
#pragma unroll
      for (int jj = 0; jj < D; ++jj) {
        T sx = row[jj];
#pragma unroll
        for (int k = 0; k < jj; ++k) sx -= x[k] * ld[jj][k];
        x[jj] = sx / ld[jj][jj];
      }
#pragma unroll
      for (int jj = 0; jj < D; ++jj) row[jj] = x[jj];
    }
    __syncthreads();

    // ---- write-out into the factor's slots: entries fastest, batch next --
    for (int t = threadIdx.x; t < nr * tb * DD; t += blockDim.x) {
      const int rw = t / (tb * DD);
      const int x = t % (tb * DD);
      lflat[col_slots[r0 + rw] * rowB + boff + x] = cbuf[rw * blk + x];
    }
    __syncthreads();  // before the next pass reuses cbuf
  }
}

// The most threads a block of this instantiation can have: its registers
// decide.
template <typename T, int D, bool ROWS>
int thread_cap() {
  static const int cap = [] {
    cudaFuncAttributes a;
    if (cudaFuncGetAttributes(&a, level_factor_kernel<T, D, ROWS>) != cudaSuccess) return 0;
    const int n = a.maxThreadsPerBlock < LF_THREADS_MAX ? a.maxThreadsPerBlock : LF_THREADS_MAX;
    return n / 32 * 32;
  }();
  return cap;
}

// unit: threads per (r, b) in phase 1 (d for block rows, d^2 for entries);
// phase 3 needs d and phase 2 one, which unit covers
template <typename T, int D>
Geometry pick(int C, int rl, int ul, int B, int cap, int unit) {
  Geometry g;
  const int target = cap < LF_THREADS_TARGET ? cap : LF_THREADS_TARGET;
  g.tile = LF_TILE_MAX;
  while (g.tile > 1 && (g.tile * unit * rl > target ||
                        static_cast<long long>(C) * ((B + g.tile - 1) / g.tile) < LF_MIN_BLOCKS))
    g.tile >>= 1;
  if (g.tile > B) g.tile = B;
  g.rc = rl < target / (g.tile * unit) ? rl : target / (g.tile * unit);
  if (g.rc < 1) g.rc = 1;
  // no more u per chunk than the level has: shared memory limits the
  // blocks on an SM
  g.uc = ul < LF_U_CHUNK_MAX ? (ul > 0 ? ul : 1) : LF_U_CHUNK_MAX;
  while (g.uc > 1 && smem_bytes<T, D>(g.tile, g.rc, g.uc) > LF_SMEM_MAX) --g.uc;
  while (g.rc > 1 && smem_bytes<T, D>(g.tile, g.rc, g.uc) > LF_SMEM_MAX) --g.rc;
  g.threads = (g.rc * g.tile * unit + 31) / 32 * 32;
  g.smem = smem_bytes<T, D>(g.tile, g.rc, g.uc);
  return g;
}

template <typename T, int D, bool ROWS>
int launch_m(const void* ata, void* lflat, const int* rec, int C, int rl, int ul, int B,
             cudaStream_t stream) {
  const bool vec = reinterpret_cast<size_t>(lflat) % 16 == 0;
  const int cap = thread_cap<T, D, ROWS>();
  const int unit = ROWS ? D : D * D;
  if (cap < unit) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Geometry g = pick<T, D>(C, rl, ul, B, cap, unit);
  const long long blocks = static_cast<long long>(C) * ((B + g.tile - 1) / g.tile);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  level_factor_kernel<T, D, ROWS><<<static_cast<unsigned>(blocks), g.threads, g.smem, stream>>>(
      static_cast<const T*>(ata), static_cast<T*>(lflat), rec, C, rl, ul, B, g.tile, g.rc, g.uc, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_d(const void* ata, void* lflat, const int* rec, int C, int rl, int ul, int B,
             cudaStream_t stream) {
  if (C <= 0 || rl <= 0 || B <= 0) return 0;
  if (static_cast<long long>(C) * rl * B * D * D > LF_ROW_ENTRIES)
    return launch_m<T, D, true>(ata, lflat, rec, C, rl, ul, B, stream);
  return launch_m<T, D, false>(ata, lflat, rec, C, rl, ul, B, stream);
}

template <typename T>
int launch(const void* ata, void* lflat, const void* rec, int C, int rl, int ul, int B, int d,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rec);
#define TH_LF_CASE(DD) \
  case DD:             \
    return launch_d<T, DD>(ata, lflat, r, C, rl, ul, B, st);
  switch (d) {
    TH_LF_CASE(1)
    TH_LF_CASE(2)
    TH_LF_CASE(3)
    TH_LF_CASE(4)
    TH_LF_CASE(5)
    TH_LF_CASE(6)
    TH_LF_CASE(7)
    TH_LF_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TH_LF_CASE
}

}  // namespace

// ata (n_slots, B, d, d); lflat (nnz_l + 1, B, d, d), the level's valid
// rows written in place; rec: the level's record, C columns padded to rl
// rows and ul updates
TH_EXPORT int th_level_factor_f32(const void* ata, void* lflat, const void* rec, int C, int rl,
                                  int ul, int B, int d, void* stream) {
  return launch<float>(ata, lflat, rec, C, rl, ul, B, d, stream);
}

TH_EXPORT int th_level_factor_f64(const void* ata, void* lflat, const void* rec, int C, int rl,
                                  int ul, int B, int d, void* stream) {
  return launch<double>(ata, lflat, rec, C, rl, ul, B, d, stream);
}
