// Per-level forward and backward substitution with the block-sparse factor.
//
// Replaces the Pallas kernels `_fwd_sub_kernel` and `_bwd_sub_kernel` of
// theseus_tpu/sparse/pallas_factorize.py (pallas_call at :260, entries
// fwd_sub_level and bwd_sub_level). For every column j of one level and
// every batch element:
//   forward:  y_j = L_jj^{-1} (b_j - sum_u L_jk[u] y_k[u])
//   backward: x_j = L_jj^{-T} (y_j - sum_{r>=1} L_rj[r]^T x_r[r])
// Both kernels read their operands in place, through the level's int32
// record (common.cuh LevelRecord), and write their column's rows in place:
//   forward:  L_jk from the factor's slots jk_slots, y_k from y's rows upd_k,
//             L_jj from the slot diag, b_j from b's row cols -> y's row cols;
//   backward: L_rj from the factor's slots col_slots (row 0 the diagonal),
//             x_r from x's rows row_ids, y_j from y's row cols -> x's row cols.
// Only a column's nupd updates (forward) and nrow rows (backward) are read:
// a padded term is not read at all, so it reads as exact zero whatever y[0]
// or x[0] hold, and leaves the sums' bits as they were (+0 products add
// nothing). Within a level every column reads rows of earlier levels (the
// forward's updates, the backward's rows below the diagonal) and writes its
// own, so reads and writes never alias. The iterative refinement step
// reuses both kernels.
//
// Layout: AoS lflat (nnz_l + 1, B, d, d), b, y, x (n, B, d): a slot's or a
// row's batch tile is one contiguous run.
//
// What bounds it on the H100: memory and launch latency. The kernel reads
// ul (or rl) d x d blocks for 2 d^2 flops each: about half a flop per byte,
// and a sweep is one launch per etree level (13 at 256 poses), each short.
//
// Forward design. The first design gave one thread to each (column, batch)
// and walked the update list in series: on a deep level (C = 1, ul = 17) a
// thread paid ul dependent memory latencies, neighbouring lanes read blocks
// 144 bytes apart, and a wide level (C = 32, ul = 1) filled 16 SMs. Now a
// block owns (column c, a tile of bt batch elements) and:
//   1. copies the tile's nupd (ljk, yk) runs, its diagonal blocks and b into
//      shared memory by cp.async: for a fixed (c, u) the tile's blocks are
//      contiguous, so neighbouring lanes copy neighbouring elements, and
//      every load of the level is in flight at once (one memory round trip);
//   2. gives gu lanes (a power of two, up to 32) to each output (batch
//      element, row i); lane g sums L[u][i][:] y[u] over u = g, g + gu, ...
//      in order, j inner, and the gu partials are added by __shfl_down_sync
//      in a fixed tree (no atomics: two launches give the same bits);
//   3. one thread per batch element solves L_jj y = b - sum with today's
//      statements.
// The host picks (bt, gu, u chunk) per launch (sparse/level_kernels.py
// fwd_subst_geometry); a level longer than the chunk stages it in chunks of
// a multiple of gu, which keeps each lane's order.
//
// Backward design. The first design gave one thread to each (column, batch)
// and walked the column's rows in series: on the grid's deep levels (C = 2
// to 5, rl up to 15) a thread paid rl - 1 dependent memory round trips and
// the launch filled 2 to 5 SMs, with lanes reading blocks 144 bytes apart.
// Now a block owns (column c, a tile of bt batch elements) and:
//   1. copies the tile's rows 1 .. nrow - 1 of lcol and xr, its diagonal
//      blocks and y into shared memory by cp.async (16 bytes a copy where
//      both ends are aligned): for a fixed (c, r) the tile's blocks are
//      contiguous, and every load of the column is in flight at once;
//   2. gives d lanes to each batch element, lane jj owning output jj, which
//      runs the first design's chain: s = y[jj], then s -= L_r[i][jj] x_r[i]
//      over r = 1, 2, ... in order, i inner (a real row whose x is 0 is
//      kept: s - L 0 can flip the sign of a zero), so the bits do not change
//      and the whole backward sweep (whole_subst.cu) still equals this one;
//   3. one thread per batch element solves L_jj^T x = y - sum with the first
//      design's statements, and the tile's x leaves through shared memory in
//      coalesced (16-byte where aligned) stores.
// The host picks (bt, row chunk) per launch (sparse/level_kernels.py
// bwd_subst_geometry); a column whose rows exceed the shared-memory budget
// is staged in chunks of rows in order, each lane's s kept in its register.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

template <typename T, int D>
__global__ void fwd_subst_kernel(const T* __restrict__ lflat, T* y, const T* __restrict__ bvec,
                                 const int* __restrict__ rec, int C, int rl, int ul, int B, int bt,
                                 int gu, int uc) {
  constexpr int DD = D * D;
  extern __shared__ __align__(16) unsigned char fs_smem[];
  const int nbt = (B + bt - 1) / bt;
  const int c = blockIdx.x / nbt;
  const int b0 = (blockIdx.x % nbt) * bt;
  const int tb = min(bt, B - b0);
  T* ls = reinterpret_cast<T*>(fs_smem);  // [uc][bt d^2]
  T* ys = ls + uc * bt * DD;              // [uc][bt d]
  T* lds = ys + uc * bt * D;              // [bt d^2] the diagonal blocks
  T* acc = lds + bt * DD;                 // [bt d] b, then b - sum
  const long long rowL = static_cast<long long>(B) * DD;
  const long long rowY = static_cast<long long>(B) * D;
  const LevelRecord lr(rec, C, rl, ul);
  const int nupd = lr.nupd[c];
  const int* jk = lr.jk_slots + static_cast<long long>(c) * ul;
  const int* uk = lr.upd_k + static_cast<long long>(c) * ul;
  const long long cb = static_cast<long long>(lr.cols[c]) * B + b0;  // (row, batch) of the output
  const T* ld_c = lflat + lr.diag[c] * rowL + static_cast<long long>(b0) * DD;

  for (int x = threadIdx.x; x < tb * DD; x += blockDim.x)
    __pipeline_memcpy_async(lds + x, ld_c + x, sizeof(T));
  for (int x = threadIdx.x; x < tb * D; x += blockDim.x)
    __pipeline_memcpy_async(acc + x, bvec + cb * D + x, sizeof(T));

  const int g = threadIdx.x % gu;
  const int o = threadIdx.x / gu;  // output: batch element bl of the tile, row i
  const int bl = o / D;
  const int i = o % D;
  const bool mine = bl < tb;
  T part = T(0);
  for (int u0 = 0; u0 < nupd; u0 += uc) {
    const int nu = min(uc, nupd - u0);
    for (int x = threadIdx.x; x < nu * tb * DD; x += blockDim.x) {
      const int uu = x / (tb * DD);
      const int r = x % (tb * DD);
      __pipeline_memcpy_async(ls + uu * bt * DD + r, lflat + jk[u0 + uu] * rowL + b0 * DD + r, sizeof(T));
    }
    for (int x = threadIdx.x; x < nu * tb * D; x += blockDim.x) {
      const int uu = x / (tb * D);
      const int r = x % (tb * D);
      __pipeline_memcpy_async(ys + uu * bt * D + r, y + uk[u0 + uu] * rowY + b0 * D + r, sizeof(T));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (mine) {
      for (int uu = g; uu < nu; uu += gu) {
        const T* l = ls + uu * bt * DD + bl * DD + i * D;
        const T* v = ys + uu * bt * D + bl * D;
#pragma unroll
        for (int j = 0; j < D; ++j) part += l[j] * v[j];
      }
    }
    __syncthreads();  // before the next chunk overwrites the buffers
  }
  if (nupd <= 0) {
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  // lane g += lane g + off, off = gu / 2, gu / 4, ..., 1
  for (int off = gu >> 1; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off, gu);
  if (mine && g == 0) acc[bl * D + i] -= part;
  __syncthreads();

  if (threadIdx.x < tb) {
    const T* ld = lds + threadIdx.x * DD;
    const T* a = acc + threadIdx.x * D;
    T out[D];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      T s = a[r];
#pragma unroll
      for (int k = 0; k < r; ++k) s -= ld[r * D + k] * out[k];
      out[r] = s / ld[r * D + r];
    }
    T* yo = y + (cb + threadIdx.x) * D;
#pragma unroll
    for (int r = 0; r < D; ++r) yo[r] = out[r];
  }
}

// values a shared-memory slot of n values takes: a multiple of 16 bytes, so
// every slot starts 16-byte aligned
template <typename T>
__host__ __device__ constexpr int bwd_slot(int n) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  return (n + V - 1) / V * V;
}

// bytes of shared memory a backward block takes: rc staged rows and the
// diagonal row, each a slot of bt d x d blocks and one of bt d-vectors
template <typename T, int D>
size_t bwd_smem_bytes(int bt, int rc) {
  return sizeof(T) * (static_cast<size_t>(rc) + 1) * (bwd_slot<T>(bt * D * D) + bwd_slot<T>(bt * D));
}

template <typename T>
__device__ __forceinline__ bool aligned16(const T* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

template <typename T, int D>
__global__ void bwd_subst_kernel(const T* __restrict__ lflat, T* x, const T* __restrict__ yvec,
                                 const int* __restrict__ rec, int C, int rl, int ul, int B, int bt,
                                 int rc) {
  constexpr int DD = D * D;
  extern __shared__ __align__(16) unsigned char bs_smem[];
  const int nbt = (B + bt - 1) / bt;
  const int c = blockIdx.x / nbt;
  const int b0 = (blockIdx.x % nbt) * bt;
  const int tb = min(bt, B - b0);
  const int sl = bwd_slot<T>(bt * DD);
  const int sx = bwd_slot<T>(bt * D);
  T* ls = reinterpret_cast<T*>(bs_smem);  // [rc][sl] a chunk of the column's rows
  T* xs = ls + rc * sl;                   // [rc][sx] their x rows
  T* l0s = xs + rc * sx;                  // [sl] the diagonal blocks
  T* vs = l0s + sl;                       // [sx] y, then y - sum, then x
  const long long rowL = static_cast<long long>(B) * DD;
  const long long rowX = static_cast<long long>(B) * D;
  const LevelRecord lr(rec, C, rl, ul);
  const int* cs = lr.col_slots + static_cast<long long>(c) * rl;
  const int* rid = lr.row_ids + static_cast<long long>(c) * rl;
  const long long cb = static_cast<long long>(lr.cols[c]) * B + b0;  // (row, batch) of the output
  const long long lb = static_cast<long long>(b0) * DD;
  const long long xb = static_cast<long long>(b0) * D;

  const T* l0 = lflat + cs[0] * rowL + lb;
  th_stage_tile(l0s, l0, tb * DD, aligned16(l0));
  th_stage_tile(vs, yvec + cb * D, tb * D, aligned16(yvec + cb * D));

  const int bl = threadIdx.x / D;  // lane threadIdx.x owns output jj of batch element bl
  const int jj = threadIdx.x - bl * D;
  const bool mine = bl < tb;
  const int rows = lr.nrow[c] - 1;
  const int chunks = rows > 0 ? (rows + rc - 1) / rc : 1;
  T s = T(0);
  for (int k = 0; k < chunks; ++k) {
    const int r0 = 1 + k * rc;
    const int nr = min(rc, rows - k * rc);
    for (int rr = 0; rr < nr; ++rr) {
      const T* lsrc = lflat + cs[r0 + rr] * rowL + lb;
      const T* xsrc = x + rid[r0 + rr] * rowX + xb;
      th_stage_tile(ls + rr * sl, lsrc, tb * DD, aligned16(lsrc));
      th_stage_tile(xs + rr * sx, xsrc, tb * D, aligned16(xsrc));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (mine) {
      if (k == 0) s = vs[threadIdx.x];
      for (int rr = 0; rr < nr; ++rr) {
        const T* l = ls + rr * sl + bl * DD + jj;
        const T* v = xs + rr * sx + bl * D;
#pragma unroll
        for (int i = 0; i < D; ++i) s -= l[i * D] * v[i];
      }
    }
    __syncthreads();  // before the next chunk overwrites the buffers
  }
  if (mine) vs[threadIdx.x] = s;
  __syncthreads();

  if (threadIdx.x < tb) {
    const T* l0 = l0s + threadIdx.x * DD;
    T* a = vs + threadIdx.x * D;
    T out[D];
#pragma unroll
    for (int j = D - 1; j >= 0; --j) {
      T t = a[j];
#pragma unroll
      for (int k = j + 1; k < D; ++k) t -= l0[k * D + j] * out[k];
      out[j] = t / l0[j * D + j];
    }
#pragma unroll
    for (int j = 0; j < D; ++j) a[j] = out[j];
  }
  __syncthreads();
  T* xo = x + cb * D;
  th_store_tile<T, D, D>(vs, xo, tb, aligned16(xo));
}

#define TH_SUB_SWITCH(CALL)                         \
  switch (d) {                                      \
    case 1: return CALL(1);                         \
    case 2: return CALL(2);                         \
    case 3: return CALL(3);                         \
    case 4: return CALL(4);                         \
    case 5: return CALL(5);                         \
    case 6: return CALL(6);                         \
    case 7: return CALL(7);                         \
    case 8: return CALL(8);                         \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <typename T, int D>
int fwd_d(const void* lflat, void* y, const void* b, const int* rec, int C, int rl, int ul, int B,
          int bt, int gu, int uc, cudaStream_t st) {
  if (C <= 0 || B <= 0) return 0;
  const int threads = (bt * D * gu + 31) / 32 * 32;
  if (bt < 1 || gu < 1 || gu > 32 || (gu & (gu - 1)) || uc < 1 || (uc < ul && uc % gu) ||
      threads > 1024)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = sizeof(T) * (static_cast<size_t>(uc) + 1) * bt * (D * D + D);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = static_cast<long long>(C) * ((B + bt - 1) / bt);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  fwd_subst_kernel<T, D><<<static_cast<unsigned>(blocks), threads, smem, st>>>(
      static_cast<const T*>(lflat), static_cast<T*>(y), static_cast<const T*>(b), rec, C, rl, ul, B,
      bt, gu, uc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_d(const void* lflat, void* x, const void* y, const int* rec, int C, int rl, int ul, int B,
          int bt, int rc, cudaStream_t st) {
  if (C <= 0 || B <= 0) return 0;
  const int threads = bt * D;
  if (rl < 1 || bt < 1 || rc < 1 || threads > 1024 || bwd_smem_bytes<T, D>(bt, rc) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = static_cast<long long>(C) * ((B + bt - 1) / bt);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  bwd_subst_kernel<T, D><<<static_cast<unsigned>(blocks), threads, bwd_smem_bytes<T, D>(bt, rc), st>>>(
      static_cast<const T*>(lflat), static_cast<T*>(x), static_cast<const T*>(y), rec, C, rl, ul, B,
      bt, rc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd(const void* lflat, void* y, const void* b, const void* rec, int C, int rl, int ul, int B,
        int d, int bt, int gu, int uc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rec);
#define TH_FWD(DD) fwd_d<T, DD>(lflat, y, b, r, C, rl, ul, B, bt, gu, uc, st)
  TH_SUB_SWITCH(TH_FWD)
#undef TH_FWD
}

template <typename T>
int bwd(const void* lflat, void* x, const void* y, const void* rec, int C, int rl, int ul, int B,
        int d, int bt, int rc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rec);
#define TH_BWD(DD) bwd_d<T, DD>(lflat, x, y, r, C, rl, ul, B, bt, rc, st)
  TH_SUB_SWITCH(TH_BWD)
#undef TH_BWD
}

}  // namespace

// lflat (nnz_l + 1, B, d, d); y (n, B, d), the level's rows written in
// place; b (n, B, d); rec: the level's record, C columns padded to rl rows
// and ul updates
TH_EXPORT int th_level_fwd_subst_f32(const void* lflat, void* y, const void* b, const void* rec,
                                     int C, int rl, int ul, int B, int d, int bt, int gu, int uc,
                                     void* stream) {
  return fwd<float>(lflat, y, b, rec, C, rl, ul, B, d, bt, gu, uc, stream);
}

TH_EXPORT int th_level_fwd_subst_f64(const void* lflat, void* y, const void* b, const void* rec,
                                     int C, int rl, int ul, int B, int d, int bt, int gu, int uc,
                                     void* stream) {
  return fwd<double>(lflat, y, b, rec, C, rl, ul, B, d, bt, gu, uc, stream);
}

// lflat (nnz_l + 1, B, d, d); x (n, B, d), the level's rows written in
// place; y (n, B, d)
TH_EXPORT int th_level_bwd_subst_f32(const void* lflat, void* x, const void* y, const void* rec,
                                     int C, int rl, int ul, int B, int d, int bt, int rc,
                                     void* stream) {
  return bwd<float>(lflat, x, y, rec, C, rl, ul, B, d, bt, rc, stream);
}

TH_EXPORT int th_level_bwd_subst_f64(const void* lflat, void* x, const void* y, const void* rec,
                                     int C, int rl, int ul, int B, int d, int bt, int rc,
                                     void* stream) {
  return bwd<double>(lflat, x, y, rec, C, rl, ul, B, d, bt, rc, stream);
}
