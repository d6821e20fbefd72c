// Whole left-looking block Cholesky in one launch.
//
// Replaces the Pallas kernel `_fact_kernel` of
// theseus_tpu/sparse/pallas_whole.py (pallas_call at :319, entry
// factorize_whole). For every head column j and batch element b:
//   C_t    = A[a_src[j, t]] (transposed where a_tr) - sum_u L[upd_slots[j,u,t]] L[upd_jk[j,u]]^T
//   L_jj   = chol(0.5 (C_0 + C_0^T))                      (POTRF, d x d)
//   L_tj   = C_t L_jj^{-T}, t = 1 .. col_len[j]-1          (TRSM)
// written to the factor slots col_slots[j, t]; slot 0 of the factor is the
// zero sentinel that absent update rows read. A non-positive pivot gives
// sqrt of a negative number, i.e. NaN, which is not clamped (no fast
// reciprocal either): LM detects a failed solve through non-finite deltas,
// as on the level path.
//
// Design. On the TPU the grid (n_cols,) runs in order, and that order is
// the left-looking dependency. Blocks on Hopper run in no order, so columns
// are not mapped to blocks: batch elements are independent, and each block
// owns one batch element and walks the elimination-tree levels inside the
// kernel. The columns of one level depend only on earlier levels, so the
// block's threads share a level's work in three phases:
//   1. one thread per (column, row t, entry (a, b)) forms C_t[a][b], the
//      update list in its fixed order (no atomics: the same bits every run),
//      and stores it in the column's own factor slot;
//   2. one thread per column runs the POTRF on the stored diagonal block;
//   3. one thread per (column, row t >= 1, entry row a) runs the TRSM row.
// A __syncthreads() separates the phases and the levels: the barrier makes
// the block's own global writes visible to its threads, so level l+1 reads
// what level l wrote. 3 barriers per level (13 levels at 256 poses), not
// one per column. The factor is neither __restrict__ nor read through the
// non-coherent cache, since the kernel reads what it writes.
//
// Layout: AoS ata (n_slots, B, d, d), lflat (nnz_l+1, B, d, d); the tables
// are int32 (sparse/whole.py WholeTables).
//
// What bounds it on the H100: memory. At PGO 256 poses x batch 128 in
// float32 it must read AtA (9.47 MB) and write L (14.1 MB): 7.0 us at
// 3.35 TB/s; the updates are ~84 MFLOP, 1.3 us at 67 TFLOP/s. In practice
// it is latency-bound: 39 barriers, each phase a chain of dependent loads
// from L1/L2.

#include "common.cuh"

namespace {

constexpr int WF_THREADS = 256;

template <typename T, int D>
__global__ void whole_factor_kernel(const T* __restrict__ ata, const int* __restrict__ a_src,
                                    const int* __restrict__ a_tr, const int* __restrict__ col_slots,
                                    const int* __restrict__ col_len, const int* __restrict__ ucount,
                                    const int* __restrict__ upd_jk, const int* __restrict__ upd_slots,
                                    const int* __restrict__ order, const int* __restrict__ lvl_ptr,
                                    int n_levels, int rmax, int umax, int B, T* lflat) {
  constexpr int DD = D * D;
  const int b = blockIdx.x;
  const long long bstride = static_cast<long long>(B) * DD;  // slot stride
  const T* ab = ata + static_cast<long long>(b) * DD;
  T* lb = lflat + static_cast<long long>(b) * DD;

  // slot 0: the zero sentinel
  for (int e = threadIdx.x; e < DD; e += blockDim.x) lb[e] = T(0);
  __syncthreads();

  for (int lv = 0; lv < n_levels; ++lv) {
    const int c0 = lvl_ptr[lv];
    const int nc = lvl_ptr[lv + 1] - c0;

    // ---- phase 1: C = A - sum_u K_u KJ_u^T, one entry per thread --------
    const int per_col = rmax * DD;
    for (int idx = threadIdx.x; idx < nc * per_col; idx += blockDim.x) {
      const int j = order[c0 + idx / per_col];
      const int rem = idx % per_col;
      const int t = rem / DD;
      if (t >= col_len[j]) continue;
      const int e = rem % DD;
      const int a = e / D;
      const int bb = e % D;
      const int src = a_src[j * rmax + t];
      const int ae = a_tr[j * rmax + t] ? bb * D + a : e;
      T s = T(0);
      const int nu = ucount[j];
      for (int u = 0; u < nu; ++u) {
        const T* kr = lb + upd_slots[(j * umax + u) * rmax + t] * bstride + a * D;
        const T* kj = lb + upd_jk[j * umax + u] * bstride + bb * D;
#pragma unroll
        for (int k = 0; k < D; ++k) s += kr[k] * kj[k];
      }
      lb[col_slots[j * rmax + t] * bstride + e] = ab[src * bstride + ae] - s;
    }
    __syncthreads();

    // ---- phase 2: POTRF of the symmetrised diagonal block -----------------
    for (int ci = threadIdx.x; ci < nc; ci += blockDim.x) {
      const int j = order[c0 + ci];
      T* blk = lb + col_slots[j * rmax] * bstride;
      T c[D][D];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int k = 0; k < D; ++k) c[i][k] = blk[i * D + k];
      T l[D][D];
#pragma unroll
      for (int jj = 0; jj < D; ++jj) {
        T s = c[jj][jj];
#pragma unroll
        for (int k = 0; k < jj; ++k) s -= l[jj][k] * l[jj][k];
        const T ljj = sqrt(s);
        l[jj][jj] = ljj;
        const T inv = T(1) / ljj;
#pragma unroll
        for (int i = jj + 1; i < D; ++i) {
          T t = T(0.5) * (c[i][jj] + c[jj][i]);
#pragma unroll
          for (int k = 0; k < jj; ++k) t -= l[i][k] * l[jj][k];
          l[i][jj] = t * inv;
        }
      }
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int k = 0; k < D; ++k) blk[i * D + k] = k <= i ? l[i][k] : T(0);
    }
    __syncthreads();

    // ---- phase 3: TRSM, X_t = C_t L^{-T}, one row a of one X_t per thread --
    if (rmax > 1) {
      const int per_col3 = (rmax - 1) * D;
      for (int idx = threadIdx.x; idx < nc * per_col3; idx += blockDim.x) {
        const int j = order[c0 + idx / per_col3];
        const int rem = idx % per_col3;
        const int t = 1 + rem / D;
        if (t >= col_len[j]) continue;
        const int a = rem % D;
        const T* ld = lb + col_slots[j * rmax] * bstride;
        T* row = lb + col_slots[j * rmax + t] * bstride + a * D;
        T x[D];
#pragma unroll
        for (int jj = 0; jj < D; ++jj) {
          T s = row[jj];
#pragma unroll
          for (int k = 0; k < jj; ++k) s -= x[k] * ld[jj * D + k];
          x[jj] = s / ld[jj * D + jj];
        }
#pragma unroll
        for (int jj = 0; jj < D; ++jj) row[jj] = x[jj];
      }
    }
    __syncthreads();
  }
}

template <typename T, int D>
int launch_d(const void* ata, const int* a_src, const int* a_tr, const int* col_slots,
             const int* col_len, const int* ucount, const int* upd_jk, const int* upd_slots,
             const int* order, const int* lvl_ptr, int n_levels, int rmax, int umax, int B,
             void* lflat, cudaStream_t st) {
  if (B <= 0) return 0;
  whole_factor_kernel<T, D><<<B, WF_THREADS, 0, st>>>(
      static_cast<const T*>(ata), a_src, a_tr, col_slots, col_len, ucount, upd_jk, upd_slots,
      order, lvl_ptr, n_levels, rmax, umax, B, static_cast<T*>(lflat));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* ata, const void* a_src, const void* a_tr, const void* col_slots,
           const void* col_len, const void* ucount, const void* upd_jk, const void* upd_slots,
           const void* order, const void* lvl_ptr, int n_levels, int rmax, int umax, int B, int d,
           void* lflat, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TH_WF_CASE(DD)                                                                        \
  case DD:                                                                                    \
    return launch_d<T, DD>(ata, static_cast<const int*>(a_src), static_cast<const int*>(a_tr), \
                           static_cast<const int*>(col_slots), static_cast<const int*>(col_len), \
                           static_cast<const int*>(ucount), static_cast<const int*>(upd_jk),   \
                           static_cast<const int*>(upd_slots), static_cast<const int*>(order), \
                           static_cast<const int*>(lvl_ptr), n_levels, rmax, umax, B, lflat, st);
  switch (d) {
    TH_WF_CASE(1)
    TH_WF_CASE(2)
    TH_WF_CASE(3)
    TH_WF_CASE(4)
    TH_WF_CASE(5)
    TH_WF_CASE(6)
    TH_WF_CASE(7)
    TH_WF_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TH_WF_CASE
}

}  // namespace

TH_EXPORT int th_whole_factor_f32(const void* ata, const void* a_src, const void* a_tr,
                                  const void* col_slots, const void* col_len, const void* ucount,
                                  const void* upd_jk, const void* upd_slots, const void* order,
                                  const void* lvl_ptr, int n_levels, int rmax, int umax, int B,
                                  int d, void* lflat, void* stream) {
  return launch<float>(ata, a_src, a_tr, col_slots, col_len, ucount, upd_jk, upd_slots, order,
                       lvl_ptr, n_levels, rmax, umax, B, d, lflat, stream);
}

TH_EXPORT int th_whole_factor_f64(const void* ata, const void* a_src, const void* a_tr,
                                  const void* col_slots, const void* col_len, const void* ucount,
                                  const void* upd_jk, const void* upd_slots, const void* order,
                                  const void* lvl_ptr, int n_levels, int rmax, int umax, int B,
                                  int d, void* lflat, void* stream) {
  return launch<double>(ata, a_src, a_tr, col_slots, col_len, ucount, upd_jk, upd_slots, order,
                        lvl_ptr, n_levels, rmax, umax, B, d, lflat, stream);
}
