// Whole forward and backward substitution with the block-sparse factor, one
// launch per sweep.
//
// Replaces the Pallas kernels `_fwd_kernel` and `_bwd_kernel` of
// theseus_tpu/sparse/pallas_whole.py (pallas_calls at :508 and :523, entry
// solve_whole). For every batch element:
//   forward:  y_j = L_jj^{-1} (b[perm[j]] - sum_u L[upd_jk[j,u]] y[upd_k[j,u]])
//   backward: x_j = L_jj^{-T} (y_j - sum_{t>=1} L[col_slots[j,t]]^T x[row_ids[j,t]])
// with y in elimination order and x written back in the original variable
// order, x_orig[perm[j]] = x_j. The permutations are read here, so a solve
// is two launches and no gathers.
//
// Design. As in whole_factor.cu, a block owns one batch element and walks
// the elimination-tree levels (forward: first to last; backward: last to
// first), one thread per column of the level and a __syncthreads() between
// levels. The TPU forward kernel pushes each column into the rows below it
// (right-looking, one column per grid step); two columns of one level can
// push into the same row, so here the forward pulls instead (each column
// reads the y_k of its update list), which needs no atomics and sums in a
// fixed order. The block keeps its batch element's vector (n d values:
// 6 KB in float32 at 256 poses, 98 KB in float64 at 2048 poses) in shared
// memory when it fits in 200 KB (opting in above 48 KB), and works in the
// output in device memory otherwise, both inside the kernel.
//
// What bounds it on the H100: memory. Each sweep reads L once (14.1 MB in
// float32 at PGO 256 x 128) and the right-hand side, and writes the result:
// ~15.7 MB, 4.7 us at 3.35 TB/s; ~2 d^2 flops per factor block. In practice
// it is latency-bound (a chain of dependent loads per level, 13 levels).

#include "common.cuh"

namespace {

constexpr int WS_THREADS = 128;
constexpr size_t WS_SMEM_MAX = 200 * 1024;

template <typename T, int D, bool SMEM>
__global__ void whole_fwd_kernel(const T* __restrict__ lflat, const T* __restrict__ bvec,
                                 const int* __restrict__ perm, const int* __restrict__ upd_jk,
                                 const int* __restrict__ upd_k, const int* __restrict__ ucount,
                                 const int* __restrict__ diag, const int* __restrict__ order,
                                 const int* __restrict__ lvl_ptr, int n_levels, int n, int umax,
                                 int B, T* y) {
  extern __shared__ __align__(16) unsigned char ws_smem[];
  constexpr int DD = D * D;
  const int b = blockIdx.x;
  const long long lstride = static_cast<long long>(B) * DD;
  const long long vstride = static_cast<long long>(B) * D;
  const T* lb = lflat + static_cast<long long>(b) * DD;
  // the block's y: row r at ybuf + r * ystride
  T* ybuf = SMEM ? reinterpret_cast<T*>(ws_smem) : y + static_cast<long long>(b) * D;
  const long long ystride = SMEM ? D : vstride;

  for (int lv = 0; lv < n_levels; ++lv) {
    const int c0 = lvl_ptr[lv];
    const int nc = lvl_ptr[lv + 1] - c0;
    for (int ci = threadIdx.x; ci < nc; ci += blockDim.x) {
      const int j = order[c0 + ci];
      const T* bj = bvec + perm[j] * vstride + static_cast<long long>(b) * D;
      T acc[D];
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] = bj[i];
      const int nu = ucount[j];
      for (int u = 0; u < nu; ++u) {
        const T* l = lb + upd_jk[j * umax + u] * lstride;
        const T* yk = ybuf + upd_k[j * umax + u] * ystride;
        T v[D];
#pragma unroll
        for (int k = 0; k < D; ++k) v[k] = yk[k];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          T s = acc[i];
#pragma unroll
          for (int k = 0; k < D; ++k) s -= l[i * D + k] * v[k];
          acc[i] = s;
        }
      }
      const T* ld = lb + diag[j] * lstride;
      T out[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        T s = acc[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= ld[i * D + k] * out[k];
        out[i] = s / ld[i * D + i];
      }
      T* yj = ybuf + j * ystride;
#pragma unroll
      for (int i = 0; i < D; ++i) yj[i] = out[i];
    }
    __syncthreads();
  }
  if (SMEM) {
    for (int e = threadIdx.x; e < n * D; e += blockDim.x)
      y[(e / D) * vstride + static_cast<long long>(b) * D + e % D] = ybuf[e];
  }
}

template <typename T, int D, bool SMEM>
__global__ void whole_bwd_kernel(const T* __restrict__ lflat, const T* __restrict__ yvec,
                                 const int* __restrict__ perm, const int* __restrict__ col_slots,
                                 const int* __restrict__ col_len, const int* __restrict__ row_ids,
                                 const int* __restrict__ order, const int* __restrict__ lvl_ptr,
                                 int n_levels, int n, int rmax, int B, T* x) {
  extern __shared__ __align__(16) unsigned char ws_smem[];
  constexpr int DD = D * D;
  const int b = blockIdx.x;
  const long long lstride = static_cast<long long>(B) * DD;
  const long long vstride = static_cast<long long>(B) * D;
  const T* lb = lflat + static_cast<long long>(b) * DD;
  T* xs = reinterpret_cast<T*>(ws_smem);
  T* xg = x + static_cast<long long>(b) * D;
  // row r of the block's x (elimination order): in shared memory at r, or in
  // the output at its original index perm[r]
  auto xrow = [&](int r) -> T* { return SMEM ? xs + r * D : xg + perm[r] * vstride; };

  for (int lv = n_levels - 1; lv >= 0; --lv) {
    const int c0 = lvl_ptr[lv];
    const int nc = lvl_ptr[lv + 1] - c0;
    for (int ci = threadIdx.x; ci < nc; ci += blockDim.x) {
      const int j = order[c0 + ci];
      const T* yj = yvec + j * vstride + static_cast<long long>(b) * D;
      T acc[D];
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] = yj[i];
      const int nr = col_len[j];
      for (int t = 1; t < nr; ++t) {
        const T* l = lb + col_slots[j * rmax + t] * lstride;
        const T* xr = xrow(row_ids[j * rmax + t]);
        T v[D];
#pragma unroll
        for (int i = 0; i < D; ++i) v[i] = xr[i];
#pragma unroll
        for (int jj = 0; jj < D; ++jj) {
          T s = acc[jj];
#pragma unroll
          for (int i = 0; i < D; ++i) s -= l[i * D + jj] * v[i];
          acc[jj] = s;
        }
      }
      const T* l0 = lb + col_slots[j * rmax] * lstride;
      T out[D];
#pragma unroll
      for (int jj = D - 1; jj >= 0; --jj) {
        T s = acc[jj];
#pragma unroll
        for (int k = jj + 1; k < D; ++k) s -= l0[k * D + jj] * out[k];
        out[jj] = s / l0[jj * D + jj];
      }
      T* xj = xrow(j);
#pragma unroll
      for (int i = 0; i < D; ++i) xj[i] = out[i];
    }
    __syncthreads();
  }
  if (SMEM) {
    for (int e = threadIdx.x; e < n * D; e += blockDim.x)
      xg[perm[e / D] * vstride + e % D] = xs[e];
  }
}

// Shared memory for the block's vector, or 0 when it stays in device memory.
template <typename T, int D, typename K>
int smem_bytes(K kernel, int n, size_t* bytes) {
  const size_t need = static_cast<size_t>(n) * D * sizeof(T);
  *bytes = need <= WS_SMEM_MAX ? need : 0;
  if (*bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(*bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <typename T, int D>
int fwd_d(const void* lflat, const void* b, const int* perm, const int* upd_jk, const int* upd_k,
          const int* ucount, const int* diag, const int* order, const int* lvl_ptr, int n_levels,
          int n, int umax, int B, void* y, cudaStream_t st) {
  if (B <= 0 || n <= 0) return 0;
  size_t bytes = static_cast<size_t>(n) * D * sizeof(T);
  if (bytes <= WS_SMEM_MAX) {
    int rc = smem_bytes<T, D>(whole_fwd_kernel<T, D, true>, n, &bytes);
    if (rc) return rc;
    whole_fwd_kernel<T, D, true><<<B, WS_THREADS, bytes, st>>>(
        static_cast<const T*>(lflat), static_cast<const T*>(b), perm, upd_jk, upd_k, ucount, diag,
        order, lvl_ptr, n_levels, n, umax, B, static_cast<T*>(y));
  } else {
    whole_fwd_kernel<T, D, false><<<B, WS_THREADS, 0, st>>>(
        static_cast<const T*>(lflat), static_cast<const T*>(b), perm, upd_jk, upd_k, ucount, diag,
        order, lvl_ptr, n_levels, n, umax, B, static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_d(const void* lflat, const void* y, const int* perm, const int* col_slots,
          const int* col_len, const int* row_ids, const int* order, const int* lvl_ptr,
          int n_levels, int n, int rmax, int B, void* x, cudaStream_t st) {
  if (B <= 0 || n <= 0) return 0;
  size_t bytes = static_cast<size_t>(n) * D * sizeof(T);
  if (bytes <= WS_SMEM_MAX) {
    int rc = smem_bytes<T, D>(whole_bwd_kernel<T, D, true>, n, &bytes);
    if (rc) return rc;
    whole_bwd_kernel<T, D, true><<<B, WS_THREADS, bytes, st>>>(
        static_cast<const T*>(lflat), static_cast<const T*>(y), perm, col_slots, col_len, row_ids,
        order, lvl_ptr, n_levels, n, rmax, B, static_cast<T*>(x));
  } else {
    whole_bwd_kernel<T, D, false><<<B, WS_THREADS, 0, st>>>(
        static_cast<const T*>(lflat), static_cast<const T*>(y), perm, col_slots, col_len, row_ids,
        order, lvl_ptr, n_levels, n, rmax, B, static_cast<T*>(x));
  }
  return static_cast<int>(cudaGetLastError());
}

#define TH_WS_SWITCH(CALL)                                    \
  switch (d) {                                                \
    case 1: return CALL(1);                                   \
    case 2: return CALL(2);                                   \
    case 3: return CALL(3);                                   \
    case 4: return CALL(4);                                   \
    case 5: return CALL(5);                                   \
    case 6: return CALL(6);                                   \
    case 7: return CALL(7);                                   \
    case 8: return CALL(8);                                   \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <typename T>
int fwd(const void* lflat, const void* b, const void* perm, const void* upd_jk, const void* upd_k,
        const void* ucount, const void* diag, const void* order, const void* lvl_ptr, int n_levels,
        int n, int umax, int B, int d, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(perm);
#define TH_WS_FWD(DD)                                                                            \
  fwd_d<T, DD>(lflat, b, p, static_cast<const int*>(upd_jk), static_cast<const int*>(upd_k),   \
               static_cast<const int*>(ucount), static_cast<const int*>(diag),                  \
               static_cast<const int*>(order), static_cast<const int*>(lvl_ptr), n_levels, n,   \
               umax, B, y, st)
  TH_WS_SWITCH(TH_WS_FWD)
#undef TH_WS_FWD
}

template <typename T>
int bwd(const void* lflat, const void* y, const void* perm, const void* col_slots,
        const void* col_len, const void* row_ids, const void* order, const void* lvl_ptr,
        int n_levels, int n, int rmax, int B, int d, void* x, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(perm);
#define TH_WS_BWD(DD)                                                                             \
  bwd_d<T, DD>(lflat, y, p, static_cast<const int*>(col_slots), static_cast<const int*>(col_len), \
               static_cast<const int*>(row_ids), static_cast<const int*>(order),                 \
               static_cast<const int*>(lvl_ptr), n_levels, n, rmax, B, x, st)
  TH_WS_SWITCH(TH_WS_BWD)
#undef TH_WS_BWD
}

}  // namespace

TH_EXPORT int th_whole_fwd_subst_f32(const void* lflat, const void* b, const void* perm,
                                     const void* upd_jk, const void* upd_k, const void* ucount,
                                     const void* diag, const void* order, const void* lvl_ptr,
                                     int n_levels, int n, int umax, int B, int d, void* y,
                                     void* stream) {
  return fwd<float>(lflat, b, perm, upd_jk, upd_k, ucount, diag, order, lvl_ptr, n_levels, n,
                    umax, B, d, y, stream);
}

TH_EXPORT int th_whole_fwd_subst_f64(const void* lflat, const void* b, const void* perm,
                                     const void* upd_jk, const void* upd_k, const void* ucount,
                                     const void* diag, const void* order, const void* lvl_ptr,
                                     int n_levels, int n, int umax, int B, int d, void* y,
                                     void* stream) {
  return fwd<double>(lflat, b, perm, upd_jk, upd_k, ucount, diag, order, lvl_ptr, n_levels, n,
                     umax, B, d, y, stream);
}

TH_EXPORT int th_whole_bwd_subst_f32(const void* lflat, const void* y, const void* perm,
                                     const void* col_slots, const void* col_len,
                                     const void* row_ids, const void* order, const void* lvl_ptr,
                                     int n_levels, int n, int rmax, int B, int d, void* x,
                                     void* stream) {
  return bwd<float>(lflat, y, perm, col_slots, col_len, row_ids, order, lvl_ptr, n_levels, n,
                    rmax, B, d, x, stream);
}

TH_EXPORT int th_whole_bwd_subst_f64(const void* lflat, const void* y, const void* perm,
                                     const void* col_slots, const void* col_len,
                                     const void* row_ids, const void* order, const void* lvl_ptr,
                                     int n_levels, int n, int rmax, int B, int d, void* x,
                                     void* stream) {
  return bwd<double>(lflat, y, perm, col_slots, col_len, row_ids, order, lvl_ptr, n_levels, n,
                     rmax, B, d, x, stream);
}
