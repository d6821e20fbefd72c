// Per-level forward and backward substitution with the block-sparse factor.
//
// Replaces the Pallas kernels `_fwd_sub_kernel` and `_bwd_sub_kernel` of
// theseus_tpu/sparse/pallas_factorize.py (pallas_call at :260, entries
// fwd_sub_level and bwd_sub_level). For every column j of one level and
// every batch element:
//   forward:  y_j = L_jj^{-1} (b_j - sum_u L_jk[u] y_k[u])
//   backward: x_j = L_jj^{-T} (y_j - sum_{r>=1} L_rj[r]^T x_r[r])
// The backward kernel ignores row 0 of its operands (the diagonal block's
// row) and expects rows that are invalid or above the diagonal to be zeroed
// by the caller (pallas_factorize.py:204-206, cholesky.py:890-892); the
// forward kernel likewise expects invalid updates zeroed. The iterative
// refinement step reuses both kernels.
//
// Design: one thread per (column, batch), the d-vectors (d <= 8, a template
// parameter) in registers, loops over ul / rl of any size. AoS layout:
// forward ljk (C, ul, B, d, d), yk (C, ul, B, d), b (C, B, d),
// ldiag (C, B, d, d) -> y (C, B, d); backward lcol (C, rl, B, d, d),
// xr (C, rl, B, d), y (C, B, d) -> x (C, B, d).
//
// What bounds it on the H100: memory and launch latency. A thread reads
// ul (or rl) d x d blocks for 2 d^2 flops each: about half a flop per byte.

#include "common.cuh"

namespace {

template <typename T, int D>
__global__ void fwd_subst_kernel(const T* __restrict__ ljk, const T* __restrict__ yk,
                                 const T* __restrict__ bvec, const T* __restrict__ ldiag, int C,
                                 int ul, int B, T* __restrict__ y) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(C) * B) return;
  const long long c = idx / B;
  const long long b = idx % B;
  const long long DD = D * D;
  T acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = bvec[idx * D + i];
  for (int u = 0; u < ul; ++u) {
    const long long row = (c * ul + u) * B + b;
    const T* l = ljk + row * DD;
    const T* v = yk + row * D;
    T vv[D];
#pragma unroll
    for (int j = 0; j < D; ++j) vv[j] = v[j];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      T s = acc[i];
#pragma unroll
      for (int j = 0; j < D; ++j) s -= l[i * D + j] * vv[j];
      acc[i] = s;
    }
  }
  const T* ld = ldiag + idx * DD;
  T out[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T s = acc[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= ld[i * D + k] * out[k];
    out[i] = s / ld[i * D + i];
  }
#pragma unroll
  for (int i = 0; i < D; ++i) y[idx * D + i] = out[i];
}

template <typename T, int D>
__global__ void bwd_subst_kernel(const T* __restrict__ lcol, const T* __restrict__ xr,
                                 const T* __restrict__ yvec, int C, int rl, int B,
                                 T* __restrict__ x) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(C) * B) return;
  const long long c = idx / B;
  const long long b = idx % B;
  const long long DD = D * D;
  T acc[D];
#pragma unroll
  for (int j = 0; j < D; ++j) acc[j] = yvec[idx * D + j];
  for (int r = 1; r < rl; ++r) {
    const long long row = (c * rl + r) * B + b;
    const T* l = lcol + row * DD;
    const T* v = xr + row * D;
    T vv[D];
#pragma unroll
    for (int i = 0; i < D; ++i) vv[i] = v[i];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T s = acc[j];
#pragma unroll
      for (int i = 0; i < D; ++i) s -= l[i * D + j] * vv[i];
      acc[j] = s;
    }
  }
  const T* l0 = lcol + ((c * rl) * B + b) * DD;
  T out[D];
#pragma unroll
  for (int j = D - 1; j >= 0; --j) {
    T s = acc[j];
#pragma unroll
    for (int k = j + 1; k < D; ++k) s -= l0[k * D + j] * out[k];
    out[j] = s / l0[j * D + j];
  }
#pragma unroll
  for (int j = 0; j < D; ++j) x[idx * D + j] = out[j];
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
int fwd_d(const void* ljk, const void* yk, const void* b, const void* ldiag, int C, int ul, int B,
          void* y, cudaStream_t st) {
  const long long n = static_cast<long long>(C) * B;
  if (n <= 0) return 0;
  fwd_subst_kernel<T, D><<<th_blocks(n), TH_BLOCK, 0, st>>>(
      static_cast<const T*>(ljk), static_cast<const T*>(yk), static_cast<const T*>(b),
      static_cast<const T*>(ldiag), C, ul, B, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_d(const void* lcol, const void* xr, const void* y, int C, int rl, int B, void* x,
          cudaStream_t st) {
  const long long n = static_cast<long long>(C) * B;
  if (n <= 0) return 0;
  bwd_subst_kernel<T, D><<<th_blocks(n), TH_BLOCK, 0, st>>>(
      static_cast<const T*>(lcol), static_cast<const T*>(xr), static_cast<const T*>(y), C, rl, B,
      static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd(const void* ljk, const void* yk, const void* b, const void* ldiag, int C, int ul, int B,
        int d, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TH_FWD(DD) fwd_d<T, DD>(ljk, yk, b, ldiag, C, ul, B, y, st)
  TH_SUB_SWITCH(TH_FWD)
#undef TH_FWD
}

template <typename T>
int bwd(const void* lcol, const void* xr, const void* y, int C, int rl, int B, int d, void* x,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TH_BWD(DD) bwd_d<T, DD>(lcol, xr, y, C, rl, B, x, st)
  TH_SUB_SWITCH(TH_BWD)
#undef TH_BWD
}

}  // namespace

TH_EXPORT int th_level_fwd_subst_f32(const void* ljk, const void* yk, const void* b,
                                     const void* ldiag, int C, int ul, int B, int d, void* y,
                                     void* stream) {
  return fwd<float>(ljk, yk, b, ldiag, C, ul, B, d, y, stream);
}

TH_EXPORT int th_level_fwd_subst_f64(const void* ljk, const void* yk, const void* b,
                                     const void* ldiag, int C, int ul, int B, int d, void* y,
                                     void* stream) {
  return fwd<double>(ljk, yk, b, ldiag, C, ul, B, d, y, stream);
}

TH_EXPORT int th_level_bwd_subst_f32(const void* lcol, const void* xr, const void* y, int C,
                                     int rl, int B, int d, void* x, void* stream) {
  return bwd<float>(lcol, xr, y, C, rl, B, d, x, stream);
}

TH_EXPORT int th_level_bwd_subst_f64(const void* lcol, const void* xr, const void* y, int C,
                                     int rl, int B, int d, void* x, void* stream) {
  return bwd<double>(lcol, xr, y, C, rl, B, d, x, stream);
}
