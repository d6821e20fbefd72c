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
// The gathers that build col_a / ks / kj, the a_tr transpose, the valid mask
// and the scatter into the factor stay outside, as indexed torch ops, as on
// the TPU.
//
// Design: one thread per (column, batch); the d x d blocks (d <= 8, a
// template parameter) live in registers, and the thread loops over the
// level's ul updates and rl rows, whatever their size. Layout: AoS
// col_a (C, rl, B, d, d), ks (C, ul, rl, B, d, d), kj (C, ul, B, d, d);
// out (C, rl, B, d, d). The TPU's SoA layout put the batch on the 128
// lanes; here the batch index is the fastest-varying thread index.
//
// What bounds it on the H100: memory. Each thread reads (ul*rl + ul + rl)
// d x d blocks for about ul*rl*2d^3 + d^3/3 + rl*d^3 flops (a few flops per
// byte), and a level has only C*B threads (C <= 32 at 256 poses), so the
// kernel is bandwidth- and launch-latency-bound.

#include "common.cuh"

namespace {

template <typename T, int D>
__device__ __forceinline__ void load_updated(const T* __restrict__ a, const T* __restrict__ ks,
                                             const T* __restrict__ kj, int ul,
                                             long long ks_u_stride, long long kj_u_stride,
                                             T c[D][D]) {
  T upd[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) upd[i][j] = T(0);
  for (int u = 0; u < ul; ++u) {
    const T* ksu = ks + u * ks_u_stride;
    const T* kju = kj + u * kj_u_stride;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = upd[i][j];
#pragma unroll
        for (int k = 0; k < D; ++k) s += ksu[i * D + k] * kju[j * D + k];
        upd[i][j] = s;
      }
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) c[i][j] = a[i * D + j] - upd[i][j];
}

template <typename T, int D>
__global__ void level_factor_kernel(const T* __restrict__ col_a, const T* __restrict__ ks,
                                    const T* __restrict__ kj, int C, int rl, int ul, int B,
                                    T* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(C) * B) return;
  const long long c = idx / B;
  const long long b = idx % B;
  const long long DD = D * D;
  const long long blk_b = DD;                // stride of b inside one (c, ., r) group
  const long long a_r = B * DD;              // stride of r in col_a / out
  const long long ks_r = B * DD;             // stride of r in ks
  const long long ks_u = rl * ks_r;          // stride of u in ks
  const long long kj_u = B * DD;             // stride of u in kj
  const T* a0 = col_a + c * rl * a_r + b * blk_b;
  const T* ks0 = ks + c * ul * ks_u + b * blk_b;
  const T* kj0 = kj + c * ul * kj_u + b * blk_b;
  T* o0 = out + c * rl * a_r + b * blk_b;

  // ---- diagonal block: POTRF of the symmetrised update -----------------
  T cm[D][D];
  load_updated<T, D>(a0, ks0, kj0, ul, ks_u, kj_u, cm);
  T l[D][D];
  T inv[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T s = cm[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= l[j][k] * l[j][k];
    const T ljj = sqrt(s);
    l[j][j] = ljj;
    inv[j] = T(1) / ljj;
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      T t = T(0.5) * (cm[i][j] + cm[j][i]);
#pragma unroll
      for (int k = 0; k < j; ++k) t -= l[i][k] * l[j][k];
      l[i][j] = t * inv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) o0[i * D + j] = j <= i ? l[i][j] : T(0);

  // ---- rows below: X = C_r L^{-T} ---------------------------------------
  for (int r = 1; r < rl; ++r) {
    load_updated<T, D>(a0 + r * a_r, ks0 + r * ks_r, kj0, ul, ks_u, kj_u, cm);
    T x[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = cm[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) s -= x[i][k] * l[j][k];
        x[i][j] = s / l[j][j];
      }
    T* o = o0 + r * a_r;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) o[i * D + j] = x[i][j];
  }
}

template <typename T, int D>
int launch_d(const void* col_a, const void* ks, const void* kj, int C, int rl, int ul, int B,
             void* out, cudaStream_t stream) {
  const long long n = static_cast<long long>(C) * B;
  if (n <= 0) return 0;
  level_factor_kernel<T, D><<<th_blocks(n), TH_BLOCK, 0, stream>>>(
      static_cast<const T*>(col_a), static_cast<const T*>(ks), static_cast<const T*>(kj), C, rl,
      ul, B, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* col_a, const void* ks, const void* kj, int C, int rl, int ul, int B, int d,
           void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TH_LF_CASE(DD) \
  case DD:             \
    return launch_d<T, DD>(col_a, ks, kj, C, rl, ul, B, out, st);
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

TH_EXPORT int th_level_factor_f32(const void* col_a, const void* ks, const void* kj, int C, int rl,
                                  int ul, int B, int d, void* out, void* stream) {
  return launch<float>(col_a, ks, kj, C, rl, ul, B, d, out, stream);
}

TH_EXPORT int th_level_factor_f64(const void* col_a, const void* ks, const void* kj, int C, int rl,
                                  int ul, int B, int d, void* out, void* stream) {
  return launch<double>(col_a, ks, kj, C, rl, ul, B, d, out, stream);
}
