// Fused Reprojection linearization (pinhole + 2-parameter radial distortion).
//
// Replaces the Pallas kernel `_kernel` of theseus_tpu/ops/pallas_reprojection.py
// (pallas_call at :171, entry reprojection_linearize_soa). For every
// observation k and batch element b:
//   P      = R p + t                          (camera frame)
//   proj   = -P_xy / P_z;  r2 = |proj|^2
//   factor = f (1 + r2 (k1 + r2 k2))
//   err    = proj * factor - feat              (2,)
//   de/dproj = factor I + 2 f (k1 + 2 r2 k2) proj proj^T
//   dproj/dP = [[-1/Pz, 0, Px/Pz^2], [0, -1/Pz, Py/Pz^2]]
//   jpt    = de/dP R                           (2, 3)
//   jpose  = [jpt | -jpt hat(p)]               (2, 6), tangent [lin; ang]
// in the operation order of the plain twin (ops/reprojection.py, the port of
// the JAX package's _reference_linearize). Division by P_z is IEEE division
// and P_z is not clamped: a point on the camera plane gives inf/NaN exactly
// as the twin does, and the Schur solve's `bad` mask rejects that step. The
// library is built without --use_fast_math.
//
// Design: one thread per (k, b), every value in registers, no reduction.
// Pose and point are the gathered AoS stacks (K, B, 3, 4) / (K, B, 3); the
// four aux operands are read through explicit (k, b) element strides, so an
// aux shared by all observations is broadcast with a zero k stride (the
// JAX package's _fused_inputs broadcast, embodied/measurements.py:179-190).
//
// What bounds it on the H100: memory. A thread reads 21 values and writes 20
// for about 150 flops, far below the card's flop-per-byte balance; at the
// bundle-adjustment shape (K*B = 204,800) it is one short, bandwidth-bound
// launch. Indexing is 64-bit; the wrapper refuses K*B >= 2^31.

#include "common.cuh"

namespace {

template <typename T>
__global__ void reprojection_kernel(const T* __restrict__ pose, const T* __restrict__ point,
                                    const T* __restrict__ focal, const T* __restrict__ feat,
                                    const T* __restrict__ k1p, const T* __restrict__ k2p,
                                    long long f_ks, long long f_bs, long long x_ks,
                                    long long x_bs, long long k1_ks, long long k1_bs,
                                    long long k2_ks, long long k2_bs, int K, int B,
                                    T* __restrict__ jpose_out, T* __restrict__ jpt_out,
                                    T* __restrict__ err_out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(K) * B) return;
  const long long k = idx / B;
  const long long b = idx % B;

  T r[3][3], t[3], p[3];
  const T* g = pose + idx * 12;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) r[i][j] = g[4 * i + j];
    t[i] = g[4 * i + 3];
    p[i] = point[idx * 3 + i];
  }
  const T f = focal[k * f_ks + b * f_bs];
  const T k1 = k1p[k * k1_ks + b * k1_bs];
  const T k2 = k2p[k * k2_ks + b * k2_bs];
  const T* ft = feat + k * x_ks + b * x_bs;

  T pc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) pc[i] = (r[i][0] * p[0] + r[i][1] * p[1] + r[i][2] * p[2]) + t[i];
  const T proj[2] = {-pc[0] / pc[2], -pc[1] / pc[2]};
  const T r2 = proj[0] * proj[0] + proj[1] * proj[1];
  const T factor = f * (T(1) + r2 * (k1 + r2 * k2));
  const T dfdr2 = f * (k1 + T(2) * r2 * k2);

  // de/dproj (2x2) and dproj/dP (2x3)
  T de[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      de[i][j] = (i == j ? factor : T(0)) + T(2) * dfdr2 * (proj[i] * proj[j]);
  const T inv_z = T(1) / pc[2];
  const T dpp[2][3] = {{-inv_z, T(0), pc[0] * inv_z * inv_z},
                       {T(0), -inv_z, pc[1] * inv_z * inv_z}};
  const T hatp[3][3] = {{T(0), -p[2], p[1]}, {p[2], T(0), -p[0]}, {-p[1], p[0], T(0)}};

  T* jpose = jpose_out + idx * 12;
  T* jpt = jpt_out + idx * 6;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T dedp[3], row[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) dedp[j] = de[i][0] * dpp[0][j] + de[i][1] * dpp[1][j];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      row[j] = dedp[0] * r[0][j] + dedp[1] * r[1][j] + dedp[2] * r[2][j];
      jpt[3 * i + j] = row[j];
      jpose[6 * i + j] = row[j];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
      jpose[6 * i + 3 + j] = -(row[0] * hatp[0][j] + row[1] * hatp[1][j] + row[2] * hatp[2][j]);
    err_out[idx * 2 + i] = proj[i] * factor - ft[i];
  }
}

template <typename T>
int launch(const void* pose, const void* point, const void* focal, const void* feat,
           const void* k1, const void* k2, long long f_ks, long long f_bs, long long x_ks,
           long long x_bs, long long k1_ks, long long k1_bs, long long k2_ks, long long k2_bs,
           int K, int B, void* jpose, void* jpt, void* err, void* stream) {
  const long long n = static_cast<long long>(K) * B;
  if (n <= 0) return 0;
  reprojection_kernel<T><<<th_blocks(n), TH_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pose), static_cast<const T*>(point), static_cast<const T*>(focal),
      static_cast<const T*>(feat), static_cast<const T*>(k1), static_cast<const T*>(k2), f_ks,
      f_bs, x_ks, x_bs, k1_ks, k1_bs, k2_ks, k2_bs, K, B, static_cast<T*>(jpose),
      static_cast<T*>(jpt), static_cast<T*>(err));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

TH_EXPORT int th_reprojection_f32(const void* pose, const void* point, const void* focal,
                                  const void* feat, const void* k1, const void* k2,
                                  long long f_ks, long long f_bs, long long x_ks, long long x_bs,
                                  long long k1_ks, long long k1_bs, long long k2_ks,
                                  long long k2_bs, int K, int B, void* jpose, void* jpt,
                                  void* err, void* stream) {
  return launch<float>(pose, point, focal, feat, k1, k2, f_ks, f_bs, x_ks, x_bs, k1_ks, k1_bs,
                       k2_ks, k2_bs, K, B, jpose, jpt, err, stream);
}

TH_EXPORT int th_reprojection_f64(const void* pose, const void* point, const void* focal,
                                  const void* feat, const void* k1, const void* k2,
                                  long long f_ks, long long f_bs, long long x_ks, long long x_bs,
                                  long long k1_ks, long long k1_bs, long long k2_ks,
                                  long long k2_bs, int K, int B, void* jpose, void* jpt,
                                  void* err, void* stream) {
  return launch<double>(pose, point, focal, feat, k1, k2, f_ks, f_bs, x_ks, x_bs, k1_ks, k1_bs,
                        k2_ks, k2_bs, K, B, jpose, jpt, err, stream);
}
