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
// Pose and point are the gathered AoS stacks (K, B, 3, 4) / (K, B, 3); the
// four aux operands are read through explicit (k, b) element strides, so an
// aux shared by all observations is broadcast with a zero k stride (the
// JAX package's _fused_inputs broadcast, embodied/measurements.py:179-190).
//
// What bounds it on the H100: memory. An item reads 20 values (pose 12,
// point 3, focal, feat 2, k1, k2) and writes 20 (jpose 12, jpt 6, err 2)
// for about 150 flops, far below the card's flop-per-byte balance: at the
// bundle-adjustment shape (K B = 204,800) 32.8 MB in float32, 9.8 us at
// 3.35 TB/s.
//
// What held the first design back (one thread per (k, b), each loading its
// pose and point and storing jpose, jpt and err at its own 48-, 12-, 48-,
// 24- and 8-byte stride): a warp-wide access touched many sectors for few
// useful bytes, and the kernel waited on L1/L2 wavefronts and store latency
// at 4x its bound.
//
// Design (row 1's, csrc/between_se3.cu). A block of `threads`
// (ops/reprojection.py reprojection_geometry) owns a contiguous range of
// idx = k B + b, so its pose tile (12 values an item) and point tile (3)
// are contiguous: they are copied into shared memory by 16-byte cp.async,
// single values at the ragged edge of the point tile. The aux operands go
// through the read-only path, not staged (a shared aux has a zero k stride,
// so it is not a contiguous tile; a dense one is 5 of an item's 40 values).
// Each thread computes its (k, b) with the first design's statements in
// their order (the same bits), writes its outputs into a shared tile whose
// rows are padded to an odd number of values (13 for jpose, 7 for jpt, 3
// for err, so neighbouring lanes hit other banks), and after one barrier the
// block stores the jpose, jpt and err tiles, each contiguous in device
// memory, with coalesced 16-byte stores. Input and output tiles share the
// buffer: RP_TILE values a thread (float64 at 256 threads: 47,104 bytes,
// under the 48 KB a block takes without opting in). Indexing is 64-bit; the
// wrapper refuses K B >= 2^31.

#include "common.cuh"

namespace {

constexpr int RP_THREADS_MAX = 256;
constexpr int RP_JS = 13;  // jpose's row in the output tile (12 values)
constexpr int RP_TS = 7;   // jpt's row (6)
constexpr int RP_ES = 3;   // err's row (2)
constexpr int RP_TILE = RP_JS + RP_TS + RP_ES;  // values a thread (>= the 15 of pose and point)

// One (k, b): the first design's statements, in their order. jpose, jpt and
// er point at the thread's rows of the output tile.
template <typename T>
__device__ __forceinline__ void linearize(const T (&r)[3][3], const T (&t)[3], const T (&p)[3], T f, T k1,
                                          T k2, const T (&ft)[2], T* jpose, T* jpt, T* er) {
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
    er[i] = proj[i] * factor - ft[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(RP_THREADS_MAX)
    reprojection_kernel(const T* __restrict__ pose, const T* __restrict__ point, const T* __restrict__ focal,
                        const T* __restrict__ feat, const T* __restrict__ k1p, const T* __restrict__ k2p,
                        long long f_ks, long long f_bs, long long x_ks, long long x_bs, long long k1_ks,
                        long long k1_bs, long long k2_ks, long long k2_bs, int K, int B, bool vec,
                        T* __restrict__ jpose_out, T* __restrict__ jpt_out, T* __restrict__ err_out) {
  extern __shared__ __align__(16) unsigned char rp_smem[];
  T* sh = reinterpret_cast<T*>(rp_smem);
  const int nt = blockDim.x;
  const long long base = static_cast<long long>(blockIdx.x) * nt;
  const long long left = static_cast<long long>(K) * B - base;
  const int cnt = left < nt ? static_cast<int>(left) : nt;

  // the block's pose and point tiles (cnt items of 12 and 3 values)
  T* sp = sh;
  T* sq = sh + nt * 12;
  th_stage_tile(sp, pose + base * 12, cnt * 12, vec);
  th_stage_tile(sq, point + base * 3, cnt * 3, vec);
  __pipeline_commit();
  const int tid = threadIdx.x;
  const bool mine = tid < cnt;
  T f = T(0), k1 = T(0), k2 = T(0), ft[2] = {T(0), T(0)};
  if (mine) {
    const long long idx = base + tid;
    const long long k = idx / B;
    const long long b = idx % B;
    f = __ldg(focal + k * f_ks + b * f_bs);
    k1 = __ldg(k1p + k * k1_ks + b * k1_bs);
    k2 = __ldg(k2p + k * k2_ks + b * k2_bs);
    ft[0] = __ldg(feat + k * x_ks + b * x_bs);
    ft[1] = __ldg(feat + k * x_ks + b * x_bs + 1);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  T r[3][3], t[3], p[3];
  if (mine) {
    const T* g = sp + tid * 12;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) r[i][j] = g[4 * i + j];
      t[i] = g[4 * i + 3];
      p[i] = sq[tid * 3 + i];
    }
  }
  __syncthreads();  // the input tiles are read before the outputs overwrite them
  if (mine)
    linearize(r, t, p, f, k1, k2, ft, sh + tid * RP_JS, sh + nt * RP_JS + tid * RP_TS,
              sh + nt * (RP_JS + RP_TS) + tid * RP_ES);
  __syncthreads();
  th_store_tile<T, 12, RP_JS>(sh, jpose_out + base * 12, cnt, vec);
  th_store_tile<T, 6, RP_TS>(sh + nt * RP_JS, jpt_out + base * 6, cnt, vec);
  th_store_tile<T, 2, RP_ES>(sh + nt * (RP_JS + RP_TS), err_out + base * 2, cnt, vec);
}

// threads and smem from ops/reprojection.py reprojection_geometry; the
// launcher rejects a block size it was not built for and fewer bytes than
// its tile.
template <typename T>
int launch(const void* pose, const void* point, const void* focal, const void* feat, const void* k1,
           const void* k2, long long f_ks, long long f_bs, long long x_ks, long long x_bs, long long k1_ks,
           long long k1_bs, long long k2_ks, long long k2_bs, int K, int B, int threads, long long smem,
           void* jpose, void* jpt, void* err, void* stream) {
  const long long n = static_cast<long long>(K) * B;
  if (n <= 0) return 0;
  if (threads < 32 || threads % 32 || threads > RP_THREADS_MAX ||
      smem < static_cast<long long>(RP_TILE) * threads * static_cast<long long>(sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  // a block's tiles start at a multiple of 32 items: 16-byte aligned when
  // the tensors are
  const bool vec = ((reinterpret_cast<size_t>(pose) | reinterpret_cast<size_t>(point) |
                     reinterpret_cast<size_t>(jpose) | reinterpret_cast<size_t>(jpt) |
                     reinterpret_cast<size_t>(err)) % 16) == 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(reprojection_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  reprojection_kernel<T><<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pose), static_cast<const T*>(point), static_cast<const T*>(focal),
      static_cast<const T*>(feat), static_cast<const T*>(k1), static_cast<const T*>(k2), f_ks, f_bs, x_ks,
      x_bs, k1_ks, k1_bs, k2_ks, k2_bs, K, B, vec, static_cast<T*>(jpose), static_cast<T*>(jpt),
      static_cast<T*>(err));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

TH_EXPORT int th_reprojection_f32(const void* pose, const void* point, const void* focal, const void* feat,
                                  const void* k1, const void* k2, long long f_ks, long long f_bs,
                                  long long x_ks, long long x_bs, long long k1_ks, long long k1_bs,
                                  long long k2_ks, long long k2_bs, int K, int B, int threads, long long smem,
                                  void* jpose, void* jpt, void* err, void* stream) {
  return launch<float>(pose, point, focal, feat, k1, k2, f_ks, f_bs, x_ks, x_bs, k1_ks, k1_bs, k2_ks, k2_bs,
                       K, B, threads, smem, jpose, jpt, err, stream);
}

TH_EXPORT int th_reprojection_f64(const void* pose, const void* point, const void* focal, const void* feat,
                                  const void* k1, const void* k2, long long f_ks, long long f_bs,
                                  long long x_ks, long long x_bs, long long k1_ks, long long k1_bs,
                                  long long k2_ks, long long k2_bs, int K, int B, int threads, long long smem,
                                  void* jpose, void* jpt, void* err, void* stream) {
  return launch<double>(pose, point, focal, feat, k1, k2, f_ks, f_bs, x_ks, x_bs, k1_ks, k1_bs, k2_ks, k2_bs,
                        K, B, threads, smem, jpose, jpt, err, stream);
}
