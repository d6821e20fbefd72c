// Fused SE3 Between linearization.
//
// Replaces the Pallas kernel `_kernel` of theseus_tpu/ops/pallas_between_soa.py
// (pallas_call at :321, entry between_linearize_soa). For every edge k and
// batch element b:
//   d   = v1^{-1} v2
//   r   = log(m^{-1} d)                        (6,)   [lin; ang]
//   J2  = jlog(m^{-1} d)                       (6, 6)
//   J1  = -J2 Adj(d^{-1})                      (6, 6)
// with the SO3 log's near-zero and near-pi branches and the jlog Taylor
// branches of theseus_tpu/lie/{so3,se3}.py. The three eps thresholds come
// from the caller (the per-dtype table of config.py), never hard-coded.
// atan2 is the native one; the Pallas kernel's polynomial atan2 (about 1e-7)
// existed only because Mosaic had no atan.
//
// Layout is the port's AoS (K, B, 3, 4) -> (K, B, 6, 6): the TPU kernel's SoA
// transpose put the batch on the 128 lanes, a TPU tiling choice. The
// measurement is read through explicit (k, b) strides so a shared
// measurement is broadcast with stride 0, as measurements.py:74-75 does; it
// goes through the read-only path.
//
// What bounds it on the H100: memory. A thread reads 36 values and writes
// 78 for about 600 flops, far below the card's flop-per-byte balance: at
// PGO 256 x 128 (K B = 32,896) 15.2 MB in float32, 4.5 us at 3.35 TB/s.
//
// What held the first design back (one thread per (k, b), the poses loaded
// and the 78 outputs stored by each thread at its own 48- and 144-byte
// stride): every warp-wide store touched 32 sectors for 128 useful bytes,
// and at 8 warps an SM the kernel waited on L1/L2 wavefronts and store
// latency, 10x its bound.
//
// Design. A block of `threads` (ops/between_se3.py between_geometry) owns a
// contiguous range of idx = k B + b, so its v1 and v2 tiles are contiguous:
// they are copied into shared memory by 16-byte cp.async. Each thread
// computes its (k, b) with the first design's statements in their order
// (the same bits), writes its outputs into a shared tile whose rows are
// padded to an odd number of values (37 for a 6 x 6 block, 7 for err, so
// neighbouring lanes hit other banks), and after one barrier the block
// stores the J1, J2 and err tiles, each contiguous in device memory, with
// coalesced 16-byte stores. The input tiles and the output tiles share the
// buffer: BT_TILE values a thread.

#include "common.cuh"

namespace {

constexpr int BT_THREADS_MAX = 256;
constexpr int BT_JS = 37;  // a 6 x 6 block's row in the output tile
constexpr int BT_ES = 7;   // err's row
constexpr int BT_TILE = 2 * BT_JS + BT_ES;  // values a thread: J1, J2, err (>= the 24 of v1, v2)

template <typename T>
struct Pose {
  T r[3][3];
  T t[3];
};

template <typename T>
__device__ __forceinline__ void load_pose(const T* __restrict__ p, Pose<T>& g) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) g.r[i][j] = p[4 * i + j];
    g.t[i] = p[4 * i + 3];
  }
}

// the measurement, through the read-only data path
template <typename T>
__device__ __forceinline__ void load_pose_ro(const T* __restrict__ p, Pose<T>& g) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) g.r[i][j] = __ldg(p + 4 * i + j);
    g.t[i] = __ldg(p + 4 * i + 3);
  }
}

template <typename T>
__device__ __forceinline__ Pose<T> inverse(const Pose<T>& g) {
  Pose<T> out;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out.r[i][j] = g.r[j][i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out.t[i] = -(out.r[i][0] * g.t[0] + out.r[i][1] * g.t[1] + out.r[i][2] * g.t[2]);
  return out;
}

template <typename T>
__device__ __forceinline__ Pose<T> compose(const Pose<T>& a, const Pose<T>& b) {
  Pose<T> out;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out.r[i][j] = a.r[i][0] * b.r[0][j] + a.r[i][1] * b.r[1][j] + a.r[i][2] * b.r[2][j];
    out.t[i] = (a.r[i][0] * b.t[0] + a.r[i][1] * b.t[1] + a.r[i][2] * b.t[2]) + a.t[i];
  }
  return out;
}

// One (k, b): the first design's statements, in their order. j1, j2 and er
// point at the thread's rows of the output tile (row-major 6 x 6 and 6).
template <typename T>
__device__ __forceinline__ void linearize(const Pose<T>& g1, const Pose<T>& g2, const Pose<T>& gm,
                                          T eps_near_zero, T eps_near_pi, T eps_d_near_zero, T* j1,
                                          T* j2, T* er) {
  const Pose<T> d = compose(inverse(g1), g2);  // v1^{-1} v2
  const Pose<T> c = compose(inverse(gm), d);   // m^{-1} d

  // ---- SO3 log of c.r (lie/so3.py _log_helper) -------------------------
  const T half = T(0.5);
  T sa[3] = {half * (c.r[2][1] - c.r[1][2]), half * (c.r[0][2] - c.r[2][0]),
             half * (c.r[1][0] - c.r[0][1])};
  const T cosine = half * (c.r[0][0] + c.r[1][1] + c.r[2][2] - T(1));
  const T sine = sqrt(sa[0] * sa[0] + sa[1] * sa[1] + sa[2] * sa[2]);
  const T theta = atan2(sine, cosine);
  const bool near_zero = theta < eps_near_zero;
  const bool near_pi = (T(1) + cosine) <= eps_near_pi;
  const T scale = (near_zero || near_pi) ? T(1) + sine * sine / T(6) : theta / sine;
  T w[3];
  if (near_pi) {
    // axis from the row/column of the major diagonal entry
    const T d0 = c.r[0][0], d1 = c.r[1][1], d2 = c.r[2][2];
    const int major = (d1 > d0 && d1 > d2) ? 1 : ((d2 > d0 && d2 > d1) ? 2 : 0);
    T sel[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      sel[j] = half * (c.r[major][j] + c.r[j][major]) - (j == major ? cosine : T(0));
    const T an = sqrt(sel[0] * sel[0] + sel[1] * sel[1] + sel[2] * sel[2]);
    const T sign = sa[major] >= T(0) ? T(1) : T(-1);
#pragma unroll
    for (int j = 0; j < 3; ++j) w[j] = sel[j] / an * (theta * sign);
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) w[j] = sa[j] * scale;
  }

  // ---- SE3 log translation part (lie/se3.py _log_helper) ---------------
  const T theta2 = theta * theta;
  const T sine_theta = sine * theta;
  const T tcm2 = T(2) * cosine - T(2);
  const T tcm2_nz = near_zero ? T(1) : tcm2;
  const T theta2_nz = near_zero ? T(1) : theta2;
  const T a_lin = near_zero ? T(1) - theta2 / T(12) : -sine_theta / tcm2_nz;
  const T b_lin = near_zero ? T(1) / T(12) + theta2 / T(720)
                            : (sine_theta + tcm2) / (theta2_nz * tcm2_nz);
  const T wxt[3] = {w[1] * c.t[2] - w[2] * c.t[1], w[2] * c.t[0] - w[0] * c.t[2],
                    w[0] * c.t[1] - w[1] * c.t[0]};
  const T wt = w[0] * c.t[0] + w[1] * c.t[1] + w[2] * c.t[2];
  T lin[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) lin[i] = a_lin * c.t[i] - half * wxt[i] + b_lin * w[i] * wt;

  // ---- jlog blocks (so3._jlog_from_w, se3.jlog) ------------------------
  const bool dz = theta < eps_d_near_zero;
  const T tcm2_dz = dz ? T(1) : tcm2;
  const T theta2_dz = dz ? T(1) : theta2;
  const T a_rot = dz ? T(1) - theta2 / T(12) : -sine_theta / tcm2_dz;
  const T b_rot = dz ? T(1) / T(12) + theta2 / T(720) : (sine_theta + tcm2) / (theta2_dz * tcm2_dz);
  const T theta_dz = dz ? T(1) : theta;
  const T theta4_nz = theta2_nz * theta2_nz;
  const T c_q = dz ? T(-1) / T(360) - theta2 / T(7560)
                   : -(T(2) * tcm2_nz + sine_theta + theta2) / (theta4_nz * tcm2_nz);
  const T d_q = dz ? T(-1) / T(6) - theta2 / T(180) : (theta - sine) / (theta_dz * tcm2_nz);
  const T e = w[0] * lin[0] + w[1] * lin[1] + w[2] * lin[2];

  const T hw[3][3] = {{T(0), -w[2], w[1]}, {w[2], T(0), -w[0]}, {-w[1], w[0], T(0)}};
  const T hl[3][3] = {{T(0), -lin[2], lin[1]}, {lin[2], T(0), -lin[0]}, {-lin[1], lin[0], T(0)}};
  T jrot[3][3], jq[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      jrot[i][j] = b_rot * w[i] * w[j] + half * hw[i][j] + (i == j ? a_rot : T(0));
      jq[i][j] = c_q * e * w[i] * w[j] + b_rot * w[i] * lin[j] + lin[i] * (b_rot * w[j]) +
                 half * hl[i][j] + (i == j ? e * d_q : T(0));
    }
  }

  // ---- Adj(d^{-1}) = [[R, hat(t) R], [0, R]] and J1 = -J2 Adj -----------
  const Pose<T> di = inverse(d);
  const T ht[3][3] = {{T(0), -di.t[2], di.t[1]}, {di.t[2], T(0), -di.t[0]}, {-di.t[1], di.t[0], T(0)}};
  T htr[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      htr[i][j] = ht[i][0] * di.r[0][j] + ht[i][1] * di.r[1][j] + ht[i][2] * di.r[2][j];

#pragma unroll
  for (int i = 0; i < 3; ++i) {
    er[i] = lin[i];
    er[3 + i] = w[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      // J2 = [[jrot, jq], [0, jrot]]
      j2[6 * i + j] = jrot[i][j];
      j2[6 * i + 3 + j] = jq[i][j];
      j2[6 * (3 + i) + j] = T(0);
      j2[6 * (3 + i) + 3 + j] = jrot[i][j];
      // J2 Adj = [[jrot R, jrot hat(t)R + jq R], [0, jrot R]]
      const T ar = jrot[i][0] * di.r[0][j] + jrot[i][1] * di.r[1][j] + jrot[i][2] * di.r[2][j];
      const T ah = jrot[i][0] * htr[0][j] + jrot[i][1] * htr[1][j] + jrot[i][2] * htr[2][j];
      const T qr = jq[i][0] * di.r[0][j] + jq[i][1] * di.r[1][j] + jq[i][2] * di.r[2][j];
      j1[6 * i + j] = -ar;
      j1[6 * i + 3 + j] = -(ah + qr);
      j1[6 * (3 + i) + j] = T(0);
      j1[6 * (3 + i) + 3 + j] = -ar;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BT_THREADS_MAX)
    between_se3_kernel(const T* __restrict__ v1, const T* __restrict__ v2, const T* __restrict__ meas,
                       long long meas_k_stride, long long meas_b_stride, int K, int B, T eps_near_zero,
                       T eps_near_pi, T eps_d_near_zero, bool vec, T* __restrict__ j1_out,
                       T* __restrict__ j2_out, T* __restrict__ err_out) {
  extern __shared__ __align__(16) unsigned char bt_smem[];
  T* sh = reinterpret_cast<T*>(bt_smem);
  const int nt = blockDim.x;
  const long long base = static_cast<long long>(blockIdx.x) * nt;
  const long long left = static_cast<long long>(K) * B - base;
  const int cnt = left < nt ? static_cast<int>(left) : nt;

  // the block's v1 and v2 tiles (cnt poses of 12 values each)
  T* s1 = sh;
  T* s2 = sh + nt * 12;
  th_stage_tile(s1, v1 + base * 12, cnt * 12, vec);
  th_stage_tile(s2, v2 + base * 12, cnt * 12, vec);
  __pipeline_commit();
  const int t = threadIdx.x;
  const bool mine = t < cnt;
  const long long idx = base + t;
  Pose<T> g1, g2, gm;
  if (mine) {
    const long long k = idx / B;
    const long long b = idx % B;
    load_pose_ro(meas + k * meas_k_stride + b * meas_b_stride, gm);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (mine) {
    load_pose(s1 + t * 12, g1);
    load_pose(s2 + t * 12, g2);
  }
  __syncthreads();  // the input tiles are read before the outputs overwrite them
  if (mine)
    linearize(g1, g2, gm, eps_near_zero, eps_near_pi, eps_d_near_zero, sh + t * BT_JS,
              sh + (nt + t) * BT_JS, sh + 2 * nt * BT_JS + t * BT_ES);
  __syncthreads();
  th_store_tile<T, 36, BT_JS>(sh, j1_out + base * 36, cnt, vec);
  th_store_tile<T, 36, BT_JS>(sh + nt * BT_JS, j2_out + base * 36, cnt, vec);
  th_store_tile<T, 6, BT_ES>(sh + 2 * nt * BT_JS, err_out + base * 6, cnt, vec);
}

// threads and smem from ops/between_se3.py between_geometry; the launcher
// rejects a block size it was not built for and fewer bytes than its tile.
template <typename T>
int launch(const void* v1, const void* v2, const void* meas, long long mks, long long mbs, int K,
           int B, double eps_nz, double eps_np, double eps_dnz, int threads, long long smem, void* j1,
           void* j2, void* err, void* stream) {
  const long long n = static_cast<long long>(K) * B;
  if (n <= 0) return 0;
  if (threads < 32 || threads % 32 || threads > BT_THREADS_MAX ||
      smem < static_cast<long long>(BT_TILE) * threads * static_cast<long long>(sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = ((reinterpret_cast<size_t>(v1) | reinterpret_cast<size_t>(v2) |
                     reinterpret_cast<size_t>(j1) | reinterpret_cast<size_t>(j2) |
                     reinterpret_cast<size_t>(err)) % 16) == 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(between_se3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  between_se3_kernel<T><<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v1), static_cast<const T*>(v2), static_cast<const T*>(meas), mks, mbs,
      K, B, static_cast<T>(eps_nz), static_cast<T>(eps_np), static_cast<T>(eps_dnz), vec,
      static_cast<T*>(j1), static_cast<T*>(j2), static_cast<T*>(err));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

TH_EXPORT int th_between_se3_f32(const void* v1, const void* v2, const void* meas, long long mks,
                                 long long mbs, int K, int B, double eps_nz, double eps_np,
                                 double eps_dnz, int threads, long long smem, void* j1, void* j2,
                                 void* err, void* stream) {
  return launch<float>(v1, v2, meas, mks, mbs, K, B, eps_nz, eps_np, eps_dnz, threads, smem, j1, j2,
                       err, stream);
}

TH_EXPORT int th_between_se3_f64(const void* v1, const void* v2, const void* meas, long long mks,
                                 long long mbs, int K, int B, double eps_nz, double eps_np,
                                 double eps_dnz, int threads, long long smem, void* j1, void* j2,
                                 void* err, void* stream) {
  return launch<double>(v1, v2, meas, mks, mbs, K, B, eps_nz, eps_np, eps_dnz, threads, smem, j1, j2,
                        err, stream);
}

TH_EXPORT const char* th_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
