// The dense trailing supernode's external left-looking update.
//
// Replaces no Pallas kernel: the JAX package computes the tail's update with
// jnp (theseus_tpu/sparse/cholesky.py `_tail_*`), and so did the port in
// plain torch (sparse/level_kernels.py `tail_update_plain`, kept as the
// twin): a gather of every (column, update, row) block product the padded
// tables name, a permuted copy of it and a batched GEMM, then the dense
// matrix built from the blocks. For every tail column j, row r >= j and
// batch element b:
//   C[j, r] = A[j, r] - sum_k L[r, k] L[j, k]^T
// over the head columns k whose blocks L[r, k] and L[j, k] both exist, and
// the symmetric dense (B, K d, K d) that the tail's POTRF
// (torch.linalg.cholesky_ex) takes is written: C[j, r] at block (r, j) and
// its transpose at block (j, r) for r > j, 0.5 (C + C^T) on the diagonal.
//
// What bounds it on the H100: bytes. At the sphere2500-shaped graph (K =
// 123, d = 6, B = 64, float32) the distinct data is ~0.23 GB: the dense
// matrix written (0.14 GB), the 9,661 head-to-tail L blocks and A's tail
// blocks read, 0.07 ms at 3.35 TB/s; its 124,956 pairs are 3.45 GFLOP
// (0.05 ms at 67 TFLOP/s). The padded tables the twin gathers name
// 2,450,898 block products a batch element, 22.6 GB at that shape: the
// kernel reads only the pairs of two nonzero blocks, listed once per
// schedule (sparse/cholesky.py NumericSchedule: tail_out, tail_pair_ptr,
// tail_pairs).
//
// Design: one warp per (output block, tile of 32 batch elements), one lane
// per batch element, owning that element's d x d entries of the block. All
// lanes of a warp walk the same pair list in list order, so no lane
// diverges, and each entry is summed over the pairs (outer) and k (inner)
// from zero by the one thread that owns it: no atomics, no second pass, so
// two launches give the same bits. A pair's blocks are (B, d, d) slabs in
// the factor, so the warp's 32 blocks of each are one contiguous run: the
// warp copies both runs into its shared memory by cp.async, coalesced (16
// bytes a copy where aligned), and each lane then reads its own blocks
// there. The registers hold the sums, L[j, k] and one row of L[r, k]. A's
// block is staged the same way. The output rows are runs of d entries,
// stored two at a time where d is even.
//
// Measured on an H100 80GB HBM3 at 700 W, sphere2500 shape, back to back:
// 0.71 ms a launch in float32, 0.97 in float64 (the twin's gather, copy and
// GEMM took 72.8 ms). Of the 0.71 ms about 0.31 is the stores: a warp's
// store lands in 32 matrices, each a run of d values, a partial sector
// that other warps complete; the rest is the pair slabs' 2.3 GB through L2.
// Reading the blocks from device memory without staging (lanes a block
// apart, 32 lines a load) took 1.09 ms.
//
// Layout: ata (n_slots, B, d, d), lflat (nnz_l + 1, B, d, d), out_tab
// (n_out, 4) int32 (j, r, AtA slot, transpose flag), pair_ptr (n_out + 1),
// pairs (n_pairs, 2) (slot of L[r, k], slot of L[j, k]); dense (B, K d, K d).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TU_LANES = 32;
constexpr int TU_WARPS_MAX = 4;
constexpr size_t TU_SMEM_MAX = 48 * 1024;  // static shared memory, no opt-in

// warps a block: as many (up to 4) as fit two staged slabs each
template <typename T, int D>
__host__ __device__ constexpr int warps_of() {
  constexpr size_t per_warp = 2 * TU_LANES * D * D * sizeof(T);
  return TU_SMEM_MAX / per_warp >= TU_WARPS_MAX ? TU_WARPS_MAX : static_cast<int>(TU_SMEM_MAX / per_warp);
}

template <typename T>
using Pair = typename std::conditional<sizeof(T) == 4, float2, double2>::type;

// n values from device memory into shared memory by the warp's lanes, by
// cp.async: 16 bytes a copy when vec (both ends 16-byte aligned), single
// values for the rest
template <typename T>
__device__ __forceinline__ void stage_warp(T* dst, const T* src, int n, bool vec, int lane) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  int done = 0;
  if (vec) {
    const int nv = n / V;
    for (int v = lane; v < nv; v += TU_LANES) __pipeline_memcpy_async(dst + v * V, src + v * V, 16);
    done = nv * V;
  }
  for (int e = done + lane; e < n; e += TU_LANES) __pipeline_memcpy_async(dst + e, src + e, sizeof(T));
  __pipeline_commit();
}

// N contiguous values of shared memory into registers: 16 bytes a load
// when N values are a multiple of 16 bytes (the run is then 16-byte
// aligned), else two values a load when N is even, else one
template <typename T, int N>
__device__ __forceinline__ void load_run(T (&dst)[N], const T* src) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int V = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int v = 0; v < N / V; ++v) {
      union {
        uint4 u;
        T x[V];
      } w;
      w.u = reinterpret_cast<const uint4*>(src)[v];
#pragma unroll
      for (int e = 0; e < V; ++e) dst[v * V + e] = w.x[e];
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const Pair<T> w = reinterpret_cast<const Pair<T>*>(src)[e];
      dst[2 * e] = w.x;
      dst[2 * e + 1] = w.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = src[e];
  }
}

// a run of N values into device memory: two a store when N is even (the
// run then starts at an even element of an aligned matrix), else one
template <typename T, int N>
__device__ __forceinline__ void store_run(T* dst, const T (&v)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      Pair<T> w;
      w.x = v[2 * e];
      w.y = v[2 * e + 1];
      reinterpret_cast<Pair<T>*>(dst)[e] = w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = v[e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(TU_WARPS_MAX * TU_LANES)
    tail_update_kernel(const T* __restrict__ ata, const T* __restrict__ lflat,
                       const int* __restrict__ out_tab, const int* __restrict__ pair_ptr,
                       const int* __restrict__ pairs, int n_out, int K, int B, bool vec, T* __restrict__ dense) {
  constexpr int DD = D * D;
  constexpr int SLAB = TU_LANES * DD;  // a warp's 32 blocks of one slot
  constexpr int WARPS = warps_of<T, D>();
  __shared__ __align__(16) T sbuf[WARPS * 2 * SLAB];
  const int warp = threadIdx.x / TU_LANES, lane = threadIdx.x % TU_LANES;
  const int nbt = (B + TU_LANES - 1) / TU_LANES;
  const long long item = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (item >= static_cast<long long>(n_out) * nbt) return;  // the whole warp
  // batch tile slowest: the warps in flight share a tile's slabs in L2
  const int o = static_cast<int>(item % n_out);
  const int b0 = static_cast<int>(item / n_out) * TU_LANES;
  const int tb = min(TU_LANES, B - b0);
  const bool live = lane < tb;
  T* sr = sbuf + warp * 2 * SLAB;  // L[r, k], later A
  T* sj = sr + SLAB;               // L[j, k]

  const long long slab = static_cast<long long>(B) * DD;  // one slot's (B, d, d)
  const long long tile = static_cast<long long>(b0) * DD;
  const int n = tb * DD;
  T acc[DD];
#pragma unroll
  for (int e = 0; e < DD; ++e) acc[e] = T(0);
  const int p1 = pair_ptr[o + 1];
  for (int p = pair_ptr[o]; p < p1; ++p) {
    stage_warp(sr, lflat + pairs[2 * p] * slab + tile, n, vec, lane);
    stage_warp(sj, lflat + pairs[2 * p + 1] * slab + tile, n, vec, lane);
    __pipeline_wait_prior(0);
    __syncwarp();
    if (live) {
      T lj[DD];
      load_run<T, DD>(lj, sj + lane * DD);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        T row[D];
        load_run<T, D>(row, sr + lane * DD + i * D);
#pragma unroll
        for (int m = 0; m < D; ++m) {
          T s = acc[i * D + m];
#pragma unroll
          for (int k = 0; k < D; ++k) s += row[k] * lj[m * D + k];
          acc[i * D + m] = s;
        }
      }
    }
    __syncwarp();  // before the next pair overwrites the slabs
  }

  const int j = out_tab[4 * o], r = out_tab[4 * o + 1];
  const bool tr = out_tab[4 * o + 3] != 0;
  stage_warp(sr, ata + out_tab[4 * o + 2] * slab + tile, n, vec, lane);
  __pipeline_wait_prior(0);
  __syncwarp();
  if (!live) return;
  T a[DD];
  load_run<T, DD>(a, sr + lane * DD);
  // C = A - acc in place (A read transposed where the pattern stores A[r, j])
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int m = 0; m < D; ++m) acc[i * D + m] = (tr ? a[m * D + i] : a[i * D + m]) - acc[i * D + m];

  const long long kd = static_cast<long long>(K) * D;
  T* mat = dense + static_cast<long long>(b0 + lane) * kd * kd;
  T run[D];
  if (j == r) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int m = 0; m < D; ++m) run[m] = T(0.5) * (acc[i * D + m] + acc[m * D + i]);
      store_run<T, D>(mat + (static_cast<long long>(r) * D + i) * kd + j * D, run);
    }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int m = 0; m < D; ++m) run[m] = acc[i * D + m];
      store_run<T, D>(mat + (static_cast<long long>(r) * D + i) * kd + j * D, run);
    }
#pragma unroll
    for (int m = 0; m < D; ++m) {
#pragma unroll
      for (int i = 0; i < D; ++i) run[i] = acc[i * D + m];
      store_run<T, D>(mat + (static_cast<long long>(j) * D + m) * kd + r * D, run);
    }
  }
}

template <typename T, int D>
int launch_d(const void* ata, const void* lflat, const int* out_tab, const int* pair_ptr, const int* pairs,
             int n_out, int K, int B, void* dense, cudaStream_t stream) {
  if (n_out <= 0 || B <= 0) return 0;
  constexpr int WARPS = warps_of<T, D>();
  const long long items = static_cast<long long>(n_out) * ((B + TU_LANES - 1) / TU_LANES);
  const long long blocks = (items + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the stores write pairs of values from even elements: the matrix must
  // be aligned to two of them (a fresh allocation is)
  if (D % 2 == 0 && reinterpret_cast<size_t>(dense) % (2 * sizeof(T)) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // 16-byte copies: every staged run starts at a multiple of B d^2 (a slot)
  // plus 32 d^2 (a tile) values from the base
  const bool vec = (static_cast<size_t>(B) * D * D * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<size_t>(ata) | reinterpret_cast<size_t>(lflat)) % 16 == 0;
  tail_update_kernel<T, D><<<static_cast<unsigned>(blocks), WARPS * TU_LANES, 0, stream>>>(
      static_cast<const T*>(ata), static_cast<const T*>(lflat), out_tab, pair_ptr, pairs, n_out, K, B, vec,
      static_cast<T*>(dense));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* ata, const void* lflat, const void* out_tab, const void* pair_ptr, const void* pairs,
           int n_out, int K, int B, int d, void* dense, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ot = static_cast<const int*>(out_tab);
  const int* pp = static_cast<const int*>(pair_ptr);
  const int* pr = static_cast<const int*>(pairs);
#define TH_TU_CASE(DD) \
  case DD:             \
    return launch_d<T, DD>(ata, lflat, ot, pp, pr, n_out, K, B, dense, st);
  switch (d) {
    TH_TU_CASE(1)
    TH_TU_CASE(2)
    TH_TU_CASE(3)
    TH_TU_CASE(4)
    TH_TU_CASE(5)
    TH_TU_CASE(6)
    TH_TU_CASE(7)
    TH_TU_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TH_TU_CASE
}

}  // namespace

TH_EXPORT int th_tail_update_f32(const void* ata, const void* lflat, const void* out_tab, const void* pair_ptr,
                                 const void* pairs, int n_out, int K, int B, int d, void* dense, void* stream) {
  return launch<float>(ata, lflat, out_tab, pair_ptr, pairs, n_out, K, B, d, dense, stream);
}

TH_EXPORT int th_tail_update_f64(const void* ata, const void* lflat, const void* out_tab, const void* pair_ptr,
                                 const void* pairs, int n_out, int K, int B, int d, void* dense, void* stream) {
  return launch<double>(ata, lflat, out_tab, pair_ptr, pairs, n_out, K, B, d, dense, stream);
}
