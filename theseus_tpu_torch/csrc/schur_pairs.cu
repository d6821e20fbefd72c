// The Schur complement's pair sum into the reduced camera system S.
//
// Replaces no Pallas kernel: the JAX package sums the pair products with
// jnp in a lax.scan over point chunks (theseus_tpu/optim/schur.py), and so
// did the port in plain torch: every point padded to the most cameras any
// point has, a padded einsum of W_k H_l^T per chunk, its permuted copy,
// then an index_add_ of the valid products. For every camera pair (a, b)
// that shares a point, batch element e and entry (i, m) of the dc x dc
// block:
//   S[e, a dc + i, b dc + m] -= sum over the shared points p of
//                               sum_k W[o(a, p), e, i, k] Hcp[o(b, p), e, m, k]
// with o(c, p) the (camera, point) coupling of camera c and point p, W_o =
// Hcp_o Hpp_p^-1, k over the point's dp dof. S arrives holding Hcc and is
// updated in place.
//
// What bounds it on the H100: memory traffic of scattered blocks. The
// useful work at BAL Dubrovnik-356 (356 cameras of 9 dof, 226,730 points,
// 1,255,268 couplings, float32) is 10.6e6 pair products, 0.52 GFLOP, and W
// and Hcp read once and S written once, 0.31 GB: 0.093 ms at 3.35 TB/s.
// But each pair product reads a W block and an Hcp block of 108 bytes at
// scattered places, and the 271 MB of W and Hcp does not fit the 50 MB L2:
// ~2.3 GB of blocks pass through L2 a launch, a few sectors each.
//
// Design: one thread block per (camera pair, batch element), dc * dc
// threads, each owning one entry (i, m) of the pair's S block. The pairs'
// lists are CSR segments of (W's coupling, Hcp's coupling) int32 pairs
// (optim/schur_pairs.py `pair_table`: ordered by (a, b), then by point, one
// entry per shared point), so no padded product is formed. The block walks
// its segment a chunk of up to 32 entries at a time: the chunk's pairs into
// shared memory, then all its threads copy the chunk's blocks there by
// cp.async (neighbouring threads on neighbouring values), each row padded
// to 16 bytes, and each thread then sums its entry over the chunk, reading
// row i of each W block and row m of each Hcp block as 16-byte loads. Each
// entry is summed from zero over the entries (outer) and k (inner) by fma,
// by the one thread that owns it: no atomics and no second pass, so two
// launches give the same bits. The blocks launch longest segment first
// (the table's `order`): a diagonal block (a, a) sums every point camera a
// sees, ~42 times an off-diagonal one at BAL's counts.
//
// Measured on an H100 80GB HBM3 at 700 W, BAL Dubrovnik-356's table (10.6e6
// entries, float32): 1.91 ms a launch on the device; reading each entry's
// rows straight from device memory through L1, four entries' loads issued
// together, took 2.93 ms, and splitting each segment over two or four
// groups of threads of the block, their sums added in a fixed order,
// 3.1-3.6 ms.
//
// Layout: w, hcp (O, B, dc, dp) contiguous; ptr (n_seg + 1), blk (n_seg,
// 2) (a, b), obs (n_entries, 2), order (n_seg), int32; s (B, C dc, C dc)
// contiguous.

#include "common.cuh"

namespace {

constexpr int SP_CHUNK = 32;                // entries staged at a time, at most (<= the threads)
constexpr int SP_DC_MAX = 32;               // dc * dc threads a block
constexpr size_t SP_SMEM_MAX = 46 * 1024;   // dynamic shared memory: within 48 KB, no opt-in

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

// a block's row of DP values in shared memory, padded to whole 16 bytes
template <typename T, int DP>
__host__ __device__ constexpr int padded_row() {
  return (DP + Vec16<T>::n - 1) / Vec16<T>::n * Vec16<T>::n;
}

// a padded row of shared memory into registers, 16 bytes a load
template <typename T, int PD>
__device__ __forceinline__ void load_row(T (&x)[PD], const T* src) {
  using V = typename Vec16<T>::type;
  constexpr int VN = Vec16<T>::n;
#pragma unroll
  for (int v = 0; v < PD / VN; ++v) {
    union {
      V u;
      T x[VN];
    } r;
    r.u = reinterpret_cast<const V*>(src)[v];
#pragma unroll
    for (int e = 0; e < VN; ++e) x[v * VN + e] = r.x[e];
  }
}

template <typename T, int DP>
__global__ void schur_pairs_kernel(const T* __restrict__ w, const T* __restrict__ hcp,
                                   const int* __restrict__ ptr, const int* __restrict__ blk,
                                   const int2* __restrict__ obs, const int* __restrict__ order, int C, int B,
                                   int DC, int CH, T* __restrict__ s) {
  constexpr int PD = padded_row<T, DP>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sw = reinterpret_cast<T*>(smem);  // the chunk's W blocks, (CH, DC, PD)
  T* sh = sw + CH * DC * PD;           // and its Hcp blocks
  __shared__ int2 sq[SP_CHUNK];
  const int t = threadIdx.x;
  const int e = static_cast<int>(blockIdx.x % B);
  const int seg = order[blockIdx.x / B];
  const int bn = DC * DP;                                  // values of a block
  const long long stride = static_cast<long long>(B) * bn;  // one coupling's (B, dc, dp)
  const T* w_e = w + static_cast<long long>(e) * bn;
  const T* h_e = hcp + static_cast<long long>(e) * bn;
  const bool own = t < DC * DC;
  const int i = own ? t / DC : 0, m = own ? t % DC : 0;
  const int p1 = ptr[seg + 1];
  T acc = T(0);
  for (int c0 = ptr[seg]; c0 < p1; c0 += CH) {
    const int n = min(CH, p1 - c0);
    if (t < n) sq[t] = obs[c0 + t];
    __syncthreads();
    for (int v = t; v < 2 * n * bn; v += blockDim.x) {
      const int hv = v >= n * bn;  // 0: a W value, 1: an Hcp value
      const int r = v - hv * n * bn;
      const int j = r / bn, q = r - j * bn;
      const T* src = hv ? h_e + sq[j].y * stride : w_e + sq[j].x * stride;
      __pipeline_memcpy_async((hv ? sh : sw) + (j * DC + q / DP) * PD + q % DP, src + q, sizeof(T));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (own) {
      for (int j = 0; j < n; ++j) {
        T x[PD], y[PD];
        load_row<T, PD>(x, sw + (j * DC + i) * PD);
        load_row<T, PD>(y, sh + (j * DC + m) * PD);
#pragma unroll
        for (int k = 0; k < DP; ++k) acc = fma(x[k], y[k], acc);
      }
    }
    __syncthreads();  // before the next chunk overwrites the blocks
  }
  if (!own) return;
  const long long cd = static_cast<long long>(C) * DC;
  s[(e * cd + blk[2 * seg] * DC + i) * cd + blk[2 * seg + 1] * DC + m] -= acc;
}

template <typename T, int DP>
int launch_dp(const void* w, const void* hcp, const int* ptr, const int* blk, const void* obs, const int* order,
              int n_seg, int C, int B, int dc, void* s, cudaStream_t stream) {
  if (n_seg <= 0 || B <= 0) return 0;
  const long long blocks = static_cast<long long>(n_seg) * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  // int2 loads of the entry pairs
  if (reinterpret_cast<size_t>(obs) % sizeof(int2) != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const int threads = (dc * dc + 31) / 32 * 32;  // >= SP_CHUNK: one thread a staged pair
  const size_t chunk_bytes = 2 * static_cast<size_t>(dc) * padded_row<T, DP>() * sizeof(T);
  const size_t fit = SP_SMEM_MAX / chunk_bytes;
  const int chunk = fit < static_cast<size_t>(SP_CHUNK) ? static_cast<int>(fit) : SP_CHUNK;
  schur_pairs_kernel<T, DP><<<static_cast<unsigned>(blocks), threads, chunk * chunk_bytes, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(hcp), ptr, blk, static_cast<const int2*>(obs), order, C, B,
      dc, chunk, static_cast<T*>(s));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* w, const void* hcp, const void* ptr, const void* blk, const void* obs, const void* order,
           int n_seg, int C, int B, int dc, int dp, void* s, void* stream) {
  if (dc < 1 || dc > SP_DC_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pp = static_cast<const int*>(ptr);
  const int* bk = static_cast<const int*>(blk);
  const int* od = static_cast<const int*>(order);
#define TH_SP_CASE(DD) \
  case DD:             \
    return launch_dp<T, DD>(w, hcp, pp, bk, obs, od, n_seg, C, B, dc, s, st);
  switch (dp) {
    TH_SP_CASE(1)
    TH_SP_CASE(2)
    TH_SP_CASE(3)
    TH_SP_CASE(4)
    TH_SP_CASE(5)
    TH_SP_CASE(6)
    TH_SP_CASE(7)
    TH_SP_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TH_SP_CASE
}

}  // namespace

TH_EXPORT int th_schur_pairs_f32(const void* w, const void* hcp, const void* ptr, const void* blk, const void* obs,
                                 const void* order, int n_seg, int C, int B, int dc, int dp, void* s, void* stream) {
  return launch<float>(w, hcp, ptr, blk, obs, order, n_seg, C, B, dc, dp, s, stream);
}

TH_EXPORT int th_schur_pairs_f64(const void* w, const void* hcp, const void* ptr, const void* blk, const void* obs,
                                 const void* order, int n_seg, int C, int B, int dc, int dp, void* s, void* stream) {
  return launch<double>(w, hcp, ptr, blk, obs, order, n_seg, C, B, dc, dp, s, stream);
}
