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
// What bounds it on the H100: memory. Each sweep reads L once (14.1 MB in
// float32 at PGO 256 x 128) and the right-hand side, and writes the result:
// ~15.7 MB, 4.7 us at 3.35 TB/s; ~2 d^2 flops per factor block. In practice
// the etree levels (13 at 256 poses) run one after the other, each a short
// dependent chain.
//
// Forward design. A block of WFS_THREADS owns one batch element and walks
// the stages of the sweep (sparse/whole.py `fwd_stages`): a stage is a run
// of columns of one etree level, or one piece of a column's update list too
// long for the buffer. The TPU forward kernel pushes each column into the rows below it
// (right-looking); two columns of one level can push into the same row, so
// here the forward pulls (each column reads the y_k of its update list),
// which needs no atomics and sums in a fixed order. The factor is complete
// before the sweep starts, so only y carries a dependency: each stage's L
// blocks (its columns' update blocks and diagonal blocks) and b rows are
// copied into shared memory by cp.async one stage ahead (two buffers; 16
// bytes a copy where a block is a whole number of 16-byte pieces), and the
// stage's index record two stages ahead (three buffers), so device-memory
// latency leaves the level chain. Per stage:
//   1. gu lanes per output (column, row i), gu the level's `update_lanes`
//      (the level plan's rule): lane g sums L[u][i][:] y[u] over u = g,
//      g + gu, ... with j inner, and a fixed __shfl_down_sync tree adds the
//      partials; acc = b - sum. These are level_subst.cu's forward
//      statements in its order, so the sweep gives the level forward
//      sweep's bits. A piece of a long list keeps each lane's partial in a
//      register until the column's last piece (pieces are a multiple of gu
//      updates, so each lane keeps its order);
//   -- __syncthreads() --
//   2. one thread per column solves L_jj y_j = acc with the level kernel's
//      statements and writes y_j;
//   -- wait for the copies, __syncthreads() --
// y stays in shared memory when it fits beside the buffers (the host
// decides, `FwdPlan`), else in the output in device memory.
//
// Backward design (the first one). A block per batch element walks the
// levels last to first, one thread per column of the level and a
// __syncthreads() between levels, the block's x in shared memory when it
// fits in 200 KB, else in the output.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int WS_THREADS = 128;
constexpr size_t WS_SMEM_MAX = 200 * 1024;
// the forward block: at least d x 32 lanes, so that a piece's outputs take
// one pass (scripts/torch_block_sizes.py times 256, 512 and 1024)
constexpr int WFS_THREADS = 512;
static_assert(WFS_THREADS % 32 == 0 && WFS_THREADS >= 8 * 32, "a warp multiple of at least d_max x 32 lanes");
constexpr int WFS_RECORD_BUFS = 3;  // stage s in use, s + 1 landed, s + 2 in flight
constexpr unsigned WFS_FULL = 0xffffffffu;

__host__ __device__ __forceinline__ size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// the bytes of one stage buffer of buf_vals values (a stage's blocks, then
// its b rows)
template <typename T>
__host__ __device__ __forceinline__ size_t fwd_buf_bytes(int buf_vals) {
  return round16(static_cast<size_t>(buf_vals) * sizeof(T));
}

// Stage table row (sparse/whole.py fwd_records): x = record offset, y = nc
// columns, z = nb staged blocks, w = gu | first << 6 | last << 7. Record:
// col[nc] brow[nc] nu[nc] boff[nc] slot[nb] kk[nb].
template <typename T, int D, bool SMEM_Y>
__global__ void __launch_bounds__(WFS_THREADS)
    whole_fwd_kernel(const T* __restrict__ lflat, const T* __restrict__ bvec, const int* __restrict__ rec,
                     const int4* __restrict__ stages, int n_stages, int stage_ints, int buf_vals,
                     int n, int B, bool vec, T* y) {
  extern __shared__ __align__(16) unsigned char ws_smem[];
  constexpr int DD = D * D;
  // 16-byte pieces of a d x d block, when it is a whole number of them
  constexpr int V = (DD * sizeof(T)) % 16 == 0 ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int CH = DD / V;
  const int b = blockIdx.x;
  const long long lstride = static_cast<long long>(B) * DD;
  const long long vstride = static_cast<long long>(B) * D;
  const T* lb = lflat + static_cast<long long>(b) * DD;
  const T* bb = bvec + static_cast<long long>(b) * D;
  const size_t ybytes = SMEM_Y ? round16(static_cast<size_t>(n) * D * sizeof(T)) : 0;
  const size_t bufvals = fwd_buf_bytes<T>(buf_vals) / sizeof(T);
  // the block's y: row r at ybuf + r * ystride
  T* ybuf = SMEM_Y ? reinterpret_cast<T*>(ws_smem) : y + static_cast<long long>(b) * D;
  const long long ystride = SMEM_Y ? D : vstride;
  T* data = reinterpret_cast<T*>(ws_smem + ybytes);                           // 2 stage buffers
  int* recs = reinterpret_cast<int*>(data + 2 * bufvals);                      // record buffers

  auto copy_record = [&](int s) {
    const int4 S = __ldg(stages + s);
    const int cnt = 4 * S.y + 2 * S.z;
    int* dst = recs + (s % WFS_RECORD_BUFS) * stage_ints;
    for (int i = threadIdx.x; i < cnt; i += WFS_THREADS)
      __pipeline_memcpy_async(dst + i, rec + S.x + i, sizeof(int));
  };
  // stage s's blocks and (where it holds its columns' last pieces) b rows;
  // its record has landed
  auto copy_data = [&](int s) {
    const int4 S = __ldg(stages + s);
    const int* r = recs + (s % WFS_RECORD_BUFS) * stage_ints;
    const int* brow = r + S.y;
    const int* slot = r + 4 * S.y;
    T* buf = data + (s & 1) * bufvals;
    if (vec && V > 1) {
      for (int i = threadIdx.x; i < S.z * CH; i += WFS_THREADS) {
        const int k = i / CH;
        const int x = (i - k * CH) * V;
        __pipeline_memcpy_async(buf + k * DD + x, lb + slot[k] * lstride + x, 16);
      }
    } else {
      for (int i = threadIdx.x; i < S.z * DD; i += WFS_THREADS) {
        const int k = i / DD;
        const int x = i - k * DD;
        __pipeline_memcpy_async(buf + k * DD + x, lb + slot[k] * lstride + x, sizeof(T));
      }
    }
    if (S.w & 128) {
      T* bs = buf + S.z * DD;
      for (int i = threadIdx.x; i < S.y * D; i += WFS_THREADS)
        __pipeline_memcpy_async(bs + i, bb + brow[i / D] * vstride + i % D, sizeof(T));
    }
  };

  if (n_stages > 0) {
    copy_record(0);
    if (n_stages > 1) copy_record(1);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    copy_data(0);
    __pipeline_commit();
  }

  T part = T(0);  // a lane's partial; kept across the pieces of one column
  for (int s = 0; s < n_stages; ++s) {
    const int4 S = __ldg(stages + s);
    // stage s's data and record s + 1 have landed; stage s - 1 is done
    __pipeline_wait_prior(0);
    __syncthreads();
    if (s + 1 < n_stages) copy_data(s + 1);
    if (s + 2 < n_stages) copy_record(s + 2);
    __pipeline_commit();

    const int nc = S.y;
    const int gu = S.w & 63;
    const bool first = S.w & 64;
    const bool last = S.w & 128;
    const int* r = recs + (s % WFS_RECORD_BUFS) * stage_ints;
    const int* col = r;
    const int* nu = r + 2 * nc;
    const int* boff = r + 3 * nc;
    const int* kk = r + 4 * nc + S.z;
    const T* buf = data + (s & 1) * bufvals;
    T* bs = data + (s & 1) * bufvals + S.z * DD;

    // ---- 1. partial sums, gu lanes an output, and the tree ----------------
    const int g = threadIdx.x % gu;
    const int per_pass = WFS_THREADS / gu;
    const int nout = nc * D;
    for (int o0 = 0; o0 < nout; o0 += per_pass) {  // uniform: every lane takes the shuffles
      const int o = o0 + threadIdx.x / gu;
      const bool mine = o < nout;
      if (first) part = T(0);
      if (mine) {
        const int ci = o / D;
        const int i = o - ci * D;
        const int cnt = nu[ci];
        const int bo = boff[ci];
        for (int u = g; u < cnt; u += gu) {
          const T* l = buf + (bo + u) * DD + i * D;
          const T* v = ybuf + kk[bo + u] * ystride;
#pragma unroll
          for (int j = 0; j < D; ++j) part += l[j] * v[j];
        }
      }
      if (last) {
        // lane g += lane g + off, off = gu / 2, gu / 4, ..., 1
        for (int off = gu >> 1; off > 0; off >>= 1) part += __shfl_down_sync(WFS_FULL, part, off, gu);
        if (mine && g == 0) bs[o] -= part;
      }
    }
    if (!last) continue;
    __syncthreads();

    // ---- 2. the diagonal solves, one thread a column ------------------------
    for (int ci = threadIdx.x; ci < nc; ci += WFS_THREADS) {
      const T* ld = buf + (boff[ci] + nu[ci]) * DD;
      const T* a = bs + ci * D;
      T out[D];
#pragma unroll
      for (int rr = 0; rr < D; ++rr) {
        T sum = a[rr];
#pragma unroll
        for (int k = 0; k < rr; ++k) sum -= ld[rr * D + k] * out[k];
        out[rr] = sum / ld[rr * D + rr];
      }
      T* yj = ybuf + col[ci] * ystride;
#pragma unroll
      for (int rr = 0; rr < D; ++rr) yj[rr] = out[rr];
    }
  }
  if (SMEM_Y) {
    __syncthreads();
    for (int e = threadIdx.x; e < n * D; e += WFS_THREADS)
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

// Shared memory for the backward block's vector, or 0 when it stays in device memory.
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

// smem: the bytes the plan (sparse/whole.py FwdPlan) gives the block, with y
// in shared memory when y_smem. A request under the layout, or over what a
// block may opt into, fails.
template <typename T, int D>
int fwd_d(const void* lflat, const void* b, const int* rec, const int4* stages, int n_stages,
          int stage_ints, int buf_vals, int n, int B, bool y_smem, long long smem, void* y,
          cudaStream_t st) {
  if (B <= 0 || n <= 0) return 0;
  const size_t need = (y_smem ? round16(static_cast<size_t>(n) * D * sizeof(T)) : 0) +
                      2 * fwd_buf_bytes<T>(buf_vals) +
                      static_cast<size_t>(WFS_RECORD_BUFS) * stage_ints * sizeof(int);
  if (smem < 0 || static_cast<size_t>(smem) < need) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<size_t>(lflat) % 16) == 0;
  auto kernel = y_smem ? whole_fwd_kernel<T, D, true> : whole_fwd_kernel<T, D, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B, WFS_THREADS, smem, st>>>(static_cast<const T*>(lflat), static_cast<const T*>(b), rec, stages,
                                   n_stages, stage_ints, buf_vals, n, B, vec, static_cast<T*>(y));
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
int fwd(const void* lflat, const void* b, const void* rec, const void* stages, int n_stages,
        int stage_ints, int buf_vals, int n, int B, int d, int y_smem, long long smem, void* y,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TH_WS_FWD(DD)                                                                              \
  fwd_d<T, DD>(lflat, b, static_cast<const int*>(rec), static_cast<const int4*>(stages), n_stages, \
               stage_ints, buf_vals, n, B, y_smem != 0, smem, y, st)
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

TH_EXPORT int th_whole_fwd_subst_f32(const void* lflat, const void* b, const void* rec,
                                     const void* stages, int n_stages, int stage_ints, int buf_vals,
                                     int n, int B, int d, int y_smem, long long smem, void* y,
                                     void* stream) {
  return fwd<float>(lflat, b, rec, stages, n_stages, stage_ints, buf_vals, n, B, d, y_smem, smem, y,
                    stream);
}

TH_EXPORT int th_whole_fwd_subst_f64(const void* lflat, const void* b, const void* rec,
                                     const void* stages, int n_stages, int stage_ints, int buf_vals,
                                     int n, int B, int d, int y_smem, long long smem, void* y,
                                     void* stream) {
  return fwd<double>(lflat, b, rec, stages, n_stages, stage_ints, buf_vals, n, B, d, y_smem, smem, y,
                     stream);
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
