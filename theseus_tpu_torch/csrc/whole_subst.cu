// Whole forward and backward substitution with the block-sparse factor, one
// launch per sweep.
//
// Replaces the Pallas kernels `_fwd_kernel` and `_bwd_kernel` of
// theseus_tpu/sparse/pallas_whole.py (pallas_calls at :508 and :523, entry
// solve_whole). For every batch element:
//   forward:  y_j = L_jj^{-1} (b[perm[j]] - sum_u L[upd_jk[j,u]] y[upd_k[j,u]])
//   backward: x_j = L_jj^{-T} (y_j - sum_{t>=1} L[col_slots[j,t]]^T x[row_ids[j,t]])
// with y in elimination order and x written back in the original variable
// order, x_orig[perm[j]] = x_j. The permutations are folded into the index
// records, so a solve is two launches and no gathers.
//
// What bounds it on the H100: memory. Each sweep reads L once (14.1 MB in
// float32 at PGO 256 x 128) and the right-hand side, and writes the result:
// ~15.7 MB, 4.7 us at 3.35 TB/s (2.3 us at 2048 x 8); ~2 d^2 flops per
// factor block. In practice the etree levels (13 at 256 poses, 16 at 2048)
// run one after the other, each a short dependent chain.
//
// Both sweeps walk one batch element per block through stages
// (sparse/whole.py `fwd_stages`, `bwd_stages`): a stage is a run of whole
// columns of one etree level, or one piece of a column's list too long for
// the buffer. The factor is complete before the sweep starts, so only the
// vector carries a dependency: each stage's L blocks and vector rows are
// copied into shared memory by cp.async one stage ahead (two buffers; 16
// bytes a copy where a block is a whole number of 16-byte pieces), and the
// stage's index record two stages ahead (three buffers), so device-memory
// latency leaves the level chain. The vector being solved for stays in
// shared memory when it fits beside the buffers (the host decides,
// `FwdPlan` / `BwdPlan`), else in the output in device memory.
//
// Forward design. The TPU forward kernel pushes each column into the rows
// below it (right-looking); two columns of one level can push into the same
// row, so here the forward pulls (each column reads the y_k of its update
// list), which needs no atomics and sums in a fixed order. Per stage:
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
//
// What held the first backward design back (a 128-thread block per batch
// element, one thread per column of a level, a __syncthreads() between
// levels): each thread loaded its column's slots and row ids, then the L
// blocks and the x rows they name, from device memory in series, so every
// level (13 at 256 x 128, 16 at 2048 x 8) paid a chain of dependent memory
// round trips: 11x its bound.
//
// Backward design, the forward's with the column's own rows in place of its
// update list, levels last to first. The first piece of a column stages its
// y row, the last its diagonal block. Per stage:
//   1. d lanes per column, lane jj owning output jj: s = y_j[jj], then
//      s -= L[t][i][jj] x_r[i] over the column's rows t = 1, 2, ... in order,
//      i inner. These are level_subst.cu's backward statements for one
//      output, so the sweep gives the level backward sweep's bits (a padded
//      row there multiplies the zero sentinel block by a zeroed x and leaves
//      s as it is). A piece keeps s in the lane's register until the
//      column's last piece;
//   -- __syncthreads() --
//   2. one thread per column solves L_jj^T x_j = s with the level kernel's
//      statements and writes x_j at its original row;
//   -- wait for the copies, __syncthreads() --
// x is kept in the original order, so the end is one contiguous copy.

#include "common.cuh"

namespace {

// the forward block: at least d x 32 lanes, so that a piece's outputs take
// one pass (scripts/torch_block_sizes.py times 256, 512 and 1024)
constexpr int WFS_THREADS = 512;
static_assert(WFS_THREADS % 32 == 0 && WFS_THREADS >= 8 * 32, "a warp multiple of at least d_max x 32 lanes");
// the backward block: a wide level's d lanes per column take a few passes
// (scripts/torch_block_sizes.py times 128, 256 and 512)
constexpr int WBS_THREADS = 256;
static_assert(WBS_THREADS % 32 == 0 && WBS_THREADS >= 8, "a warp multiple of at least d_max lanes");
constexpr int WS_RECORD_BUFS = 3;  // stage s in use, s + 1 landed, s + 2 in flight
constexpr unsigned WFS_FULL = 0xffffffffu;

__host__ __device__ __forceinline__ size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// the bytes of one stage buffer of buf_vals values (a stage's blocks, then
// its vector rows)
template <typename T>
__host__ __device__ __forceinline__ size_t buf_bytes(int buf_vals) {
  return round16(static_cast<size_t>(buf_vals) * sizeof(T));
}

// Stage table row (sparse/whole.py sweep records): x = record offset, y = nc
// columns, z = nb staged blocks, w = gu | first << 6 | last << 7. Record:
// out[nc] vrow[nc] nu[nc] boff[nc] slot[nb] kk[nb]: the row each column's
// result is written to, the row of the vector it starts from, its blocks in
// this stage (the diagonal block not counted), its first block in the
// buffer; the factor slot of each staged block and the result row each
// multiplies.

// stage s's record into its record buffer
template <int NT>
__device__ __forceinline__ void copy_record(const int4* __restrict__ stages, const int* __restrict__ rec, int s,
                                            int* recs, int stage_ints) {
  const int4 S = __ldg(stages + s);
  const int cnt = 4 * S.y + 2 * S.z;
  int* dst = recs + (s % WS_RECORD_BUFS) * stage_ints;
  for (int i = threadIdx.x; i < cnt; i += NT) __pipeline_memcpy_async(dst + i, rec + S.x + i, sizeof(int));
}

// nb factor blocks L[slot[k]] of the block's batch element into buf
template <typename T, int D, int NT>
__device__ __forceinline__ void copy_blocks(T* buf, const T* lb, long long lstride, const int* slot, int nb,
                                            bool vec) {
  constexpr int DD = D * D;
  // 16-byte pieces of a d x d block, when it is a whole number of them
  constexpr int V = (DD * sizeof(T)) % 16 == 0 ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int CH = DD / V;
  if (vec && V > 1) {
    for (int i = threadIdx.x; i < nb * CH; i += NT) {
      const int k = i / CH;
      const int x = (i - k * CH) * V;
      __pipeline_memcpy_async(buf + k * DD + x, lb + slot[k] * lstride + x, 16);
    }
  } else {
    for (int i = threadIdx.x; i < nb * DD; i += NT) {
      const int k = i / DD;
      const int x = i - k * DD;
      __pipeline_memcpy_async(buf + k * DD + x, lb + slot[k] * lstride + x, sizeof(T));
    }
  }
}

// nc vector rows vb[row[c]] into dst
template <typename T, int D, int NT>
__device__ __forceinline__ void copy_rows(T* dst, const T* vb, long long vstride, const int* row, int nc) {
  for (int i = threadIdx.x; i < nc * D; i += NT)
    __pipeline_memcpy_async(dst + i, vb + row[i / D] * vstride + i % D, sizeof(T));
}

template <typename T, int D, bool SMEM_Y>
__global__ void __launch_bounds__(WFS_THREADS)
    whole_fwd_kernel(const T* __restrict__ lflat, const T* __restrict__ bvec, const int* __restrict__ rec,
                     const int4* __restrict__ stages, int n_stages, int stage_ints, int buf_vals,
                     int n, int B, bool vec, T* y) {
  extern __shared__ __align__(16) unsigned char ws_smem[];
  constexpr int DD = D * D;
  const int b = blockIdx.x;
  const long long lstride = static_cast<long long>(B) * DD;
  const long long vstride = static_cast<long long>(B) * D;
  const T* lb = lflat + static_cast<long long>(b) * DD;
  const T* bb = bvec + static_cast<long long>(b) * D;
  const size_t ybytes = SMEM_Y ? round16(static_cast<size_t>(n) * D * sizeof(T)) : 0;
  const size_t bufvals = buf_bytes<T>(buf_vals) / sizeof(T);
  // the block's y: row r at ybuf + r * ystride
  T* ybuf = SMEM_Y ? reinterpret_cast<T*>(ws_smem) : y + static_cast<long long>(b) * D;
  const long long ystride = SMEM_Y ? D : vstride;
  T* data = reinterpret_cast<T*>(ws_smem + ybytes);                           // 2 stage buffers
  int* recs = reinterpret_cast<int*>(data + 2 * bufvals);                      // record buffers

  // stage s's blocks and (where it holds its columns' last pieces) b rows;
  // its record has landed
  auto copy_data = [&](int s) {
    const int4 S = __ldg(stages + s);
    const int* r = recs + (s % WS_RECORD_BUFS) * stage_ints;
    T* buf = data + (s & 1) * bufvals;
    copy_blocks<T, D, WFS_THREADS>(buf, lb, lstride, r + 4 * S.y, S.z, vec);
    if (S.w & 128) copy_rows<T, D, WFS_THREADS>(buf + S.z * DD, bb, vstride, r + S.y, S.y);
  };

  if (n_stages > 0) {
    copy_record<WFS_THREADS>(stages, rec, 0, recs, stage_ints);
    if (n_stages > 1) copy_record<WFS_THREADS>(stages, rec, 1, recs, stage_ints);
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
    if (s + 2 < n_stages) copy_record<WFS_THREADS>(stages, rec, s + 2, recs, stage_ints);
    __pipeline_commit();

    const int nc = S.y;
    const int gu = S.w & 63;
    const bool first = S.w & 64;
    const bool last = S.w & 128;
    const int* r = recs + (s % WS_RECORD_BUFS) * stage_ints;
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

template <typename T, int D, bool SMEM_X>
__global__ void __launch_bounds__(WBS_THREADS)
    whole_bwd_kernel(const T* __restrict__ lflat, const T* __restrict__ yvec, const int* __restrict__ rec,
                     const int4* __restrict__ stages, int n_stages, int stage_ints, int buf_vals,
                     int n, int B, bool vec, T* x) {
  extern __shared__ __align__(16) unsigned char ws_smem[];
  constexpr int DD = D * D;
  const int b = blockIdx.x;
  const long long lstride = static_cast<long long>(B) * DD;
  const long long vstride = static_cast<long long>(B) * D;
  const T* lb = lflat + static_cast<long long>(b) * DD;
  const T* yb = yvec + static_cast<long long>(b) * D;
  const size_t xbytes = SMEM_X ? round16(static_cast<size_t>(n) * D * sizeof(T)) : 0;
  const size_t bufvals = buf_bytes<T>(buf_vals) / sizeof(T);
  // the block's x in the original order: row r at xbuf + r * xstride
  T* xbuf = SMEM_X ? reinterpret_cast<T*>(ws_smem) : x + static_cast<long long>(b) * D;
  const long long xstride = SMEM_X ? D : vstride;
  T* data = reinterpret_cast<T*>(ws_smem + xbytes);                           // 2 stage buffers
  int* recs = reinterpret_cast<int*>(data + 2 * bufvals);                      // record buffers

  // stage s's blocks and (where it holds its columns' first pieces) y rows;
  // its record has landed
  auto copy_data = [&](int s) {
    const int4 S = __ldg(stages + s);
    const int* r = recs + (s % WS_RECORD_BUFS) * stage_ints;
    T* buf = data + (s & 1) * bufvals;
    copy_blocks<T, D, WBS_THREADS>(buf, lb, lstride, r + 4 * S.y, S.z, vec);
    if (S.w & 64) copy_rows<T, D, WBS_THREADS>(buf + S.z * DD, yb, vstride, r + S.y, S.y);
  };

  if (n_stages > 0) {
    copy_record<WBS_THREADS>(stages, rec, 0, recs, stage_ints);
    if (n_stages > 1) copy_record<WBS_THREADS>(stages, rec, 1, recs, stage_ints);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    copy_data(0);
    __pipeline_commit();
  }

  T carry = T(0);  // a lane's running value; kept across the pieces of one column
  for (int s = 0; s < n_stages; ++s) {
    const int4 S = __ldg(stages + s);
    // stage s's data and record s + 1 have landed; stage s - 1 is done
    __pipeline_wait_prior(0);
    __syncthreads();
    if (s + 1 < n_stages) copy_data(s + 1);
    if (s + 2 < n_stages) copy_record<WBS_THREADS>(stages, rec, s + 2, recs, stage_ints);
    __pipeline_commit();

    const int nc = S.y;
    const bool first = S.w & 64;
    const bool last = S.w & 128;
    const int* r = recs + (s % WS_RECORD_BUFS) * stage_ints;
    const int* out = r;
    const int* nu = r + 2 * nc;
    const int* boff = r + 3 * nc;
    const int* kk = r + 4 * nc + S.z;
    const T* buf = data + (s & 1) * bufvals;
    T* vs = data + (s & 1) * bufvals + S.z * DD;

    // ---- 1. d lanes a column, each over the column's rows in order --------
    for (int o = threadIdx.x; o < nc * D; o += WBS_THREADS) {
      const int ci = o / D;
      const int jj = o - ci * D;
      const int cnt = nu[ci];
      const int bo = boff[ci];
      T acc = first ? vs[o] : carry;
      for (int t = 0; t < cnt; ++t) {
        const T* l = buf + (bo + t) * DD + jj;
        const T* v = xbuf + kk[bo + t] * xstride;
#pragma unroll
        for (int i = 0; i < D; ++i) acc -= l[i * D] * v[i];
      }
      if (last)
        vs[o] = acc;
      else
        carry = acc;
    }
    if (!last) continue;
    __syncthreads();

    // ---- 2. the transposed diagonal solves, one thread a column -----------
    for (int ci = threadIdx.x; ci < nc; ci += WBS_THREADS) {
      const T* l0 = buf + (boff[ci] + nu[ci]) * DD;
      const T* a = vs + ci * D;
      T xo[D];
#pragma unroll
      for (int jj = D - 1; jj >= 0; --jj) {
        T sum = a[jj];
#pragma unroll
        for (int k = jj + 1; k < D; ++k) sum -= l0[k * D + jj] * xo[k];
        xo[jj] = sum / l0[jj * D + jj];
      }
      T* xj = xbuf + out[ci] * xstride;
#pragma unroll
      for (int i = 0; i < D; ++i) xj[i] = xo[i];
    }
  }
  if (SMEM_X) {
    __syncthreads();
    for (int e = threadIdx.x; e < n * D; e += WBS_THREADS)
      x[(e / D) * vstride + static_cast<long long>(b) * D + e % D] = xbuf[e];
  }
}

// One sweep's launch. smem: the bytes the plan (sparse/whole.py FwdPlan,
// BwdPlan) gives the block, with the vector in shared memory when
// vec_smem. A request under the layout, or over what a block may opt into,
// fails.
template <typename T, int D, int NT, typename K>
int sweep_d(K kernel, const void* lflat, const void* v, const int* rec, const int4* stages, int n_stages,
            int stage_ints, int buf_vals, int n, int B, long long smem, void* out, cudaStream_t st,
            bool vec_smem) {
  if (B <= 0 || n <= 0) return 0;
  const size_t need = (vec_smem ? round16(static_cast<size_t>(n) * D * sizeof(T)) : 0) +
                      2 * buf_bytes<T>(buf_vals) + static_cast<size_t>(WS_RECORD_BUFS) * stage_ints * sizeof(int);
  if (smem < 0 || static_cast<size_t>(smem) < need) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<size_t>(lflat) % 16) == 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B, NT, smem, st>>>(static_cast<const T*>(lflat), static_cast<const T*>(v), rec, stages, n_stages,
                              stage_ints, buf_vals, n, B, vec, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int fwd_d(const void* lflat, const void* b, const int* rec, const int4* stages, int n_stages, int stage_ints,
          int buf_vals, int n, int B, bool y_smem, long long smem, void* y, cudaStream_t st) {
  auto kernel = y_smem ? whole_fwd_kernel<T, D, true> : whole_fwd_kernel<T, D, false>;
  return sweep_d<T, D, WFS_THREADS>(kernel, lflat, b, rec, stages, n_stages, stage_ints, buf_vals, n, B, smem,
                                    y, st, y_smem);
}

template <typename T, int D>
int bwd_d(const void* lflat, const void* y, const int* rec, const int4* stages, int n_stages, int stage_ints,
          int buf_vals, int n, int B, bool x_smem, long long smem, void* x, cudaStream_t st) {
  auto kernel = x_smem ? whole_bwd_kernel<T, D, true> : whole_bwd_kernel<T, D, false>;
  return sweep_d<T, D, WBS_THREADS>(kernel, lflat, y, rec, stages, n_stages, stage_ints, buf_vals, n, B, smem,
                                    x, st, x_smem);
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
int bwd(const void* lflat, const void* y, const void* rec, const void* stages, int n_stages,
        int stage_ints, int buf_vals, int n, int B, int d, int x_smem, long long smem, void* x,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TH_WS_BWD(DD)                                                                              \
  bwd_d<T, DD>(lflat, y, static_cast<const int*>(rec), static_cast<const int4*>(stages), n_stages, \
               stage_ints, buf_vals, n, B, x_smem != 0, smem, x, st)
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

TH_EXPORT int th_whole_bwd_subst_f32(const void* lflat, const void* y, const void* rec,
                                     const void* stages, int n_stages, int stage_ints, int buf_vals,
                                     int n, int B, int d, int x_smem, long long smem, void* x,
                                     void* stream) {
  return bwd<float>(lflat, y, rec, stages, n_stages, stage_ints, buf_vals, n, B, d, x_smem, smem, x,
                    stream);
}

TH_EXPORT int th_whole_bwd_subst_f64(const void* lflat, const void* y, const void* rec,
                                     const void* stages, int n_stages, int stage_ints, int buf_vals,
                                     int n, int B, int d, int x_smem, long long smem, void* x,
                                     void* stream) {
  return bwd<double>(lflat, y, rec, stages, n_stages, stage_ints, buf_vals, n, B, d, x_smem, smem, x,
                     stream);
}
