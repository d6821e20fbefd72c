// Whole left-looking block Cholesky in one launch.
//
// Replaces the Pallas kernel `_fact_kernel` of
// theseus_tpu/sparse/pallas_whole.py (pallas_call at :319, entry
// factorize_whole). For every head column j and batch element b:
//   C_t    = A[a_src[j, t]] (transposed where a_tr) - sum_u L[upd_slots[j,u,t]] L[upd_jk[j,u]]^T
//   L_jj   = chol(0.5 (C_0 + C_0^T))                      (POTRF, d x d)
//   L_tj   = C_t L_jj^{-T}, t = 1 .. col_len[j]-1          (TRSM)
// written to the factor slots col_slots[j, t]; slot 0 of the factor is the
// zero sentinel that absent update rows read. A non-positive pivot gives
// sqrt of a negative number, i.e. NaN, which is not clamped (no fast
// reciprocal either): LM detects a failed solve through non-finite deltas,
// as on the level path.
//
// What bounds it on the H100: memory in principle. At PGO 256 poses x batch
// 128 in float32 it must read AtA (9.47 MB) and write L (14.1 MB): 7.0 us at
// 3.35 TB/s; the updates are ~84 MFLOP, 1.3 us at 67 TFLOP/s. In practice
// latency: the elimination-tree levels (13 at 256 poses) run one after the
// other, and inside a level each column's work is a chain (the update list,
// then the POTRF's d pivots, then the TRSM).
//
// What held the first design back (one 256-thread block per batch element,
// the factor in device memory, one thread per column for the POTRF, 3
// barriers per level): every phase re-read the factor from L1/L2 and loaded
// an index before each data load; 8 warps an SM hid none of that latency;
// and one thread ran each column's chain of d square roots and divisions,
// then the TRSM's chain of d divisions, while the block waited.
//
// Design. Batch elements are independent, so a block of WF_THREADS owns one
// batch element and walks the levels inside the kernel (on the TPU the grid
// ran the columns in order; blocks on Hopper run in no order). Per level:
//   1. one thread per (column, row t, entry pair {(a, b), (b, a)}) forms
//      both entries of C_t: each update list summed u outer and k inner from
//      zero, then A - s, the order of the level kernel (level_factor.cu), so
//      both give the same bits; written in place into the column's own
//      factor slot. The pair reads both A entries before it writes, so A can
//      sit in the slot untransposed;
//   -- __syncthreads() --
//   2. a group of G lanes of one warp per column (G = 8, 16 or 32, the
//      power of two at or above d times the column's rows below the
//      diagonal, so 16 and two columns a warp at 256 poses): lane r < d
//      owns row r of the POTRF, and lane q one TRSM item (row t = 1 + q / d,
//      entry row a = q % d). At pivot step jj every lane receives row jj of
//      L_jj by __shfl_sync and forms the pivot sqrt(s) and its reciprocal
//      itself (the same statements on the same values: the same bits on
//      every lane, and no branch or broadcast on the chain); the POTRF
//      lanes then form column jj, the TRSM lanes x[jj] by a division by the
//      pivot, so the TRSM ends one step after the POTRF. Each value is
//      formed by the level kernel's statements in their order. Items
//      beyond 32 lanes (a column of 7 or more rows at d = 6) run their
//      TRSM afterwards from L_jj in memory, by the same statements;
//   -- wait for the prefetches, __syncthreads() --
// two barriers per level, not three.
//
// SMEM (a template flag): the block keeps its batch element's whole factor
// ((nnz_l + 1) d^2 values: 110,304 bytes in float32 and 220,608 in float64
// at 256 poses) in shared memory while it is built, so every phase reads
// and writes shared memory, and stores it to `lflat` at the end in 16-byte
// pieces. It also holds the level table, and each level's index record
// (below) is staged in shared memory by cp.async two levels ahead (three
// buffers), and each level's AtA blocks are copied by cp.async (16 bytes a
// copy), one level ahead, straight into the factor slots they start. The
// caller picks the variant (sparse/whole.py `whole_factor_smem_bytes`
// against its budget) and passes the shared-memory bytes, 0 for the other
// variant: where the factor does not fit (2048 poses: 884,448 bytes in
// float32), the same kernel keeps the factor in device memory and reads
// the records and AtA from device memory.
//
// Records (sparse/whole.py `factor_records`): one per level, ints, with nc
// columns, rl rows and ul updates a column (the level's maxima):
//   col_len[nc] ucount[nc] col_slots[nc][rl] a_code[nc][rl] (a_src * 2 + a_tr)
//   upd_jk[nc][ul] upd_slots[nc][ul][rl]
// and `lvl` (n_levels, 4) = (offset, nc, rl, ul). A padded row has slot 0.
//
// Layout: AoS ata (n_slots, B, d, d), lflat (nnz_l+1, B, d, d).

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int WF_THREADS = 1024;
constexpr int WF_STAGES = 3;  // record buffers: level lv in use, lv + 1 landed, lv + 2 in flight
constexpr unsigned WF_FULL = 0xffffffffu;

struct Record {
  const int *len, *uc, *cs, *ac, *jk, *us;
  int nc, rl, ul;
};

__device__ __forceinline__ Record record_at(const int* r, int4 lv) {
  Record R;
  R.nc = lv.y;
  R.rl = lv.z;
  R.ul = lv.w;
  R.len = r;
  R.uc = r + R.nc;
  R.cs = R.uc + R.nc;
  R.ac = R.cs + R.nc * R.rl;
  R.jk = R.ac + R.nc * R.rl;
  R.us = R.jk + R.nc * R.ul;
  return R;
}

__device__ __forceinline__ int record_ints(int4 lv) {
  return lv.y * (2 + 2 * lv.z + lv.w + lv.w * lv.z);
}

// a row of d values; in float32 in 8-byte loads when d is even (a row then
// starts an even number of values into a block). float64 keeps scalar loads:
// its wider loads cost more in registers than they save.
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* p, T (&v)[D]) {
  if constexpr (D % 2 == 0 && sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < D; k += 2) {
      const float2 w = *reinterpret_cast<const float2*>(p + k);
      v[k] = w.x;
      v[k + 1] = w.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = p[k];
  }
}

template <typename T, int D, bool SMEM>
__global__ void __launch_bounds__(WF_THREADS, 1)
    whole_factor_kernel(const T* __restrict__ ata, const int* __restrict__ rec,
                        const int4* __restrict__ lvl, int n_levels, int n_lslots, int stage_ints,
                        int B, bool vec, T* lflat) {
  constexpr int DD = D * D;
  constexpr int NP = D * (D + 1) / 2;  // entry pairs (a, b), a <= b
  // 16-byte pieces of a d x d block, when it is a whole number of them
  constexpr int V = (DD * sizeof(T)) % 16 == 0 ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int CH = DD / V;
  extern __shared__ __align__(16) unsigned char wf_smem[];
  const int b = blockIdx.x;
  const long long bstride = static_cast<long long>(B) * DD;  // slot stride in device memory
  const T* ab = ata + static_cast<long long>(b) * DD;
  T* lg = lflat + static_cast<long long>(b) * DD;
  T* fs = reinterpret_cast<T*>(wf_smem);
  const size_t fbytes = (static_cast<size_t>(n_lslots) * DD * sizeof(T) + 15) / 16 * 16;
  int4* lvs = reinterpret_cast<int4*>(wf_smem + fbytes);  // SMEM: the level table
  int* stage = reinterpret_cast<int*>(lvs + n_levels);
  // the factor slot s as the kernel builds it
  auto F = [&](int s) -> T* { return SMEM ? fs + s * DD : lg + s * bstride; };

  // copy level lv's record into its buffer (SMEM only)
  auto copy_record = [&](int lv, int4 L) {
    const int n = record_ints(L);
    int* dst = stage + (lv % WF_STAGES) * stage_ints;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      __pipeline_memcpy_async(dst + i, rec + L.x + i, sizeof(int));
  };
  // copy level lv's AtA blocks, untransposed, into the factor slots they
  // start (SMEM only; its record has landed)
  auto copy_a = [&](int lv, int4 L) {
    const Record R = record_at(stage + (lv % WF_STAGES) * stage_ints, L);
    const int nrows = R.nc * R.rl;
    if (vec && V > 1) {
      for (int i = threadIdx.x; i < nrows * CH; i += blockDim.x) {
        const int row = i / CH;
        const int slot = R.cs[row];
        if (slot == 0) continue;
        const int x = (i - row * CH) * V;
        __pipeline_memcpy_async(fs + slot * DD + x,
                                ab + static_cast<long long>(R.ac[row] >> 1) * bstride + x, 16);
      }
    } else {
      for (int i = threadIdx.x; i < nrows * DD; i += blockDim.x) {
        const int row = i / DD;
        const int slot = R.cs[row];
        if (slot == 0) continue;
        const int x = i - row * DD;
        __pipeline_memcpy_async(fs + slot * DD + x,
                                ab + static_cast<long long>(R.ac[row] >> 1) * bstride + x,
                                sizeof(T));
      }
    }
  };

  // this thread's entry pair in phase 1, (pa, pb) with pa <= pb
  const int rpp = blockDim.x / NP;  // rows a pass
  int pa = 0, pb = threadIdx.x % NP;
  while (pb >= D - pa) {
    pb -= D - pa;
    ++pa;
  }
  pb += pa;

  // slot 0: the zero sentinel (SMEM: stored with the factor at the end)
  for (int e = threadIdx.x; e < DD; e += blockDim.x) F(0)[e] = T(0);
  if (SMEM && n_levels > 0) {
    for (int i = threadIdx.x; i < n_levels; i += blockDim.x) lvs[i] = __ldg(lvl + i);
    copy_record(0, __ldg(lvl));
    if (n_levels > 1) copy_record(1, __ldg(lvl + 1));
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    copy_a(0, lvs[0]);
    __pipeline_commit();
  }

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int lv = 0; lv < n_levels; ++lv) {
    const int4 L = SMEM ? lvs[lv] : __ldg(lvl + lv);
    if (SMEM) {
      // A(lv) and record lv + 1 have landed; record lv - 1's buffer is free
      __pipeline_wait_prior(0);
      __syncthreads();
      if (lv + 1 < n_levels) copy_a(lv + 1, lvs[lv + 1]);
      if (lv + 2 < n_levels) copy_record(lv + 2, lvs[lv + 2]);
      __pipeline_commit();
    } else {
      __syncthreads();
    }
    const Record R = record_at(SMEM ? stage + (lv % WF_STAGES) * stage_ints : rec + L.x, L);
    const int rl = R.rl;

    // ---- phase 1: C = A - sum_u K_u KJ_u^T, one entry pair per thread ----
    const int nrows = R.nc * rl;
    for (int row = threadIdx.x < rpp * NP ? threadIdx.x / NP : nrows; row < nrows; row += rpp) {
      const int slot = R.cs[row];
      if (slot == 0) continue;  // a padded row
      const int ci = row / rl;
      const int t = row - ci * rl;
      const int nu = R.uc[ci];
      const int code = R.ac[row];
      const bool tr = code & 1;
      if (SMEM && nu == 0 && !tr) continue;  // the slot already holds C = A - 0
      T* blk = F(slot);
      T x1, x2;  // C's (pa, pb) and (pb, pa) entries of A
      if (SMEM) {
        x1 = blk[pa * D + pb];
        x2 = blk[pb * D + pa];
        if (tr) {
          const T x = x1;
          x1 = x2;
          x2 = x;
        }
      } else {
        const T* as = ab + static_cast<long long>(code >> 1) * bstride;
        x1 = as[tr ? pb * D + pa : pa * D + pb];
        x2 = as[tr ? pa * D + pb : pb * D + pa];
      }
      const int* us = R.us + ci * R.ul * rl + t;
      const int* jk = R.jk + ci * R.ul;
      T s1 = T(0), s2 = T(0);
#pragma unroll 2
      for (int u = 0; u < nu; ++u) {
        const T* kr = F(us[u * rl]);
        const T* kj = F(jk[u]);
        T ra[D], rb[D], ja[D], jb[D];
        load_row(kr + pa * D, ra);
        load_row(kj + pb * D, jb);
        load_row(kr + pb * D, rb);
        load_row(kj + pa * D, ja);
#pragma unroll
        for (int k = 0; k < D; ++k) s1 += ra[k] * jb[k];
#pragma unroll
        for (int k = 0; k < D; ++k) s2 += rb[k] * ja[k];
      }
      blk[pa * D + pb] = x1 - s1;
      blk[pb * D + pa] = x2 - s2;
    }
    __syncthreads();

    // ---- phase 2: POTRF and TRSM, a group of G lanes per column --------------
    int G = 8;
    while (G < 32 && G < (rl - 1) * D) G <<= 1;
    const int gpw = 32 / G;  // columns per warp
    const int gl = lane % G;
    const int gsrc = lane - gl;  // the group's lane 0
    for (int cbase = (threadIdx.x >> 5) * gpw; cbase < R.nc; cbase += nwarps * gpw) {
      const int ci = cbase + lane / G;
      const bool active = ci < R.nc;
      const int nq = active ? (R.len[ci] - 1) * D : 0;
      const bool potrf = active && gl < D;  // POTRF row r = gl
      const bool trsm = gl < nq;            // TRSM item gl: row t = 1 + gl / D, entry row a = gl % D
      const int r = gl;
      T* blk = F(active ? R.cs[ci * rl] : 0);
      T* trow = trsm ? F(R.cs[ci * rl + 1 + gl / D]) + (gl % D) * D : blk;
      // rowp: c[r][*], colp: c[*][r] (stride d), trow: the TRSM item's row
      // of C_t; read at each step (no stores until the steps end). The
      // lanes pick addresses, not values: a select between values would let
      // the compiler move the 0.5 product behind it and contract the other
      // product instead, which rounds differently.
      const T* rowp = potrf ? blk + r * D : blk;
      const T* colp = potrf ? blk + r : blk;
      T lrow[D], xrow[D];  // lrow: l[r][*]; xrow: the TRSM item's x[*]
#pragma unroll
      for (int k = 0; k < D; ++k) {
        lrow[k] = T(0);
        xrow[k] = T(0);
      }
      // level_factor.cu's statements, each value formed by the same
      // expressions (so FMA contraction makes the same choices):
      //   s      = c[jj][jj] - sum_k l[jj][k] l[jj][k];  l[jj][jj] = sqrt(s)
      //   t      = 0.5 (c[r][jj] + c[jj][r]) - sum_k l[r][k] l[jj][k];  l[r][jj] = t * (1 / l[jj][jj])
      //   x[jj]  = (C_t[a][jj] - sum_k x[k] l[jj][k]) / l[jj][jj]
      // An inactive group factors the identity, so no lane's square root or
      // division leaves its fast path.
#pragma unroll
      for (int jj = 0; jj < D; ++jj) {
        T lj[D];  // l[jj][k], k < jj: lane jj's row
#pragma unroll
        for (int k = 0; k < jj; ++k) lj[k] = __shfl_sync(WF_FULL, lrow[k], gsrc + jj);
        T s = active ? blk[jj * D + jj] : T(1);
#pragma unroll
        for (int k = 0; k < jj; ++k) s -= lj[k] * lj[k];
        const T ljj = sqrt(s);
        const T inv = T(1) / ljj;
        T t = T(0.5) * (rowp[jj] + colp[jj * D]);
#pragma unroll
        for (int k = 0; k < jj; ++k) t -= lrow[k] * lj[k];
        // `s -= x[k] l[jj][k]` contracts to this fma; spelt out, so that it
        // stays the same whatever the compiler makes of the products around
        T sx = trow[jj];
#pragma unroll
        for (int k = 0; k < jj; ++k) sx = fma(-xrow[k], lj[k], sx);
        if (rl > 1) xrow[jj] = sx / ljj;  // a level with rows below the diagonal
        if (r == jj)
          lrow[jj] = ljj;
        else if (r > jj)
          lrow[jj] = t * inv;
      }
      __syncwarp();  // the group's C_0 reads are done before any lane overwrites them
      if (potrf) {
#pragma unroll
        for (int k = 0; k < D; ++k) blk[r * D + k] = k <= r ? lrow[k] : T(0);
      }
      if (trsm) {
#pragma unroll
        for (int k = 0; k < D; ++k) trow[k] = xrow[k];
      }
      // TRSM items beyond the group's lanes (more than 32): the level's rl
      // decides, so the whole warp takes this branch together
      if ((rl - 1) * D > G) {
        __syncwarp();  // L_jj is visible
        for (int q2 = G + gl; q2 < nq; q2 += G) {
          T* row = F(R.cs[ci * rl + 1 + q2 / D]) + (q2 % D) * D;
          T x[D];
#pragma unroll
          for (int jj = 0; jj < D; ++jj) {
            T sx = row[jj];
#pragma unroll
            for (int k = 0; k < jj; ++k) sx = fma(-x[k], blk[jj * D + k], sx);
            x[jj] = sx / blk[jj * D + jj];
          }
#pragma unroll
          for (int jj = 0; jj < D; ++jj) row[jj] = x[jj];
        }
      }
    }
  }

  if (SMEM) {  // the factor to device memory, 16 bytes a store where aligned
    __syncthreads();
    if (vec && V > 1) {
      for (int i = threadIdx.x; i < n_lslots * CH; i += blockDim.x) {
        const int slot = i / CH;
        const int x = (i - slot * CH) * V;
        *reinterpret_cast<uint4*>(lg + slot * bstride + x) =
            *reinterpret_cast<const uint4*>(fs + slot * DD + x);
      }
    } else {
      for (int i = threadIdx.x; i < n_lslots * DD; i += blockDim.x)
        lg[(i / DD) * bstride + i % DD] = fs[i];
    }
  }
}

// the shared memory the SMEM variant carves: the factor (rounded up to 16
// bytes), the level table and WF_STAGES record buffers
template <typename T, int D>
size_t smem_layout(int n_levels, int n_lslots, int stage_ints) {
  const size_t f = (static_cast<size_t>(n_lslots) * D * D * sizeof(T) + 15) / 16 * 16;
  return f + static_cast<size_t>(n_levels) * sizeof(int4) +
         static_cast<size_t>(WF_STAGES) * stage_ints * sizeof(int);
}

// smem: the bytes of the SMEM variant, or 0 for the device-memory variant.
// A request under the layout, or over what a block may opt into, fails.
template <typename T, int D>
int launch_d(const void* ata, const int* rec, const int4* lvl, int n_levels, int n_lslots,
             int stage_ints, long long smem, int B, void* lflat, cudaStream_t st) {
  if (B <= 0) return 0;
  const bool vec = (reinterpret_cast<size_t>(ata) | reinterpret_cast<size_t>(lflat)) % 16 == 0;
  if (smem > 0) {
    if (static_cast<size_t>(smem) < smem_layout<T, D>(n_levels, n_lslots, stage_ints))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = whole_factor_kernel<T, D, true>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<B, WF_THREADS, smem, st>>>(static_cast<const T*>(ata), rec, lvl, n_levels, n_lslots,
                                        stage_ints, B, vec, static_cast<T*>(lflat));
  } else {
    whole_factor_kernel<T, D, false><<<B, WF_THREADS, 0, st>>>(
        static_cast<const T*>(ata), rec, lvl, n_levels, n_lslots, stage_ints, B, vec,
        static_cast<T*>(lflat));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* ata, const void* rec, const void* lvl, int n_levels, int n_lslots,
           int stage_ints, long long smem, int B, int d, void* lflat, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rec);
  const int4* l = static_cast<const int4*>(lvl);
#define TH_WF_CASE(DD) \
  case DD:             \
    return launch_d<T, DD>(ata, r, l, n_levels, n_lslots, stage_ints, smem, B, lflat, st);
  switch (d) {
    TH_WF_CASE(1)
    TH_WF_CASE(2)
    TH_WF_CASE(3)
    TH_WF_CASE(4)
    TH_WF_CASE(5)
    TH_WF_CASE(6)
    TH_WF_CASE(7)
    TH_WF_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TH_WF_CASE
}

}  // namespace

TH_EXPORT int th_whole_factor_f32(const void* ata, const void* rec, const void* lvl, int n_levels,
                                  int n_lslots, int stage_ints, long long smem, int B, int d,
                                  void* lflat, void* stream) {
  return launch<float>(ata, rec, lvl, n_levels, n_lslots, stage_ints, smem, B, d, lflat, stream);
}

TH_EXPORT int th_whole_factor_f64(const void* ata, const void* rec, const void* lvl, int n_levels,
                                  int n_lslots, int stage_ints, long long smem, int B, int d,
                                  void* lflat, void* stream) {
  return launch<double>(ata, rec, lvl, n_levels, n_lslots, stage_ints, smem, B, d, lflat, stream);
}
