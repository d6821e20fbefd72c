// Shared definitions for the theseus_tpu_torch CUDA kernels.
//
// Every kernel is a template over the floating type (float, double) and is
// exposed through a plain C entry point per type (suffix _f32 / _f64) that
// launches on the stream it is given and returns cudaGetLastError().
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#define TH_EXPORT extern "C" __attribute__((visibility("default")))

// One elimination-tree level's int32 record (sparse/level_kernels.py
// `level_record`), read by level_factor.cu and level_subst.cu: per column c
// of the level's C, its column `cols`, its valid rows `nrow` and updates
// `nupd` (each a prefix of the level's rl rows and ul updates), the slot of
// its diagonal block; per (c, row) the AtA slot (negative: read transposed),
// the factor slot and the row's column; per (c, u) the slot of L[j, k] and
// the update's column k; per (c, u, row) the slot of L[row, k] (0, the zero
// block, where the row is not in k's pattern).
struct LevelRecord {
  const int *cols, *nrow, *nupd, *diag, *a_src, *col_slots, *row_ids, *jk_slots, *upd_k, *upd_slots;
  __device__ LevelRecord(const int* r, int C, int rl, int ul)
      : cols(r),
        nrow(r + C),
        nupd(r + 2 * C),
        diag(r + 3 * C),
        a_src(r + 4 * C),
        col_slots(a_src + C * rl),
        row_ids(col_slots + C * rl),
        jk_slots(row_ids + C * rl),
        upd_k(jk_slots + C * ul),
        upd_slots(upd_k + C * ul) {}
};

// The tile kernels (between_se3.cu, reprojection.cu; level_subst.cu's
// backward kernel per row of a column): a block owns a contiguous range of
// items, stages its input tiles in shared memory and stores its output
// tiles from there.

// count values from device memory into shared memory by cp.async: 16 bytes
// a copy when vec (both ends 16-byte aligned), single values for the rest
template <typename T>
__device__ __forceinline__ void th_stage_tile(T* dst, const T* src, int count, bool vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  int done = 0;
  if (vec) {
    const int nv = count / V;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) __pipeline_memcpy_async(dst + v * V, src + v * V, 16);
    done = nv * V;
  }
  for (int e = done + threadIdx.x; e < count; e += blockDim.x) __pipeline_memcpy_async(dst + e, src + e, sizeof(T));
}

// a tile of `rows` rows of W values, row stride S in shared memory, stored
// to device memory where it is contiguous: 16 bytes a store when vec
template <typename T, int W, int S>
__device__ __forceinline__ void th_store_tile(const T* sh, T* out, int rows, bool vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int count = rows * W;
  int done = 0;
  if (vec) {
    const int nv = count / V;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      union {
        uint4 u;
        T x[V];
      } w;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int g = v * V + e;
        w.x[e] = sh[(g / W) * S + g % W];
      }
      reinterpret_cast<uint4*>(out)[v] = w.u;
    }
    done = nv * V;
  }
  for (int g = done + threadIdx.x; g < count; g += blockDim.x) out[g] = sh[(g / W) * S + g % W];
}
