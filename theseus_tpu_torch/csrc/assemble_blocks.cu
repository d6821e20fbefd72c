// Block AtA / Atb assembly from per-bucket jacobian blocks.
//
// Replaces the Pallas kernel `_bucket_kernel` of
// theseus_tpu/sparse/pallas_assemble.py (pallas_call at :124, entry
// assemble_pallas). Per cost bucket it sums J_s^T J_t into each stored
// lower-triangle block slot of AtA (with the per-edge transpose / also-diag
// select of pallas_assemble.py:75-76) and -J_s^T r into each Atb row.
//
// The TPU kernel accumulated read-modify-write into VMEM, race-free only
// because a TPU grid runs its steps in order. A GPU grid does not, so this
// kernel is an OWNER-COMPUTES reduction: each output (slot, batch) block, or
// (variable, batch) Atb row, is written by one block, one warp or one
// thread, which sums a host-built CSR list of the contributions to it in a
// fixed order. There are no floating-point atomics, so the result is bitwise
// the same on every run; LM's accept/reject test turns run-to-run rounding
// noise into different trajectories (bench.py:45-50), which is why that
// matters here.
//
// Contributions refer to "sources": one per (bucket, optim slot), each a
// jacobian tensor (K, B, m, D) and its bucket's error (K, B, m), passed by
// pointer in the kernel's parameter block. An AtA item is
// (src_s, src_t, edge, flags) with flags bit 0 = store the transpose and
// bit 1 = also add the transpose (same variable in both slots); an Atb item
// is (src, edge). Every output is written, so the outputs need no zeroing.
// The identity on padding dofs of the diagonal blocks stays an epilogue in
// the Python wrapper, as in theseus_tpu/sparse/assemble.py:275-280.
//
// What bounds it on the H100: memory, and the latency of dependent loads.
// Each jacobian row is read once per slot pair it enters, 2*m*D*D flops per
// item against 2*m*D loads: far below the flop-per-byte balance. A thread
// that walks a list pays two dependent loads per item (the item, then the
// rows it points to), so one thread cannot own a long list: at BA 128 x 4000
// a camera's diagonal slot and Atb row have ~1,600 items each, milliseconds
// of dependent loads in series.
//
// Design. The host splits every list longer than SPLIT items into G
// contiguous chunks in CSR order (sparse/assemble_kernel.py split_plan), and
// the grid has three ranges of blocks:
//   1. large split outputs (G * tile > 32): one block per (output, batch
//      tile). Thread (chunk slot, batch element), the batch element fastest,
//      sums its chunks g = slot, slot + slots, ... in CSR order into a
//      partial in registers, prefetching the next item before the FMAs of
//      the current one. The partials meet in a fixed tree: shuffles within
//      each warp, then shared memory across warps, summed in warp order by
//      threads that each own one output entry (coalesced writes);
//   2. small split outputs: one warp per (output, batch tile), shuffles only;
//   3. short outputs: one thread per (output, batch element, block row),
//      the row fastest, so a warp stores whole consecutive blocks; each
//      entry is a per-item FMA chain added in list order, the bits of a
//      thread that walks the whole list for the whole block.
// The batch tile is min(8, next power of two >= B): lanes on one item read
// neighbouring (b) jacobian rows when B is large and consecutive chunks
// when B is 1. The split, the chunk order and the tree are fixed, so two
// launches on the same inputs give the same bits.
//
// Layout: AoS (K, B, m, D) in and (n_slots, B, D, D) / (n_vars, B, D) out.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TH_ASM_MAX_SRC = 32;
constexpr int ASM_SPLIT_THREADS = 256;  // sparse/assemble_kernel.py SPLIT_THREADS
constexpr int ASM_WARPS = ASM_SPLIT_THREADS / 32;
constexpr int ASM_TILE_MAX = 8;  // sparse/assemble_kernel.py BATCH_TILE_MAX

template <typename T>
struct Sources {
  const T* jac[TH_ASM_MAX_SRC];
  const T* err[TH_ASM_MAX_SRC];
  int m[TH_ASM_MAX_SRC];
};

// D values from p into r: by pairs (8-byte float2 / 16-byte double2 loads)
// when D is even and the wrapper found every jacobian 16-byte aligned (vec),
// else one by one. A row starts at an even element when D is even.
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* p, T* r, bool vec) {
  if constexpr (D % 2 == 0) {
    if (vec) {
      using V = typename std::conditional<sizeof(T) == 4, float2, double2>::type;
      const V* pv = reinterpret_cast<const V*>(p);
#pragma unroll
      for (int k = 0; k < D / 2; ++k) {
        const V x = pv[k];
        r[2 * k] = x.x;
        r[2 * k + 1] = x.y;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) r[k] = p[k];
}

// D values to p, an output row (the outputs are fresh allocations, so a row
// at an even element is aligned for pairs)
template <typename T, int D>
__device__ __forceinline__ void store_row(T* p, const T* r) {
  if constexpr (D % 2 == 0) {
    using V = typename std::conditional<sizeof(T) == 4, float2, double2>::type;
    V* pv = reinterpret_cast<V*>(p);
#pragma unroll
    for (int k = 0; k < D / 2; ++k) pv[k] = V{r[2 * k], r[2 * k + 1]};
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) p[k] = r[k];
  }
}

// ---- split outputs: per-item accumulation straight into the partial ------

template <typename T, int D>
__device__ __forceinline__ void add_ata_item(const Sources<T>& src, int4 e, long long B,
                                             long long b, bool vec, T* p) {
  const int m = src.m[e.x];
  const T* js = src.jac[e.x] + (static_cast<long long>(e.z) * B + b) * m * D;
  const T* jt = src.jac[e.y] + (static_cast<long long>(e.z) * B + b) * m * D;
  const bool tr = (e.w & 1) != 0;
  const bool ad = (e.w & 2) != 0;
  // v = (tr ? c^T : c) + (ad ? c^T : 0) with c = sum_mm rs rt^T, row by row
  const T* pa = tr ? jt : js;
  const T* pb = tr ? js : jt;
  for (int mm = 0; mm < m; ++mm) {
    T ra[D], rb[D];
    load_row<T, D>(pa + mm * D, ra, vec);
    load_row<T, D>(pb + mm * D, rb, vec);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) p[i * D + j] += ra[i] * rb[j];
    if (ad) {
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) p[i * D + j] += tr ? ra[i] * rb[j] : rb[i] * ra[j];
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void add_atb_item(const Sources<T>& src, int2 e, long long B,
                                             long long b, T* p) {
  const int m = src.m[e.x];
  const long long row = static_cast<long long>(e.y) * B + b;
  const T* jac = src.jac[e.x] + row * m * D;
  const T* err = src.err[e.x] + row * m;
  for (int mm = 0; mm < m; ++mm) {
    const T em = err[mm];
#pragma unroll
    for (int i = 0; i < D; ++i) p[i] -= jac[mm * D + i] * em;
  }
}

// The partial of the chunks g = g0, g0 + gstep, ... < G of one list, each
// in CSR order. Chunk g covers items [start + g q + min(g, rem), + q +
// (g < rem)) with q = count / G, rem = count % G; G <= count, so no chunk
// is empty.
template <typename T, int D, bool ATA>
__device__ __forceinline__ void chunk_partial(const Sources<T>& src, const void* items, int start,
                                              int count, int G, int g0, int gstep, long long B,
                                              long long b, bool vec, T* p) {
  const int q = count / G;
  const int rem = count % G;
  for (int g = g0; g < G; g += gstep) {
    int it = start + g * q + min(g, rem);
    const int end = it + q + (g < rem ? 1 : 0);
    if constexpr (ATA) {
      const int4* list = static_cast<const int4*>(items);
      int4 next = list[it];
      for (; it < end; ++it) {
        const int4 e = next;
        if (it + 1 < end) next = list[it + 1];
        add_ata_item<T, D>(src, e, B, b, vec, p);
      }
    } else {
      const int2* list = static_cast<const int2*>(items);
      int2 next = list[it];
      for (; it < end; ++it) {
        const int2 e = next;
        if (it + 1 < end) next = list[it + 1];
        add_atb_item<T, D>(src, e, B, b, p);
      }
    }
  }
}

// Shuffle-down tree over the lanes that hold the same batch element
// (lane = chunk slot * tile + bt): offsets 16, 8, ..., tile.
template <typename T, int N>
__device__ __forceinline__ void warp_tree(T* p, int tile) {
  for (int off = 16; off >= tile; off >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) p[n] += __shfl_down_sync(0xffffffffu, p[n], off);
  }
}

// One split output for batch tile [b0, b0 + tile): `warps` warps starting
// at warp w0 of this block sum its chunks, and their partials are added in
// warp order into out[(o B + b0 + bt) N + n].
template <typename T, int D, bool ATA>
__device__ void split_output(const Sources<T>& src, const int* ptr, const void* items, int o,
                             int G, int tile, int lane, int warp, int w0, int warps, long long B,
                             int b0, bool vec, T* red, T* out, int tid_in_group,
                             int group_threads) {
  constexpr int N = ATA ? D * D : D;
  // one D x D slot of `red` per (warp, batch element) whatever N is: AtA and
  // Atb outputs share a block in the warp-per-output range
  constexpr int S = D * D;
  const int bt = lane % tile;
  const int slot = (warp - w0) * (32 / tile) + lane / tile;
  const long long b = b0 + bt;
  T p[N];
#pragma unroll
  for (int n = 0; n < N; ++n) p[n] = T(0);
  if (b < B) {
    const int start = ptr[o];
    chunk_partial<T, D, ATA>(src, items, start, ptr[o + 1] - start, G, slot, warps * (32 / tile),
                             B, b, vec, p);
  }
  warp_tree<T, N>(p, tile);
  if (lane < tile) {
#pragma unroll
    for (int n = 0; n < N; ++n) red[(warp * tile + lane) * S + n] = p[n];
  }
  if (warps > 1) __syncthreads(); else __syncwarp();
  const int tb = static_cast<int>(min(static_cast<long long>(tile), B - b0));
  T* o_base = out + (static_cast<long long>(o) * B + b0) * N;
  for (int t = tid_in_group; t < tb * N; t += group_threads) {
    const int bt2 = t / N;
    const int n = t % N;
    T acc = red[(w0 * tile + bt2) * S + n];
    for (int w = 1; w < warps; ++w) acc += red[((w0 + w) * tile + bt2) * S + n];
    o_base[t] = acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(ASM_SPLIT_THREADS) assemble_kernel(Sources<T> src, const int* __restrict__ ata_ptr,
                                const int4* __restrict__ ata_items,
                                const int* __restrict__ atb_ptr,
                                const int2* __restrict__ atb_items,
                                const int4* __restrict__ split, int n_split, int n_large, int tile,
                                const int* __restrict__ short_ata, int n_short_ata,
                                const int* __restrict__ short_atb, int n_short_atb, int B,
                                bool vec, T* __restrict__ ata, T* __restrict__ atb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  const int nbt = (B + tile - 1) / tile;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const long long large_blocks = static_cast<long long>(n_large) * nbt;
  const long long small_units = static_cast<long long>(n_split - n_large) * nbt;
  const long long small_blocks = (small_units + warps - 1) / warps;
  const long long blk = blockIdx.x;

  if (blk < large_blocks + small_blocks) {
    // ---- split outputs: a block (large) or a warp (small) each ----------
    long long unit;
    int w0, nw, tid, nthreads;
    if (blk < large_blocks) {
      unit = blk;
      w0 = 0, nw = warps, tid = threadIdx.x, nthreads = blockDim.x;
    } else {
      unit = large_blocks + (blk - large_blocks) * warps + warp;
      if (unit >= large_blocks + small_units) return;  // no barrier follows for a lone warp
      w0 = warp, nw = 1, tid = lane, nthreads = 32;
    }
    const int4 s = split[unit / nbt];  // (kind, output, count, G)
    const int b0 = static_cast<int>(unit % nbt) * tile;
    if (s.x == 0)
      split_output<T, D, true>(src, ata_ptr, ata_items, s.y, s.w, tile, lane, warp, w0, nw, B, b0,
                               vec, red, ata, tid, nthreads);
    else
      split_output<T, D, false>(src, atb_ptr, atb_items, s.y, s.w, tile, lane, warp, w0, nw, B,
                                b0, vec, red, atb, tid, nthreads);
    return;
  }

  // ---- short outputs: one thread per (output, batch element, block row i),
  // the row fastest. Each entry is the per-item block entry c[i][j] (or
  // c[j][i]) as an FMA chain over the residual rows, added to the output in
  // list order. -------------------------------------------
  const long long idx = (blk - large_blocks - small_blocks) * blockDim.x + threadIdx.x;
  const long long n_ata = static_cast<long long>(n_short_ata) * B * D;
  const long long n_atb = static_cast<long long>(n_short_atb) * B * D;
  if (idx < n_ata) {
    const int i = static_cast<int>(idx % D);
    const long long ob = idx / D;
    const int o = short_ata[ob / B];
    const long long b = ob % B;
    T acc[D];
#pragma unroll
    for (int j = 0; j < D; ++j) acc[j] = T(0);
    for (int it = ata_ptr[o]; it < ata_ptr[o + 1]; ++it) {
      const int4 e = ata_items[it];
      const int m = src.m[e.x];
      const T* js = src.jac[e.x] + (static_cast<long long>(e.z) * B + b) * m * D;
      const T* jt = src.jac[e.y] + (static_cast<long long>(e.z) * B + b) * m * D;
      const bool tr = (e.w & 1) != 0;
      const bool ad = (e.w & 2) != 0;
      T c[D], ct[D];  // row i of c = sum_mm rs rt^T, and column i (row i of c^T)
#pragma unroll
      for (int j = 0; j < D; ++j) c[j] = ct[j] = T(0);
      for (int mm = 0; mm < m; ++mm) {
        T rt[D];
        load_row<T, D>(jt + mm * D, rt, vec);
        const T rsi = js[mm * D + i];
#pragma unroll
        for (int j = 0; j < D; ++j) c[j] += rsi * rt[j];
        if (tr || ad) {
          T rs[D];
          load_row<T, D>(js + mm * D, rs, vec);
          const T rti = jt[mm * D + i];
#pragma unroll
          for (int j = 0; j < D; ++j) ct[j] += rs[j] * rti;
        }
      }
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T v = tr ? ct[j] : c[j];
        if (ad) v += ct[j];
        acc[j] += v;
      }
    }
    store_row<T, D>(ata + (static_cast<long long>(o) * B + b) * D * D + i * D, acc);
  } else if (idx < n_ata + n_atb) {
    const long long r = idx - n_ata;
    const int i = static_cast<int>(r % D);
    const long long vb = r / D;
    const int v = short_atb[vb / B];
    const long long b = vb % B;
    T acc = T(0);
    for (int it = atb_ptr[v]; it < atb_ptr[v + 1]; ++it) {
      const int2 e = atb_items[it];
      const int m = src.m[e.x];
      const long long row = static_cast<long long>(e.y) * B + b;
      const T* jac = src.jac[e.x] + row * m * D;
      const T* err = src.err[e.x] + row * m;
      T g = T(0);
      for (int mm = 0; mm < m; ++mm) g += jac[mm * D + i] * err[mm];
      acc -= g;
    }
    atb[(static_cast<long long>(v) * B + b) * D + i] = acc;
  }
}

struct Plan {
  const void* ata_ptr;
  const void* ata_items;
  const void* atb_ptr;
  const void* atb_items;
  const void* split;
  int n_split, n_large, tile, threads;
  const void* short_ata;
  int n_short_ata;
  const void* short_atb;
  int n_short_atb;
  int vec;
};

template <typename T, int D>
int launch_d(const Sources<T>& s, const Plan& p, int B, void* ata, void* atb, cudaStream_t stream) {
  if (B <= 0) return 0;
  const long long nbt = (B + p.tile - 1) / p.tile;
  const int warps = p.threads / 32;
  const long long large = static_cast<long long>(p.n_large) * nbt;
  const long long small = (static_cast<long long>(p.n_split - p.n_large) * nbt + warps - 1) / warps;
  const long long n_short = (static_cast<long long>(p.n_short_ata) + p.n_short_atb) * B * D;
  const long long blocks = large + small + (n_short + p.threads - 1) / p.threads;
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = p.n_split > 0 ? sizeof(T) * warps * p.tile * D * D : 0;
  assemble_kernel<T, D><<<static_cast<unsigned>(blocks), p.threads, smem, stream>>>(
      s, static_cast<const int*>(p.ata_ptr), static_cast<const int4*>(p.ata_items),
      static_cast<const int*>(p.atb_ptr), static_cast<const int2*>(p.atb_items),
      static_cast<const int4*>(p.split), p.n_split, p.n_large, p.tile,
      static_cast<const int*>(p.short_ata), p.n_short_ata, static_cast<const int*>(p.short_atb),
      p.n_short_atb, B, p.vec != 0, static_cast<T*>(ata), static_cast<T*>(atb));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* const* jac, const void* const* err, const int* m, int n_src,
           const Plan& p, int B, int d, void* ata, void* atb, void* stream) {
  if (n_src < 0 || n_src > TH_ASM_MAX_SRC) return static_cast<int>(cudaErrorInvalidValue);
  // the tile is a power of two <= 8 and a block holds whole warps (at most
  // ASM_WARPS of them when outputs are split: the reduction's shared memory)
  const bool tile_ok = p.tile >= 1 && p.tile <= ASM_TILE_MAX && (p.tile & (p.tile - 1)) == 0;
  const bool threads_ok = p.threads >= 32 && p.threads % 32 == 0 && p.threads <= 1024 &&
                          (p.n_split == 0 || p.threads <= ASM_SPLIT_THREADS);
  if (!tile_ok || !threads_ok || p.n_large < 0 || p.n_large > p.n_split)
    return static_cast<int>(cudaErrorInvalidValue);
  Sources<T> s;
  for (int i = 0; i < TH_ASM_MAX_SRC; ++i) {
    s.jac[i] = i < n_src ? static_cast<const T*>(jac[i]) : nullptr;
    s.err[i] = i < n_src ? static_cast<const T*>(err[i]) : nullptr;
    s.m[i] = i < n_src ? m[i] : 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TH_ASM_CASE(DD) \
  case DD:              \
    return launch_d<T, DD>(s, p, B, ata, atb, st);
  switch (d) {
    TH_ASM_CASE(1)
    TH_ASM_CASE(2)
    TH_ASM_CASE(3)
    TH_ASM_CASE(4)
    TH_ASM_CASE(5)
    TH_ASM_CASE(6)
    TH_ASM_CASE(7)
    TH_ASM_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TH_ASM_CASE
}

}  // namespace

#define TH_ASM_EXPORT(SUFFIX, TYPE)                                                               \
  TH_EXPORT int th_assemble_blocks_##SUFFIX(                                                      \
      const void* const* jac, const void* const* err, const int* m, int n_src,                    \
      const void* ata_ptr, const void* ata_items, const void* atb_ptr, const void* atb_items,     \
      const void* split, int n_split, int n_large, int tile, int threads, const void* short_ata, \
      int n_short_ata, const void* short_atb, int n_short_atb, int B, int d, int vec, void* ata,  \
      void* atb, void* stream) {                                                                  \
    const Plan p{ata_ptr,   ata_items,   atb_ptr,   atb_items,   split, n_split, n_large,        \
                 tile,      threads,     short_ata, n_short_ata, short_atb, n_short_atb, vec};    \
    return launch<TYPE>(jac, err, m, n_src, p, B, d, ata, atb, stream);                           \
  }

TH_ASM_EXPORT(f32, float)
TH_ASM_EXPORT(f64, double)
