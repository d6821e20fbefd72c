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
// kernel is an OWNER-COMPUTES reduction: one thread owns one output
// (slot, batch) block, or one (variable, batch) Atb row, and walks a host-built
// CSR list of the contributions to it in a fixed order. There are no
// floating-point atomics, so the result is bitwise the same on every run;
// LM's accept/reject test turns run-to-run rounding noise into different
// trajectories (bench.py:45-50), which is why that matters here.
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
// Layout: AoS (K, B, m, D) in and (n_slots, B, D, D) / (n_vars, B, D) out;
// the TPU's SoA batch-on-lanes layout was a tiling choice, and here the
// threads of a warp are consecutive batch elements of one output slot, so
// they walk the same item list without divergence.
//
// What bounds it on the H100: memory and latency. Each jacobian row is read
// once per slot pair it enters (3 pairs for a Between edge), 2*m*D*D flops
// per item against 2*m*D loads: far below the flop-per-byte balance.

#include "common.cuh"

namespace {

constexpr int TH_ASM_MAX_SRC = 32;

template <typename T>
struct Sources {
  const T* jac[TH_ASM_MAX_SRC];
  const T* err[TH_ASM_MAX_SRC];
  int m[TH_ASM_MAX_SRC];
};

template <typename T, int D>
__global__ void assemble_kernel(Sources<T> src, const int* __restrict__ ata_ptr,
                                const int4* __restrict__ ata_items, int n_slots,
                                const int* __restrict__ atb_ptr,
                                const int2* __restrict__ atb_items, int n_vars, int B,
                                T* __restrict__ ata, T* __restrict__ atb) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n_ata = static_cast<long long>(n_slots) * B;
  const long long n_atb = static_cast<long long>(n_vars) * B;
  if (idx < n_ata) {
    const int o = static_cast<int>(idx / B);
    const long long b = idx % B;
    T acc[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) acc[i][j] = T(0);
    for (int it = ata_ptr[o]; it < ata_ptr[o + 1]; ++it) {
      const int4 e = ata_items[it];
      const int m = src.m[e.x];
      const T* js = src.jac[e.x] + (static_cast<long long>(e.z) * B + b) * m * D;
      const T* jt = src.jac[e.y] + (static_cast<long long>(e.z) * B + b) * m * D;
      T c[D][D];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) c[i][j] = T(0);
      for (int mm = 0; mm < m; ++mm) {
        T rs[D], rt[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          rs[i] = js[mm * D + i];
          rt[i] = jt[mm * D + i];
        }
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int j = 0; j < D; ++j) c[i][j] += rs[i] * rt[j];
      }
      const bool tr = (e.w & 1) != 0;
      const bool ad = (e.w & 2) != 0;
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) {
          T v = tr ? c[j][i] : c[i][j];
          if (ad) v += c[j][i];
          acc[i][j] += v;
        }
    }
    T* out = ata + idx * D * D;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) out[i * D + j] = acc[i][j];
  } else if (idx < n_ata + n_atb) {
    const long long r = idx - n_ata;
    const int v = static_cast<int>(r / B);
    const long long b = r % B;
    T acc[D];
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] = T(0);
    for (int it = atb_ptr[v]; it < atb_ptr[v + 1]; ++it) {
      const int2 e = atb_items[it];
      const int m = src.m[e.x];
      const long long row = static_cast<long long>(e.y) * B + b;
      const T* jac = src.jac[e.x] + row * m * D;
      const T* err = src.err[e.x] + row * m;
      T g[D];
#pragma unroll
      for (int i = 0; i < D; ++i) g[i] = T(0);
      for (int mm = 0; mm < m; ++mm) {
        const T em = err[mm];
#pragma unroll
        for (int i = 0; i < D; ++i) g[i] += jac[mm * D + i] * em;
      }
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] -= g[i];
    }
    T* out = atb + r * D;
#pragma unroll
    for (int i = 0; i < D; ++i) out[i] = acc[i];
  }
}

template <typename T, int D>
int launch_d(const Sources<T>& s, const void* ata_ptr, const void* ata_items, int n_slots,
             const void* atb_ptr, const void* atb_items, int n_vars, int B, void* ata, void* atb,
             cudaStream_t stream) {
  const long long n = (static_cast<long long>(n_slots) + n_vars) * B;
  if (n <= 0) return 0;
  assemble_kernel<T, D><<<th_blocks(n), TH_BLOCK, 0, stream>>>(
      s, static_cast<const int*>(ata_ptr), static_cast<const int4*>(ata_items), n_slots,
      static_cast<const int*>(atb_ptr), static_cast<const int2*>(atb_items), n_vars, B,
      static_cast<T*>(ata), static_cast<T*>(atb));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* const* jac, const void* const* err, const int* m, int n_src,
           const void* ata_ptr, const void* ata_items, int n_slots, const void* atb_ptr,
           const void* atb_items, int n_vars, int B, int d, void* ata, void* atb, void* stream) {
  if (n_src < 0 || n_src > TH_ASM_MAX_SRC) return static_cast<int>(cudaErrorInvalidValue);
  Sources<T> s;
  for (int i = 0; i < TH_ASM_MAX_SRC; ++i) {
    s.jac[i] = i < n_src ? static_cast<const T*>(jac[i]) : nullptr;
    s.err[i] = i < n_src ? static_cast<const T*>(err[i]) : nullptr;
    s.m[i] = i < n_src ? m[i] : 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TH_ASM_CASE(DD) \
  case DD:              \
    return launch_d<T, DD>(s, ata_ptr, ata_items, n_slots, atb_ptr, atb_items, n_vars, B, ata, atb, st);
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

TH_EXPORT int th_assemble_blocks_f32(const void* const* jac, const void* const* err, const int* m,
                                     int n_src, const void* ata_ptr, const void* ata_items,
                                     int n_slots, const void* atb_ptr, const void* atb_items,
                                     int n_vars, int B, int d, void* ata, void* atb,
                                     void* stream) {
  return launch<float>(jac, err, m, n_src, ata_ptr, ata_items, n_slots, atb_ptr, atb_items,
                       n_vars, B, d, ata, atb, stream);
}

TH_EXPORT int th_assemble_blocks_f64(const void* const* jac, const void* const* err, const int* m,
                                     int n_src, const void* ata_ptr, const void* ata_items,
                                     int n_slots, const void* atb_ptr, const void* atb_items,
                                     int n_vars, int B, int d, void* ata, void* atb,
                                     void* stream) {
  return launch<double>(jac, err, m, n_src, ata_ptr, ata_items, n_slots, atb_ptr, atb_items,
                        n_vars, B, d, ata, atb, stream);
}
