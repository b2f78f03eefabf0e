// Block-ELL SpMV for Hopper (M3):
//   y[n*br + i] = sum_k sum_j A(n, k)[i, j] * x[ncol[n, k]*bc + j].
//
// Replaces femcy_tpu/solvers/bell.py's bell_spmv (a row gather and an
// einsum that XLA lowers to a gather and a reduction), the operator of
// every step of the algebraic multigrid: the fine apply of each PCG
// iteration, each Chebyshev smoothing step and residual, and each
// restriction and prolongation of the V-cycle.  It is not a Pallas
// kernel in the JAX package; on the card it carries the AMG-PCG, so it is
// written by hand.
//
// Operand layout (kernels/bell_spmv.py builds it):
// - values_t (K, bc, N*br): entry [k, j, n*br + i] is A(n, k)[i, j].  For
//   the fine level that is exactly the transposed dof-ELL values (W, n_dof)
//   of the eliminated operator, since dof-ELL slot k*dm + j of row n*dm + i
//   is block k's entry (i, j); the coarse levels are transposed once at
//   setup;
// - ncol_t (K, N) int32 block-column ids;
// - counts (N,) int32: the blocks of row n past counts[n] are zero blocks
//   (the fine level's pads, the valid mask of the block plan, and the
//   trailing pads of the coarse levels), and are not read.
//
// Values are bf16 (the AMG hierarchy), float or double; x and y float or
// double.  A bf16 value is widened exactly to x's type in a register.
//
// What bounds it on the H100: bytes.  At the fine level of the 1,053,696-
// element C3D4 box (N = 185,193 nodes, K = 15, 3 x 3 blocks, f64) it reads
// the 2,700,601 valid blocks (194 MB of values, 11 MB of ids), the counts
// and x, and writes 4.4 MB: a floor of 0.064 ms at 3.35 TB/s, against
// 0.090 ms for the scalar ELL SpMV (M2) on the same operator, whose int32
// id per entry is ~100 MB more.
//
// Design: one thread per output row r = n*br + i.
// - For each (k, j) neighbouring threads read neighbouring values
//   (coalesced); the br threads of a block row read the same id and the
//   same bc consecutive entries of x, which the gather serves from one or
//   two 32-byte sectors of L2.
// - Each row is summed in a fixed order, k then j, one multiply-add per
//   entry, no atomics: the same bits on every run.
// - bc is a template argument (2, 3 or 6), so the j loop unrolls; br is a
//   run-time divisor.
// - The k loop is unrolled by 8, so the ids, values and x entries of
//   eight blocks are loaded before their multiply-adds; the order of the
//   sum is unchanged, and so are the bits.  The AMG's coarse operands
//   have few rows and hundreds of blocks a row (R at level 1 of the AMG
//   slice: 439 block rows of 353 6 x 6 blocks, 2,634 threads on 132 SMs),
//   so each thread's chain of dependent loads is what they wait on.  On
//   an H100 SXM at 700 W, in f64, one V-cycle of the AMG slice took 3.96
//   ms of device time with the loop not unrolled (the first design), 2.75
//   unrolled by 4 and 2.67 by 8 (R at level 0: 0.252, 0.252, 0.157 ms;
//   the fine level: 0.094, 0.094, 0.088 ms);
//   tools/m3_designs.py builds the other two beside this one and times
//   them in turns.
// 64-bit offsets.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename V, typename T>
__device__ __forceinline__ T widen(const V* p) {
  return static_cast<T>(__ldg(p));
}

// bf16 is the upper half of a float: a shift widens it exactly
template <>
__device__ __forceinline__ float widen<uint16_t, float>(const uint16_t* p) {
  return __uint_as_float(static_cast<unsigned int>(__ldg(p)) << 16);
}

template <>
__device__ __forceinline__ double widen<uint16_t, double>(const uint16_t* p) {
  return static_cast<double>(
      __uint_as_float(static_cast<unsigned int>(__ldg(p)) << 16));
}

template <typename V, typename T, int BC>
__global__ void __launch_bounds__(kThreads) bell_spmv_kernel(
    const V* __restrict__ values_t, const int* __restrict__ ncol_t,
    const int* __restrict__ counts, const T* __restrict__ x,
    T* __restrict__ y, long long n_blocks, int br) {
  const long long m = n_blocks * br;  // output rows
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r >= m) return;
  const long long n = r / br;
  const int count = __ldg(counts + n);
  T acc = T(0);
#pragma unroll 8
  for (int k = 0; k < count; ++k) {
    const long long c = static_cast<long long>(
                            __ldg(ncol_t + static_cast<long long>(k) *
                                               n_blocks + n)) * BC;
    const V* v = values_t + static_cast<long long>(k) * BC * m + r;
#pragma unroll
    for (int j = 0; j < BC; ++j)
      acc += widen<V, T>(v + j * m) * __ldg(x + c + j);
  }
  y[r] = acc;
}

template <typename V, typename T>
int launch(const void* values_t, const int* ncol_t, const int* counts,
           const T* x, T* y, long long n_blocks, int br, int bc,
           void* stream) {
  const long long m = n_blocks * br;
  if (m <= 0) return 0;
  const long long blocks = (m + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned int>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const V* v = static_cast<const V*>(values_t);
  switch (bc) {
    case 2:
      bell_spmv_kernel<V, T, 2><<<grid, kThreads, 0, s>>>(
          v, ncol_t, counts, x, y, n_blocks, br);
      break;
    case 3:
      bell_spmv_kernel<V, T, 3><<<grid, kThreads, 0, s>>>(
          v, ncol_t, counts, x, y, n_blocks, br);
      break;
    case 6:
      bell_spmv_kernel<V, T, 6><<<grid, kThreads, 0, s>>>(
          v, ncol_t, counts, x, y, n_blocks, br);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FEMCY_BELL_ENTRY(NAME, V, T)                                        \
  extern "C" int NAME(const void* values_t, const int* ncol_t,              \
                      const int* counts, const T* x, T* y,                  \
                      long long n_blocks, int br, int bc, void* stream) {   \
    return launch<V, T>(values_t, ncol_t, counts, x, y, n_blocks, br, bc,   \
                        stream);                                            \
  }

FEMCY_BELL_ENTRY(femcy_bell_spmv_bf16_f32, uint16_t, float)
FEMCY_BELL_ENTRY(femcy_bell_spmv_bf16_f64, uint16_t, double)
FEMCY_BELL_ENTRY(femcy_bell_spmv_f32_f32, float, float)
FEMCY_BELL_ENTRY(femcy_bell_spmv_f32_f64, float, double)
FEMCY_BELL_ENTRY(femcy_bell_spmv_f64_f64, double, double)
