// ELL SpMV for Hopper (M2): y[r] = sum_w values_t[w, r] * x[colidx_t[w, r]].
//
// Replaces femcy_tpu/solvers/cg.py's ell_spmv (a row gather and a row sum
// that XLA lowers to a gather), the operator of every Jacobi-PCG iteration
// on the general ELL layout.  It is not a Pallas kernel in the JAX
// package; on the card it carries the CG, so it is written by hand.
//
// What bounds it on the H100: bytes.  Per call it reads the valid values
// and column ids once (24.3M of each at 1M C3D4 elements, W = 45: 194 MB
// of f64 values and 97 MB of int32 ids), the row counts, and writes n
// results: a floor of about 0.090 ms at 3.35 TB/s.  x (4.4 MB in f64) is
// gathered once per slot from the 50 MB L2, a 32-byte sector per gather
// at random node numbering, which is where this kernel and cuSPARSE's CSR
// matvec both stop short of the floor.
//
// The first design, one thread per row over the (W, n) transposed
// operands, reached 72% of the floor and lost to the CSR matvec on the
// same operator (0.1263 against 0.1175 ms in f64 on an H100 SXM at 700 W):
// 555,579 threads are two waves of the card, and each had one slot's
// loads in flight.
//
// Design: R rows per thread, R = 6 in f64 and 1 in f32.
// - Thread t takes rows t + q * ceil(n / R), q < R, and walks them at once,
//   slot by slot: R independent chains of id, value and x loads and
//   multiply-adds in flight per thread.  For each slot, neighbouring
//   threads read neighbouring addresses of the transposed operands
//   (coalesced); each row stops at its own count of valid slots, so the
//   padding is never read.
// - Each row is summed in slot order with one multiply-add per slot, as
//   in the first design (R = 1), with no atomics: the result is the same
//   bits whatever R, so a CG takes the same iterations.
// - R was chosen on the ELL slice's operator, in turns with the CSR matvec
//   on an H100 SXM at 700 W: in f64, 6 rows came closest to cuSPARSE,
//   mostly a little behind it (0.1182 against 0.1172 ms in one run,
//   0.1192 against 0.1218 in another), where 1 row ran 7% behind it; in
//   f32 every R > 1 was slower than 1.  The
//   time moves with R and the register count in steps no model here
//   predicts (2 rows per thread was the slowest of all in both types).
// - Also tried: a row split over four threads changes the rounding (the
//   ELL slice's CG then took 306 iterations, not 312); staging (n, W)
//   row-major runs of 64 rows in shared memory, by thread loads (0.194 ms
//   in f64) or by bulk copies, was slower.
// Float and double, 64-bit offsets.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__host__ __device__ constexpr int rows_per_thread() {
  return sizeof(T) == 8 ? 6 : 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ell_spmv_kernel(
    const T* __restrict__ values_t, const int* __restrict__ colidx_t,
    const int* __restrict__ row_counts, const T* __restrict__ x,
    T* __restrict__ y, long long n) {
  constexpr int R = rows_per_thread<T>();
  const long long stride = (n + R - 1) / R;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= stride) return;
  long long r[R];
  int count[R];
  T acc[R];
  int most = 0;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    r[q] = t + q * stride;
    count[q] = r[q] < n ? __ldg(row_counts + r[q]) : 0;
    most = count[q] > most ? count[q] : most;
    acc[q] = T(0);
  }
  for (int w = 0; w < most; ++w) {
    const long long s = static_cast<long long>(w) * n;
    int c[R];
    T v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      c[q] = 0;
      v[q] = T(0);
      if (w < count[q]) {
        c[q] = __ldg(colidx_t + s + r[q]);
        v[q] = __ldg(values_t + s + r[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (w < count[q]) acc[q] += v[q] * __ldg(x + c[q]);
  }
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (r[q] < n) y[r[q]] = acc[q];
}

template <typename T>
int launch(const T* values_t, const int* colidx_t, const int* row_counts,
           const T* x, T* y, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long threads =
      (n + rows_per_thread<T>() - 1) / rows_per_thread<T>();
  const long long blocks = (threads + kThreads - 1) / kThreads;
  ell_spmv_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      values_t, colidx_t, row_counts, x, y, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int femcy_ell_spmv_f32(const float* values_t, const int* colidx_t,
                                  const int* row_counts, const float* x,
                                  float* y, long long n, void* stream) {
  return launch<float>(values_t, colidx_t, row_counts, x, y, n, stream);
}

extern "C" int femcy_ell_spmv_f64(const double* values_t, const int* colidx_t,
                                  const int* row_counts, const double* x,
                                  double* y, long long n, void* stream) {
  return launch<double>(values_t, colidx_t, row_counts, x, y, n, stream);
}
