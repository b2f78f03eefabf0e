// ELL SpMV for Hopper: y[r] = sum_w values_t[w, r] * x[colidx_t[w, r]].
//
// Replaces femcy_tpu/solvers/cg.py's ell_spmv (a row gather and a row sum
// that XLA lowers to a gather), the operator of every Jacobi-PCG iteration
// on the general ELL layout.  It is not a Pallas kernel in the JAX
// package; on the card it carries the CG, so it is written by hand.
//
// What bounds it on the H100: bytes.  Per call it reads the values and the
// column ids once (W * n of each: 200 MB of f64 values and 100 MB of int32
// ids at 1M C3D4 elements, W = 45) and writes n results: a floor of about
// 0.09 ms at 3.35 TB/s.  x (4.4 MB in f64) is gathered W times per row,
// but after the first touch it sits in the 50 MB L2.
//
// Design: one thread per row over the (W, n) transposed operands -- values
// made once per solve, column ids once per system -- so for each slot w
// neighbouring threads read neighbouring addresses (coalesced).  Each row
// stops at its own count of valid slots (row_counts), so the padding is
// never read.  The sum runs over w in slot order, one multiply-add per
// slot, with no atomics: the result is deterministic.  Float and double,
// 64-bit offsets.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void ell_spmv_kernel(const T* __restrict__ values_t,
                                const int* __restrict__ colidx_t,
                                const int* __restrict__ row_counts,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long n) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int count = __ldg(row_counts + r);
  T acc = T(0);
  for (int w = 0; w < count; ++w) {
    const long long s = static_cast<long long>(w) * n + r;
    acc += __ldg(values_t + s) * __ldg(x + __ldg(colidx_t + s));
  }
  y[r] = acc;
}

template <typename T>
int launch(const T* values_t, const int* colidx_t, const int* row_counts,
           const T* x, T* y, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
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
