// DIA SpMV for Hopper: y = A x with A[r, r + off_k] = values_t[k, r].
//
// Replaces the Pallas kernel femcy_tpu/kernels/dia_spmv.py (pallas_spmv,
// its _kernel and prep_values), which keeps x resident in VMEM and streams
// the transposed diagonals by row block.
//
// What bounds it on the H100: the values stream.  Per call it reads K * n
// values once (K = 59 at the structured box, 262 MB in f64 at NX=56) and
// writes n results; x (4.4 MB in f64) is read K times, but every read after
// the first hits the 50 MB L2, which is the card's version of "x resident
// in VMEM".  Arithmetic is 2 flops per 8-byte value, far below the f64 or
// f32 rate, so the kernel is memory bound by a wide margin.
//
// Design: one thread per row.  values_t is the (K, n) transposed operand
// made once per solve, so for each k neighbouring threads read neighbouring
// addresses (fully coalesced), and their x reads are one shifted contiguous
// run.  The K offsets are a small device array read with warp-uniform
// addresses (broadcast).  Instead of padding x as the TPU kernel does, each
// column is bounds-checked.  The sum runs over k in offset order, one fused
// multiply-add per term, with no atomics: the result is deterministic.
// There is no dtype or size gate: float and double, any n that fits the
// 64-bit index arithmetic.
//
// The windowed entry points (femcy_dia_spmv_window_*) run the same kernel
// over a window of a longer x: y[r] = sum_k values_t[k, r] *
// x[base + r + off_k] for the n rows of values_t, columns checked against
// x's own length n_x.  They replace the shifted slices of the slab's halo
// SpMV (femcy_tpu/parallel/structured.py, _spmv_local), whose x is the
// slab's rows with two node planes of halo on each side (base = the halo's
// length).  Same bound, same design; the plain entry points are the window
// with base 0 and n_x = n.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ values_t,
                                const T* __restrict__ x, T* __restrict__ y,
                                const int* __restrict__ offsets, long long n,
                                long long n_x, long long base,
                                int n_offsets) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  T acc = T(0);
  for (int k = 0; k < n_offsets; ++k) {
    const long long c = base + r + __ldg(offsets + k);
    if (c >= 0 && c < n_x) {
      acc += __ldg(values_t + static_cast<long long>(k) * n + r) * __ldg(x + c);
    }
  }
  y[r] = acc;
}

template <typename T>
int launch(const T* values_t, const T* x, T* y, const int* offsets,
           long long n, long long n_x, long long base, int n_offsets,
           void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  dia_spmv_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      values_t, x, y, offsets, n, n_x, base, n_offsets);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int femcy_dia_spmv_f32(const float* values_t, const float* x,
                                  float* y, const int* offsets, long long n,
                                  int n_offsets, void* stream) {
  return launch<float>(values_t, x, y, offsets, n, n, 0, n_offsets, stream);
}

extern "C" int femcy_dia_spmv_f64(const double* values_t, const double* x,
                                  double* y, const int* offsets, long long n,
                                  int n_offsets, void* stream) {
  return launch<double>(values_t, x, y, offsets, n, n, 0, n_offsets, stream);
}

extern "C" int femcy_dia_spmv_window_f32(const float* values_t,
                                         const float* x, float* y,
                                         const int* offsets, long long n,
                                         long long n_x, long long base,
                                         int n_offsets, void* stream) {
  return launch<float>(values_t, x, y, offsets, n, n_x, base, n_offsets,
                       stream);
}

extern "C" int femcy_dia_spmv_window_f64(const double* values_t,
                                         const double* x, double* y,
                                         const int* offsets, long long n,
                                         long long n_x, long long base,
                                         int n_offsets, void* stream) {
  return launch<double>(values_t, x, y, offsets, n, n_x, base, n_offsets,
                        stream);
}
