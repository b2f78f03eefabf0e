// Block-tridiagonal stiffness and force scatter for Hopper (M8): a shard's
// element entries -> its local (nbl + 1, 3, B, B) block-tridiagonal
// buffer, halo row block included, or its element forces -> (nbl + 1) * B
// rows, with no atomics.
//
// Replaces the segment-sums of femcy_tpu/parallel/banded.py: _btd_assemble
// (:679), the Newton tangent (:641) and the internal force (:611).  None of
// them is a Pallas kernel; XLA lowers them to a sorted or atomic scatter.
// Here the scatter is a gather: the host (or the device, once per plan)
// sorts the shard's entry targets stably, which gives for every target
// slot the run of entries that land there, in entry order.
//
// Inputs: the shard's values (n_entries,) in entry order (Ke flattened in
// element order, or the element forces); order (n_entries,): the entry
// ids sorted by target, stable (int32 where it fits, else int64);
// run_start (n_runs + 1,) int64: run u is order[run_start[u] ..
// run_start[u + 1]); run_target (n_runs,) int64: the slot run u sums into.
//
// Design, the simple one that is right: the entry point zeroes the whole
// output (cudaMemsetAsync; slots no entry touches stay 0), then one thread
// per run sums its entries from 0 in entry order and writes the slot once.
// That is the order of femcy_tpu's segment_sum and of the plain version
// (an indexed add over the entries in entry order from a zeroed buffer),
// so the result is the same bits, on every run.
//
// What bounds it on the H100: bytes.  It must write the whole output (the
// zero blocks of the band too: at the full-width cantilever's shard,
// 101 x 3 x 1328^2 values, 4.27 GB in f64) and read the values and the
// plan once.  The output's memset streams at the card's rate; the values
// are read through order, 8 bytes at random addresses, which wastes most
// of each 32-byte sector.  Making that fast (entries sorted by target once
// per plan and read in that order, a warp per row of a block) is later
// work.  Float and double, 64-bit offsets.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads) run_sum_kernel(
    const T* __restrict__ values, const I* __restrict__ order,
    const long long* __restrict__ run_start,
    const long long* __restrict__ run_target, T* __restrict__ out,
    long long n_runs) {
  const long long u = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (u >= n_runs) return;
  const long long a = __ldg(run_start + u);
  const long long b = __ldg(run_start + u + 1);
  T acc = T(0);
  for (long long j = a; j < b; ++j)
    acc += __ldg(values + static_cast<long long>(__ldg(order + j)));
  out[__ldg(run_target + u)] = acc;
}

template <typename T, typename I>
int launch(const T* values, const I* order, const long long* run_start,
           const long long* run_target, T* out, long long n_runs,
           long long n_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, n_out * sizeof(T), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_runs <= 0) return 0;
  const long long blocks = (n_runs + kThreads - 1) / kThreads;
  run_sum_kernel<T, I><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      values, order, run_start, run_target, out, n_runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FEMCY_BTD_ENTRY(NAME, T, I)                                          \
  extern "C" int NAME(const T* values, const I* order,                      \
                      const long long* run_start,                           \
                      const long long* run_target, T* out,                  \
                      long long n_runs, long long n_out, void* stream) {    \
    return launch<T, I>(values, order, run_start, run_target, out, n_runs, \
                        n_out, stream);                                     \
  }

FEMCY_BTD_ENTRY(femcy_btd_scatter_f32_i32, float, int)
FEMCY_BTD_ENTRY(femcy_btd_scatter_f64_i32, double, int)
FEMCY_BTD_ENTRY(femcy_btd_scatter_f32_i64, float, long long)
FEMCY_BTD_ENTRY(femcy_btd_scatter_f64_i64, double, long long)
