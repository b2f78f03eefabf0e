// Deterministic stiffness scatter for Hopper: element stiffnesses -> ELL
// values (or general-DIA values), with no atomics.
//
// Replaces the segment-sum scatters of femcy_tpu on the general path:
// assembly.scatter_stiffness_blocks (ELL), solvers/dia.dia_scatter (DIA)
// and their caller system._scatter.  None of them is a Pallas kernel;
// XLA lowers them to a sorted or atomic scatter.  Here the scatter is
// turned into a gather, so the result is the same bits on every run.
//
// Inputs: Ke (E, edof, edof) with edof = npe * DM, row-major; the inverse
// of the node-block scatter map, made once per pattern on the host: for
// each node-ELL slot q = n * node_width + pos, the contributions
// c = (e * npe + a) * npe + b whose node pair (a, b) of element e lands
// there, in ascending c (ptr/ids, CSR form).  Node slot q of node row n
// owns the DM x DM dof slots (n*DM + di, pos*DM + dj); its value is the
// sum over its list of Ke[e, a*DM + di, b*DM + dj].
//
// Design: one thread per node slot keeps the DM*DM sums in registers and
// walks its list once, reading DM runs of DM contiguous Ke entries per
// contribution.  The sums run in list order, which is element order: the
// order of the plain segment-sum (an indexed add over the contributions
// in Ke layout order), so the kernel differs from it on the CPU by no
// rounding at all, and agrees with itself bit for bit on a rerun.  Every
// output slot is written, padding included (its list is empty: 0).  All
// offsets are 64-bit.  The general-DIA route passes out_map, the flat DIA
// slot of each flat ELL slot (-1 on padding), and a zeroed output; the
// map is injective on the valid slots, so no two threads write one slot.
//
// What bounds it on the H100: bytes.  At 1M C3D4 elements in f64 it reads
// Ke once (1.21 GB), the map (16.9M int32 ids, 68 MB, plus the node-slot
// pointers) and writes 0.20 GB of values: a floor of about 0.45 ms at
// 3.35 TB/s.  Ke is read in runs of DM values (24 bytes in f64), which is
// where it loses to the floor; staging Ke or fusing its computation in is
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int DM>
__global__ void ell_scatter_kernel(const T* __restrict__ ke,
                                   const long long* __restrict__ ptr,
                                   const int* __restrict__ ids,
                                   const long long* __restrict__ out_map,
                                   T* __restrict__ out, long long n_slots,
                                   int node_width, int width, int npe) {
  const long long q =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n_slots) return;
  const long long n = q / node_width;
  const int pos = static_cast<int>(q - n * node_width);
  const int npe2 = npe * npe;
  const long long edof = static_cast<long long>(npe) * DM;
  const long long ke_size = edof * edof;

  T acc[DM * DM];
#pragma unroll
  for (int i = 0; i < DM * DM; ++i) acc[i] = T(0);

  const long long lo = __ldg(ptr + q), hi = __ldg(ptr + q + 1);
  for (long long t = lo; t < hi; ++t) {
    const int c = __ldg(ids + t);
    const int e = c / npe2;
    const int ab = c - e * npe2;
    const int a = ab / npe;
    const int b = ab - a * npe;
    const T* blk = ke + static_cast<long long>(e) * ke_size +
                   static_cast<long long>(a) * DM * edof +
                   static_cast<long long>(b) * DM;
#pragma unroll
    for (int di = 0; di < DM; ++di) {
#pragma unroll
      for (int dj = 0; dj < DM; ++dj) {
        acc[di * DM + dj] += __ldg(blk + di * edof + dj);
      }
    }
  }

#pragma unroll
  for (int di = 0; di < DM; ++di) {
    const long long s0 =
        (n * DM + di) * static_cast<long long>(width) + pos * DM;
#pragma unroll
    for (int dj = 0; dj < DM; ++dj) {
      if (out_map == nullptr) {
        out[s0 + dj] = acc[di * DM + dj];
      } else {
        const long long s = __ldg(out_map + s0 + dj);
        if (s >= 0) out[s] = acc[di * DM + dj];
      }
    }
  }
}

template <typename T>
int launch(const T* ke, const long long* ptr, const int* ids,
           const long long* out_map, T* out, long long n_slots,
           int node_width, int width, int npe, int dm, void* stream) {
  if (n_slots <= 0) return 0;
  const long long blocks = (n_slots + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dm == 2) {
    ell_scatter_kernel<T, 2><<<static_cast<unsigned int>(blocks), kThreads,
                               0, s>>>(ke, ptr, ids, out_map, out, n_slots,
                                       node_width, width, npe);
  } else if (dm == 3) {
    ell_scatter_kernel<T, 3><<<static_cast<unsigned int>(blocks), kThreads,
                               0, s>>>(ke, ptr, ids, out_map, out, n_slots,
                                       node_width, width, npe);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int femcy_ell_scatter_f32(const float* ke, const long long* ptr,
                                     const int* ids, const long long* out_map,
                                     float* out, long long n_slots,
                                     int node_width, int width, int npe,
                                     int dm, void* stream) {
  return launch<float>(ke, ptr, ids, out_map, out, n_slots, node_width, width,
                       npe, dm, stream);
}

extern "C" int femcy_ell_scatter_f64(const double* ke, const long long* ptr,
                                     const int* ids, const long long* out_map,
                                     double* out, long long n_slots,
                                     int node_width, int width, int npe,
                                     int dm, void* stream) {
  return launch<double>(ke, ptr, ids, out_map, out, n_slots, node_width,
                        width, npe, dm, stream);
}
