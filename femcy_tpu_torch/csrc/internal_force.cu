// Deterministic internal-force scatter for Hopper, in gather form (M4).
//
// Replaces the segment-sum of the JAX package's general Newton path:
// femcy_tpu/assembly.py internal_force (:198-207), called from
// system._internal_force_parts (:665-676), which sums the per-element nodal
// forces f_e (E, npe, dm) into the global force (n_dof,) over the targets
// elements * dm + i.  XLA runs it as a scatter-add.
//
// Inputs: f_e, the (E * npe * dm) element forces, with pair p = e * npe + a
// owning f_e[p * dm .. p * dm + dm); and the inverse of the element-node map
// that the stiffness scatter (M1, ell_scatter.cu) already uses: node n's
// pairs are pairs[node_ptr[n] .. node_ptr[n + 1]), in ascending p, a pair
// stored as ~p where its element names one node twice.
// Output: out[n * dm + i] = the sum of f_e[p * dm + i] over node n's pairs.
//
// What bounds it on the H100: reading f_e once (E * npe * dm values, 101 MB
// in f64 at 1,053,696 C3D4) plus the pair list (4 bytes a pair) and the
// node pointers, and writing n_dof values.  One add per value read: memory
// bound.
//
// Design:
// - Gather form, one thread per node, dm accumulators in registers.  A
//   thread walks its node's pairs in list order and adds each pair's dm
//   consecutive values; every component sums its contributions in
//   ascending p from +0, the order in which the plain version (an indexed
//   add over f_e in element order, kernels/internal_force.py) reaches
//   them.  No atomics: the result is bit for bit the plain version's, and
//   identical from run to run.
// - A flagged pair (~p) is decoded to p and added like any other: an
//   element that names a node twice gives that node both its pairs.
// - 64-bit index arithmetic for f_e (E * npe * dm reaches 2^31 at about
//   180M tets); the pair ids themselves are int32, as the plan stores them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int DM>
__global__ void internal_force_kernel(const T* __restrict__ f_e,
                                      const long long* __restrict__ node_ptr,
                                      const int* __restrict__ pairs,
                                      T* __restrict__ out, long long n_nodes) {
  const long long n =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  T acc[DM];
#pragma unroll
  for (int i = 0; i < DM; ++i) acc[i] = T(0);
  const long long t_end = __ldg(node_ptr + n + 1);
  for (long long t = __ldg(node_ptr + n); t < t_end; ++t) {
    int p = __ldg(pairs + t);
    if (p < 0) p = ~p;
    const T* src = f_e + static_cast<long long>(p) * DM;
#pragma unroll
    for (int i = 0; i < DM; ++i) acc[i] += __ldg(src + i);
  }
#pragma unroll
  for (int i = 0; i < DM; ++i) out[n * DM + i] = acc[i];
}

template <typename T>
int launch(const T* f_e, const long long* node_ptr, const int* pairs, T* out,
           long long n_nodes, int dm, void* stream) {
  if (n_nodes <= 0) return 0;
  const long long blocks = (n_nodes + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dm == 3) {
    internal_force_kernel<T, 3><<<static_cast<unsigned int>(blocks), kThreads,
                                  0, s>>>(f_e, node_ptr, pairs, out, n_nodes);
  } else if (dm == 2) {
    internal_force_kernel<T, 2><<<static_cast<unsigned int>(blocks), kThreads,
                                  0, s>>>(f_e, node_ptr, pairs, out, n_nodes);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int femcy_internal_force_f32(const float* f_e,
                                        const long long* node_ptr,
                                        const int* pairs, float* out,
                                        long long n_nodes, int dm,
                                        void* stream) {
  return launch<float>(f_e, node_ptr, pairs, out, n_nodes, dm, stream);
}

extern "C" int femcy_internal_force_f64(const double* f_e,
                                        const long long* node_ptr,
                                        const int* pairs, double* out,
                                        long long n_nodes, int dm,
                                        void* stream) {
  return launch<double>(f_e, node_ptr, pairs, out, n_nodes, dm, stream);
}
