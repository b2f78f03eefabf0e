// Deterministic internal-force scatter for Hopper, in gather form (M4).
//
// Replaces the segment-sum of the JAX package's general Newton path:
// femcy_tpu/assembly.py internal_force (:198-207), called from
// system._internal_force_parts (:665-676), which sums the per-element nodal
// forces f_e (E, npe, dm) into the global force (n_dof,) over the targets
// elements * dm + i.  XLA runs it as a scatter-add.
//
// Inputs: f_e, the (E * npe * dm) element forces, with pair p = e * npe + a
// owning f_e[p * dm .. p * dm + dm); the inverse of the element-node map
// that the stiffness scatter (M1, ell_scatter.cu) already uses: node n's
// pairs are pairs[node_ptr[n] .. node_ptr[n + 1]), in ascending p, a pair
// stored as ~p where its element names one node twice; and node_order, the
// n_nodes node numbers sorted by their first (smallest) pair, nodes with no
// pair last.
// Output: out[n * dm + i] = the sum of f_e[p * dm + i] over node n's pairs.
//
// What bounds it on the H100: reading f_e once (E * npe * dm values, 101 MB
// in f64 at 1,053,696 C3D4: 12.6M values) plus the pair list (4 bytes a
// pair, 16.9 MB there), the node pointers and the order (12 bytes a node),
// and writing n_dof values.  One add per value read: memory bound.
//
// Design:
// - Gather form, eight lanes a node, dm accumulators in registers.  The
//   group takes its node's pairs eight at a time: lane j loads the id of
//   pair base + j and that pair's dm consecutive values, so a group has
//   eight records in flight where one thread had one, behind a dependent
//   pair-id load.  Then every lane of the group adds the eight records in
//   list order, from +0, reading each through a shuffle: every component
//   sums its contributions in ascending p from +0, the order in which the
//   plain version (an indexed add over f_e in element order,
//   kernels/internal_force.py) reaches them.  No atomics: the result is
//   bit for bit the plain version's, and identical from run to run.
// - Element-ordered traversal: group t sums node node_order[t].  Node
//   numbers of a real mesh are in no useful order (unstructured_box_tets
//   permutes them at random), but element numbers follow space, so groups
//   that sit together take nodes whose elements are neighbours: the
//   96-byte block of one tet's four records (f64, dm 3) is then pulled
//   from DRAM about once, by groups that run together, and not up to four
//   times by unrelated threads at unrelated times (f_e is twice the 50 MB
//   L2).  Each group also reads its node's pair ids as one run.
// - A flagged pair (~p) is decoded to p and added like any other: an
//   element that names a node twice gives that node both its pairs.
// - 64-bit index arithmetic for f_e (E * npe * dm reaches 2^31 at about
//   180M tets); the pair ids themselves are int32, as the plan stores them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // lanes a node

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
internal_force_kernel(const T* __restrict__ f_e,
                      const long long* __restrict__ node_ptr,
                      const int* __restrict__ pairs,
                      const int* __restrict__ node_order,
                      T* __restrict__ out, long long n_nodes) {
  const long long t =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
      kGroup;
  const int sub = threadIdx.x % kGroup;
  // the group's lanes: every lane of a group runs the same loop
  const unsigned group = 0xffu << ((threadIdx.x % 32) / kGroup * kGroup);
  const bool live = t < n_nodes;
  long long n = 0, lo = 0, hi = 0;
  if (live) {
    n = __ldg(node_order + t);
    lo = __ldg(node_ptr + n);
    hi = __ldg(node_ptr + n + 1);
  }
  T acc[DM];
#pragma unroll
  for (int i = 0; i < DM; ++i) acc[i] = T(0);
  for (long long base = lo; base < hi; base += kGroup) {
    const long long mine = base + sub;
    int p = mine < hi ? __ldg(pairs + mine) : 0;
    if (p < 0) p = ~p;
    T v[DM];
#pragma unroll
    for (int i = 0; i < DM; ++i)
      v[i] = mine < hi ? __ldg(f_e + static_cast<long long>(p) * DM + i)
                       : T(0);
    const long long count = hi - base;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
#pragma unroll
      for (int i = 0; i < DM; ++i) {
        const T w = __shfl_sync(group, v[i], j, kGroup);
        if (j < count) acc[i] += w;
      }
    }
  }
  // lane i of the group writes component i
  if (live && sub < DM) {
    T val = acc[0];
#pragma unroll
    for (int i = 1; i < DM; ++i)
      if (sub == i) val = acc[i];
    out[n * DM + sub] = val;
  }
}

template <typename T>
int launch(const T* f_e, const long long* node_ptr, const int* pairs,
           const int* node_order, T* out, long long n_nodes, int dm,
           void* stream) {
  if (n_nodes <= 0) return 0;
  const long long blocks = (n_nodes * kGroup + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  if (dm == 3) {
    internal_force_kernel<T, 3><<<grid, kThreads, 0, s>>>(
        f_e, node_ptr, pairs, node_order, out, n_nodes);
  } else if (dm == 2) {
    internal_force_kernel<T, 2><<<grid, kThreads, 0, s>>>(
        f_e, node_ptr, pairs, node_order, out, n_nodes);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int femcy_internal_force_f32(const float* f_e,
                                        const long long* node_ptr,
                                        const int* pairs,
                                        const int* node_order, float* out,
                                        long long n_nodes, int dm,
                                        void* stream) {
  return launch<float>(f_e, node_ptr, pairs, node_order, out, n_nodes, dm,
                       stream);
}

extern "C" int femcy_internal_force_f64(const double* f_e,
                                        const long long* node_ptr,
                                        const int* pairs,
                                        const int* node_order, double* out,
                                        long long n_nodes, int dm,
                                        void* stream) {
  return launch<double>(f_e, node_ptr, pairs, node_order, out, n_nodes, dm,
                        stream);
}
