// Deterministic mixed beam + continuum stiffness scatter for Hopper (M6):
// continuum element stiffnesses and B31 beam stiffnesses -> ELL values of
// the 6-dof union pattern, with no atomics.
//
// Replaces the two indexed adds of femcy_tpu's mixed assembly
// (mixed.py, MixedSystem._assemble_impl: flat.at[targets].add per block),
// which XLA lowers to a sorted or atomic scatter; it is no Pallas kernel.
// femcy_tpu adds every block into one running array, so a slot is
// ((0 + c_1 + c_2 + ...) + b_1 + b_2 + ...): blocks in order, elements in
// order within a block.  This kernel keeps that order.
//
// Layout.  Every node n owns the six dof rows 6n + d (d < 3 the
// translations, d >= 3 the rotations), each W slots wide.  The three
// translation rows share one column list: for each neighbour m in
// ascending order, a run of 3 columns (6m + 0..2), or of 6 (6m + 0..5)
// where a beam couples n and m.  The three rotation rows of a beam node
// share the beam neighbours' runs of 6.
//
// Inputs: a table of the blocks, in femcy_tpu's block order, four int64
// each: the address of the block's element matrices (E_b, edof_b, edof_b)
// with edof_b = npe_b * dm_b (dm_b 3 for a continuum block, 6 for a beam
// block), the first global pair id of the block, npe_b and dm_b; the
// inverse of the element-node maps, made once per pattern on the host:
// for each node n its element-node pairs, global pair id
// p = offset_b + e * npe_b + a with elements_b[e, a] == n, in ascending p
// (node_ptr/pairs, CSR form; stored as ~p where element e names one node
// twice), and for pair t of that list `stride` run starts
// (positions[t * stride + k]): for a continuum pair, k = b the start of
// local node b's run in n's translation row; for a beam pair, k = b the
// translation start and k = 2 + b the rotation start of local node b.
// Value (di, b, dj) of pair p's band Ke[e, a*dm:(a+1)*dm, :] goes to row
// 6n + di, slot start + dj, where start is the translation run start of b
// for di < 3 and its rotation run start for di >= 3.
//
// Design, M1's row band widened: one warp owns node n.  It zeroes n's
// 6 * W values in shared memory and walks n's pairs in order.  A pair's
// contributions are one contiguous band of dm * edof values (288 bytes
// for C3D4 in f64, 576 for a beam), read with coalesced loads, lane j of
// round r taking value r * 32 + j of the band.  The slots of one pair are
// distinct unless its element names a node twice; such pairs (flagged on
// the host) add their b one at a time.  A __syncwarp closes every pair,
// so each slot takes its contributions in ascending p, which is block
// order and then element order, from 0: bit for bit the plain version's
// sum (one indexed add per block into one accumulator), on every run.  At
// the end the warp writes n's six rows as one contiguous run, padding
// included (0).  A node row group longer than kRowBytes (W > 1024) is
// refused, as the plan builder refuses it first.
//
// What bounds it on the H100: bytes.  At 1M C3D4 elements with a beam grid
// in f64 it reads the continuum Ke once (1.21 GB) in 288-byte bands, the
// beam matrices (7 MB), the plan (4.2M int32 pairs, 16.9M int16
// positions) and writes the 6 * 185k * W values.  The adds are one
// shared-memory read-modify-write per value and hide behind the reads.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// warps (node row groups) per block
constexpr int kWarps = 2;
// the longest node row group (6 * W values, at 8 bytes a value) kept in
// shared memory (SHARED_ROW_BYTES in kernels/mixed_scatter.py)
constexpr int kRowBytes = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mixed_row_kernel(const long long* __restrict__ blocks, int n_blocks,
                 const long long* __restrict__ node_ptr,
                 const int* __restrict__ pairs,
                 const short* __restrict__ positions, int stride, T* __restrict__ out, long long n_nodes, int width,
                 int row_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (n >= n_nodes) return;  // the whole warp
  const int len = 6 * width;
  T* dst = out + n * len;
  T* row = reinterpret_cast<T*>(smem) + warp * row_stride;
  for (int i = lane; i < len; i += 32) row[i] = T(0);
  __syncwarp();

  const long long lo = __ldg(node_ptr + n);
  const int np = static_cast<int>(__ldg(node_ptr + n + 1) - lo);
  for (int t = 0; t < np; ++t) {
    const int pid = __ldg(pairs + lo + t);
    const long long p = pid < 0 ? ~pid : pid;
    // the block of pair p: the last one whose first pair is <= p
    int b = 0;
    while (b + 1 < n_blocks && __ldg(blocks + (b + 1) * 4 + 1) <= p) ++b;
    const T* ke = reinterpret_cast<const T*>(__ldg(blocks + b * 4));
    const long long q = p - __ldg(blocks + b * 4 + 1);
    const int npe = static_cast<int>(__ldg(blocks + b * 4 + 2));
    const int dm = static_cast<int>(__ldg(blocks + b * 4 + 3));
    const int edof = npe * dm;
    const int band = dm * edof;
    const long long e = q / npe;
    const int a = static_cast<int>(q - e * npe);
    const T* src = ke + (e * edof + a * dm) * edof;
    const int pos = lane < stride
        ? static_cast<int>(__ldg(positions + (lo + t) * stride + lane)) : 0;
    for (int r = 0; r * 32 < band; ++r) {
      const int j = r * 32 + lane;
      const bool act = j < band;
      const int jj = act ? j : 0;
      const int di = jj / edof;
      const int col = jj - di * edof;
      const int bl = col / dm;
      const int dj = col - bl * dm;
      const int start = __shfl_sync(kFull, pos, di >= 3 ? 2 + bl : bl);
      const int slot = di * width + start + dj;
      const T v = act ? __ldg(src + j) : T(0);
      if (pid >= 0) {
        if (act) row[slot] += v;
      } else {
        // the element names a node twice: two b share a slot, so add the
        // b in ascending order
        for (int bb = 0; bb < npe; ++bb) {
          if (act && bl == bb) row[slot] += v;
          __syncwarp();
        }
      }
    }
    __syncwarp();
  }

  for (int i = lane; i < len; i += 32) dst[i] = row[i];
}

template <typename T>
int launch(const long long* blocks, int n_blocks, const long long* node_ptr,
           const int* pairs, const short* positions, int stride, T* out,
           long long n_nodes, int width, void* stream) {
  if (n_nodes <= 0) return 0;
  if (n_blocks < 1 || stride < 1 || stride > 32 || width < 1 ||
      6 * width * 8 > kRowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // row groups start on 16-byte boundaries
  const int row_stride = (6 * width * static_cast<int>(sizeof(T)) + 15) / 16
      * 16 / static_cast<int>(sizeof(T));
  const int smem = kWarps * row_stride * static_cast<int>(sizeof(T));
  auto kernel = mixed_row_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = (n_nodes + kWarps - 1) / kWarps;
  kernel<<<static_cast<unsigned int>(grid), kWarps * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
      blocks, n_blocks, node_ptr, pairs, positions, stride, out, n_nodes,
      width, row_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int femcy_mixed_scatter_f32(const long long* blocks, int n_blocks,
                                       const long long* node_ptr,
                                       const int* pairs,
                                       const short* positions, int stride,
                                       float* out, long long n_nodes,
                                       int width, void* stream) {
  return launch<float>(blocks, n_blocks, node_ptr, pairs, positions, stride,
                       out, n_nodes, width, stream);
}

extern "C" int femcy_mixed_scatter_f64(const long long* blocks, int n_blocks,
                                       const long long* node_ptr,
                                       const int* pairs,
                                       const short* positions, int stride,
                                       double* out, long long n_nodes,
                                       int width, void* stream) {
  return launch<double>(blocks, n_blocks, node_ptr, pairs, positions, stride,
                        out, n_nodes, width, stream);
}
