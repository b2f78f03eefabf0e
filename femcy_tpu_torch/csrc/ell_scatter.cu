// Deterministic stiffness scatter for Hopper (M1): element stiffnesses ->
// ELL values (or general-DIA values), with no atomics.
//
// Replaces the segment-sum scatters of femcy_tpu on the general path:
// assembly.scatter_stiffness_blocks (ELL), solvers/dia.dia_scatter (DIA)
// and their caller system._scatter.  None of them is a Pallas kernel;
// XLA lowers them to a sorted or atomic scatter.  Here the scatter is
// turned into a gather, so the result is the same bits on every run.
//
// Inputs: Ke (E, edof, edof) with edof = npe * dm, row-major; the inverse
// of the element-node map, made once per pattern on the host: for each
// node n, its element-node pairs p = e * npe + a with elements[e, a] == n,
// in ascending p (node_ptr/pairs, CSR form; stored as ~p where element e
// names one node twice), and for pair t of that list and each local node
// b, the position of elements[e, b] in n's node-ELL row
// (positions[t * npe + b]).  Node n owns the dm output rows n * dm + di;
// on the ELL layout value (di, b, dj) of pair p goes to row n * dm + di,
// slot pos_b * dm + dj, and each slot is the sum of its contributions in
// ascending (e, a, b): the order of the plain segment-sum (an indexed add
// over the contributions in Ke layout order).
//
// Design, a row band per node: one warp owns node n.  It zeroes n's dm * W
// ELL values in shared memory and walks n's pairs in order.  Pair p's
// contributions are one contiguous band Ke[e, a*dm:(a+1)*dm, :] of
// dm * edof values (288 bytes for C3D4 in f64), read with coalesced
// loads: lane j of round r takes value r * 32 + j = (di, b, dj) of the
// band into a register, and the next pair's band is loaded while the
// current one is added.  Each value goes into slot (di, pos_b, dj).  The
// slots of one pair are distinct unless its element names a node twice;
// such pairs (flagged on the host) add their b one at a time.  A
// __syncwarp closes every pair, so each slot takes its contributions in
// ascending (e, a, b) and the result is bit for bit the plain version's,
// on every run.  At the end the warp writes n's dm rows as one contiguous
// run, padding included (0).  On the general-DIA route it zeroes n's
// dm * K output values and then writes each ELL value to its DIA column
// (dia_columns: k in [0, K) of every ELL slot, -1 on padding), so the
// output needs no memset.
//
// Wide rows: a node row of more than kRowBytes (dm * W values at 8 bytes;
// a node with more than 682 neighbours in 3-D) is not kept in shared
// memory.  The host then builds a wide plan (int32 indices, also taken
// for K > 2^15 DIA columns), and the kernel keeps the sums in the output
// itself: the warp zeroes its output run, and each value goes to its final
// slot (through dia_columns on the DIA route) in the same order, so the
// bits are the same.  Any W and K are accepted.  All offsets into Ke and
// the output are 64-bit.
//
// What bounds it on the H100: bytes.  At 1M C3D4 elements in f64 it reads
// Ke once (1.21 GB), in 288-byte bands in the nodes' order, the plan (4.2M
// int32 pairs and 16.9M int16 positions) and writes 0.20 GB of values: a
// floor of about 0.44 ms at 3.35 TB/s.  The adds are one shared-memory
// read-modify-write per value and hide behind the reads.  The reads land
// in random 288-byte runs, which the card serves more slowly than a
// stream; more bands in flight (in registers, or by bulk copies into a
// shared ring) gained at most a few percent.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// warps (node rows) per block
constexpr int kWarps = 2;
// the most values of a band a warp handles: 32 lanes, 8 rounds
constexpr int kMaxBand = 32 * 8;
// the longest node row kept in shared memory, in bytes at 8 bytes a value
// (SHARED_ROW_BYTES in kernels/ell_scatter.py)
constexpr int kRowBytes = 48 * 1024;
static_assert(kWarps * kRowBytes <= 227 * 1024,
              "a block of the longest rows exceeds the shared memory of an SM");

// Unless kWide, each warp keeps its ELL row (dm * W values) in shared
// memory, row_stride values apart.
template <typename T, int MAXR, bool kWide>
__global__ void __launch_bounds__(kWarps * 32)
row_band_kernel(const T* __restrict__ ke,
                const long long* __restrict__ node_ptr,
                const int* __restrict__ pairs,
                const typename std::conditional<kWide, int, short>::type*
                    __restrict__ positions,
                const typename std::conditional<kWide, int, short>::type*
                    __restrict__ dia_columns,
                T* __restrict__ out, long long n_nodes, int width,
                int n_cols, int npe, int dm, int row_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (n >= n_nodes) return;  // the whole warp
  const bool dia = dia_columns != nullptr;
  const int ell_len = dm * width;
  const int out_len = dia ? dm * n_cols : ell_len;
  T* dst = out + n * out_len;
  // where the sums are kept: the ELL row in shared memory, or (wide) the
  // output run itself
  T* row = kWide ? dst : reinterpret_cast<T*>(smem) + warp * row_stride;
  for (int i = lane; i < (kWide ? out_len : ell_len); i += 32) row[i] = T(0);

  // lane's value (di, b, dj) in each round of a band, its row di, and its
  // ELL slot without the position term
  const int edof = npe * dm;
  const int band = dm * edof;
  int base[MAXR], bsel[MAXR], brow[MAXR];
  bool act[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int j = r * 32 + lane;
    act[r] = j < band;
    const int jj = act[r] ? j : 0;
    const int di = jj / edof, col = jj - di * edof;
    const int b = col / dm;
    base[r] = di * width + (col - b * dm);
    bsel[r] = b;
    brow[r] = di;
  }

  const long long lo = __ldg(node_ptr + n);
  const int np = static_cast<int>(__ldg(node_ptr + n + 1) - lo);
  // the node's pair ids, 32 at a time, one per lane
  int chunk = 0;
  int ids = lane < np ? __ldg(pairs + lo + lane) : 0;

  // pair t's id, the lane's values of its band, and (lane < npe) the
  // position of local node lane
  auto load = [&](int t, T* v, int& pid, int& pos) {
    if (t >= chunk + 32) {
      chunk += 32;
      ids = chunk + lane < np ? __ldg(pairs + lo + chunk + lane) : 0;
    }
    pid = __shfl_sync(kFull, ids, t - chunk);
    const T* src =
        ke + static_cast<long long>(pid < 0 ? ~pid : pid) * band + lane;
#pragma unroll
    for (int r = 0; r < MAXR; ++r) v[r] = act[r] ? __ldg(src + r * 32) : T(0);
    pos = lane < npe
        ? static_cast<int>(__ldg(positions + (lo + t) * npe + lane)) : 0;
  };
  __syncwarp();
  T v[MAXR];
  int pid = 0, pos = 0;
  if (np > 0) load(0, v, pid, pos);
  for (int t = 0; t < np; ++t) {
    T w[MAXR];
    int pid_next = 0, pos_next = 0;
    if (t + 1 < np) load(t + 1, w, pid_next, pos_next);
    int slot[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      slot[r] = base[r] + __shfl_sync(kFull, pos, bsel[r]) * dm;
      if constexpr (kWide) {
        if (dia && act[r])
          slot[r] = brow[r] * n_cols + static_cast<int>(
              __ldg(dia_columns + n * ell_len + slot[r]));
      }
    }
    if (pid >= 0) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (act[r]) row[slot[r]] += v[r];
    } else {
      // the element names a node twice: two b share a slot, so add the
      // b in ascending order
      for (int b = 0; b < npe; ++b) {
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (act[r] && bsel[r] == b) row[slot[r]] += v[r];
        __syncwarp();
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < MAXR; ++r) v[r] = w[r];
    pid = pid_next;
    pos = pos_next;
  }

  if (kWide) return;  // the sums are in place
  if (!dia) {
    for (int i = lane; i < ell_len; i += 32) dst[i] = row[i];
    return;
  }
  for (int i = lane; i < out_len; i += 32) dst[i] = T(0);
  __syncwarp();
  const auto* cols = dia_columns + n * ell_len;
  for (int i = lane; i < ell_len; i += 32) {
    const int k = __ldg(cols + i);
    if (k >= 0) dst[(i / width) * n_cols + k] = row[i];
  }
}

template <typename T, int MAXR, bool kWide>
int launch_t(const T* ke, const long long* node_ptr, const int* pairs,
             const void* positions, const void* dia_columns, T* out,
             long long n_nodes, int width, int n_cols, int npe, int dm,
             cudaStream_t s) {
  using Index = typename std::conditional<kWide, int, short>::type;
  if (!kWide && dm * width * 8 > kRowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // rows start on 16-byte boundaries
  const int row_stride = kWide ? 0
      : (dm * width * static_cast<int>(sizeof(T)) + 15) / 16 * 16
            / static_cast<int>(sizeof(T));
  const int smem = kWarps * row_stride * static_cast<int>(sizeof(T));
  auto kernel = row_band_kernel<T, MAXR, kWide>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n_nodes + kWarps - 1) / kWarps;
  kernel<<<static_cast<unsigned int>(blocks), kWarps * 32, smem, s>>>(
      ke, node_ptr, pairs, static_cast<const Index*>(positions),
      static_cast<const Index*>(dia_columns), out, n_nodes, width, n_cols,
      npe, dm, row_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MAXR>
int launch_r(const T* ke, const long long* node_ptr, const int* pairs,
             const void* positions, const void* dia_columns, int wide, T* out,
             long long n_nodes, int width, int n_cols, int npe, int dm,
             cudaStream_t s) {
  return wide ? launch_t<T, MAXR, true>(ke, node_ptr, pairs, positions,
                                        dia_columns, out, n_nodes, width,
                                        n_cols, npe, dm, s)
              : launch_t<T, MAXR, false>(ke, node_ptr, pairs, positions,
                                         dia_columns, out, n_nodes, width,
                                         n_cols, npe, dm, s);
}

template <typename T>
int launch(const T* ke, const long long* node_ptr, const int* pairs,
           const void* positions, const void* dia_columns, int wide, T* out,
           long long n_nodes, int width, int n_cols, int npe, int dm,
           void* stream) {
  if (n_nodes <= 0) return 0;
  const int band = dm * dm * npe;
  if (npe < 1 || npe > 32 || (dm != 2 && dm != 3) || band > kMaxBand)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rounds = (band + 31) / 32;
  if (rounds <= 2)
    return launch_r<T, 2>(ke, node_ptr, pairs, positions, dia_columns, wide,
                          out, n_nodes, width, n_cols, npe, dm, s);
  if (rounds == 3)
    return launch_r<T, 3>(ke, node_ptr, pairs, positions, dia_columns, wide,
                          out, n_nodes, width, n_cols, npe, dm, s);
  return launch_r<T, 8>(ke, node_ptr, pairs, positions, dia_columns, wide,
                        out, n_nodes, width, n_cols, npe, dm, s);
}

}  // namespace

extern "C" int femcy_ell_scatter_f32(const float* ke, const long long* node_ptr,
                                     const int* pairs, const void* positions,
                                     const void* dia_columns, int wide,
                                     float* out, long long n_nodes, int width,
                                     int n_cols, int npe, int dm,
                                     void* stream) {
  return launch<float>(ke, node_ptr, pairs, positions, dia_columns, wide, out,
                       n_nodes, width, n_cols, npe, dm, stream);
}

extern "C" int femcy_ell_scatter_f64(const double* ke,
                                     const long long* node_ptr,
                                     const int* pairs, const void* positions,
                                     const void* dia_columns, int wide,
                                     double* out, long long n_nodes, int width,
                                     int n_cols, int npe, int dm,
                                     void* stream) {
  return launch<double>(ke, node_ptr, pairs, positions, dia_columns, wide,
                        out, n_nodes, width, n_cols, npe, dm, stream);
}
