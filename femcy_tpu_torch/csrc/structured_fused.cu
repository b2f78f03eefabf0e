// Fused structured-box assembly for Hopper (P3): node coordinates -> DIA
// values of a Kuhn box in one kernel, in gather form.
//
// Replaces the Pallas kernel femcy_tpu/kernels/structured_fused.py
// (pallas_fused_assemble, its _kernel and build_fused_plan), which DMAs
// corner-coordinate windows into VMEM, computes each orientation's
// gradients there, and adds the isotropic element-stiffness entries into a
// VMEM output block along a sequential grid.
//
// Inputs: coords (n_nodes, 3) in node order (ix * (ny + 1) + iy) * (nz + 1)
// + iz; the combo list of structured.build_structured_plan as a CSR table
// over (orientation o, output column c = i * K + k) pairs: col_start[o * n_cols
// + c] .. col_start[o * n_cols + c + 1] index entries (3a + i, 3b + j,
// 2 dx + dy, dz), (dx, dy, dz) the corner of node a in its cell; by value:
// lam, mu, the one-Gauss-point shape gradients dN0 (4, 3) and weight w0,
// and the flat node offset of each orientation's 4 cell corners.
// Output: out[(node * 3 + i) * K + k], the (n_dof, K) DIA values, where
// entry (node, i, k) is the sum over its combos of
//   Ke_o[(a,i),(b,j)] = vol (lam dNa_i dNb_j + mu dNa_j dNb_i
//                            + delta_ij mu dNa.dNb)
// of the cell at node - (dx, dy, dz), cells outside the box giving zero.
//
// What bounds it on the H100: with the gradients staged, each output value
// costs about 5 combos of ~10 flops and shared-memory reads, and the
// compulsory traffic is the 262 MB output in f64 at NX=56 (4.4 MB of
// coordinates in).  The two-stage path it replaces writes and reads back
// 1.2 GB of planes.
//
// Design:
// - A block owns a tile of 32 consecutive nodes and all 3 K columns, as in
//   structured_accumulate.cu: lane l of each warp takes node tile_start + l
//   and a warp walks one column at a time (warp-uniform combo list); the
//   sums go to a (32, 3 K) shared tile that is one contiguous, coalesced
//   run of the output.
// - The gradients are staged once per (cell, orientation), not per output
//   entry.  Cells are indexed by their lower-corner node, so the cells a
//   tile touches at corner shift (dx, dy, dz) are the flat node range
//   tile - (dx sx + dy sy + dz) of length 32: four windows of 33 slots, one
//   per (dx, dy), cover all eight shifts.  A slot whose node is outside the
//   box or on its upper faces holds no cell: its gradients and volume are
//   zero (the TPU kernel's `valid` plane).
// - One orientation at a time: stage its 132 slots' 4 x 3 gradients and
//   volume (closed-form cofactors, as the TPU kernel), then sum each column's
//   combos of that orientation and add the sum into the tile.  That is the
//   plain version's order (structured.accumulate_planes: per orientation in
//   plan order, then over orientations), with no atomics: results are
//   identical bit for bit from run to run.
// - Shared memory: (32 x 3K + 13 x 132) values, 59 KB in f64 at K = 59, so
//   the launch raises the dynamic limit above 48 KB.
// - 64-bit node indices; no dtype or box-size gate: float and double, any
//   nx, ny, nz.

#include <cuda_runtime.h>

namespace {

constexpr int kTileNodes = 32;           // one warp's lanes
constexpr int kWin = kTileNodes + 1;     // slots per (dx, dy) window
constexpr int kSlots = 4 * kWin;         // staged cells per orientation
constexpr int kVals = 13;                // 4 x 3 gradients and the volume
constexpr int kThreads = 256;

template <typename T>
struct Params {
  T lam, mu, w0;
  T dN0[12];          // [n * 3 + d]
  int corner[6][4];   // flat node offset of corner n of orientation o
};

// Gradients dN/dx (ds[n * 3 + D]) and volume of the orientation-o tet of
// the cell whose lower-corner node is m.
template <typename T>
__device__ void cell_gradients(const T* __restrict__ coords,
                               const Params<T>& P, int o, long long m,
                               T* ds, T& vol) {
  T x[4][3];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const long long node = m + P.corner[o][n];
#pragma unroll
    for (int D = 0; D < 3; ++D) x[n][D] = __ldg(coords + node * 3 + D);
  }
  T dxdn[3][3];
#pragma unroll
  for (int D = 0; D < 3; ++D)
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      T s = T(0);
#pragma unroll
      for (int n = 0; n < 4; ++n) s += P.dN0[n * 3 + d] * x[n][D];
      dxdn[D][d] = s;
    }
  T cof[3][3];
#pragma unroll
  for (int D = 0; D < 3; ++D)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      cof[D][d] = dxdn[(D + 1) % 3][(d + 1) % 3] * dxdn[(D + 2) % 3][(d + 2) % 3] -
                  dxdn[(D + 1) % 3][(d + 2) % 3] * dxdn[(D + 2) % 3][(d + 1) % 3];
  const T det =
      dxdn[0][0] * cof[0][0] + dxdn[0][1] * cof[0][1] + dxdn[0][2] * cof[0][2];
  const T inv_det = T(1) / det;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int D = 0; D < 3; ++D) {
      T s = T(0);
#pragma unroll
      for (int d = 0; d < 3; ++d) s += P.dN0[n * 3 + d] * cof[D][d];
      ds[n * 3 + D] = s * inv_det;
    }
  vol = det * P.w0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) structured_fused_kernel(
    const T* __restrict__ coords, T* __restrict__ out,
    const int* __restrict__ col_start, const int4* __restrict__ entries,
    const Params<T> params, int nx, int ny, int nz, int n_cols,
    long long n_nodes) {
  extern __shared__ unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // [kTileNodes][n_cols]
  T* grad = tile + kTileNodes * n_cols;      // [kVals][kSlots]
  __shared__ Params<T> P;                    // dynamic indexing by o
  if (threadIdx.x == 0) P = params;

  const long long node0 = static_cast<long long>(blockIdx.x) * kTileNodes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long sy = nz + 1;
  const long long sx = static_cast<long long>(ny + 1) * sy;

  for (int t = threadIdx.x; t < kTileNodes * n_cols; t += blockDim.x)
    tile[t] = T(0);

  for (int o = 0; o < 6; ++o) {
    // P and the tile are set, and the previous orientation's gradients read
    __syncthreads();
    for (int s = threadIdx.x; s < kSlots; s += blockDim.x) {
      const int w = s / kWin;  // (dx, dy) = (w >> 1, w & 1)
      const long long m =
          node0 - (w >> 1) * sx - (w & 1) * sy - 1 + (s - w * kWin);
      T ds[12];
      T vol = T(0);
#pragma unroll
      for (int v = 0; v < 12; ++v) ds[v] = T(0);
      bool cell = m >= 0 && m < n_nodes;
      if (cell) {
        const long long cx = m / sx;
        const long long rem = m - cx * sx;
        const long long cy = rem / sy;
        const long long cz = rem - cy * sy;
        cell = cx < nx && cy < ny && cz < nz;
      }
      if (cell) cell_gradients(coords, P, o, m, ds, vol);
#pragma unroll
      for (int v = 0; v < 12; ++v) grad[v * kSlots + s] = ds[v];
      grad[12 * kSlots + s] = vol;
    }
    __syncthreads();

    const int* starts = col_start + o * n_cols;
    for (int c = warp; c < n_cols; c += n_warps) {
      const int e0 = __ldg(starts + c);
      const int e1 = __ldg(starts + c + 1);
      if (e0 == e1) continue;
      T acc = T(0);
      for (int e = e0; e < e1; ++e) {
        const int4 ent = __ldg(entries + e);  // (3a + i, 3b + j, 2dx + dy, dz)
        const int a = ent.x / 3, i = ent.x - 3 * a;
        const int b = ent.y / 3, j = ent.y - 3 * b;
        const int s = ent.z * kWin + lane + 1 - ent.w;
        const T* ga = grad + 3 * a * kSlots + s;  // ga[d * kSlots] = dNa_d
        const T* gb = grad + 3 * b * kSlots + s;
        T term = P.lam * (ga[i * kSlots] * gb[j * kSlots]) +
                 P.mu * (ga[j * kSlots] * gb[i * kSlots]);
        if (i == j) {
          term += P.mu * (ga[0] * gb[0] + ga[kSlots] * gb[kSlots] +
                          ga[2 * kSlots] * gb[2 * kSlots]);
        }
        acc += term * grad[12 * kSlots + s];
      }
      tile[lane * n_cols + c] += acc;
    }
  }
  __syncthreads();

  const long long rows =
      n_nodes - node0 < kTileNodes ? n_nodes - node0 : kTileNodes;
  const long long count = rows * n_cols;
  T* dst = out + node0 * n_cols;
  for (long long t = threadIdx.x; t < count; t += blockDim.x) dst[t] = tile[t];
}

template <typename T>
int launch(const T* coords, T* out, const int* col_start, const int* entries,
           const double* consts, const int* corner, int nx, int ny, int nz,
           int n_cols, void* stream) {
  const long long n_nodes =
      static_cast<long long>(nx + 1) * (ny + 1) * (nz + 1);
  if (n_nodes <= 0 || n_cols <= 0) return 0;
  Params<T> p;
  p.lam = static_cast<T>(consts[0]);
  p.mu = static_cast<T>(consts[1]);
  p.w0 = static_cast<T>(consts[2]);
  for (int v = 0; v < 12; ++v) p.dN0[v] = static_cast<T>(consts[3 + v]);
  for (int o = 0; o < 6; ++o)
    for (int n = 0; n < 4; ++n) p.corner[o][n] = corner[o * 4 + n];
  const size_t smem =
      sizeof(T) * (kTileNodes * static_cast<size_t>(n_cols) + kVals * kSlots);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        structured_fused_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n_nodes + kTileNodes - 1) / kTileNodes;
  structured_fused_kernel<T>
      <<<static_cast<unsigned int>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          coords, out, col_start, reinterpret_cast<const int4*>(entries), p,
          nx, ny, nz, n_cols, n_nodes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts and corner are HOST arrays, read before the launch returns:
// consts = (lam, mu, w0, dN0[4][3]) in double; corner = int[6][4].
extern "C" int femcy_fused_assemble_f32(const float* coords, float* out,
                                        const int* col_start,
                                        const int* entries,
                                        const double* consts,
                                        const int* corner, int nx, int ny,
                                        int nz, int n_cols, void* stream) {
  return launch<float>(coords, out, col_start, entries, consts, corner, nx, ny,
                       nz, n_cols, stream);
}

extern "C" int femcy_fused_assemble_f64(const double* coords, double* out,
                                        const int* col_start,
                                        const int* entries,
                                        const double* consts,
                                        const int* corner, int nx, int ny,
                                        int nz, int n_cols, void* stream) {
  return launch<double>(coords, out, col_start, entries, consts, corner, nx,
                        ny, nz, n_cols, stream);
}
