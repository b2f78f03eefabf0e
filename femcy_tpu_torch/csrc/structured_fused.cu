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
// + iz of a meshgen.box_tets box, whose cells hold the six Kuhn tets
// (corners 0137, 0175, 0574, 0476, 0672, 0273; corner c at (c & 1,
// c >> 1 & 1, c >> 2 & 1)); by value: lam, mu, the one-Gauss-point shape
// gradients dN0 (4, 3) and weight w0, and the pre-decoded column table
// colk[i][3 s + j]: the DIA column k of row i's entry for neighbour slot s
// (one of the 15 node offsets of the Kuhn stencil, slot_of below) and
// dof j.  Output: out[(node * 3 + i) * K + k], the (n_dof, K) DIA values,
// where entry (node, i, k) sums over the tets o of the cells at node - d
// (d in {0,1}^3, cells outside the box giving zero) in which the node is
// corner a, over their corners b, the element-stiffness entries
//   Ke_o[(a,i),(b,j)] = vol (lam dNa_i dNb_j + mu dNa_j dNb_i
//                            + delta_ij mu dNa.dNb),
// k given by (slot of corner b - corner a, j).
//
// What bounds it on the H100: bytes, the 262 MB output in f64 at NX=56
// (4.4 MB of coordinates in): 0.080 ms at 3.35 TB/s.  The work is about
// 1.6 GFLOP in f64 (0.047 ms at 34 TFLOP/s).  The first design (a block
// per 32 consecutive nodes, one orientation at a time) took 0.916 ms,
// 8.7% of the bound: each cell's gradients were computed in ~4 blocks and
// 6 passes, each with 12 uncoalesced coordinate loads; 12 barriers per
// block; a serial combo list with integer division per output column; and
// 59 KB of shared memory for 8 warps.
//
// Design:
// - A block owns a 4 x 4 x 4 brick of nodes.  It stages the brick's halo
//   of 6^3 node coordinates, all of a thread's loads in flight at once,
//   then the gradients and volume of all six tets of the 5^3 cells the
//   brick touches, each once, into shared memory (1.95 cells per node,
//   against ~4 per node and orientation before).
// - Thread (node, i) -- 192 threads, i uniform per warp -- keeps the 45
//   sums of its row (15 neighbour slots x 3 dofs j) in registers across
//   all orientations: the Kuhn subdivision is compiled in, so every
//   (tet, corner a, corner b) has a fixed register, and no combo list,
//   integer division or shared read-modify-write is left.  The staged
//   values sit so that the 16 nodes of a half-warp read 16 distinct banks.
// - Order of summation: the plain version's (structured.accumulate_planes)
//   -- for each orientation in turn, the entries of a column summed in
//   plan order (corner a ascending), that sum added to the column.  Only
//   the node's own block (b = a) has more than one entry per orientation;
//   it is summed in a temporary first.  No atomics: the result is the
//   same bits on every run.
// - The sums go through a (64, 3K) shared tile (over the staged values,
//   after a barrier), the K - 45 columns of each row that no entry reaches
//   written as zero, so each z-run of the brick leaves as one contiguous,
//   coalesced 4 x 3K run of the output.  4 barriers per block.
// - Shared memory: 99 KB in f64 (the staged values; the 90.6 KB tile at
//   K = 59 fits under them), 164 registers a thread: 2 blocks, 12 warps
//   per SM.  The halo is 648 values, so cp.async or TMA would buy nothing.
// - What holds it at about a third of the bound: taking phases out one at
//   a time (H100 SXM, 700 W) ranks the row sums first, the output stream
//   second and the gradients third, and they overlap little at 12 warps
//   per SM; blocks that walk several bricks, half the blocks started
//   late, or the three rows of a node in one warp changed nothing.
// - 64-bit node indices; float and double; any nx, ny, nz.

#include <cuda_runtime.h>

namespace {

constexpr int kB = 4;                    // brick edge, nodes
constexpr int kC = kB + 1;               // cells a brick touches, per edge
constexpr int kH = kB + 2;               // halo nodes per edge
constexpr int kNodes = kB * kB * kB;
constexpr int kCells = kC * kC * kC;
constexpr int kHalo = kH * kH * kH;
constexpr int kThreads = 3 * kNodes;
constexpr int kVals = 13;                // 4 x 3 gradients and the volume
// Staged values live at v * kVS + cx * kXS + cy * kYS + o * kC + cz
// (cell (cx, cy, cz) of the brick, orientation o, value v): the six
// orientations share a y-row of 36 slots, so the 16 nodes (y, z) of a
// half-warp read 16 distinct 8-byte banks for every corner shift
// (kYS = 36 = 4 mod 16).
constexpr int kYS = 36;
constexpr int kXS = kC * kYS;
constexpr int kVS = kC * kXS;
static_assert(6 * kC <= kYS, "the orientations overflow a y-row");
constexpr int kSlots = 15;               // neighbour nodes of the stencil
constexpr int kAcc = 3 * kSlots;

// corner a (0..3) of Kuhn tet o, as a cube corner index (0..7)
__host__ __device__ constexpr int kuhn(int o, int a) {
  return ((o == 0   ? 07310
           : o == 1 ? 05710
           : o == 2 ? 04750
           : o == 3 ? 06740
           : o == 4 ? 02760
                    : 03720) >>
          (3 * a)) &
         7;
}

// the slot (0..14) of node offset corner cb - corner ca: its index in
// {-1,0,1}^3 ((vx + 1) 9 + (vy + 1) 3 + vz + 1) ranked among the 15 that
// Kuhn tets have (kernels/structured_fused.py's SLOTS27; kuhn() and this
// ladder are held to KUHN and SLOTS27 by tests/test_torch_fused.py)
__host__ __device__ constexpr int slot_of(int ca, int cb) {
  const int v = ((cb & 1) - (ca & 1) + 1) * 9 +
                (((cb >> 1) & 1) - ((ca >> 1) & 1) + 1) * 3 +
                (((cb >> 2) & 1) - ((ca >> 2) & 1) + 1);
  return v == 0    ? 0
         : v == 1  ? 1
         : v == 3  ? 2
         : v == 4  ? 3
         : v == 9  ? 4
         : v == 10 ? 5
         : v == 12 ? 6
         : v == 13 ? 7
         : v == 14 ? 8
         : v == 16 ? 9
         : v == 17 ? 10
         : v == 22 ? 11
         : v == 23 ? 12
         : v == 25 ? 13
         : v == 26 ? 14
                   : -1;
}
constexpr int kSelf = slot_of(0, 0);

constexpr bool every_pair_has_a_slot() {
  for (int o = 0; o < 6; ++o)
    for (int a = 0; a < 4; ++a)
      for (int b = 0; b < 4; ++b)
        if (slot_of(kuhn(o, a), kuhn(o, b)) < 0) return false;
  return true;
}
static_assert(every_pair_has_a_slot(), "a Kuhn edge outside the 15 slots");

template <typename T>
struct Params {
  T lam, mu, w0;
  T dN0[12];             // [n * 3 + d]
  int colk[3][kAcc];     // DIA column of (i, 3 slot + j)
};

// Gradients dN/dx (g[n * 3 + D]) and volume of a tet from its corner
// coordinates xs[n][D] (closed-form cofactors, as the TPU kernel).
template <typename T>
__device__ __forceinline__ void tet_gradients(const T (&x)[4][3],
                                              const Params<T>& P, T* g,
                                              T& vol) {
  T J[3][3];
#pragma unroll
  for (int D = 0; D < 3; ++D)
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      T s = T(0);
#pragma unroll
      for (int n = 0; n < 4; ++n) s += P.dN0[n * 3 + d] * x[n][D];
      J[D][d] = s;
    }
  T cof[3][3];
#pragma unroll
  for (int D = 0; D < 3; ++D)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      cof[D][d] = J[(D + 1) % 3][(d + 1) % 3] * J[(D + 2) % 3][(d + 2) % 3] -
                  J[(D + 1) % 3][(d + 2) % 3] * J[(D + 2) % 3][(d + 1) % 3];
  const T det = J[0][0] * cof[0][0] + J[0][1] * cof[0][1] + J[0][2] * cof[0][2];
  const T inv_det = T(1) / det;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int D = 0; D < 3; ++D) {
      T s = T(0);
#pragma unroll
      for (int d = 0; d < 3; ++d) s += P.dN0[n * 3 + d] * cof[D][d];
      g[n * 3 + D] = s * inv_det;
    }
  vol = det * P.w0;
}

// The 45 sums of row I of the node whose cell at corner shift 0 is
// ``cell0`` (a brick-local cell index), over the staged gradients.  One
// code path for the three rows (I at run time): the unrolled body is ~2K
// instructions, and three copies of it, one per row, ran slower.
template <typename T>
__device__ __forceinline__ void row_sums(const T* __restrict__ grad, int cell0,
                                         const int I, const Params<T>& P,
                                         T (&acc)[kAcc]) {
#pragma unroll
  for (int o = 0; o < 6; ++o) {
    T self[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ca = kuhn(o, a);
      const T* gp = grad + o * kC + cell0 -
                    ((ca & 1) * kXS + ((ca >> 1) & 1) * kYS + ((ca >> 2) & 1));
      T g[12];
#pragma unroll
      for (int v = 0; v < 12; ++v) g[v] = gp[v * kVS];
      const T vol = gp[12 * kVS];
      T gI[4];  // g[b * 3 + I]
#pragma unroll
      for (int b = 0; b < 4; ++b) gI[b] = gp[(b * 3 + I) * kVS];
      // row (a, I) of the tet's stiffness, the volume folded in
      const T la = P.lam * vol * gI[a];
      T ma[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) ma[d] = P.mu * vol * g[a * 3 + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const T gm =
            ma[0] * g[b * 3] + ma[1] * g[b * 3 + 1] + ma[2] * g[b * 3 + 2];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          T t = la * g[b * 3 + j] + ma[j] * gI[b];
          if (j == I) t += gm;
          if (b == a)
            self[j] += t;
          else
            acc[slot_of(ca, kuhn(o, b)) * 3 + j] += t;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[kSelf * 3 + j] += self[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) structured_fused_kernel(
    const T* __restrict__ coords, T* __restrict__ out,
    const __grid_constant__ Params<T> P, int nx, int ny, int nz, int n_cols) {
  extern __shared__ unsigned char smem_raw[];
  T* grad = reinterpret_cast<T*>(smem_raw);  // [kVals][kVS], see kYS
  T* xs = grad + kVals * kVS;                // [kHalo][3]
  T* tile = grad;                            // [kNodes][n_cols], later
  const int tid = threadIdx.x;
  const int nbz = (nz + kB) / kB, nby = (ny + kB) / kB;
  const long long sy = nz + 1;
  const long long sx = static_cast<long long>(ny + 1) * sy;
  const int bz = blockIdx.x % nbz;
  const int by = (blockIdx.x / nbz) % nby;
  const int bx = blockIdx.x / (nbz * nby);
  const int x0 = bx * kB, y0 = by * kB, z0 = bz * kB;

  // 1. the halo's node coordinates, nodes (x0 - 1 .. x0 + kB) per axis,
  //    all of a thread's loads in flight at once
  constexpr int kHaloRounds = (kHalo * 3 + kThreads - 1) / kThreads;
  T hv[kHaloRounds];
#pragma unroll
  for (int k = 0; k < kHaloRounds; ++k) {
    const int t = tid + k * kThreads;
    const int h = t / 3;
    const int hx = h / (kH * kH), hy = (h / kH) % kH, hz = h % kH;
    const int gx = x0 - 1 + hx, gy = y0 - 1 + hy, gz = z0 - 1 + hz;
    hv[k] = T(0);
    if (t < kHalo * 3 && gx >= 0 && gx <= nx && gy >= 0 && gy <= ny &&
        gz >= 0 && gz <= nz)
      hv[k] = __ldg(coords + (gx * sx + gy * sy + gz) * 3 + (t - 3 * h));
  }
#pragma unroll
  for (int k = 0; k < kHaloRounds; ++k)
    if (tid + k * kThreads < kHalo * 3) xs[tid + k * kThreads] = hv[k];
  __syncthreads();

  // 2. gradients and volume of every (orientation, cell) the brick
  //    touches, cells (x0 - 1 .. x0 + kB - 1) per axis; zero outside.
  //    Two tets per thread at a time, so their chains overlap.
  for (int t0 = tid; t0 < 6 * kCells; t0 += 2 * kThreads) {
    T g[2][12];
    T vol[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int t = t0 + q * kThreads;
      const int o = t / kCells;
      const int c = t - o * kCells;
      const int cx = c / (kC * kC), cy = (c / kC) % kC, cz = c % kC;
      const int gx = x0 - 1 + cx, gy = y0 - 1 + cy, gz = z0 - 1 + cz;
      vol[q] = T(0);
#pragma unroll
      for (int v = 0; v < 12; ++v) g[q][v] = T(0);
      if (t < 6 * kCells && gx >= 0 && gx < nx && gy >= 0 && gy < ny &&
          gz >= 0 && gz < nz) {
        T x[4][3];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int cn = kuhn(o, n);
          const int h = ((cx + (cn & 1)) * kH + cy + ((cn >> 1) & 1)) * kH +
                        cz + ((cn >> 2) & 1);
#pragma unroll
          for (int D = 0; D < 3; ++D) x[n][D] = xs[h * 3 + D];
        }
        tet_gradients(x, P, g[q], vol[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int t = t0 + q * kThreads;
      if (t >= 6 * kCells) continue;
      const int o = t / kCells;
      const int c = t - o * kCells;
      T* dst = grad + (c / (kC * kC)) * kXS + ((c / kC) % kC) * kYS + o * kC +
               c % kC;
#pragma unroll
      for (int v = 0; v < 12; ++v) dst[v * kVS] = g[q][v];
      dst[12 * kVS] = vol[q];
    }
  }
  __syncthreads();

  // 3. thread (node l, row i): its 45 sums, in registers
  const int i = tid / kNodes;  // uniform per warp
  const int l = tid - i * kNodes;
  const int lx = l / (kB * kB), ly = (l / kB) % kB, lz = l % kB;
  const int cell0 = (lx + 1) * kXS + (ly + 1) * kYS + lz + 1;
  T acc[kAcc];
#pragma unroll
  for (int s = 0; s < kAcc; ++s) acc[s] = T(0);
  row_sums<T>(grad, cell0, i, P, acc);
  __syncthreads();  // the gradients are read: the tile may overwrite them

  // 4. the row into the tile, its unreached columns zero
  const int K = n_cols / 3;
  T* row = tile + l * n_cols + i * K;
  for (int k = 0; k < K; ++k) row[k] = T(0);
#pragma unroll
  for (int s = 0; s < kAcc; ++s) row[P.colk[i][s]] = acc[s];
  __syncthreads();

  // 5. the tile out: each z-run of the brick (rows lx * kB + ly) is one
  //    contiguous run of the output
  const int nzr = nz + 1 - z0 < kB ? nz + 1 - z0 : kB;
  for (int r = 0; r < kB * kB; ++r) {
    const int gx = x0 + r / kB, gy = y0 + r % kB;
    if (gx > nx || gy > ny) continue;  // uniform over the block
    T* dst = out + (gx * sx + gy * sy + z0) * n_cols;
    const T* src = tile + r * kB * n_cols;
    for (int t = tid; t < nzr * n_cols; t += kThreads) dst[t] = src[t];
  }
}

template <typename T>
int launch(const T* coords, T* out, const double* consts, const int* colk,
           int nx, int ny, int nz, int n_cols, void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || n_cols <= 0) return 0;
  Params<T> p;
  p.lam = static_cast<T>(consts[0]);
  p.mu = static_cast<T>(consts[1]);
  p.w0 = static_cast<T>(consts[2]);
  for (int v = 0; v < 12; ++v) p.dN0[v] = static_cast<T>(consts[3 + v]);
  for (int i = 0; i < 3; ++i)
    for (int s = 0; s < kAcc; ++s) p.colk[i][s] = colk[i * kAcc + s];
  const size_t staged = kVals * kVS + kHalo * 3;
  const size_t tile = static_cast<size_t>(kNodes) * n_cols;
  const size_t smem = sizeof(T) * (staged > tile ? staged : tile);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        structured_fused_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>((nx + kB) / kB) *
                           ((ny + kB) / kB) * ((nz + kB) / kB);
  structured_fused_kernel<T>
      <<<static_cast<unsigned int>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(coords, out, p, nx, ny, nz,
                                              n_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts and colk are HOST arrays, read before the launch returns:
// consts = (lam, mu, w0, dN0[4][3]) in double; colk = int[3][45].
extern "C" int femcy_fused_assemble_f32(const float* coords, float* out,
                                        const double* consts, const int* colk,
                                        int nx, int ny, int nz, int n_cols,
                                        void* stream) {
  return launch<float>(coords, out, consts, colk, nx, ny, nz, n_cols, stream);
}

extern "C" int femcy_fused_assemble_f64(const double* coords, double* out,
                                        const double* consts, const int* colk,
                                        int nx, int ny, int nz, int n_cols,
                                        void* stream) {
  return launch<double>(coords, out, consts, colk, nx, ny, nz, n_cols, stream);
}
